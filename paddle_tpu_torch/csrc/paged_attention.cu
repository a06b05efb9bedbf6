// Paged attention kernels for Hopper (sm_90a): decode and prefill over a
// paged KV pool.  Built by paddle_tpu_torch/cuda_kernels.py with nvcc into a
// shared library with a plain C interface (loaded with ctypes); nothing
// here includes PyTorch's headers.
//
// Layouts (the JAX package's, kept at the public functions):
//   q            [S, H, Dh] (decode) or [C, H, Dh] (prefill), float32
//   k/v pool     [P, ps, H, Dh], float32 or bfloat16 (one layer's slice)
//   page_tables  [S, MP] int32 (decode), pages [MP] int32 (prefill)
//   kv_lens      [S] int32 (decode); start is a host int (prefill)
//   out          like q, float32
//   workspace    [S, H, splits, Dh + 2] float32 (decode): each split's
//                unnormalised (acc[Dh], m, l)
// One token's Dh values for head h are contiguous; neighbouring tokens of
// a page are H*Dh apart.  Both kernels stage key and value rows in shared
// memory with cp.async, 16 bytes a copy.
//
// Both kernels keep the TPU kernels' contracts: the masked sentinel is
// NEG_INF = -1e30 (not -inf), the final division is by max(l, 1e-30), a
// row with no visible key yields exact zeros, and key/value rows past a
// slot's kv_len (decode) or past the chunk's last row (prefill) are never
// read, so stale or non-finite page tails cannot reach the sum.  Neither
// walks past the page table's width: keys at or past mp * ps are never
// visible, as in the TPU kernels' mp-page grids.
//
// Math is float32 throughout; bf16 pools are copied as bf16 and widened
// when read (exactly).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------------------
// B4, the paged decode.  Replaces
// paddle_tpu/parallel/flash_attention.py:_paged_decode_kernel (launcher
// _paged_pallas): one query row per (slot, head) against the slot's first
// min(kv_len, mp * ps) keys, read through its page-table row.
//
// It is a mat-vec over the cache, so the card's byte rate bounds it: every
// visible key and value row is read once, S * kv_len * H * Dh * 2 *
// itemsize bytes in all, for 4 * Dh operations a key.  The TPU kernel
// walks a slot's pages in order on one core; here the walk is cut into
// splits of whole pages (split_pages(ps) of them, at most kSplitKeys keys:
// 256 keys at ps 16), one block per (split, head, slot), so a long slot
// fills many SMs.  The split size is a constant of the page size: it never
// depends on S, on kv_lens, on the other slots or on the card, so a
// slot's bits are the same alone or in any batch.
//
// Inside a split, key rows and then value rows stream through a ring of
// NS staged kDT-key tiles (cp.async, 16 bytes a copy, zero-filled past the
// split's last visible key), NS - 1 tiles in flight.  The split's token
// rows (page * ps + row, from its page-table entries) are tabled in shared
// memory once, so a copy costs one shared load and no division.  Four
// lanes own a key's whole dot product (Dh/4 values each, 2 shuffle steps),
// with q scaled into log2 units once; the split's scores are kept in
// shared memory, so the softmax is one max and one sum a split (exp2f).
// The value pass gives each thread 4 columns and every (512/Dh)-th key of
// a tile; the key groups' sums are added in order.  Each split writes
// (acc, m, l) once to the workspace; paged_decode_merge_kernel then
// combines a (slot, head)'s live splits in split order.  No atomics: two
// calls give the same bits.  The block's time is set by the chain of
// dependent steps a tile costs it (barrier, copies, products), so the
// loops a tile runs have compile-time trip counts and are unrolled.
constexpr int kDecodeThreads = 128;  // 4 warps a split
constexpr int kSplitKeys = 256;      // a split's keys at most (whole pages)
constexpr int kDT = 32;              // keys a staged tile
constexpr int kKeyLanes = 4;         // lanes that share a key's dot product
constexpr int kRingBytes = 64 * 1024;
static_assert(kDT % (kDecodeThreads / kKeyLanes) == 0 &&
                  kSplitKeys % kDT == 0,
              "a tile is whole rounds of the lane groups");

// Pages a split covers (the host's _b4_split_pages): ps is 1..32.
__host__ __device__ constexpr int split_pages(int ps) {
  return ps >= kSplitKeys ? 1 : kSplitKeys / ps;
}

template <int DH, typename KV>
struct DecodeTile {
  static constexpr int EPC = 16 / static_cast<int>(sizeof(KV));  // a copy
  static constexpr int CH = DH / EPC;  // copies a row
  static constexpr int COPIES = kDT * CH / kDecodeThreads;  // a thread's
  // row stride: 16 elements of padding put the two (f32) or four (bf16)
  // keys a quarter or half warp reads in the score step in disjoint banks
  static constexpr int RK = DH + 16;
  static constexpr int ELEMS = kDT * RK;
  static constexpr int BYTES = ELEMS * static_cast<int>(sizeof(KV));
  static constexpr int NS_FIT = kRingBytes / BYTES;
  static constexpr int NS_MAX = 2 * kSplitKeys / kDT;  // tiles a split streams
  static constexpr int NS =
      NS_FIT < 2 ? 2 : (NS_FIT > NS_MAX ? NS_MAX : NS_FIT);
  static constexpr int KG = kDecodeThreads / (DH / 4);  // value-step key groups
  static constexpr int GROUPS = kDecodeThreads / kKeyLanes;  // score step
  static_assert(kDecodeThreads % CH == 0 && COPIES * kDecodeThreads ==
                    kDT * CH && kDT % KG == 0,
                "a tile's copies and value rows split evenly");
};

template <int DH, typename KV>
constexpr size_t decode_smem() {
  using T = DecodeTile<DH, KV>;
  return static_cast<size_t>(T::NS) * T::BYTES +
         (kSplitKeys + T::KG * DH + 8) * sizeof(float) +
         kSplitKeys * sizeof(int);
}

// Tile t of a split's stream (key tiles 0..ntk-1, then value tiles) into
// its ring slot: keys [kDT t', kDT t' + kDT) of the split, zero-filled at
// or past n.  k_src and v_src point at the pools' column c of head h (c =
// the thread's 16-byte column, the same for all its copies); rows[kk] is
// the split's key kk as a token row of the pool.  Always commits a group,
// even an empty one, so every iteration adds one and wait_group's count
// holds.
template <int DH, typename KV>
__device__ __forceinline__ void stage_decode_tile(KV* ring, const KV* k_src,
                                                  const KV* v_src,
                                                  const int* rows, int t,
                                                  int ntk, int n, size_t tok) {
  using T = DecodeTile<DH, KV>;
  if (t < 2 * ntk) {
    const KV* src = t < ntk ? k_src : v_src;
    const int kt = (t < ntk ? t : t - ntk) * kDT;
    const int c = threadIdx.x % T::CH;
    KV* dst = ring + (t % T::NS) * T::ELEMS + c * T::EPC;
#pragma unroll
    for (int i = 0; i < T::COPIES; ++i) {
      const int r = threadIdx.x / T::CH + i * (kDecodeThreads / T::CH);
      const bool ok = kt + r < n;
      const size_t row = ok ? static_cast<size_t>(rows[kt + r]) : 0;
      pt_async::copy16(dst + r * T::RK, src + row * tok, ok ? 16 : 0);
    }
  }
  pt_async::commit();
}

template <int DH, typename KV>
__global__ void __launch_bounds__(kDecodeThreads)
    paged_decode_kernel(const float* __restrict__ q,
                        const KV* __restrict__ k_pool,
                        const KV* __restrict__ v_pool,
                        const int* __restrict__ page_tables,
                        const int* __restrict__ kv_lens,
                        float* __restrict__ ws, int H, int ps, int mp,
                        float scale) {
  using T = DecodeTile<DH, KV>;
  constexpr int NS = T::NS;
  extern __shared__ float4 decode_smem4[];
  KV* ring = reinterpret_cast<KV*>(decode_smem4);           // [NS][kDT][RK]
  float* sc = reinterpret_cast<float*>(ring + NS * T::ELEMS);  // [kSplitKeys]
  float* red = sc + kSplitKeys;                             // [KG][DH]
  float* wred = red + T::KG * DH;                           // [2][4 warps]
  int* rows = reinterpret_cast<int*>(wred + 8);             // [kSplitKeys]

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pps = split_pages(ps);
  const int k0 = split * pps * ps;  // the split's first key
  // the split's token rows (page-table entries inside the row's mp),
  // tabled while kv_len is read
  const int* table = page_tables + static_cast<size_t>(s) * mp;
  for (int kk = tid; kk < pps * ps && k0 + kk < mp * ps;
       kk += kDecodeThreads) {
    const int pg = (k0 + kk) / ps;
    rows[kk] = table[pg] * ps + (k0 + kk - pg * ps);
  }
  const int kend = min(kv_lens[s], mp * ps);  // keys the slot sees
  if (kend <= k0) return;  // past the slot's keys (kv_len <= 0 included)
  const int n = min(pps * ps, kend - k0);  // the split's keys, >= 1
  const int ntk = (n + kDT - 1) / kDT;
  const size_t tok = static_cast<size_t>(H) * DH;  // between two tokens

  // score step: lanes 4r..4r+3 own keys r, r + 32, ... of a tile; lane j
  // holds q's 4-value chunks 4i + j, scaled into log2 units
  const int key = tid / kKeyLanes;
  const int j = tid % kKeyLanes;
  const float sl2 = scale * kLog2e;
  float4 qv[DH / 16];
  const float* qrow = q + (static_cast<size_t>(s) * H + h) * DH;
#pragma unroll
  for (int i = 0; i < DH / 16; ++i) {
    const float4 t = *reinterpret_cast<const float4*>(qrow + 16 * i + 4 * j);
    qv[i] = make_float4(t.x * sl2, t.y * sl2, t.z * sl2, t.w * sl2);
  }
  // value step: 4 columns [4u, 4u + 4) over keys g, g + KG, ... of a tile
  const int u = tid % (DH / 4);
  const int g = tid / (DH / 4);
  const size_t col = static_cast<size_t>(h) * DH +
                     (tid % T::CH) * T::EPC;  // the thread's copy column
  const KV* k_src = k_pool + col;
  const KV* v_src = v_pool + col;
  __syncthreads();  // the token rows

#pragma unroll
  for (int t = 0; t < NS - 1; ++t)
    stage_decode_tile<DH>(ring, k_src, v_src, rows, t, ntk, n, tok);
  float m = kNegInf, l = 0.f;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t = 0; t < 2 * ntk; ++t) {
    pt_async::wait_group<NS - 2>();
    __syncthreads();  // tile t landed; tile t - 1's slot is consumed
    stage_decode_tile<DH>(ring, k_src, v_src, rows, t + NS - 1, ntk, n, tok);
    const KV* tile = ring + (t % NS) * T::ELEMS;
    if (t < ntk) {
#pragma unroll
      for (int kr = 0; kr < kDT / T::GROUPS; ++kr) {
        const KV* kp = tile + (key + kr * T::GROUPS) * T::RK + 4 * j;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DH / 16; ++i)
          part = pt_async::dot4(qv[i], pt_async::lds4(kp + 16 * i), part);
        part += __shfl_xor_sync(kFull, part, 1);
        part += __shfl_xor_sync(kFull, part, 2);
        if (j == 0) sc[t * kDT + key + kr * T::GROUPS] = part;
      }
      if (t == ntk - 1) {  // the split's softmax: one max, one sum
        __syncthreads();
        float mx = kNegInf;
        for (int i = tid; i < n; i += kDecodeThreads) mx = fmaxf(mx, sc[i]);
        mx = warp_max(mx);
        if (lane == 0) wred[warp] = mx;
        __syncthreads();
        m = fmaxf(fmaxf(wred[0], wred[1]), fmaxf(wred[2], wred[3]));
        float ls = 0.f;
        // keys past n (to the last tile's end) get p = 0 against the
        // tile's zero-filled rows, so the value step adds exact zeros
        for (int i = tid; i < ntk * kDT; i += kDecodeThreads) {
          const float p = i < n ? exp2f(sc[i] - m) : 0.f;
          sc[i] = p;
          ls += p;
        }
        ls = warp_sum(ls);
        if (lane == 0) wred[4 + warp] = ls;
        __syncthreads();
        l = (wred[4] + wred[5]) + (wred[6] + wred[7]);
      }
    } else {
      const float* p = sc + (t - ntk) * kDT;
#pragma unroll
      for (int i = 0; i < kDT / T::KG; ++i) {
        const int r = g + i * T::KG;
        const float pr = p[r];
        const float4 v = pt_async::lds4(tile + r * T::RK + 4 * u);
        acc[0] = fmaf(pr, v.x, acc[0]);
        acc[1] = fmaf(pr, v.y, acc[1]);
        acc[2] = fmaf(pr, v.z, acc[2]);
        acc[3] = fmaf(pr, v.w, acc[3]);
      }
    }
  }
  *reinterpret_cast<float4*>(red + g * DH + 4 * u) =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  float* rec = ws + ((static_cast<size_t>(s) * H + h) * gridDim.x + split) *
                        (DH + 2);
  if (tid < DH) {
    float a = red[tid];
#pragma unroll
    for (int k = 1; k < T::KG; ++k) a += red[k * DH + tid];
    rec[tid] = a;
  }
  if (tid == 0) {
    rec[DH] = m;
    rec[DH + 1] = l;
  }
}

// B4's second launch: out[s, h] = sum_i acc_i 2^(m_i - M) / max(sum_i l_i
// 2^(m_i - M), 1e-30) over the (slot, head)'s live splits, in split order
// (M = their largest m).  A slot with kv_len <= 0 gets exact zeros; the
// splits past its keys wrote nothing and are not read.
template <int DH>
__global__ void __launch_bounds__(DH)
    paged_decode_merge_kernel(const int* __restrict__ kv_lens,
                              const float* __restrict__ ws,
                              float* __restrict__ out, int H, int ps, int mp,
                              int splits) {
  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int d = threadIdx.x;
  float* o = out + (static_cast<size_t>(s) * H + h) * DH;
  const int kend = min(kv_lens[s], mp * ps);
  if (kend <= 0) {
    o[d] = 0.f;
    return;
  }
  const int sk = split_pages(ps) * ps;
  const int live = (kend + sk - 1) / sk;
  const float* rec = ws + (static_cast<size_t>(s) * H + h) * splits * (DH + 2);
  float mx = kNegInf;
  for (int i = 0; i < live; ++i) mx = fmaxf(mx, rec[i * (DH + 2) + DH]);
  float lsum = 0.f, a = 0.f;
  for (int i = 0; i < live; ++i) {
    const float* r = rec + i * (DH + 2);
    const float w = exp2f(r[DH] - mx);
    lsum = fmaf(r[DH + 1], w, lsum);
    a = fmaf(r[d], w, a);
  }
  o[d] = a / fmaxf(lsum, 1e-30f);
}

// Replaces paddle_tpu/parallel/flash_attention.py:_paged_prefill_kernel
// (launcher _paged_prefill_pallas): the flash forward's tile step with a
// loader that gathers through the page table.
//
// One block of 128 threads per (head, tile of 32 query rows); the tiles
// with the longest key walk are launched first (under the causal triangle
// the last tile of a chunk walks C/64 times as many key tiles as the
// first, and that walk sets the kernel's time: 32-row tiles halve its
// work against 64-row ones and fit 2 blocks an SM).  Key tiles are 64
// keys aligned at absolute key 0: key kk is row kk % ps of page
// pages[kk / ps], so any page size 1..32 works.  Each key's head row is
// Dh * itemsize contiguous bytes, staged by cp.async 16 bytes a copy, two
// tiles deep: tile j + 1 is in flight while tile j computes.
// Keys at or past the tile's last visible key (start + its last row,
// within the page row's span) are zero-filled and never read, so stale or
// non-finite page tails change nothing.  bfloat16 pools are copied as
// bfloat16 and widened when read.
//
// Math (float32 FMAs): scores from register micro-tiles (rows ty + 8i,
// keys tx + 16c, i, c < 4) fed by 16-byte shared loads, 8 loads for 64
// FMAs; the online-softmax update of flash_fwd_kernel (m = -1e30 start,
// p = 0 where masked, max(l, 1e-30) division), row max and sum over the 16
// lanes of a half warp; then acc += P V from a P^T tile, each thread
// owning 4 consecutive rows by Dh/16 columns (16 FMAs for two 16-byte
// loads at Dh 64).  Row strides are padded to keep every row 16-byte
// aligned and the 8 rows a quarter warp reads in different bank groups.
//
// Chunk split is bitwise by construction: a row's state changes only at
// absolute key tiles, in order, by code that does not depend on the row's
// slot in its block, on C or on start; a tile a row cannot see is inert
// for it (alpha = 1, p = 0, and fma(0, finite, acc) == acc).  So
// monolithic, chunked and split calls give the same bits.  The work is
// 4*Dh operations a visible (row, key) pair on float32 CUDA cores; the
// bytes (each visible key tile read once a query tile) are far below.
constexpr int kPT = 64;   // keys a prefill key tile
constexpr int kPR = 32;   // query rows a prefill block
constexpr int kPrefillThreads = 4 * kPR;
constexpr int kPTS = kPR + 4;  // row stride of the P^T tile

// Keys [k0, k0 + 64) of one head into K and V tiles [64][Dh + 16/itemsize]
// (zeros at or past kend, never read); the caller commits.
template <int DH, typename KV>
__device__ __forceinline__ void stage_keys(KV* Kd, const KV* k_pool,
                                           const KV* v_pool, const int* pages,
                                           int k0, int kend, int ps, int h,
                                           size_t tok) {
  constexpr int EPC = 16 / static_cast<int>(sizeof(KV));  // elements a copy
  constexpr int CH = DH / EPC;                             // copies a key
  constexpr int RK = DH + EPC;
  KV* Vd = Kd + kPT * RK;
  for (int e = threadIdx.x; e < kPT * CH; e += kPrefillThreads) {
    const int r = e / CH;
    const int c = e - r * CH;
    const int kk = k0 + r;
    const bool ok = kk < kend;
    size_t off = 0;
    if (ok) {
      const int pg = kk / ps;
      off = (static_cast<size_t>(pages[pg]) * ps + (kk - pg * ps)) * tok +
            static_cast<size_t>(h) * DH + c * EPC;
    }
    pt_async::copy16(Kd + r * RK + c * EPC, k_pool + off, ok ? 16 : 0);
    pt_async::copy16(Vd + r * RK + c * EPC, v_pool + off, ok ? 16 : 0);
  }
}

// The Dh/16 columns a thread owns in the P V step: x[j] is column
// 2*ca + j at Dh 32, else 64*(j/4) + 4*ca + j%4.
template <int DH>
__device__ __forceinline__ int prefill_col(int j, int ca) {
  return DH == 32 ? 2 * ca + j : 64 * (j >> 2) + 4 * ca + (j & 3);
}

template <int DH, typename KV>
__device__ __forceinline__ void load_value_cols(const KV* row, int ca,
                                                float (&x)[DH / 16]) {
  if constexpr (DH == 32) {
    x[0] = to_float(row[2 * ca]);
    x[1] = to_float(row[2 * ca + 1]);
  } else {
#pragma unroll
    for (int g = 0; g < DH / 64; ++g) {
      const float4 t = pt_async::lds4(row + 64 * g + 4 * ca);
      x[4 * g] = t.x;
      x[4 * g + 1] = t.y;
      x[4 * g + 2] = t.z;
      x[4 * g + 3] = t.w;
    }
  }
}

// Max / sum over the 16 lanes of a half warp (one score row).
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int DH, typename KV>
__global__ void __launch_bounds__(kPrefillThreads)
    paged_prefill_kernel(const float* __restrict__ q,
                         const KV* __restrict__ k_pool,
                         const KV* __restrict__ v_pool,
                         const int* __restrict__ pages,
                         float* __restrict__ out, int C, int H, int ps,
                         int mp, int start, float scale) {
  constexpr int RQ = DH + 4;  // q tile row stride (floats)
  constexpr int RK = DH + 16 / static_cast<int>(sizeof(KV));
  constexpr int NJ = DH / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                  // [kPR][RQ]
  float* PT = Qs + kPR * RQ;         // [64 keys][kPTS]
  float* alpha_s = PT + kPT * kPTS;  // [kPR]
  float* l_s = alpha_s + kPR;        // [kPR]
  KV* KVs = reinterpret_cast<KV*>(l_s + kPR);  // [2][K, V][64][RK]

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kPR;
  const int tx = threadIdx.x & 15;  // score step: keys tx + 16c
  const int ty = threadIdx.x >> 4;  // score step: rows ty + kPR/4 i
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ca = (lane & 7) + 8 * (warp & 1);    // P V step: columns
  const int rb = (lane >> 3) + 4 * (warp >> 1);  // P V step: rows 4rb + i
  const int span = mp * ps;  // keys the page row can hold
  const int rows = min(kPR, C - q0);
  // keys [0, kend) hold every key a row of the tile sees
  const int kend = min(start + q0 + rows, span);
  const int nkt = (kend + kPT - 1) / kPT;
  const size_t tok = static_cast<size_t>(H) * DH;  // between two tokens

  for (int e = threadIdx.x; e < kPR * (DH / 4); e += kPrefillThreads) {
    const int r = e / (DH / 4);
    const int c = e - r * (DH / 4);
    const bool ok = r < rows;
    pt_async::copy16(
        Qs + r * RQ + 4 * c,
        ok ? q + (static_cast<size_t>(q0 + r) * H + h) * DH + 4 * c : q,
        ok ? 16 : 0);
  }
  stage_keys<DH>(KVs, k_pool, v_pool, pages, 0, kend, ps, h, tok);
  pt_async::commit();

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  for (int t = 0; t < nkt; ++t) {
    const int k0 = t * kPT;
    const int buf = t & 1;
    pt_async::wait_all();
    __syncthreads();  // tile t landed; tile t - 1 and its P^T are consumed
    if (t + 1 < nkt) {
      stage_keys<DH>(KVs + (buf ^ 1) * 2 * kPT * RK, k_pool, v_pool, pages,
                     k0 + kPT, kend, ps, h, tok);
      pt_async::commit();
    }
    const KV* Kt = KVs + buf * 2 * kPT * RK;
    const KV* Vt = Kt + kPT * RK;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = pt_async::lds4(Qs + (ty + kPR / 4 * i) * RQ + d);
        kv[i] = pt_async::lds4(Kt + (tx + 16 * i) * RK + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = pt_async::dot4(qv[i], kv[c], s[i][c]);
    }
    // online softmax, row by row: row r sees keys [0, min(start + q0 + r + 1, span))
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + kPR / 4 * i;
      const int vis = min(start + q0 + r + 1, span);
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ok[c] = r < rows && k0 + tx + 16 * c < vis;
        s[i][c] = ok[c] ? s[i][c] * scale : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[i][c] - m_new) : 0.f;
        PT[(tx + 16 * c) * kPTS + r] = p;
        psum += p;
      }
      l[i] = l[i] * alpha + half_sum(psum);
      m[i] = m_new;
      if (tx == 0) alpha_s[r] = alpha;
    }
    __syncthreads();
    // acc = acc * alpha + P V, keys in order
    float pa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pa[i] = alpha_s[4 * rb + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= pa[i];
    }
#pragma unroll 4
    for (int c = 0; c < kPT; ++c) {
      const float4 p4 = pt_async::lds4(PT + c * kPTS + 4 * rb);
      float vv[NJ];
      load_value_cols<DH>(Vt + c * RK, ca, vv);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pr[i], vv[j], acc[i][j]);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) l_s[ty + kPR / 4 * i] = l[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * rb + i;
    if (r >= rows) continue;
    const float denom = fmaxf(l_s[r], 1e-30f);
    float* o = out + (static_cast<size_t>(q0 + r) * H + h) * DH;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[prefill_col<DH>(j, ca)] = acc[i][j] / denom;
  }
}

template <int DH, typename KV>
constexpr size_t prefill_smem() {
  return (kPR * (DH + 4) + kPT * kPTS + 2 * kPR) * sizeof(float) +
         2 * 2 * kPT * (DH + 16 / sizeof(KV)) * sizeof(KV);
}

template <int DH, typename KV>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const void* tables, const void* lens, void* out,
                          void* ws, int splits, int S, int H, int ps, int mp,
                          float scale, cudaStream_t st) {
  if (splits > 0) {
    constexpr size_t smem = decode_smem<DH, KV>();
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<DH, KV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    paged_decode_kernel<DH, KV>
        <<<dim3(splits, H, S), kDecodeThreads, smem, st>>>(
            static_cast<const float*>(q), static_cast<const KV*>(k),
            static_cast<const KV*>(v), static_cast<const int*>(tables),
            static_cast<const int*>(lens), static_cast<float*>(ws), H, ps, mp,
            scale);
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return launched;
  }
  paged_decode_merge_kernel<DH><<<dim3(H, S), DH, 0, st>>>(
      static_cast<const int*>(lens), static_cast<const float*>(ws),
      static_cast<float*>(out), H, ps, mp, splits);
  return cudaGetLastError();
}

template <int DH, typename KV>
cudaError_t launch_prefill(const void* q, const void* k, const void* v,
                           const void* pages, void* out, int C, int H,
                           int ps, int mp, int start, float scale,
                           cudaStream_t st) {
  constexpr size_t smem = prefill_smem<DH, KV>();
  const cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel<DH, KV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  paged_prefill_kernel<DH, KV>
      <<<dim3(H, (C + kPR - 1) / kPR), kPrefillThreads, smem, st>>>(
          static_cast<const float*>(q), static_cast<const KV*>(k),
          static_cast<const KV*>(v), static_cast<const int*>(pages),
          static_cast<float*>(out), C, H, ps, mp, start, scale);
  return cudaGetLastError();
}

}  // namespace

// The C interface.  Every pointer is a device pointer; kv_bf16 selects
// the pool type (0: float32, 1: bfloat16).  Dh must be 32, 64 or 128 and
// ps 1..32; q and the pools must be 16-byte aligned (the Python wrappers
// check all of this first).  Each function launches on `stream` (decode:
// its two kernels, in order) and returns the first launch error.
extern "C" int pt_paged_decode(const void* q, const void* k_pool,
                               const void* v_pool, const void* page_tables,
                               const void* kv_lens, void* out, void* ws,
                               int splits, int S, int H, int Dh, int ps,
                               int mp, float scale, int kv_bf16, int device,
                               void* stream) {
  // the workspace holds [S, H, splits, Dh + 2]: splits must be this
  // library's count for (mp, ps)
  if (ps < 1 || splits != (mp + split_pages(ps) - 1) / split_pages(ps))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PT_DECODE(DH, KV) \
  err = launch_decode<DH, KV>(q, k_pool, v_pool, page_tables, kv_lens, out, \
                              ws, splits, S, H, ps, mp, scale, st)
  if (kv_bf16) {
    if (Dh == 32) PT_DECODE(32, __nv_bfloat16);
    else if (Dh == 64) PT_DECODE(64, __nv_bfloat16);
    else if (Dh == 128) PT_DECODE(128, __nv_bfloat16);
    else return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (Dh == 32) PT_DECODE(32, float);
    else if (Dh == 64) PT_DECODE(64, float);
    else if (Dh == 128) PT_DECODE(128, float);
    else return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PT_DECODE
  return static_cast<int>(err);
}

extern "C" int pt_paged_prefill(const void* q, const void* k_pool,
                                const void* v_pool, const void* pages,
                                void* out, int C, int H, int Dh, int ps,
                                int mp, int start, float scale, int kv_bf16,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PT_PREFILL(DH, KV) \
  err = launch_prefill<DH, KV>(q, k_pool, v_pool, pages, out, C, H, ps, mp, \
                               start, scale, st)
  if (kv_bf16) {
    if (Dh == 32) PT_PREFILL(32, __nv_bfloat16);
    else if (Dh == 64) PT_PREFILL(64, __nv_bfloat16);
    else if (Dh == 128) PT_PREFILL(128, __nv_bfloat16);
    else return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (Dh == 32) PT_PREFILL(32, float);
    else if (Dh == 64) PT_PREFILL(64, float);
    else if (Dh == 128) PT_PREFILL(128, float);
    else return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PT_PREFILL
  return static_cast<int>(err);
}
