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
// One token's Dh values for head h are contiguous; neighbouring tokens of
// a page are H*Dh apart.  In the decode kernel a warp holds one query row
// with lane l owning the VPT = Dh/32 contiguous elements
// [l*VPT, l*VPT + VPT), so every key or value row is read as one
// coalesced 32-lane load; the prefill kernel stages 64-key tiles (see it).
//
// Both kernels keep the TPU kernels' contracts: masked scores are
// NEG_INF = -1e30 (not -inf), the final division is by max(l, 1e-30), a
// row with no visible key yields exact zeros, and key/value rows past a
// slot's kv_len (decode) or past the chunk's last row (prefill) are never
// read, so stale or non-finite page tails cannot reach the sum.
//
// Math is float32 throughout; bf16 pools are widened on load (exactly).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDecodeThreads = 256;   // 8 warps split one slot's pages

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

// VPT contiguous values as float32 (vector loads; alignment holds because
// Dh is 32, 64 or 128 and every row starts at a multiple of Dh).
template <int VPT>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[VPT]) {
  if constexpr (VPT == 1) {
    out[0] = p[0];
  } else if constexpr (VPT == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x;
    out[1] = t.y;
  } else {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x;
    out[1] = t.y;
    out[2] = t.z;
    out[3] = t.w;
  }
}

template <int VPT>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&out)[VPT]) {
  if constexpr (VPT == 1) {
    out[0] = __bfloat162float(p[0]);
  } else {
#pragma unroll
    for (int i = 0; i < VPT / 2; ++i) {
      const float2 f =
          __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One warp's online-softmax update over one page: the first n_valid
// (1..ps, ps <= 32) tokens of the page are visible, the rest are masked.
// kbase/vbase point at token 0 of the page for this head, lane offset
// applied; token t is tok_stride elements further.  Scores are computed
// first (lane t keeps score t), then the page's max, the rescale of the
// running state and the p.v accumulation — the TPU kernel's per-page
// block update, with the same order of operations for every row whatever
// chunk or batch it sits in.
template <int VPT, typename KV>
__device__ __forceinline__ void attend_page(const float (&q)[VPT],
                                            const KV* kbase, const KV* vbase,
                                            size_t tok_stride, int n_valid,
                                            float scale, int lane, float& m,
                                            float& l, float (&acc)[VPT]) {
  float my_s = kNegInf;
#pragma unroll 4
  for (int t = 0; t < n_valid; ++t) {
    float kv[VPT];
    load_vec<VPT>(kbase + t * tok_stride, kv);
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) part = fmaf(q[i], kv[i], part);
    const float s = warp_sum(part) * scale;
    if (lane == t) my_s = s;
  }
  const float m_new = fmaxf(m, warp_max(my_s));
  const float p = lane < n_valid ? expf(my_s - m_new) : 0.f;
  const float alpha = expf(m - m_new);
  l = l * alpha + warp_sum(p);
#pragma unroll
  for (int i = 0; i < VPT; ++i) acc[i] *= alpha;
#pragma unroll 4
  for (int t = 0; t < n_valid; ++t) {
    const float pt = __shfl_sync(kFull, p, t);
    float vv[VPT];
    load_vec<VPT>(vbase + t * tok_stride, vv);
#pragma unroll
    for (int i = 0; i < VPT; ++i) acc[i] = fmaf(pt, vv[i], acc[i]);
  }
  m = m_new;
}

// Replaces paddle_tpu/parallel/flash_attention.py:_paged_decode_kernel
// (launcher _paged_pallas).  One block per (slot, head).  On the TPU the
// page walk is the sequential last grid dimension; here the block's 8
// warps take the slot's pages round-robin, each keeping its own
// (m, l, acc), and the block merges the 8 states at the end.  The kernel
// is bound by bytes: every visible key and value row is read once from
// device memory, S*kv_len*H*Dh*2*itemsize in all.  Pages past
// ceil(kv_len/ps) are never touched.
template <int VPT, typename KV>
__global__ void __launch_bounds__(kDecodeThreads)
    paged_decode_kernel(const float* __restrict__ q,
                        const KV* __restrict__ k_pool,
                        const KV* __restrict__ v_pool,
                        const int* __restrict__ page_tables,
                        const int* __restrict__ kv_lens,
                        float* __restrict__ out, int H, int ps, int mp,
                        float scale) {
  constexpr int DH = 32 * VPT;
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float* o = out + (static_cast<size_t>(s) * H + h) * DH;
  const int kvl = kv_lens[s];
  if (kvl <= 0) {  // inactive slot: exact zeros
    for (int d = threadIdx.x; d < DH; d += blockDim.x) o[d] = 0.f;
    return;
  }
  float qv[VPT];
  load_vec<VPT>(q + (static_cast<size_t>(s) * H + h) * DH + lane * VPT, qv);
  float m = kNegInf, l = 0.f;
  float acc[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) acc[i] = 0.f;
  const int npages = (kvl + ps - 1) / ps;
  const int* row = page_tables + static_cast<size_t>(s) * mp;
  const size_t tok_stride = static_cast<size_t>(H) * DH;
  for (int j = warp; j < npages; j += nwarps) {
    const size_t base = static_cast<size_t>(row[j]) * ps * tok_stride +
                        static_cast<size_t>(h) * DH + lane * VPT;
    attend_page<VPT>(qv, k_pool + base, v_pool + base, tok_stride,
                     min(ps, kvl - j * ps), scale, lane, m, l, acc);
  }
  // merge the warps' states in warp order (a fixed order: the result for
  // a slot depends on its own kv_len and pages only)
  extern __shared__ float smem[];
  float* sm_m = smem;
  float* sm_l = smem + nwarps;
  float* sm_acc = smem + 2 * nwarps;
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < VPT; ++i) sm_acc[warp * DH + lane * VPT + i] = acc[i];
  __syncthreads();
  for (int d = threadIdx.x; d < DH; d += blockDim.x) {
    float mx = kNegInf;
    for (int w = 0; w < nwarps; ++w) mx = fmaxf(mx, sm_m[w]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < nwarps; ++w) {
      const float c = expf(sm_m[w] - mx);  // 0 for a warp that saw no page
      lsum = fmaf(sm_l[w], c, lsum);
      a = fmaf(sm_acc[w * DH + d], c, a);
    }
    o[d] = a / fmaxf(lsum, 1e-30f);
  }
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

template <int VPT, typename KV>
void launch_decode(const void* q, const void* k, const void* v,
                   const void* tables, const void* lens, void* out, int S,
                   int H, int ps, int mp, float scale, cudaStream_t st) {
  const size_t smem = (kDecodeThreads / 32) * (2 + 32 * VPT) * sizeof(float);
  paged_decode_kernel<VPT, KV><<<dim3(S, H), kDecodeThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<float*>(out), H, ps, mp,
      scale);
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
// ps at most 32; prefill's q and pools must be 16-byte aligned (the Python
// wrappers check all of this first).  Each
// function launches on `stream` and returns cudaGetLastError().
extern "C" int pt_paged_decode(const void* q, const void* k_pool,
                               const void* v_pool, const void* page_tables,
                               const void* kv_lens, void* out, int S, int H,
                               int Dh, int ps, int mp, float scale,
                               int kv_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PT_DECODE(VPT, KV) \
  launch_decode<VPT, KV>(q, k_pool, v_pool, page_tables, kv_lens, out, S, H, \
                         ps, mp, scale, st)
  if (kv_bf16) {
    if (Dh == 32) PT_DECODE(1, __nv_bfloat16);
    else if (Dh == 64) PT_DECODE(2, __nv_bfloat16);
    else if (Dh == 128) PT_DECODE(4, __nv_bfloat16);
    else return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (Dh == 32) PT_DECODE(1, float);
    else if (Dh == 64) PT_DECODE(2, float);
    else if (Dh == 128) PT_DECODE(4, float);
    else return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PT_DECODE
  return static_cast<int>(cudaGetLastError());
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
