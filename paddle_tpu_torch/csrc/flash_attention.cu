// Flash attention for Hopper (sm_90a): the forward (out and the row
// log-sum-exp), the fused backward (dq, dk and dv in one launch, B2) and
// the two-pass backward (a dk/dv kernel and a dq kernel, B3).  Built
// by paddle_tpu_torch/cuda_kernels.py with nvcc into the same shared
// library as paged_attention.cu, with a plain C interface (loaded with
// ctypes); nothing here includes PyTorch's headers.
//
// Layouts (the JAX package's, kept at the public function):
//   q, out, do   [B, H, T, D]      float32 or bfloat16
//   k, v         [B, H, S, D]      the same type as q
//   kv_lens      [B] int32, or null (every key visible)
//   lse          [B, H, T] float32, contiguous
// q, k, v, out and do may be strided views (the Program feeds q/k/v
// through transpose ops): the kernels take each tensor's batch, head and
// time strides in elements; the last dimension must be contiguous.  The
// outputs the kernels write (out, lse, dq, dk, dv) are contiguous.
//
// Masking is the TPU kernels' (paddle_tpu/parallel/flash_attention.py):
// key c is visible to query row t when c < kv_lens[b] and, if causal,
// c <= t + S - T (bottom-right aligned).  Key and value rows at or past
// kv_lens[b] are never read from device memory (the tile loaders write
// zeros in their place), so non-finite values there cannot reach a sum.
// A row with no visible key gets out = 0 and lse = -1e30 + log(1e-30),
// from the same m = -1e30 start and max(l, 1e-30) division as the TPU
// kernel.  p = exp(s - lse) is computed only where the pair is visible:
// for such a row s - lse is about +1e30, and a 0/1 mask would turn
// 0 * inf into NaN.
//
// Tiling of B2.  A block has 256 threads seen as 16 x 16 (ty, tx).
// Tiles are 64 query rows by 64 keys, staged in shared memory as float32
// with a row stride of D + 1 (so the 16 rows one half-warp reads at one
// column fall in 16 different banks).  In a [64 x 64] score tile a thread
// owns rows ty + 16a and keys tx + 16c (a, c < 4); in a [64 x D] tile it
// owns rows ty + 16a and columns tx + 16j (j < D/16).  All math is
// float32 on CUDA cores; bfloat16 inputs are widened when staged (exactly)
// and outputs rounded once when stored.  A simple kernel that is right:
// wgmma, TMA and pipelined loads are later work.  B3 and B1 have their own
// tiling (8 x 8 register tiles fed by 16-byte shared loads, cp.async
// staging; see their sections).
//
// Bound.  The kernels do 4*D (forward), 10*D (B2) or 8*D + 6*D (B3's two
// passes) operations per visible (query, key) pair on float32 CUDA cores,
// against bytes that are read and written once (q, k, v, out, lse; plus
// do, dq, dk, dv in the backward), so at the training shapes the
// operations bound them; the staged tiles keep the device-memory traffic
// near that minimum (each query tile reads each visible key tile once).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // 16 x 16
constexpr int kTile = 64;      // query rows and keys a tile
constexpr int kPS = kTile + 1; // row stride of the [64 x 64] tiles

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Strides {
  long long b, h, t;  // in elements; the last dimension is contiguous
};

// Rows [row0, row0 + 64) of one (b, h) slice into shared memory as
// float [64][D + 1] (B2's tiles).  Rows at or past `valid` become zeros
// and are never read from device memory.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long tstride, int row0,
                                          int valid) {
  constexpr int DP = D + 1;
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    const int row = row0 + r;
    dst[r * DP + d] = row < valid ? ld(src + row * tstride + d) : 0.f;
  }
}

__device__ __forceinline__ bool visible(int row, int col, int Tq, int kvl,
                                        int causal, int shift) {
  return row < Tq && col < kvl && (!causal || col <= row + shift);
}

// ---------------------------------------------------------------------------
// Tile math of the fused backward (B2), the counterpart of the JAX
// package's _bwd_tiles (row_delta also serves B3's delta pre-pass).  In a
// [64 x 64] tile pair a
// thread owns query rows ty + 16a and keys tx + 16c (a, c < 4); in a
// [64 x D] tile, rows (or keys) ty + 16a and columns tx + 16j (j < D/16).
// ---------------------------------------------------------------------------

// delta = rowsum(do * out) of one row, summed by the 32 lanes of a warp
// (every lane returns the sum).
template <int D, typename T>
__device__ __forceinline__ float row_delta(const T* dob, long long dost,
                                           const T* ob, long long ost,
                                           int row, int lane) {
  float part = 0.f;
  for (int d = lane; d < D; d += 32)
    part = fmaf(ld(dob + row * dost + d), ld(ob + row * ost + d), part);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_xor_sync(kFull, part, off);
  return part;
}

// s = Q K^T and dp = dO V^T for the 4 x 4 entries this thread owns.
template <int D>
__device__ __forceinline__ void score_tiles(const float* Qs, const float* dOs,
                                            const float* Ks, const float* Vs,
                                            int ty, int tx, float s[4][4],
                                            float dp[4][4]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; ++d) {
    float qa[4], da[4], kc[4], vc[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = Qs[(ty + 16 * a) * DP + d];
      da[a] = dOs[(ty + 16 * a) * DP + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kc[c] = Ks[(tx + 16 * c) * DP + d];
      vc[c] = Vs[(tx + 16 * c) * DP + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
        dp[a][c] = fmaf(da[a], vc[c], dp[a][c]);
      }
  }
}

// p = exp(s scale - lse) and ds = p (dp - delta) scale, only where the
// pair is visible (0 elsewhere: a row with no visible key has lse about
// -1e30, and a 0/1 mask would turn 0 * inf into NaN), into dSs and, when
// Ps is not null, Ps.
__device__ __forceinline__ void tile_p_ds(const float s[4][4],
                                          const float dp[4][4],
                                          const float* lse_s,
                                          const float* dlt_s, float* Ps,
                                          float* dSs, int q0, int k0, int ty,
                                          int tx, int Tq, int kvl, int causal,
                                          int shift, float scale) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = tx + 16 * c;
      float p = 0.f, ds = 0.f;
      if (visible(q0 + r, k0 + col, Tq, kvl, causal, shift)) {
        p = expf(s[a][c] * scale - lse_s[r]);
        ds = p * (dp[a][c] - dlt_s[r]) * scale;
      }
      if (Ps) Ps[r * kPS + col] = p;
      dSs[r * kPS + col] = ds;
    }
  }
}

// dv += P^T dO and dk += dS^T Q for keys ty + 16a, columns tx + 16j, over
// the tile's query rows in order.
template <int D>
__device__ __forceinline__ void accumulate_dkv(const float* Ps,
                                               const float* dSs,
                                               const float* dOs,
                                               const float* Qs, int ty,
                                               int tx, float dk[4][D / 16],
                                               float dv[4][D / 16]) {
  constexpr int DP = D + 1;
  constexpr int NJ = D / 16;
#pragma unroll 2
  for (int r = 0; r < kTile; ++r) {
    float pk[4], sk[4], dov[NJ], qv[NJ];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      pk[a] = Ps[r * kPS + ty + 16 * a];
      sk[a] = dSs[r * kPS + ty + 16 * a];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dov[j] = dOs[r * DP + tx + 16 * j];
      qv[j] = Qs[r * DP + tx + 16 * j];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        dv[a][j] = fmaf(pk[a], dov[j], dv[a][j]);
        dk[a][j] = fmaf(sk[a], qv[j], dk[a][j]);
      }
  }
}

// dq += dS K for rows ty + 16a, columns tx + 16j, over the tile's keys in
// order.
template <int D>
__device__ __forceinline__ void accumulate_dq(const float* dSs,
                                              const float* Ks, int ty,
                                              int tx, float dq[4][D / 16]) {
  constexpr int DP = D + 1;
  constexpr int NJ = D / 16;
#pragma unroll 2
  for (int c = 0; c < kTile; ++c) {
    float sa[4], kv[NJ];
#pragma unroll
    for (int a = 0; a < 4; ++a) sa[a] = dSs[(ty + 16 * a) * kPS + c];
#pragma unroll
    for (int j = 0; j < NJ; ++j) kv[j] = Ks[c * DP + tx + 16 * j];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < NJ; ++j) dq[a][j] = fmaf(sa[a], kv[j], dq[a][j]);
  }
}

// One key tile's dk and dv rows into [b*h, S, D] outputs.
template <int D, typename T>
__device__ __forceinline__ void store_dkv(T* dk, T* dv, const float dka[4][D / 16],
                                          const float dva[4][D / 16], int bh,
                                          int k0, int S, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= S) continue;
    const size_t base = (static_cast<size_t>(bh) * S + key) * D + tx;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      st(dk + base + 16 * j, dka[a][j]);
      st(dv + base + 16 * j, dva[a][j]);
    }
  }
}

// Replaces paddle_tpu/parallel/flash_attention.py:_fused_bwd_kernel
// (launcher _flash_bwd_fused): dq, dk and dv in one launch, with
// p = exp(s - lse) recomputed from the saved lse, dv = p^T do,
// dp = do v^T, ds = p (dp - delta) scale, dk = ds^T q, dq = ds k — five
// products per tile pair, every input read from device memory once per
// visible tile pair.
//
// One block per (b*h): it first computes delta = rowsum(do * out) for its
// rows (the TPU launcher does this outside the kernel) and zeroes its
// float32 dq accumulator, then walks the key tiles in order; for each it
// walks the query tiles that can see it, keeping that key tile's dk and
// dv in registers and adding each query tile's ds k into the dq
// accumulator in device memory.  The TPU kernel keeps dq resident in VMEM
// while its grid walks the key blocks of one b*h in order; on the card a
// grid of (b*h, key tile) blocks would have to sum dq across blocks with
// float atomicAdd, whose order changes from run to run.  Owning all of a
// b*h's key tiles in one block keeps every sum in a fixed order, so two
// calls give the same bits (512 blocks at the slice's shape, about four
// per SM, enough to fill the card).
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ o,
                     const T* __restrict__ dout,
                     const int* __restrict__ kv_lens,
                     const float* __restrict__ lse, T* dq, T* __restrict__ dk,
                     T* __restrict__ dv, float* dq_acc,
                     float* __restrict__ delta, int H, int Tq, int S,
                     Strides qs, Strides ks, Strides vs, Strides os,
                     Strides dos, int causal, float scale, int convert_dq) {
  constexpr int DP = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                // [64][DP]
  float* dOs = Qs + kTile * DP;    // [64][DP]
  float* Ks = dOs + kTile * DP;    // [64][DP]
  float* Vs = Ks + kTile * DP;     // [64][DP]
  float* Ps = Vs + kTile * DP;     // [64][kPS]
  float* dSs = Ps + kTile * kPS;   // [64][kPS]
  float* lse_s = dSs + kTile * kPS;  // [64]
  float* dlt_s = lse_s + kTile;      // [64]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kvl = kv_lens ? min(max(kv_lens[b], 0), S) : S;
  const int shift = S - Tq;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const T* ob = o + b * os.b + h * os.h;
  const T* dob = dout + b * dos.b + h * dos.h;
  float* dqa = dq_acc + static_cast<size_t>(bh) * Tq * D;
  float* dlt = delta + static_cast<size_t>(bh) * Tq;
  const float* lseb = lse + static_cast<size_t>(bh) * Tq;

  // delta = rowsum(do * out), one warp a row; dq accumulator = 0
  for (int row = warp; row < Tq; row += kThreads / 32) {
    const float part = row_delta<D>(dob, dos.t, ob, os.t, row, lane);
    if (lane == 0) dlt[row] = part;
  }
  for (int e = threadIdx.x; e < Tq * D; e += kThreads) dqa[e] = 0.f;
  __syncthreads();  // delta and the zeroed dq are visible to the block

  const int nq = (Tq + kTile - 1) / kTile;
  const int nk = (S + kTile - 1) / kTile;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < NJ; ++j) dk_acc[a][j] = dv_acc[a][j] = 0.f;
    if (k0 < kvl) {
      __syncthreads();  // the previous key tile's K and V are consumed
      load_tile<D>(Ks, kb, ks.t, k0, kvl);
      load_tile<D>(Vs, vb, vs.t, k0, kvl);
      // causal: rows below k0 - shift see no key of this tile
      const int i0 = causal ? max(0, k0 - shift) / kTile : 0;
      for (int qt = i0; qt < nq; ++qt) {
        const int q0 = qt * kTile;
        __syncthreads();  // the previous query tile is consumed
        load_tile<D>(Qs, qb, qs.t, q0, Tq);
        load_tile<D>(dOs, dob, dos.t, q0, Tq);
        if (threadIdx.x < kTile) {
          const int row = q0 + threadIdx.x;
          lse_s[threadIdx.x] = row < Tq ? lseb[row] : 0.f;
          dlt_s[threadIdx.x] = row < Tq ? dlt[row] : 0.f;
        }
        __syncthreads();
        float s[4][4], dp[4][4];
        score_tiles<D>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
        tile_p_ds(s, dp, lse_s, dlt_s, Ps, dSs, q0, k0, ty, tx, Tq, kvl,
                  causal, shift, scale);
        __syncthreads();
        accumulate_dkv<D>(Ps, dSs, dOs, Qs, ty, tx, dk_acc, dv_acc);
        // dq (rows ty + 16a, columns tx + 16j) += dS K, in key order
        float dqp[4][NJ];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < NJ; ++j) dqp[a][j] = 0.f;
        accumulate_dq<D>(dSs, Ks, ty, tx, dqp);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int row = q0 + ty + 16 * a;
          if (row >= Tq) continue;
          float* dst = dqa + static_cast<size_t>(row) * D + tx;
#pragma unroll
          for (int j = 0; j < NJ; ++j) dst[16 * j] += dqp[a][j];
        }
      }
    }
    // this key tile's dk and dv (zeros for a tile no row sees)
    store_dkv<D>(dk, dv, dk_acc, dv_acc, bh, k0, S, ty, tx);
  }
  if (convert_dq) {  // a bfloat16 dq: round the float32 sums once
    __syncthreads();
    T* dqb = dq + static_cast<size_t>(bh) * Tq * D;
    for (int e = threadIdx.x; e < Tq * D; e += kThreads) st(dqb + e, dqa[e]);
  }
}

// ---------------------------------------------------------------------------
// The two-pass backward (B3).  Replaces paddle_tpu/parallel/flash_attention.py:
// _bwd_dkv_kernel and _bwd_dq_kernel (launcher _flash_bwd_pallas, shared tile
// math _bwd_tiles).  The TPU grids are (b*h, key block, query block) and
// (b*h, query block, key block), their last dimension sequential, carrying
// dk/dv or dq in VMEM scratch.  Here each becomes one block per (b*h, tile)
// that walks the other side's tiles in a loop and keeps its sums in
// registers: every output element is written by exactly one block from sums
// in a fixed order, with no atomics, so two calls give the same bits.
//
// Why two grids and not B2's one: B2 runs B*H blocks, each walking every
// (key tile, query tile) pair of its head in order, so at long T and small
// B*H (4 x 4096: 32 blocks for 264 block slots) most of the card idles.
// The pair runs B*H*T/64 blocks in each pass; the price is recomputing
// s = q k^T and dp = do v^T in both passes: 14*D operations a visible pair
// (dk/dv pass 8*D, dq pass 6*D) against B2's 10*D.
//
// Besides the FMA units, shared memory bounds such a loop on an H100: an
// SM moves 128 bytes of it a clock against 128 FMAs, and a 16-byte load
// of a warp is four such wavefronts (a 4-byte one, one).  So a thread
// must do about 16 FMAs for every float4 it loads (an 8 x 8 register tile
// over a reduction) for the two to balance; B2's 4 x 4 tiles of scalar
// loads do 2.  Measured, the loops still run near half the float32 rate
// (PERF.md): registers (255 a thread) and shared memory allow 8 warps an
// SM, which leaves load latency and barriers partly exposed.  The design
// (all math exact float32 FMAs on CUDA cores; no tensor cores):
//  - Blocks of 4 warps.  Warps 0-1 compute s = q k^T, warps 2-3
//    dp = do v^T; all four turn them into p and ds; then warps 0-1 sum
//    dv += p^T do and warps 2-3 dk += ds^T q (the dq pass: warps 0-1 sum
//    dq += ds k over the first 32 keys of each tile, warps 2-3 over the
//    last 32, and the two sums are added once at the end).  Each thread
//    owns an 8 x 8 tile of its [64 x 64] product (rows r8 + 8i, keys
//    c8 + 8j) and of its [64 x D] sums (keys or rows 8 r8 + i, columns
//    32g + 4 c8 + e), fed by 16-byte shared loads: 16 FMAs a load.
//  - Tiles are staged row-major with rows padded to D + 4 floats (16-byte
//    aligned; the 8 rows a quarter warp reads fall in 8 different bank
//    groups); p and ds rows to 72 floats and ds^T rows to 68, so the
//    scalar stores that fill them are conflict-free.
//  - cp.async staging of the side each pass streams (q, do, lse and delta
//    for dk/dv; k and v for dq) and, once, of the resident side.  Rows at
//    or past kv_lens (or Tq) are zero-filled, never read.  One buffer a
//    block, so that two blocks (8 warps) share an SM at D 64 and one
//    block's loads overlap the other's compute: a double-buffered block
//    fits only one to an SM, and measured slower.  bfloat16 inputs are
//    widened into the same float32 tiles by ordinary 16-byte loads.
//  - delta = rowsum(do * out) once per call, by flash_bwd_delta_kernel into
//    a float32 [B, H, T] scratch the wrapper allocates; both passes read it
//    as they read lse.
// ---------------------------------------------------------------------------

constexpr int kB3Threads = 128;  // 4 warps
constexpr int kP3 = kTile + 8;   // row stride of p and ds ([64][72])
constexpr int kT3 = kTile + 4;   // row stride of ds^T ([64][68], dq pass)
// shared memory a block may take for two to share an SM (228 KB, 1 KB
// reserved a block)
constexpr size_t kTwoBlockSmem = 228 * 1024 / 2 - 1024;

struct B3Lanes {
  int half;  // warps 0-1: s, p, dv; warps 2-3: dp, ds, dk
  int c8;    // lane % 8
  int r8;    // lane / 8 + 4 (warp % 2): 0..7
};

__device__ __forceinline__ B3Lanes b3_lanes() {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  return {warp >> 1, lane & 7, (lane >> 3) + 4 * (warp & 1)};
}

// Rows [row0, row0 + 64) of one (b, h) slice into a float [64][D + 4]
// tile; rows at or past `valid` are zeros, never read.  float32 goes by
// cp.async (the caller commits and waits); bfloat16 is widened on the way.
template <int D>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           long long tstride, int row0,
                                           int valid) {
  constexpr int RS = D + 4;
  constexpr int CH = D / 4;  // 16-byte chunks a row
  for (int e = threadIdx.x; e < kTile * CH; e += kB3Threads) {
    const int r = e / CH;
    const int c = e - r * CH;
    const int row = row0 + r;
    const bool ok = row < valid;
    pt_async::copy16(dst + r * RS + 4 * c,
                     ok ? src + row * tstride + 4 * c : src, ok ? 16 : 0);
  }
}

template <int D>
__device__ __forceinline__ void stage_tile(float* dst,
                                           const __nv_bfloat16* src,
                                           long long tstride, int row0,
                                           int valid) {
  constexpr int RS = D + 4;
  constexpr int CH = D / 8;  // 16-byte chunks a row
  for (int e = threadIdx.x; e < kTile * CH; e += kB3Threads) {
    const int r = e / CH;
    const int c = e - r * CH;
    const int row = row0 + r;
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    if (row < valid) {
      const uint4 u =
          *reinterpret_cast<const uint4*>(src + row * tstride + 8 * c);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
      const float2 a0 = __bfloat1622float2(h2[0]);
      const float2 a1 = __bfloat1622float2(h2[1]);
      const float2 a2 = __bfloat1622float2(h2[2]);
      const float2 a3 = __bfloat1622float2(h2[3]);
      lo = make_float4(a0.x, a0.y, a1.x, a1.y);
      hi = make_float4(a2.x, a2.y, a3.x, a3.y);
    }
    *reinterpret_cast<float4*>(dst + r * RS + 8 * c) = lo;
    *reinterpret_cast<float4*>(dst + r * RS + 8 * c + 4) = hi;
  }
}

// q, do, lse and delta of query rows [q0, q0 + 64) (zeros past Tq).
template <int D, typename T>
__device__ __forceinline__ void stage_query(float* Qs, float* dOs,
                                            float* lse_s, float* dlt_s,
                                            const T* qb, const T* dob,
                                            const float* lseb,
                                            const float* dltb, long long qst,
                                            long long dost, int q0, int Tq) {
  stage_tile<D>(Qs, qb, qst, q0, Tq);
  stage_tile<D>(dOs, dob, dost, q0, Tq);
  if (threadIdx.x < kTile) {
    const int row = q0 + threadIdx.x;
    const bool ok = row < Tq;
    pt_async::copy4(lse_s + threadIdx.x, ok ? lseb + row : lseb, ok ? 4 : 0);
    pt_async::copy4(dlt_s + threadIdx.x, ok ? dltb + row : dltb, ok ? 4 : 0);
  }
}

// x = A B^T for rows r8 + 8i of A and rows c8 + 8j of B (i, j < 8), both
// [64][D + 4] tiles, summed in d order.
template <int D>
__device__ __forceinline__ void b3_product(const float* A, const float* B,
                                           int r8, int c8, float x[8][8]) {
  constexpr int RS = D + 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) x[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 bv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = pt_async::lds4(B + (c8 + 8 * j) * RS + d);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 av = pt_async::lds4(A + (r8 + 8 * i) * RS + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) x[i][j] = pt_async::dot4(av, bv[j], x[i][j]);
    }
  }
}

// acc[i][n] += sum over rows r in [r0, r1), in order, of
// X[r][8 kc + i] Y[r][32 (n / 4) + 4 jc + n % 4] (X's row stride XS, Y's
// D + 4): dv += p^T do or dk += ds^T q for 8 keys by D/8 columns, or
// dq += ds k for 8 query rows by D/8 columns (X = ds^T, Y = k).
template <int D, int XS>
__device__ __forceinline__ void b3_accumulate(const float* X, const float* Y,
                                              int kc, int jc, int r0, int r1,
                                              float acc[8][D / 8]) {
  constexpr int RS = D + 4;
  constexpr int NG = D / 32;
#pragma unroll 2
  for (int r = r0; r < r1; ++r) {
    const float4 x0 = pt_async::lds4(X + r * XS + 8 * kc);
    const float4 x1 = pt_async::lds4(X + r * XS + 8 * kc + 4);
    const float xk[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    float y[D / 8];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float4 t = pt_async::lds4(Y + r * RS + 32 * g + 4 * jc);
      y[4 * g] = t.x;
      y[4 * g + 1] = t.y;
      y[4 * g + 2] = t.z;
      y[4 * g + 3] = t.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int n = 0; n < D / 8; ++n) acc[i][n] = fmaf(xk[i], y[n], acc[i][n]);
  }
}

// The thread's 8 x 8 entries of a product into X[r][c] (row-major, row
// stride STRIDE) or, TRANSPOSED, X[c][r].
template <int STRIDE, bool TRANSPOSED>
__device__ __forceinline__ void b3_store8(const float x[8][8], float* X,
                                          int r8, int c8) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = r8 + 8 * i;
      const int c = c8 + 8 * j;
      X[TRANSPOSED ? c * STRIDE + r : r * STRIDE + c] = x[i][j];
    }
}

// Whether every pair of the (query tile q0, key tile k0) is visible, so
// the per-pair mask can be skipped.
__device__ __forceinline__ bool tile_all_visible(int q0, int k0, int Tq,
                                                 int kvl, int causal,
                                                 int shift) {
  return q0 + kTile <= Tq && k0 + kTile <= kvl &&
         (!causal || k0 + kTile - 1 <= q0 + shift);
}

// p = exp(s scale - lse) where the pair is visible, 0 elsewhere (never
// 0 * inf), and ds = p (dp - delta) scale (0 where p is: dp is finite, as
// masked k and v rows are zeros).  `all`: every pair of the tile pair is
// visible, so the mask is skipped.
__device__ __forceinline__ void b3_p_ds(float s, float dp, float lse_r,
                                        float dlt_r, bool all, int row,
                                        int col, int Tq, int kvl, int causal,
                                        int shift, float scale, float& p,
                                        float& ds) {
  p = all || visible(row, col, Tq, kvl, causal, shift)
          ? expf(s * scale - lse_r)
          : 0.f;
  ds = p * (dp - dlt_r) * scale;
}

// dk/dv pass, all threads: s in Ps becomes p, dp in dSs becomes ds, four
// consecutive keys of a row at a time.
__device__ __forceinline__ void b3_p_ds_tile(float* Ps, float* dSs,
                                             const float* lse_s,
                                             const float* dlt_s, bool all,
                                             int q0, int k0, int Tq, int kvl,
                                             int causal, int shift,
                                             float scale) {
  for (int e = threadIdx.x; e < kTile * kTile / 4; e += kB3Threads) {
    const int r = e >> 4;
    const int c = (e & 15) * 4;
    const float4 s4 = pt_async::lds4(Ps + r * kP3 + c);
    const float4 d4 = pt_async::lds4(dSs + r * kP3 + c);
    const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
    const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
    const float lse_r = lse_s[r];
    const float dlt_r = dlt_s[r];
    float p[4], ds[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      b3_p_ds(sv[u], dv[u], lse_r, dlt_r, all, q0 + r, k0 + c + u, Tq, kvl,
              causal, shift, scale, p[u], ds[u]);
    *reinterpret_cast<float4*>(Ps + r * kP3 + c) =
        make_float4(p[0], p[1], p[2], p[3]);
    *reinterpret_cast<float4*>(dSs + r * kP3 + c) =
        make_float4(ds[0], ds[1], ds[2], ds[3]);
  }
}

// dq pass, all threads: with s in Ps and dp in dST (transposed), dST
// becomes ds^T.  Lane l takes rows l % 4 + 4a and keys l / 4 + 8b, so
// both the row-major and the transposed accesses are conflict-free.
__device__ __forceinline__ void b3_dst_tile(const float* Ps, float* dST,
                                            const float* lse_s,
                                            const float* dlt_s, bool all,
                                            int q0, int k0, int Tq, int kvl,
                                            int causal, int shift,
                                            float scale) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll 4
  for (int it = 0; it < kTile * kTile / kB3Threads; ++it) {
    const int r = (lane & 3) + 4 * (it & 15);
    const int c = (lane >> 2) + 8 * (warp + 4 * (it >> 4));
    float p, ds;
    b3_p_ds(Ps[r * kP3 + c], dST[c * kT3 + r], lse_s[r], dlt_s[r], all,
            q0 + r, k0 + c, Tq, kvl, causal, shift, scale, p, ds);
    dST[c * kT3 + r] = ds;
  }
}

// delta = rowsum(do * out) for every (b, h, t): one warp a row, into a
// contiguous float32 [B, H, T].
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                           float* __restrict__ delta, int H, int Tq, int rows,
                           Strides os, Strides dos) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int bh = row / Tq;
  const int t = row - bh * Tq;
  const int b = bh / H;
  const int h = bh - b * H;
  const float part =
      row_delta<D>(dout + b * dos.b + h * dos.h, dos.t, o + b * os.b + h * os.h,
                   os.t, t, threadIdx.x & 31);
  if ((threadIdx.x & 31) == 0) delta[row] = part;
}

// dk and dv of one 64-key tile: one block per (b*h, key tile).  It stages
// its K and V once, then walks the query tiles in order from the first
// that can see the tile (under causal, row k0 - shift), accumulating
// dv += p^T do (warps 0-1) and dk += ds^T q (warps 2-3) in registers, and
// stores each once.  A key tile at or past kv_lens[b], or seen by no row,
// stores zeros.
template <int D, typename T>
__global__ void __launch_bounds__(kB3Threads, 2)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const int* __restrict__ kv_lens,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int Tq, int S, Strides qs,
                         Strides ks, Strides vs, Strides dos, int causal,
                         float scale) {
  constexpr int RS = D + 4;
  constexpr int NC = D / 8;  // columns a thread sums
  extern __shared__ float smem[];
  float* Ks = smem;                      // [64][RS]
  float* Vs = Ks + kTile * RS;           // [64][RS]
  float* Ps = Vs + kTile * RS;           // [64][kP3]
  float* dSs = Ps + kTile * kP3;         // [64][kP3]
  float* Qs = dSs + kTile * kP3;         // [64][RS]
  float* dOs = Qs + kTile * RS;          // [64][RS]
  float* lse_s = dOs + kTile * RS;       // [64]
  float* dlt_s = lse_s + kTile;          // [64]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * kTile;
  const B3Lanes ln = b3_lanes();
  const int kvl = kv_lens ? min(max(kv_lens[b], 0), S) : S;
  const int shift = S - Tq;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* dob = dout + b * dos.b + h * dos.h;
  const float* lseb = lse + static_cast<size_t>(bh) * Tq;
  const float* dltb = delta + static_cast<size_t>(bh) * Tq;

  float acc[8][NC];  // dv (warps 0-1) or dk (warps 2-3)
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  if (k0 < kvl) {
    const int nq = (Tq + kTile - 1) / kTile;
    const int i0 = causal ? max(0, k0 - shift) / kTile : 0;
    stage_tile<D>(Ks, k + b * ks.b + h * ks.h, ks.t, k0, kvl);
    stage_tile<D>(Vs, v + b * vs.b + h * vs.h, vs.t, k0, kvl);
    stage_query<D>(Qs, dOs, lse_s, dlt_s, qb, dob, lseb, dltb, qs.t, dos.t,
                   i0 * kTile, Tq);
    pt_async::commit();
    for (int qt = i0; qt < nq; ++qt) {
      const int q0 = qt * kTile;
      pt_async::wait_all();
      __syncthreads();  // query tile qt landed
      const bool all = tile_all_visible(q0, k0, Tq, kvl, causal, shift);
      {
        float x[8][8];  // s (warps 0-1) or dp (warps 2-3)
        b3_product<D>(ln.half == 0 ? Qs : dOs, ln.half == 0 ? Ks : Vs, ln.r8,
                      ln.c8, x);
        b3_store8<kP3, false>(x, ln.half == 0 ? Ps : dSs, ln.r8, ln.c8);
      }
      __syncthreads();  // s and dp are in Ps and dSs
      b3_p_ds_tile(Ps, dSs, lse_s, dlt_s, all, q0, k0, Tq, kvl, causal, shift,
                   scale);
      __syncthreads();  // p and ds are in Ps and dSs
      const int nrows = min(kTile, Tq - q0);
      if (ln.half == 0)
        b3_accumulate<D, kP3>(Ps, dOs, ln.r8, ln.c8, 0, nrows, acc);
      else
        b3_accumulate<D, kP3>(dSs, Qs, ln.r8, ln.c8, 0, nrows, acc);
      if (qt + 1 < nq) {
        __syncthreads();  // query tile qt is consumed
        stage_query<D>(Qs, dOs, lse_s, dlt_s, qb, dob, lseb, dltb, qs.t,
                       dos.t, q0 + kTile, Tq);
        pt_async::commit();
      }
    }
  }
  T* out = ln.half == 0 ? dv : dk;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = k0 + 8 * ln.r8 + i;
    if (key >= S) continue;
    T* row = out + (static_cast<size_t>(bh) * S + key) * D + 4 * ln.c8;
#pragma unroll
    for (int n = 0; n < NC; ++n) st(row + 32 * (n >> 2) + (n & 3), acc[i][n]);
  }
}

// dq of one 64-row query tile: one block per (b*h, query tile), the
// tiles with the longest causal walk launched first.  It stages Q, dO,
// lse and delta once, then walks the key tiles in order up to the last
// one its rows can see (kv_lens[b] and the bottom-right causal diagonal),
// accumulating dq += ds k in float32 registers, and stores it once (a
// bfloat16 dq is rounded once, with no workspace).
template <int D, typename T>
__global__ void __launch_bounds__(kB3Threads, 2)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const int* __restrict__ kv_lens,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int H, int Tq, int S, Strides qs, Strides ks,
                        Strides vs, Strides dos, int causal, float scale) {
  constexpr int RS = D + 4;
  constexpr int NC = D / 8;  // columns a thread sums
  extern __shared__ float smem[];
  float* Qs = smem;                  // [64][RS]
  float* dOs = Qs + kTile * RS;      // [64][RS]
  float* Ps = dOs + kTile * RS;      // [64][kP3]
  float* dST = Ps + kTile * kP3;     // [64][kT3]
  float* lse_s = dST + kTile * kT3;  // [64]
  float* dlt_s = lse_s + kTile;      // [64]
  float* Ks = dlt_s + kTile;         // [64][RS]
  float* Vs = Ks + kTile * RS;       // [64][RS]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const B3Lanes ln = b3_lanes();
  const int kvl = kv_lens ? min(max(kv_lens[b], 0), S) : S;
  const int shift = S - Tq;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  // keys [0, kend) hold every key a row of the tile sees
  int kend = kvl;
  if (causal) kend = min(kend, min(q0 + kTile, Tq) + shift);
  const int nk = kend > 0 ? (kend + kTile - 1) / kTile : 0;

  float acc[8][NC];  // dq of rows 8 r8 + i, over half of each key tile
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  if (nk > 0) {
    stage_query<D>(Qs, dOs, lse_s, dlt_s, q + b * qs.b + h * qs.h,
                   dout + b * dos.b + h * dos.h,
                   lse + static_cast<size_t>(bh) * Tq,
                   delta + static_cast<size_t>(bh) * Tq, qs.t, dos.t, q0, Tq);
    stage_tile<D>(Ks, kb, ks.t, 0, kvl);
    stage_tile<D>(Vs, vb, vs.t, 0, kvl);
    pt_async::commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    pt_async::wait_all();
    __syncthreads();  // key tile kt landed
    const bool all = tile_all_visible(q0, k0, Tq, kvl, causal, shift);
    {
      float x[8][8];  // s (warps 0-1) or dp (warps 2-3)
      if (ln.half == 0) {
        b3_product<D>(Qs, Ks, ln.r8, ln.c8, x);
        b3_store8<kP3, false>(x, Ps, ln.r8, ln.c8);
      } else {
        b3_product<D>(dOs, Vs, ln.r8, ln.c8, x);
        b3_store8<kT3, true>(x, dST, ln.r8, ln.c8);
      }
    }
    __syncthreads();  // s is in Ps, dp in dST
    b3_dst_tile(Ps, dST, lse_s, dlt_s, all, q0, k0, Tq, kvl, causal, shift,
                scale);
    __syncthreads();  // ds^T is in dST
    // warps 0-1 sum keys [0, 32) of the tile, warps 2-3 keys [32, 64)
    const int nkeys = min(kTile, kend - k0);
    b3_accumulate<D, kT3>(dST, Ks, ln.r8, ln.c8, min(nkeys, 32 * ln.half),
                          min(nkeys, 32 * ln.half + 32), acc);
    if (kt + 1 < nk) {
      __syncthreads();  // key tile kt is consumed
      stage_tile<D>(Ks, kb, ks.t, k0 + kTile, kvl);
      stage_tile<D>(Vs, vb, vs.t, k0 + kTile, kvl);
      pt_async::commit();
    }
  }
  // dq = the first half's sums + the second half's, through shared memory
  float* red = Qs;  // [64][RS], free once the walk is done
  __syncthreads();
  if (ln.half == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int n = 0; n < NC; ++n)
        red[(8 * ln.r8 + i) * RS + 32 * (n >> 2) + 4 * ln.c8 + (n & 3)] =
            acc[i][n];
  }
  __syncthreads();
  if (ln.half == 1) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + 8 * ln.r8 + i;
    if (row >= Tq) continue;
    T* dst = dq + (static_cast<size_t>(bh) * Tq + row) * D + 4 * ln.c8;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int col = 32 * (n >> 2) + (n & 3);
      st(dst + col, acc[i][n] + red[(8 * ln.r8 + i) * RS + 4 * ln.c8 + col]);
    }
  }
}

// ---------------------------------------------------------------------------
// The flash forward (B1).  Replaces paddle_tpu/parallel/flash_attention.py:
// _fwd_kernel (launcher _flash_fwd): out = softmax(q k^T scale) v and the
// row log-sum-exp, by an online softmax over 64-key tiles.  The TPU kernel
// walks key blocks as the sequential last grid dimension, carrying
// (m, l, acc) in VMEM scratch; here one block per (b*h, tile of 128 query
// rows) walks the key tiles in a loop, carrying them in registers, and
// stops at the last tile any of its rows can see (kv_lens[b], and the
// bottom-right causal diagonal).  Blocks are launched longest walk first,
// so the heaviest do not set the tail: under causal, the query tiles
// nearest the bottom first; without it, the sequences with the longest
// kv_lens first (b_by_length).
//
// What bounds it: 4*D float32 operations a visible (query, key) pair
// (s = q k^T and acc += p v) against q, k, v read once and out, lse
// written once, so the operations, on CUDA cores (exact float32 FMAs; no
// TF32).  As in B3, shared memory is the limit a loop hits first: a
// warp's 16-byte load is four wavefronts against 128 FMAs a clock, so a
// thread needs about 16 FMAs for each float4 it loads.  The design, built
// from B3's pieces:
//  - Blocks of 4 warps; warps 0-1 own query rows [0, 64) of the block,
//    warps 2-3 rows [64, 128).  s = q k^T is b3_product: each thread an
//    8 x 8 tile of its pair's [64 x 64] scores (rows r8 + 8i, keys c8 + 8j),
//    16 FMAs a float4.  The 8 lanes that share r8 hold a row's 64 scores,
//    so its max and sum are three shuffles; every lane keeps (m, l) of its
//    8 rows.  p goes to shared memory transposed (b3_store8, conflict-free)
//    and acc += p v is b3_accumulate: each thread rows 8 r8 + i by D/8
//    columns, D FMAs for 2 + D/32 float4 loads (16 a load at D 64).  The
//    rescale alpha = 2^(m_old - m_new) of each row crosses from the score
//    layout to the accumulator layout through a 128-float shared array.
//  - Tiles are staged by cp.async, 16 bytes a copy, into rows padded to
//    D + 4 floats (stage_tile; rows at or past kv_lens or Tq are zero
//    filled, never read; bfloat16 is widened on the way by 16-byte loads).
//    One buffer each for K and V, and each is reloaded while the other is
//    in use: V of tile kt is in flight while s, the mask and p of tile kt
//    are computed, K of tile kt + 1 while acc += p v runs.  Two barriers a
//    key tile.  About 102 KB of shared memory at D 64, so two blocks share
//    an SM (8 warps), and one block's barriers overlap the other's math.
//  - The softmax works in log2 units (scores times scale * log2(e), then
//    exp2f), and a row's mask is one key limit (kv_lens, the causal
//    diagonal) compared with each key, skipped on tile pairs that are
//    wholly visible (tile_all_visible, per 64-row half).  On an H100,
//    expf and a per-pair visible() took about a fifth of the kernel's
//    time (PERF.md).  The walk still starts at m = -1e30 and divides by
//    max(l, 1e-30); lse = m ln 2 + log(denom), and -1e30 + log(1e-30) for
//    a row that sees no key, as the TPU kernel gives.
// Each row's result depends only on its own (b, h, row) inputs, summed
// over keys in a fixed order (key tiles in order, keys in order within a
// tile), so batched and unbatched calls give the same bits.  A key tile
// past a row's visibility leaves it exactly as it was (alpha = 1, p = 0),
// so a row's walk does not depend on the rows beside it.
// ---------------------------------------------------------------------------

constexpr int kF1Rows = 2 * kTile;      // query rows of a B1 block
constexpr int kF1Stride = kF1Rows + 4;  // row stride of p^T ([64][132])
// batches up to this size are ranked by length (each thread of a block
// makes about B * B / 128 comparisons)
constexpr int kF1RankMax = 256;

// The sequence whose kv_lens (clamped to [0, S]) is the r-th longest, ties
// by index: with no causal mask a block's walk is set by kv_lens alone, so
// the block launched r-th among the sequences' takes it, and the longest
// walks start first.  `scratch`: B + 1 ints of shared memory, free until
// the caller's next barrier.  Every thread gets the same b.
__device__ __forceinline__ int b_by_length(const int* kv_lens, int B, int S,
                                           int r, int* scratch) {
  for (int c = threadIdx.x; c < B; c += blockDim.x)
    scratch[c] = min(max(kv_lens[c], 0), S);
  __syncthreads();
  for (int c = threadIdx.x; c < B; c += blockDim.x) {
    const int len = scratch[c];
    int rank = 0;
    for (int o = 0; o < B; ++o)
      rank += scratch[o] > len || (scratch[o] == len && o < c);
    if (rank == r) scratch[B] = c;
  }
  __syncthreads();
  return scratch[B];
}

// Max / sum over the 8 lanes of a warp that share lane / 8.
__device__ __forceinline__ float oct_max(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float oct_sum(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Four consecutive outputs (16-byte aligned float32, 8-byte aligned
// bfloat16) in one store.
__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

template <int D, typename T>
__global__ void __launch_bounds__(kB3Threads, 2)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ kv_lens,
                     T* __restrict__ out, float* __restrict__ lse, int H,
                     int Tq, int S, Strides qs, Strides ks, Strides vs,
                     int causal, float scale) {
  constexpr int RS = D + 4;
  constexpr int NC = D / 8;  // columns a thread sums
  extern __shared__ float smem[];
  float* Qs = smem;                       // [128][RS]
  float* Ks = Qs + kF1Rows * RS;          // [64][RS]
  float* Vs = Ks + kTile * RS;            // [64][RS]
  float* PT = Vs + kTile * RS;            // [64][kF1Stride]: p^T
  float* row_s = PT + kTile * kF1Stride;  // [128]: alpha, then max(l, 1e-30)

  // which (b, h, query tile) this block takes, in launch order
  int b, h, q0;
  if (causal) {  // the tiles with the longest walk first
    b = blockIdx.x / H;
    h = blockIdx.x - b * H;
    q0 = (gridDim.y - 1 - blockIdx.y) * kF1Rows;
  } else {  // the longest sequences first
    const int B = gridDim.x / H;
    const int per_b = H * gridDim.y;
    const int L = blockIdx.x + gridDim.x * blockIdx.y;
    const int r = L / per_b;
    h = (L - r * per_b) / gridDim.y;
    q0 = (L - r * per_b - h * gridDim.y) * kF1Rows;
    b = kv_lens && B <= kF1RankMax
            ? b_by_length(kv_lens, B, S, r, reinterpret_cast<int*>(PT))
            : r;
  }
  const int bh = b * H + h;
  const B3Lanes ln = b3_lanes();
  const int grp = kTile * ln.half;  // this warp pair's first row in the block
  const int kvl = kv_lens ? min(max(kv_lens[b], 0), S) : S;
  const int shift = S - Tq;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  // keys [0, kend) hold every key a row of the block sees
  int kend = kvl;
  if (causal) kend = min(kend, min(q0 + kF1Rows, Tq) + shift);
  const int nk = kend > 0 ? (kend + kTile - 1) / kTile : 0;
  const float scale2 = scale * 1.4426950408889634f;  // scores in log2 units

  // (m, l) of rows grp + r8 + 8i (score layout); acc of rows
  // grp + 8 r8 + i, columns 32 (n / 4) + 4 c8 + n % 4 (accumulator layout)
  float m[8], l[8], acc[8][NC];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  }
  if (nk > 0) {
    const T* qb = q + b * qs.b + h * qs.h;
    stage_tile<D>(Qs, qb, qs.t, q0, Tq);
    stage_tile<D>(Qs + kTile * RS, qb, qs.t, q0 + kTile, Tq);
    stage_tile<D>(Ks, kb, ks.t, 0, kvl);
    pt_async::commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    pt_async::wait_all();
    __syncthreads();  // K of tile kt landed; V, p^T and alpha are free
    stage_tile<D>(Vs, vb, vs.t, k0, kvl);
    pt_async::commit();
    const bool all = tile_all_visible(q0 + grp, k0, Tq, kvl, causal, shift);
    float x[8][8];  // s, then p
    b3_product<D>(Qs + grp * RS, Ks, ln.r8, ln.c8, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + grp + ln.r8 + 8 * i;
      // keys [k0, lim) of this row are visible (all of the tile if `all`)
      int lim = row < Tq ? (causal ? min(kvl, row + shift + 1) : kvl) : 0;
      lim = all ? k0 + kTile : lim;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x[i][j] = k0 + ln.c8 + 8 * j < lim ? x[i][j] * scale2 : kNegInf;
        mx = fmaxf(mx, x[i][j]);
      }
      const float m_new = fmaxf(m[i], oct_max(mx));
      const float alpha = exp2f(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x[i][j] = k0 + ln.c8 + 8 * j < lim ? exp2f(x[i][j] - m_new) : 0.f;
        psum += x[i][j];
      }
      l[i] = l[i] * alpha + oct_sum(psum);
      m[i] = m_new;
      if (ln.c8 == 0) row_s[grp + ln.r8 + 8 * i] = alpha;
    }
    b3_store8<kF1Stride, true>(x, PT + grp, ln.r8, ln.c8);
    pt_async::wait_all();
    __syncthreads();  // V landed, p^T and alpha are stored, K is consumed
    if (kt + 1 < nk) {
      stage_tile<D>(Ks, kb, ks.t, k0 + kTile, kvl);
      pt_async::commit();
    }
    {
      const float4 a0 = pt_async::lds4(row_s + grp + 8 * ln.r8);
      const float4 a1 = pt_async::lds4(row_s + grp + 8 * ln.r8 + 4);
      const float alpha[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[i][n] *= alpha[i];
    }
    b3_accumulate<D, kF1Stride>(PT + grp, Vs, ln.r8, ln.c8, 0,
                                min(kTile, kend - k0), acc);
  }
  // max(l, 1e-30) from the score layout to the accumulator layout
  __syncthreads();  // every thread has read its last alpha
  if (ln.c8 == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = grp + ln.r8 + 8 * i;
      const float denom = fmaxf(l[i], 1e-30f);
      row_s[r] = denom;
      if (q0 + r < Tq)
        lse[static_cast<size_t>(bh) * Tq + q0 + r] =
            (m[i] == kNegInf ? kNegInf : m[i] * 0.6931471805599453f) +
            logf(denom);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = grp + 8 * ln.r8 + i;
    if (q0 + r >= Tq) continue;
    const float denom = row_s[r];
    T* o = out + (static_cast<size_t>(bh) * Tq + q0 + r) * D + 4 * ln.c8;
#pragma unroll
    for (int g = 0; g < D / 32; ++g)
      st4(o + 32 * g,
          make_float4(acc[i][4 * g] / denom, acc[i][4 * g + 1] / denom,
                      acc[i][4 * g + 2] / denom, acc[i][4 * g + 3] / denom));
  }
}

// B1: Q [128][D + 4], K and V [64][D + 4], p^T [64][132] and 128 floats;
// at D 64 under kTwoBlockSmem, so two blocks share an SM
template <int D>
constexpr size_t fwd_smem() {
  return ((kF1Rows + 2 * kTile) * (D + 4) + kTile * kF1Stride + kF1Rows) *
         sizeof(float);
}
static_assert(fwd_smem<64>() <= kTwoBlockSmem,
              "two B1 blocks must fit an SM at D 64");
template <int D>
constexpr size_t bwd_smem() {  // B2
  return (4 * kTile * (D + 1) + 2 * kTile * kPS + 2 * kTile) * sizeof(float);
}
// B3: four [64][D + 4] tiles, p and ds (or p and ds^T), lse and delta;
// at D 64 under kTwoBlockSmem, so two blocks share an SM
template <int D>
constexpr size_t dkv_smem() {
  return (4 * kTile * (D + 4) + 2 * kTile * kP3 + 2 * kTile) * sizeof(float);
}
template <int D>
constexpr size_t dq_smem() {
  return (4 * kTile * (D + 4) + kTile * kP3 + kTile * kT3 + 2 * kTile) *
         sizeof(float);
}
static_assert(dkv_smem<64>() <= kTwoBlockSmem && dq_smem<64>() <= kTwoBlockSmem,
              "two B3 blocks must fit an SM at D 64");

template <int D, typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* lens, void* out, void* lse, int B, int H,
                       int Tq, int S, Strides qs, Strides ks, Strides vs,
                       int causal, float scale, cudaStream_t st) {
  constexpr size_t smem = fwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tq + kF1Rows - 1) / kF1Rows);
  flash_fwd_kernel<D, T><<<grid, kB3Threads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lens),
      static_cast<T*>(out), static_cast<float*>(lse), H, Tq, S, qs, ks, vs,
      causal, scale);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const void* lens,
                       const void* lse, void* dq, void* dk, void* dv,
                       void* dq_acc, void* delta, int B, int H, int Tq, int S,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       Strides dos, int causal, float scale, int convert_dq,
                       cudaStream_t st) {
  constexpr size_t smem = bwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_bwd_kernel<D, T><<<B * H, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const int*>(lens),
      static_cast<const float*>(lse), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(dq_acc),
      static_cast<float*>(delta), H, Tq, S, qs, ks, vs, os, dos, causal,
      scale, convert_dq);
  return cudaGetLastError();
}

// The delta pre-pass, the dk/dv kernel, then the dq kernel; stops at the
// first error.
template <int D, typename T>
cudaError_t launch_bwd_pair(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lens,
                            const void* lse, void* delta, void* dq, void* dk,
                            void* dv, int B, int H, int Tq, int S, Strides qs,
                            Strides ks, Strides vs, Strides os, Strides dos,
                            int causal, float scale, cudaStream_t st) {
  const int rows = B * H * Tq;
  constexpr int warps = kThreads / 32;
  flash_bwd_delta_kernel<D, T><<<(rows + warps - 1) / warps, kThreads, 0,
                                 st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(delta), H, Tq, rows, os, dos);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t dkv_bytes = dkv_smem<D>();
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dkv_bytes));
  if (err != cudaSuccess) return err;
  const dim3 dkv_grid(B * H, (S + kTile - 1) / kTile);
  flash_bwd_dkv_kernel<D, T><<<dkv_grid, kB3Threads, dkv_bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const int*>(lens), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), H, Tq, S, qs, ks, vs, dos, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t dq_bytes = dq_smem<D>();
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dq_bytes));
  if (err != cudaSuccess) return err;
  const dim3 dq_grid(B * H, (Tq + kTile - 1) / kTile);
  flash_bwd_dq_kernel<D, T><<<dq_grid, kB3Threads, dq_bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const int*>(lens), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), H, Tq, S, qs,
      ks, vs, dos, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// The C interface.  Every pointer is a device pointer (kv_lens may be
// null); strides are in elements (batch, head, time) and the last
// dimension is contiguous; `bf16` selects the tensor type (0: float32,
// 1: bfloat16).  D must be 32, 64 or 128 (the Python wrappers check all
// of this first).  Each function launches on `stream` and returns the
// launch's cudaError_t.
// The forward (B1): out and lse.  q, k and v must be 16-byte aligned, with
// batch, head and time strides that are multiples of 16 bytes (the
// wrapper copies any that are not).
extern "C" int pt_flash_fwd(const void* q, const void* k, const void* v,
                            const void* kv_lens, void* out, void* lse, int B,
                            int H, int Tq, int S, int D, long long qsb,
                            long long qsh, long long qst, long long ksb,
                            long long ksh, long long kst, long long vsb,
                            long long vsh, long long vst, int causal,
                            float scale, int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qsh, qst}, ks{ksb, ksh, kst}, vs{vsb, vsh, vst};
#define PT_FWD(DIM, TYPE)                                                   \
  err = launch_fwd<DIM, TYPE>(q, k, v, kv_lens, out, lse, B, H, Tq, S, qs, \
                              ks, vs, causal, scale, st)
  if (bf16) {
    if (D == 32) PT_FWD(32, __nv_bfloat16);
    else if (D == 64) PT_FWD(64, __nv_bfloat16);
    else if (D == 128) PT_FWD(128, __nv_bfloat16);
    else return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (D == 32) PT_FWD(32, float);
    else if (D == 64) PT_FWD(64, float);
    else if (D == 128) PT_FWD(128, float);
    else return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PT_FWD
  return static_cast<int>(err);
}

extern "C" int pt_flash_bwd(const void* q, const void* k, const void* v,
                            const void* o, const void* dout,
                            const void* kv_lens, const void* lse, void* dq,
                            void* dk, void* dv, void* dq_acc, void* delta,
                            int B, int H, int Tq, int S, int D, long long qsb,
                            long long qsh, long long qst, long long ksb,
                            long long ksh, long long kst, long long vsb,
                            long long vsh, long long vst, long long osb,
                            long long osh, long long ost, long long dosb,
                            long long dosh, long long dost, int causal,
                            float scale, int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qsh, qst}, ks{ksb, ksh, kst}, vs{vsb, vsh, vst},
      os{osb, osh, ost}, dos{dosb, dosh, dost};
  const int convert_dq = dq != dq_acc;
#define PT_BWD(DIM, TYPE)                                                    \
  err = launch_bwd<DIM, TYPE>(q, k, v, o, dout, kv_lens, lse, dq, dk, dv,   \
                              dq_acc, delta, B, H, Tq, S, qs, ks, vs, os, \
                              dos, causal, scale, convert_dq, st)
  if (bf16) {
    if (D == 32) PT_BWD(32, __nv_bfloat16);
    else if (D == 64) PT_BWD(64, __nv_bfloat16);
    else if (D == 128) PT_BWD(128, __nv_bfloat16);
    else return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (D == 32) PT_BWD(32, float);
    else if (D == 64) PT_BWD(64, float);
    else if (D == 128) PT_BWD(128, float);
    else return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PT_BWD
  return static_cast<int>(err);
}

// The two-pass backward (B3): dq, dk and dv, each written once, from
// three launches: delta = rowsum(do * out) into `delta` (float32
// [B, H, Tq], contiguous scratch), then dk/dv, then dq.  q, k, v and do
// must be 16-byte aligned, with batch, head and time strides that are
// multiples of 16 bytes (the wrapper copies any that are not).
extern "C" int pt_flash_bwd_pair(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* kv_lens, const void* lse, void* delta,
    void* dq, void* dk, void* dv, int B, int H, int Tq, int S, int D,
    long long qsb, long long qsh, long long qst, long long ksb,
    long long ksh, long long kst, long long vsb, long long vsh,
    long long vst, long long osb, long long osh, long long ost,
    long long dosb, long long dosh, long long dost, int causal,
    float scale, int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qsh, qst}, ks{ksb, ksh, kst}, vs{vsb, vsh, vst},
      os{osb, osh, ost}, dos{dosb, dosh, dost};
#define PT_PAIR(DIM, TYPE)                                                  \
  err = launch_bwd_pair<DIM, TYPE>(q, k, v, o, dout, kv_lens, lse, delta, \
                                   dq, dk, dv, B, H, Tq, S, qs, ks, vs, os, \
                                   dos, causal, scale, st)
  if (bf16) {
    if (D == 32) PT_PAIR(32, __nv_bfloat16);
    else if (D == 64) PT_PAIR(64, __nv_bfloat16);
    else if (D == 128) PT_PAIR(128, __nv_bfloat16);
    else return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (D == 32) PT_PAIR(32, float);
    else if (D == 64) PT_PAIR(64, float);
    else if (D == 128) PT_PAIR(128, float);
    else return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PT_PAIR
  return static_cast<int>(err);
}
