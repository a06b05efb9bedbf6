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
// All three share one tiling: 64-row tiles staged by cp.async into shared
// memory as float32 (bfloat16 is widened when staged, exactly, and outputs
// are rounded once when stored), blocks of 4 warps, and 8 x 8 register
// tiles fed by 16-byte shared loads; all math is exact float32 FMAs on CUDA
// cores (no TF32, no tensor cores).  See the B3 section.
//
// Bound.  The kernels do 4*D (forward), 10*D (B2) or 8*D + 6*D (B3's two
// passes) operations per visible (query, key) pair on float32 CUDA cores,
// against bytes that are read and written once (q, k, v, out, lse; plus
// do, dq, dk, dv in the backward), so at the training shapes the
// operations bound them; the staged tiles keep the device-memory traffic
// near that minimum (each query tile reads each visible key tile once).
// B2 adds a float32 workspace of dq partials, written once and read once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // the delta pre-pass and B2's dq sum
constexpr int kTile = 64;      // query rows and keys a tile

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
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

struct Strides {
  long long b, h, t;  // in elements; the last dimension is contiguous
};

__device__ __forceinline__ bool visible(int row, int col, int Tq, int kvl,
                                        int causal, int shift) {
  return row < Tq && col < kvl && (!causal || col <= row + shift);
}

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
// Two grids, so that each output is summed in one block: the price is
// recomputing s = q k^T and dp = do v^T in both passes, 14*D operations a
// visible pair (dk/dv pass 8*D, dq pass 6*D).  B2 (below) walks the dk/dv
// pass's grid once and does 10*D, paying instead with a workspace of dq
// partials and a third launch that sums them.
//
// Besides the FMA units, shared memory bounds such a loop on an H100: an
// SM moves 128 bytes of it a clock against 128 FMAs, and a 16-byte load
// of a warp is four such wavefronts (a 4-byte one, one).  So a thread
// must do about 16 FMAs for every float4 it loads (an 8 x 8 register tile
// over a reduction) for the two to balance; 4 x 4 tiles of scalar loads
// (slice 2's first B2) do 2.  Measured, the loops still run near half the
// float32 rate (PERF.md): registers (255 a thread) and shared memory allow
// 8 warps an SM, which leaves load latency and barriers partly exposed.
// The design (all math exact float32 FMAs on CUDA cores; no tensor cores):
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

// ---------------------------------------------------------------------------
// The fused backward (B2).  Replaces paddle_tpu/parallel/flash_attention.py:
// _fused_bwd_kernel (launcher _flash_bwd_fused): dq, dk and dv from one walk
// over the visible tile pairs, with p = exp(s - lse) recomputed from the
// saved lse, dv = p^T do, dp = do v^T, ds = p (dp - delta) scale,
// dk = ds^T q and dq = ds k: five products, 10*D operations a visible pair
// against B3's 14*D.  The TPU kernel keeps dq resident in VMEM while its
// grid walks the key blocks of one b*h in order; on the card blocks run in
// parallel, and summing dq across them with float atomics would change its
// bits from run to run.  So, in three launches:
//  1. delta = rowsum(do * out) once per call (flash_bwd_delta_kernel, as
//     for B3; the TPU launcher also computes delta outside its kernel);
//  2. flash_bwd_fused_kernel: B3's dk/dv grid, one block per (b*h, 64-key
//     tile), and its walk (key_tile_walk: cp.async staging, 4 warps, 8 x 8
//     register tiles, two blocks an SM at D 64), which after dv and dk
//     computes the tile pair's dq partial, ds k over the tile's keys in
//     order (b2_dq_partial, 16 FMAs a 16-byte load at D 64), and writes it
//     once into a float32 workspace [b*h, key tile, T, D];
//  3. flash_bwd_dq_sum_kernel: each dq row is the sum, in key-tile order,
//     of the partials of the key tiles that walked its query tile, rounded
//     once to dq's type (0 for a row no tile walked).
// Every output element comes from sums in a fixed order with no atomics,
// so two calls give the same bits.  B*H*ceil(S/64) blocks fill the card
// at any B*H (slice 2's first B2, one block per b*h, left most of it idle
// at long T).  The softmax is B1's: log2 units (exp2f) and one key limit a
// row, skipped on wholly visible tile pairs.  The workspace holds
// B*H*ceil(S/64)*T*D floats (2 GiB at [4, 8, 4096, 64]); the partials of
// the walked tile pairs are written once and read once, which the sum
// kernel's own time shows.
// ---------------------------------------------------------------------------

// The first query tile whose rows can see key tile k0: under causal, rows
// below k0 - shift see none of its keys.  Both B3's dk/dv kernel and B2
// walk query tiles [first_query_tile, nq) of every key tile below kv_lens,
// and B2's dq sum reads the partials of exactly those pairs.
__device__ __forceinline__ int first_query_tile(int k0, int causal,
                                                int shift) {
  return causal ? max(0, k0 - shift) / kTile : 0;
}

// B2: s in Ps becomes p and dp in dSs becomes ds, four consecutive keys of
// a row at a time, as b3_p_ds_tile but in log2 units
// (p = 2^(s scale log2(e) - lse log2(e)), by exp2f) and with one key limit
// a row for the mask (every key of the tile where `all`).  p is computed
// only where the pair is visible, never 0 * inf.
__device__ __forceinline__ void b2_p_ds_tile(float* Ps, float* dSs,
                                             const float* lse_s,
                                             const float* dlt_s, bool all,
                                             int q0, int k0, int Tq, int kvl,
                                             int causal, int shift,
                                             float scale) {
  const float scale2 = scale * kLog2e;
  for (int e = threadIdx.x; e < kTile * kTile / 4; e += kB3Threads) {
    const int r = e >> 4;
    const int c = (e & 15) * 4;
    const int row = q0 + r;
    // keys [k0, lim) of this row are visible
    int lim = row < Tq ? (causal ? min(kvl, row + shift + 1) : kvl) : 0;
    lim = all ? k0 + kTile : lim;
    const float4 s4 = pt_async::lds4(Ps + r * kP3 + c);
    const float4 d4 = pt_async::lds4(dSs + r * kP3 + c);
    const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
    const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
    const float lse2 = lse_s[r] * kLog2e;
    const float dlt_r = dlt_s[r];
    float p[4], ds[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      p[u] = k0 + c + u < lim ? exp2f(fmaf(sv[u], scale2, -lse2)) : 0.f;
      ds[u] = p[u] * (dv[u] - dlt_r) * scale;
    }
    *reinterpret_cast<float4*>(Ps + r * kP3 + c) =
        make_float4(p[0], p[1], p[2], p[3]);
    *reinterpret_cast<float4*>(dSs + r * kP3 + c) =
        make_float4(ds[0], ds[1], ds[2], ds[3]);
  }
}

// B2's dq partial of one tile pair, ds k summed over the tile's keys in
// order, into rows [0, nrows) of `dst` (float32, row stride D).  Warps 0-1
// sum keys [0, 32), warps 2-3 keys [32, 64), and the two sums are added
// once through `red`, a consumed [64][min(D, 64) + 4] tile (a chunk of up
// to 64 columns at a time): warps 2-3 hand over rows 8 r8 + i for i < 4,
// warps 0-1 the rest, and each side finishes the rows it was handed.  A
// thread owns rows 8 r8 + i (i < 8) and, in a chunk, columns
// 32 g + 4 c8 + e.  A step takes 4 keys: 8 float4 of ds (4 keys of each
// row, row-major) and the matching float4s of k, 16 FMAs a load at D 64.
// Keys at or past `nkeys` (kv_lens) add nothing (ds is 0 there and their k
// rows are zeros), so the walk stops at nkeys rounded up to 4.
template <int D>
__device__ __forceinline__ void b2_dq_partial(const float* dSs,
                                              const float* Ks, float* red,
                                              const B3Lanes& ln, int nkeys,
                                              int nrows, float* dst) {
  constexpr int RS = D + 4;
  constexpr int CG = D < 64 ? D / 32 : 2;  // 32-column groups a chunk
  constexpr int CW = 32 * CG;              // columns a chunk
  constexpr int RR = CW + 4;               // row stride of red
  constexpr int NC = 4 * CG;               // columns a thread sums
  static_assert(kTile * RR <= kTile * kP3, "red must fit in p's tile");
  const int n4 = (nkeys + 3) & ~3;
  const int c0 = min(n4, 32 * ln.half);
  const int c1 = min(n4, 32 * ln.half + 32);
#pragma unroll 1
  for (int ch = 0; ch < D / CW; ++ch) {
    float acc[8][NC];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
#pragma unroll 2
    for (int c = c0; c < c1; c += 4) {
      float sk[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 t = pt_async::lds4(dSs + (8 * ln.r8 + i) * kP3 + c);
        sk[i][0] = t.x;
        sk[i][1] = t.y;
        sk[i][2] = t.z;
        sk[i][3] = t.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float y[NC];
#pragma unroll
        for (int g = 0; g < CG; ++g) {
          const float4 t = pt_async::lds4(Ks + (c + u) * RS + CW * ch +
                                          32 * g + 4 * ln.c8);
          y[4 * g] = t.x;
          y[4 * g + 1] = t.y;
          y[4 * g + 2] = t.z;
          y[4 * g + 3] = t.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int n = 0; n < NC; ++n)
            acc[i][n] = fmaf(sk[i][u], y[n], acc[i][n]);
      }
    }
    if (ch > 0) __syncthreads();  // the previous chunk's red is read
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if ((i < 4) != (ln.half == 1)) continue;
#pragma unroll
      for (int g = 0; g < CG; ++g)
        *reinterpret_cast<float4*>(red + (8 * ln.r8 + i) * RR + 32 * g +
                                   4 * ln.c8) =
            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                        acc[i][4 * g + 3]);
    }
    __syncthreads();  // each side's handed-over rows are in red
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = 8 * ln.r8 + i;
      if ((i < 4) != (ln.half == 0) || row >= nrows) continue;
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        const float4 o =
            pt_async::lds4(red + row * RR + 32 * g + 4 * ln.c8);
        st4(dst + static_cast<size_t>(row) * D + CW * ch + 32 * g + 4 * ln.c8,
            make_float4(acc[i][4 * g] + o.x, acc[i][4 * g + 1] + o.y,
                        acc[i][4 * g + 2] + o.z, acc[i][4 * g + 3] + o.w));
      }
    }
  }
}

// The walk of one 64-key tile, one block per (b*h, key tile): B3's dk/dv
// kernel and, with kFused, B2.  It stages its K and V once, then walks the
// query tiles in order from the first that can see the tile
// (first_query_tile), accumulating dv += p^T do (warps 0-1) and
// dk += ds^T q (warps 2-3) in registers, and stores each once.  A key tile
// at or past kv_lens[b], or seen by no row, stores zeros.  With kFused the
// softmax is b2_p_ds_tile's and each tile pair's dq partial goes to the
// workspace `ws` ([b*h][gridDim.y][Tq][D]) once its dk and dv are added;
// the next query tile's loads overlap that.
template <int D, typename T, bool kFused>
__device__ __forceinline__ void key_tile_walk(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const int* __restrict__ kv_lens, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ ws, int H, int Tq, int S, Strides qs, Strides ks,
    Strides vs, Strides dos, int causal, float scale) {
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
    const int i0 = first_query_tile(k0, causal, shift);
    stage_tile<D>(Ks, k + b * ks.b + h * ks.h, ks.t, k0, kvl);
    stage_tile<D>(Vs, v + b * vs.b + h * vs.h, vs.t, k0, kvl);
    stage_query<D>(Qs, dOs, lse_s, dlt_s, qb, dob, lseb, dltb, qs.t, dos.t,
                   i0 * kTile, Tq);
    pt_async::commit();
    for (int qt = i0; qt < nq; ++qt) {
      const int q0 = qt * kTile;
      pt_async::wait_all();
      __syncthreads();  // query tile qt landed (B2: the last partial is out)
      const bool all = tile_all_visible(q0, k0, Tq, kvl, causal, shift);
      {
        float x[8][8];  // s (warps 0-1) or dp (warps 2-3)
        b3_product<D>(ln.half == 0 ? Qs : dOs, ln.half == 0 ? Ks : Vs, ln.r8,
                      ln.c8, x);
        b3_store8<kP3, false>(x, ln.half == 0 ? Ps : dSs, ln.r8, ln.c8);
      }
      __syncthreads();  // s and dp are in Ps and dSs
      if constexpr (kFused)
        b2_p_ds_tile(Ps, dSs, lse_s, dlt_s, all, q0, k0, Tq, kvl, causal,
                     shift, scale);
      else
        b3_p_ds_tile(Ps, dSs, lse_s, dlt_s, all, q0, k0, Tq, kvl, causal,
                     shift, scale);
      __syncthreads();  // p and ds are in Ps and dSs
      const int nrows = min(kTile, Tq - q0);
      if (ln.half == 0)
        b3_accumulate<D, kP3>(Ps, dOs, ln.r8, ln.c8, 0, nrows, acc);
      else
        b3_accumulate<D, kP3>(dSs, Qs, ln.r8, ln.c8, 0, nrows, acc);
      if (kFused || qt + 1 < nq)
        __syncthreads();  // p, q and do of query tile qt are consumed
      if (qt + 1 < nq) {
        stage_query<D>(Qs, dOs, lse_s, dlt_s, qb, dob, lseb, dltb, qs.t,
                       dos.t, q0 + kTile, Tq);
        pt_async::commit();
      }
      if constexpr (kFused)
        b2_dq_partial<D>(
            dSs, Ks, Ps, ln, min(kTile, kvl - k0), nrows,
            ws + ((static_cast<size_t>(bh) * gridDim.y + blockIdx.y) * Tq +
                  q0) * D);
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

// B3's dk and dv: key_tile_walk.
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
  key_tile_walk<D, T, false>(q, k, v, dout, kv_lens, lse, delta, dk, dv,
                             nullptr, H, Tq, S, qs, ks, vs, dos, causal,
                             scale);
}

// B2's dk, dv and dq partials: key_tile_walk with the dq partial.
template <int D, typename T>
__global__ void __launch_bounds__(kB3Threads, 2)
    flash_bwd_fused_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const int* __restrict__ kv_lens,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta, T* __restrict__ dk,
                           T* __restrict__ dv, float* __restrict__ ws, int H,
                           int Tq, int S, Strides qs, Strides ks, Strides vs,
                           Strides dos, int causal, float scale) {
  key_tile_walk<D, T, true>(q, k, v, dout, kv_lens, lse, delta, dk, dv, ws,
                            H, Tq, S, qs, ks, vs, dos, causal, scale);
}

// B2's dq: one thread a float4 of dq [b*h, Tq, D], the sum in key-tile
// order of the workspace's partials of the key tiles that walked the row's
// query tile (key tiles below kv_lens whose first_query_tile is at or
// before it: a prefix of the key tiles), rounded once to dq's type; 0 for
// a row that no tile walked (kv_lens 0).
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_sum_kernel(const float* __restrict__ ws,
                            const int* __restrict__ kv_lens,
                            T* __restrict__ dq,
                            int H, int Tq, int S, int nk, int causal,
                            long long n4) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (e >= n4) return;
  const long long row = e / (D / 4);  // b*h*Tq + t
  const int c = static_cast<int>(e - row * (D / 4));
  const int bh = static_cast<int>(row / Tq);
  const int t = static_cast<int>(row - static_cast<long long>(bh) * Tq);
  const int b = bh / H;
  const int kvl = kv_lens ? min(max(kv_lens[b], 0), S) : S;
  const int qt = t / kTile;
  const int shift = S - Tq;
  const float* src = ws + (static_cast<size_t>(bh) * nk * Tq + t) * D + 4 * c;
  const size_t tile = static_cast<size_t>(Tq) * D;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int kt = 0; kt < nk && kt * kTile < kvl &&
                   first_query_tile(kt * kTile, causal, shift) <= qt;
       ++kt) {
    const float4 x = *reinterpret_cast<const float4*>(src + kt * tile);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  st4(dq + row * D + 4 * c, acc);
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
// B3 (and B2, whose blocks are B3's dk/dv blocks): four [64][D + 4] tiles,
// p and ds (or p and ds^T), lse and delta; at D 64 under kTwoBlockSmem, so
// two blocks share an SM
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

// delta = rowsum(do * out) into `delta` (float32 [B, H, Tq]).
template <int D, typename T>
cudaError_t launch_delta(const void* o, const void* dout, void* delta, int B,
                         int H, int Tq, Strides os, Strides dos,
                         cudaStream_t st) {
  const int rows = B * H * Tq;
  constexpr int warps = kThreads / 32;
  flash_bwd_delta_kernel<D, T><<<(rows + warps - 1) / warps, kThreads, 0,
                                 st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(delta), H, Tq, rows, os, dos);
  return cudaGetLastError();
}

// B2: the delta pre-pass, the fused kernel, then the dq sum; stops at the
// first error.
template <int D, typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const void* lens,
                       const void* lse, void* dq, void* dk, void* dv,
                       void* ws, void* delta, int B, int H, int Tq, int S,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       Strides dos, int causal, float scale, cudaStream_t st) {
  cudaError_t err = launch_delta<D, T>(o, dout, delta, B, H, Tq, os, dos, st);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = dkv_smem<D>();
  err = cudaFuncSetAttribute(flash_bwd_fused_kernel<D, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int nk = (S + kTile - 1) / kTile;
  flash_bwd_fused_kernel<D, T><<<dim3(B * H, nk), kB3Threads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const int*>(lens), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<float*>(ws), H, Tq, S, qs, ks, vs, dos,
      causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n4 = static_cast<long long>(B) * H * Tq * (D / 4);
  flash_bwd_dq_sum_kernel<D, T><<<static_cast<unsigned>(
                                      (n4 + kThreads - 1) / kThreads),
                                  kThreads, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const int*>(lens),
      static_cast<T*>(dq), H, Tq, S, nk, causal, n4);
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
  cudaError_t err = launch_delta<D, T>(o, dout, delta, B, H, Tq, os, dos, st);
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

// The fused backward (B2): dq, dk and dv, each written once, from three
// launches: delta = rowsum(do * out) into `delta` (float32 [B, H, Tq],
// contiguous scratch), then the fused kernel, which writes dq partials
// into `ws` (float32 [B*H, ceil(S/64), Tq, D], contiguous scratch; only
// the walked tile pairs' rows are written), then the dq sum.  q, k, v and
// do must be 16-byte aligned, with batch, head and time strides that are
// multiples of 16 bytes (the wrapper copies any that are not).
extern "C" int pt_flash_bwd(const void* q, const void* k, const void* v,
                            const void* o, const void* dout,
                            const void* kv_lens, const void* lse, void* dq,
                            void* dk, void* dv, void* ws, void* delta,
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
#define PT_BWD(DIM, TYPE)                                                  \
  err = launch_bwd<DIM, TYPE>(q, k, v, o, dout, kv_lens, lse, dq, dk, dv, \
                              ws, delta, B, H, Tq, S, qs, ks, vs, os, dos, \
                              causal, scale, st)
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
