// Flash attention for Hopper (sm_90a): the forward (out and the row
// log-sum-exp) and the fused backward (dq, dk and dv in one launch).  Built
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
// Tiling.  A block has 256 threads seen as 16 x 16 (ty, tx).  Tiles are
// 64 query rows by 64 keys, staged in shared memory as float32 with a
// row stride of D + 1 (so the 16 rows one half-warp reads at one column
// fall in 16 different banks).  In a [64 x 64] score tile a thread owns
// rows ty + 16a and keys tx + 16c (a, c < 4); in a [64 x D] tile it owns
// rows ty + 16a and columns tx + 16j (j < D/16).  All math is float32 on
// CUDA cores; bfloat16 inputs are widened when staged (exactly) and
// outputs rounded once when stored.  A simple kernel that is right:
// wgmma, TMA and pipelined loads are later work.
//
// Bound.  Both kernels do 4*D (forward) or 10*D (backward) operations per
// visible (query, key) pair on float32 CUDA cores, against bytes that
// are read and written once (q, k, v, out, lse; plus do, dq, dk, dv in
// the backward), so at the slice's shape ([64, 8, 256, 64]) the
// operations bound them; the staged tiles keep the device-memory traffic
// near that minimum (each query tile reads each visible key tile once).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// Max / sum over the 16 threads of a half-warp that share a ty (they
// differ in the low four bits of threadIdx.x).
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

struct Strides {
  long long b, h, t;  // in elements; the last dimension is contiguous
};

// Rows [row0, row0 + 64) of one (b, h) slice into shared memory as
// float [64][D + 1].  Rows at or past `valid` become zeros and are never
// read from device memory.
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

// Replaces paddle_tpu/parallel/flash_attention.py:_fwd_kernel (launcher
// _flash_fwd).  One block per (b*h, tile of 64 query rows).  The TPU
// kernel walks key blocks as the sequential last grid dimension, carrying
// (m, l, acc) in VMEM scratch; here the block walks the key tiles in a
// loop, carrying them in registers, and stops at the last tile that any
// of its rows can see (past kv_lens, or above the causal diagonal).
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ kv_lens,
                     T* __restrict__ out, float* __restrict__ lse, int H,
                     int Tq, int S, Strides qs, Strides ks, Strides vs,
                     int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;               // [64][DP]
  float* Ks = Qs + kTile * DP;    // [64][DP]
  float* Vs = Ks + kTile * DP;    // [64][DP]
  float* Ps = Vs + kTile * DP;    // [64][kPS]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int kvl = kv_lens ? min(max(kv_lens[b], 0), S) : S;
  const int shift = S - Tq;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  load_tile<D>(Qs, qb, qs.t, q0, Tq);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[a][j] = 0.f;
  }
  int kend = kvl;  // keys [0, kend) hold every key a row of the tile sees
  if (causal) kend = min(kend, q0 + kTile + shift);
  const int nk = kend > 0 ? (kend + kTile - 1) / kTile : 0;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<D>(Ks, kb, ks.t, k0, kvl);
    load_tile<D>(Vs, vb, vs.t, k0, kvl);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], kc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = Qs[(ty + 16 * a) * DP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kc[c] = Ks[(tx + 16 * c) * DP + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
    }
    // online softmax over this tile, row by row
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
      const int row = q0 + r;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ok[c] = visible(row, k0 + tx + 16 * c, Tq, kvl, causal, shift);
        s[a][c] = ok[c] ? s[a][c] * scale : kNegInf;
        mx = fmaxf(mx, s[a][c]);
      }
      const float m_new = fmaxf(m[a], half_max(mx));
      const float alpha = expf(m[a] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[a][c] - m_new) : 0.f;
        Ps[r * kPS + tx + 16 * c] = p;
        psum += p;
      }
      l[a] = l[a] * alpha + half_sum(psum);
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[a][j] *= alpha;
      m[a] = m_new;
    }
    __syncthreads();
    // acc += P V
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float pa[4], vv[NJ];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = Ps[(ty + 16 * a) * kPS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[c * DP + tx + 16 * j];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[a][j] = fmaf(pa[a], vv[j], acc[a][j]);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= Tq) continue;
    const float denom = fmaxf(l[a], 1e-30f);
    T* o = out + (static_cast<size_t>(bh) * Tq + row) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) st(o + tx + 16 * j, acc[a][j] / denom);
    if (tx == 0) lse[static_cast<size_t>(bh) * Tq + row] = m[a] + logf(denom);
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
    float part = 0.f;
    for (int d = lane; d < D; d += 32)
      part = fmaf(ld(dob + row * dos.t + d), ld(ob + row * os.t + d), part);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(kFull, part, off);
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
            Ps[r * kPS + col] = p;
            dSs[r * kPS + col] = ds;
          }
        }
        __syncthreads();
        // dv += P^T dO and dk += dS^T Q for keys ty + 16a, columns tx + 16j
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
              dv_acc[a][j] = fmaf(pk[a], dov[j], dv_acc[a][j]);
              dk_acc[a][j] = fmaf(sk[a], qv[j], dk_acc[a][j]);
            }
        }
        // dq (rows ty + 16a, columns tx + 16j) += dS K, in key order
        float dqp[4][NJ];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < NJ; ++j) dqp[a][j] = 0.f;
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
            for (int j = 0; j < NJ; ++j) dqp[a][j] = fmaf(sa[a], kv[j], dqp[a][j]);
        }
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
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int key = k0 + ty + 16 * a;
      if (key >= S) continue;
      const size_t base = (static_cast<size_t>(bh) * S + key) * D + tx;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        st(dk + base + 16 * j, dk_acc[a][j]);
        st(dv + base + 16 * j, dv_acc[a][j]);
      }
    }
  }
  if (convert_dq) {  // a bfloat16 dq: round the float32 sums once
    __syncthreads();
    T* dqb = dq + static_cast<size_t>(bh) * Tq * D;
    for (int e = threadIdx.x; e < Tq * D; e += kThreads) st(dqb + e, dqa[e]);
  }
}

template <int D>
constexpr size_t fwd_smem() {
  return (3 * kTile * (D + 1) + kTile * kPS) * sizeof(float);
}
template <int D>
constexpr size_t bwd_smem() {
  return (4 * kTile * (D + 1) + 2 * kTile * kPS + 2 * kTile) * sizeof(float);
}

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
  const dim3 grid(B * H, (Tq + kTile - 1) / kTile);
  flash_fwd_kernel<D, T><<<grid, kThreads, smem, st>>>(
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

}  // namespace

// The C interface.  Every pointer is a device pointer (kv_lens may be
// null); strides are in elements (batch, head, time) and the last
// dimension is contiguous; `bf16` selects the tensor type (0: float32,
// 1: bfloat16).  D must be 32, 64 or 128 (the Python wrappers check all
// of this first).  Each function launches on `stream` and returns the
// launch's cudaError_t.
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
