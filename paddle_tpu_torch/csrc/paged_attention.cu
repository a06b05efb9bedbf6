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
// a page are H*Dh apart.  A warp holds one query row with lane l owning
// the VPT = Dh/32 contiguous elements [l*VPT, l*VPT + VPT), so every key
// or value row is read as one coalesced 32-lane load.
//
// Both kernels keep the TPU kernels' contracts: masked scores are
// NEG_INF = -1e30 (not -inf), the final division is by max(l, 1e-30), a
// row with no visible key yields exact zeros, and a masked key/value row
// is never read, so stale or non-finite page tails cannot reach the sum.
//
// Math is float32 throughout; bf16 pools are widened on load (exactly).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDecodeThreads = 256;   // 8 warps split one slot's pages
constexpr int kPrefillThreads = 512;  // 16 warps = 16 query rows a block

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
// (launcher _paged_prefill_pallas).  One block per (tile of 16 query
// rows, head), one warp per row.  The block walks the page row up to the
// last visibility of its rows, staging each page's keys and values in
// shared memory once for all 16 rows.  Row i (absolute position start+i)
// attends keys [0, start+i]; it folds in pages 0..its own last visible
// page, in order, with attend_page — so its reduction order depends on
// its position alone, never on C, on start or on the tile it sits in:
// chunked and monolithic prefill give the same bits.  Pages a row cannot
// see are skipped, which is bitwise inert (a fully masked page has
// alpha = 1 and p = 0).  The work is ~2*H*Dh*C*(start + C/2)*2 FLOP, all
// on float32 CUDA cores; the staging keeps the device-memory traffic at
// one read of each visible page per tile.
template <int VPT, typename KV>
__global__ void __launch_bounds__(kPrefillThreads)
    paged_prefill_kernel(const float* __restrict__ q,
                         const KV* __restrict__ k_pool,
                         const KV* __restrict__ v_pool,
                         const int* __restrict__ pages,
                         float* __restrict__ out, int C, int H, int ps,
                         int mp, int start, float scale) {
  constexpr int DH = 32 * VPT;
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int row0 = blockIdx.x * nwarps;
  const int i = row0 + warp;
  const bool active = i < C;
  const int span = mp * ps;  // keys the page row can hold
  const int row_kv = active ? min(start + i + 1, span) : 0;
  const int last = min(row0 + nwarps, C) - 1;
  const int npages = (min(start + last + 1, span) + ps - 1) / ps;

  extern __shared__ float smem[];
  float* ks = smem;            // [ps, DH]
  float* vs = smem + ps * DH;  // [ps, DH]

  float qv[VPT];
#pragma unroll
  for (int t = 0; t < VPT; ++t) qv[t] = 0.f;
  if (active)
    load_vec<VPT>(q + (static_cast<size_t>(i) * H + h) * DH + lane * VPT, qv);
  float m = kNegInf, l = 0.f;
  float acc[VPT];
#pragma unroll
  for (int t = 0; t < VPT; ++t) acc[t] = 0.f;
  const size_t tok_stride = static_cast<size_t>(H) * DH;
  for (int j = 0; j < npages; ++j) {
    __syncthreads();  // every warp is done with the previous page
    const size_t base = static_cast<size_t>(pages[j]) * ps * tok_stride +
                        static_cast<size_t>(h) * DH;
    for (int e = threadIdx.x; e < ps * DH; e += blockDim.x) {
      const int t = e / DH;
      const int d = e - t * DH;
      ks[e] = to_float(k_pool[base + t * tok_stride + d]);
      vs[e] = to_float(v_pool[base + t * tok_stride + d]);
    }
    __syncthreads();
    const int n_valid = row_kv - j * ps;  // uniform across the warp
    if (n_valid > 0)
      attend_page<VPT>(qv, ks + lane * VPT, vs + lane * VPT, DH,
                       min(n_valid, ps), scale, lane, m, l, acc);
  }
  if (active) {
    float* o = out + (static_cast<size_t>(i) * H + h) * DH + lane * VPT;
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int t = 0; t < VPT; ++t) o[t] = acc[t] / denom;
  }
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

template <int VPT, typename KV>
void launch_prefill(const void* q, const void* k, const void* v,
                    const void* pages, void* out, int C, int H, int ps,
                    int mp, int start, float scale, cudaStream_t st) {
  constexpr int rows = kPrefillThreads / 32;
  const size_t smem = 2 * static_cast<size_t>(ps) * 32 * VPT * sizeof(float);
  paged_prefill_kernel<VPT, KV>
      <<<dim3((C + rows - 1) / rows, H), kPrefillThreads, smem, st>>>(
          static_cast<const float*>(q), static_cast<const KV*>(k),
          static_cast<const KV*>(v), static_cast<const int*>(pages),
          static_cast<float*>(out), C, H, ps, mp, start, scale);
}

}  // namespace

// The C interface.  Every pointer is a device pointer; kv_bf16 selects
// the pool type (0: float32, 1: bfloat16).  Dh must be 32, 64 or 128 and
// ps at most 32 (the Python wrappers check all of this first).  Each
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
#define PT_PREFILL(VPT, KV) \
  launch_prefill<VPT, KV>(q, k_pool, v_pool, pages, out, C, H, ps, mp, \
                          start, scale, st)
  if (kv_bf16) {
    if (Dh == 32) PT_PREFILL(1, __nv_bfloat16);
    else if (Dh == 64) PT_PREFILL(2, __nv_bfloat16);
    else if (Dh == 128) PT_PREFILL(4, __nv_bfloat16);
    else return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (Dh == 32) PT_PREFILL(1, float);
    else if (Dh == 64) PT_PREFILL(2, float);
    else if (Dh == 128) PT_PREFILL(4, float);
    else return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PT_PREFILL
  return static_cast<int>(cudaGetLastError());
}
