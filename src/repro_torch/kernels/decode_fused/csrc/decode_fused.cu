// The elementwise passes between the products of a zoned decode step, fused,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves these passes to XLA, which
// fuses each chain of elementwise ops into one loop. PyTorch's eager ops
// (and a CUDA graph of them) launch one kernel an op: at granite-8b width a
// decoder layer's norms, RoPE and SiLU were about 60 launches of a few
// microseconds each, each moving well under 2 MB. Here a layer runs four:
//
//  * add_rmsnorm: x' = x + r (r optional), h = x' * rsqrt(mean(x'^2) + eps)
//    * scale, one CTA a row. x' is rounded to x's type, then read back in
//    float32 as the plain code reads it (models/common.py::apply_norm).
//  * rope_qk: q [B, H, hd] and k [B, KV, hd] rotated at each row's position,
//    one CTA a row, from float32 cos/sin [B, hd/2] that the wrapper computes
//    once a step with models/common.py::rope's own expression (so the angles,
//    up to about 4,000 rad, are rope's, bit for bit).
//  * swiglu: silu(gate) * up, a grid-stride loop.
//
// Rounding is the plain code's, op for op, so the results are the plain
// code's bit for bit, apart from the norm's row sum (another order of
// additions): products, sums and differences are __fmul_rn, __fadd_rn and
// __fsub_rn, which nvcc never contracts into an FMA; divisions are __fdiv_rn
// and exp is the accurate expf (no fast-math anywhere); a bfloat16 result is
// rounded (to nearest even) where the plain code rounds it:
//  * silu in bfloat16 is x * (1 / (1 + exp(-x))) with every op rounded to
//    bfloat16 (models/common.py::silu; PyTorch computes each op in float32
//    and rounds it), then * up rounded once more; in float32 it is F.silu's
//    x / (1 + exp(-x)), then * up;
//  * rope is x1 * cos - x2 * sin and x2 * cos + x1 * sin in float32, each
//    product rounded, then one rounding to q's type;
//  * the norm's mean is sum * (1 / d), as PyTorch's CUDA mean scales it, and
//    its square root the reciprocal rsqrtf.
//
// Bound: launches. At granite-8b width (B = 64, d 4,096, H/KV/hd 32/8/128,
// d_ff 14,336, bf16) a norm moves about 1.6 MB, rope 1.3 MB and swiglu 5.5
// MB: 0.5-1.6 us at 3.35 TB/s, against a launch's floor of about 2 us. So a
// kernel does one pass over its bytes in 16-byte loads and stores (a Pack of
// 8 bfloat16 or 4 float32) wherever the shapes and addresses allow, else one
// value at a time, and keeps nothing else in device memory.
//
// C interface (dtype 0 float32, 1 bfloat16; vec the values a load, 1 or
// 16 / itemsize, which the caller has checked the shapes and addresses
// for): df_add_rmsnorm, df_rope_qk, df_swiglu each launch one kernel on the
// caller's stream and return cudaGetLastError(); none allocates or waits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V values loaded or stored at once (16 bytes for V = 16 / sizeof(T))
template <typename T, int V> struct alignas(sizeof(T) * V) Pack { T v[V]; };

template <typename T, int V> __device__ __forceinline__ Pack<T, V> load(const T* p, long long i) {
  return reinterpret_cast<const Pack<T, V>*>(p)[i];
}
template <typename T, int V>
__device__ __forceinline__ void store(T* p, long long i, const Pack<T, V>& x) {
  reinterpret_cast<Pack<T, V>*>(p)[i] = x;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ------------------------------------------------------------ add_rmsnorm

// One CTA a row of d values, V at a time. With r, x' = x + r is written to
// xo and normed; without, x itself is normed. The row's sum of squares is
// each thread's partial sum, summed over the warp and then over the warps:
// an order fixed by d, so the same from run to run.
template <typename T, typename S, int V>
__global__ void add_rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ r,
                                   const S* __restrict__ scale, T* __restrict__ xo,
                                   T* __restrict__ h, int d, float inv_d, float eps) {
  __shared__ float part[32];
  const long long base = (long long)blockIdx.x * d;
  const int packs = d / V;
  float ss = 0.f;
  for (int j = threadIdx.x; j < packs; j += blockDim.x) {
    Pack<T, V> a = load<T, V>(x + base, j);
    if (r) {
      const Pack<T, V> b = load<T, V>(r + base, j);
#pragma unroll
      for (int t = 0; t < V; ++t) a.v[t] = from_f<T>(__fadd_rn(to_f(a.v[t]), to_f(b.v[t])));
      store<T, V>(xo + base, j, a);
    }
#pragma unroll
    for (int t = 0; t < V; ++t) {
      const float f = to_f(a.v[t]);
      ss = __fadd_rn(ss, __fmul_rn(f, f));
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ss = warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (int)(blockDim.x >> 5) ? part[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) part[0] = t;
  }
  __syncthreads();
  const float inv = rsqrtf(__fadd_rn(__fmul_rn(part[0], inv_d), eps));
  for (int j = threadIdx.x; j < packs; j += blockDim.x) {
    // x' as this thread wrote it in the first pass (or x)
    const Pack<T, V> a = r ? load<T, V>(xo + base, j) : load<T, V>(x + base, j);
    const Pack<S, V> s = load<S, V>(scale, j);
    Pack<T, V> o;
#pragma unroll
    for (int t = 0; t < V; ++t)
      o.v[t] = from_f<T>(__fmul_rn(__fmul_rn(to_f(a.v[t]), inv), to_f(s.v[t])));
    store<T, V>(h + base, j, o);
  }
}

int threads_for(long long packs) {
  const long long t = (packs + 31) / 32 * 32;
  return (int)(t < 32 ? 32 : t > 1024 ? 1024 : t);
}

template <typename T, typename S, int V>
cudaError_t launch_norm(const void* x, const void* r, const void* scale, void* xo, void* h,
                        int rows, int d, float eps, cudaStream_t s) {
  add_rmsnorm_kernel<T, S, V><<<rows, threads_for(d / V), 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const S*>(scale),
      static_cast<T*>(xo), static_cast<T*>(h), d, 1.0f / (float)d, eps);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t norm_of(int vec, const void* x, const void* r, const void* scale, void* xo, void* h,
                    int rows, int d, float eps, cudaStream_t s) {
  constexpr int kV = 16 / sizeof(T);
  if (vec == kV) return launch_norm<T, S, kV>(x, r, scale, xo, h, rows, d, eps, s);
  if (vec == 1) return launch_norm<T, S, 1>(x, r, scale, xo, h, rows, d, eps, s);
  return cudaErrorInvalidValue;
}

// ----------------------------------------------------------------- rope_qk

// One CTA a row b: every (head, V values of the first half) of q's H heads
// and then k's KV heads, each with its partner in the second half.
template <typename T, int V>
__global__ void rope_qk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                               T* __restrict__ qo, T* __restrict__ ko, int H, int KV, int half) {
  const int b = blockIdx.x;
  const int hp = half / V;
  const int total = (H + KV) * hp;
  const float* cr = cos_t + (long long)b * half;
  const float* sr = sin_t + (long long)b * half;
  for (int j = threadIdx.x; j < total; j += blockDim.x) {
    const int head = j / hp, i = j - head * hp;
    const long long off = head < H ? ((long long)b * H + head) * 2 * half
                                   : ((long long)b * KV + head - H) * 2 * half;
    const T* src = (head < H ? q : k) + off;
    T* dst = (head < H ? qo : ko) + off;
    const Pack<T, V> x1 = load<T, V>(src, i), x2 = load<T, V>(src + half, i);
    const Pack<float, V> c = load<float, V>(cr, i), s = load<float, V>(sr, i);
    Pack<T, V> o1, o2;
#pragma unroll
    for (int t = 0; t < V; ++t) {
      const float a = to_f(x1.v[t]), z = to_f(x2.v[t]);
      o1.v[t] = from_f<T>(__fsub_rn(__fmul_rn(a, c.v[t]), __fmul_rn(z, s.v[t])));
      o2.v[t] = from_f<T>(__fadd_rn(__fmul_rn(z, c.v[t]), __fmul_rn(a, s.v[t])));
    }
    store<T, V>(dst, i, o1);
    store<T, V>(dst + half, i, o2);
  }
}

template <typename T, int V>
cudaError_t launch_rope(const void* q, const void* k, const void* cos_t, const void* sin_t,
                        void* qo, void* ko, int B, int H, int KV, int half, cudaStream_t s) {
  rope_qk_kernel<T, V><<<B, threads_for((long long)(H + KV) * (half / V)), 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<T*>(qo), static_cast<T*>(ko), H, KV, half);
  return cudaGetLastError();
}

template <typename T>
cudaError_t rope_of(int vec, const void* q, const void* k, const void* cos_t, const void* sin_t,
                    void* qo, void* ko, int B, int H, int KV, int half, cudaStream_t s) {
  constexpr int kV = 16 / sizeof(T);
  if (vec == kV) return launch_rope<T, kV>(q, k, cos_t, sin_t, qo, ko, B, H, KV, half, s);
  if (vec == 1) return launch_rope<T, 1>(q, k, cos_t, sin_t, qo, ko, B, H, KV, half, s);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------------ swiglu

__device__ __forceinline__ float silu_mul(float g, float u) {
  return __fmul_rn(__fdiv_rn(g, __fadd_rn(1.0f, expf(-g))), u);
}
__device__ __forceinline__ __nv_bfloat16 silu_mul(__nv_bfloat16 g, __nv_bfloat16 u) {
  const float x = to_f(g);
  const float e = to_f(from_f<__nv_bfloat16>(expf(-x)));
  const float den = to_f(from_f<__nv_bfloat16>(__fadd_rn(1.0f, e)));
  const float rec = to_f(from_f<__nv_bfloat16>(__fdiv_rn(1.0f, den)));
  const float act = to_f(from_f<__nv_bfloat16>(__fmul_rn(x, rec)));
  return from_f<__nv_bfloat16>(__fmul_rn(act, to_f(u)));
}

template <typename T, int V>
__global__ void swiglu_kernel(const T* __restrict__ gate, const T* __restrict__ up,
                              T* __restrict__ out, long long packs) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < packs;
       j += (long long)gridDim.x * blockDim.x) {
    const Pack<T, V> g = load<T, V>(gate, j), u = load<T, V>(up, j);
    Pack<T, V> o;
#pragma unroll
    for (int t = 0; t < V; ++t) o.v[t] = silu_mul(g.v[t], u.v[t]);
    store<T, V>(out, j, o);
  }
}

constexpr int kSwigluThreads = 256;
constexpr long long kSwigluMaxBlocks = 132 * 8;   // 8 CTAs an SM of an H100

template <typename T, int V>
cudaError_t launch_swiglu(const void* gate, const void* up, void* out, long long n,
                          cudaStream_t s) {
  const long long packs = n / V;
  long long blocks = (packs + kSwigluThreads - 1) / kSwigluThreads;
  if (blocks > kSwigluMaxBlocks) blocks = kSwigluMaxBlocks;
  swiglu_kernel<T, V><<<(int)blocks, kSwigluThreads, 0, s>>>(
      static_cast<const T*>(gate), static_cast<const T*>(up), static_cast<T*>(out), packs);
  return cudaGetLastError();
}

template <typename T>
cudaError_t swiglu_of(int vec, const void* gate, const void* up, void* out, long long n,
                      cudaStream_t s) {
  constexpr int kV = 16 / sizeof(T);
  if (vec == kV) return launch_swiglu<T, kV>(gate, up, out, n, s);
  if (vec == 1) return launch_swiglu<T, 1>(gate, up, out, n, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x, r (nullptr: none), xo and h [rows, d] of dtype; scale [d] of
// scale_dtype. d a multiple of vec, every pointer aligned to vec values.
extern "C" int df_add_rmsnorm(int dtype, int scale_dtype, int vec, const void* x, const void* r,
                              const void* scale, void* xo, void* h, int rows, int d, float eps,
                              void* stream) {
  if (dtype < 0 || dtype > 1 || scale_dtype < 0 || scale_dtype > 1 || rows < 1 || d < 1 ||
      vec < 1 || d % vec)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (scale_dtype == 0) return norm_of<float, float>(vec, x, r, scale, xo, h, rows, d, eps, s);
    return norm_of<float, __nv_bfloat16>(vec, x, r, scale, xo, h, rows, d, eps, s);
  }
  if (scale_dtype == 0)
    return norm_of<__nv_bfloat16, float>(vec, x, r, scale, xo, h, rows, d, eps, s);
  return norm_of<__nv_bfloat16, __nv_bfloat16>(vec, x, r, scale, xo, h, rows, d, eps, s);
}

// q, qo [B, H, 2 * half] and k, ko [B, KV, 2 * half] of dtype; cos_t, sin_t
// [B, half] float32. half a multiple of vec, every pointer aligned to vec
// values.
extern "C" int df_rope_qk(int dtype, int vec, const void* q, const void* k, const void* cos_t,
                          const void* sin_t, void* qo, void* ko, int B, int H, int KV, int half,
                          void* stream) {
  if (dtype < 0 || dtype > 1 || B < 1 || H < 1 || KV < 1 || half < 1 || vec < 1 || half % vec)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return rope_of<float>(vec, q, k, cos_t, sin_t, qo, ko, B, H, KV, half, s);
  return rope_of<__nv_bfloat16>(vec, q, k, cos_t, sin_t, qo, ko, B, H, KV, half, s);
}

// gate, up, out: n values of dtype; n a multiple of vec, every pointer
// aligned to vec values.
extern "C" int df_swiglu(int dtype, int vec, const void* gate, const void* up, void* out,
                         long long n, void* stream) {
  if (dtype < 0 || dtype > 1 || n < 1 || vec < 1 || n % vec) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return swiglu_of<float>(vec, gate, up, out, n, s);
  return swiglu_of<__nv_bfloat16>(vec, gate, up, out, n, s);
}
