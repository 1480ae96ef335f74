// Flash-decode attention over a zoned KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/paged_attn/kernel.py::paged_attention_pallas
// (with its body _decode_kernel).
//
// What it computes. One decode step: for each sequence b and query head h,
// softmax(q[b, h] . K / sqrt(hd)) . V over the sequence's cached tokens, read
// in place from a pool of zones. q is [B, H, hd]; K and V are
// [NZ, ZL, KV, hd]; zone_table [B, MZ] int32 names each sequence's zones in
// order (-1 = unused); lengths [B] int32. Position p = z*ZL + s of sequence b
// is valid iff p < lengths[b] and zone_table[b, z] >= 0. Query head h reads
// KV head h / G with G = H / KV (the reference's q.reshape(B, KV, G, hd)).
// q is scaled in float32 before the dot product; softmax state and sums are
// float32; the output is rounded to q's type (bf16 round-to-nearest-even).
//
// Semantics kept from the reference:
//  * masked logits are -1e30, never -inf (-inf - -inf would be NaN), and the
//    denominator is max(l, 1e-30);
//  * a row with at least one valid position: masked positions weigh
//    exp(-1e30 - m) = 0 exactly, so skipping them gives the same result, and
//    the kernel reads only valid positions (every -1 entry is skipped, not
//    only a -1 tail);
//  * a row with no valid position (length <= 0, or every entry of its first
//    ceil(length/ZL) zones -1) has all logits equal to -1e30: the reference
//    returns the uniform mean of V over all MZ*ZL clamped positions (-1 reads
//    zone 0, once for every -1 entry). The kernel walks exactly those
//    positions with weight 1.
//  * zone ids are clamped to [0, NZ-1] before the read, as jnp's gather
//    clamps.
//
// Bound: memory. Each valid token costs 2*KV*hd*itemsize bytes of K+V and
// 4*H*hd FLOP over all heads, about G/itemsize FLOP per byte: far below the
// card's ratio. At granite-8b width (B=64, H=32, KV=8, hd=128, bf16, 4,096
// tokens a sequence) one step reads 1 GiB: 0.32 ms at 3.35 TB/s.
//
// Design (simple first; split-K over zones, TMA and wgmma are later work).
//  * One CTA of 128 threads per (sequence, KV head, chunk of at most 8 query
//    heads of that KV head): B*KV CTAs when G <= 8. Each CTA reads its
//    sequence's K/V once for all of its query heads.
//  * A token's hd values are split over a lane group of T lanes (T the power
//    of two >= hd/8), 8 values a lane: one 16-byte load per lane in bf16, two
//    in float32. A CTA holds 128/T lane groups; each group walks its share of
//    each zone's tokens, two tokens at a time so that four loads a lane are
//    in flight, and keeps its own online-softmax state (m, l, acc) in
//    registers. A token's logit is a dot product of the lane's 8 values,
//    summed over the group with xor shuffles (every lane gets the same sum).
//    The update takes one exp a token and head: exp(-|s - m|) is the
//    rescale of the old state when s > m, else the new token's weight.
//  * At the end the groups' states are merged in shared memory with the
//    usual max/rescale, and the CTA writes its [G', hd] output coalesced.
//  * The zone table and the length are read on the card: no host sync.
//
// C interface: pa_paged_attention(...) launches on the caller's stream and
// returns cudaGetLastError(); it neither allocates nor synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kVec = 8;            // head-dim values a lane holds
constexpr int kMaxHeadDim = 256;   // so T <= 32: a lane group fits a warp
constexpr int kMaxHeadsPerCta = 8;
constexpr float kMasked = -1e30f;

// The raw bytes of 8 values of one token row, as loaded.
template <typename T> struct Raw;
template <> struct Raw<float> { float4 a, b; };
template <> struct Raw<__nv_bfloat16> { uint4 a; };

__device__ __forceinline__ void zero(Raw<float>& r) {
  r.a = make_float4(0.f, 0.f, 0.f, 0.f);
  r.b = r.a;
}
__device__ __forceinline__ void zero(Raw<__nv_bfloat16>& r) { r.a = make_uint4(0u, 0u, 0u, 0u); }

__device__ __forceinline__ void load(Raw<float>& r, const float* p) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
  r.a = __ldg(p4);
  r.b = __ldg(p4 + 1);
}
__device__ __forceinline__ void load(Raw<__nv_bfloat16>& r, const __nv_bfloat16* p) {
  r.a = __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void widen(const Raw<float>& r, float (&x)[kVec]) {
  x[0] = r.a.x; x[1] = r.a.y; x[2] = r.a.z; x[3] = r.a.w;
  x[4] = r.b.x; x[5] = r.b.y; x[6] = r.b.z; x[7] = r.b.w;
}
// bf16 -> f32 is exact: the bf16 bits are the high half of the f32. Element
// 2i is the low half of word i (little-endian).
__device__ __forceinline__ void widen(const Raw<__nv_bfloat16>& r, float (&x)[kVec]) {
  const uint32_t w[4] = {r.a.x, r.a.y, r.a.z, r.a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load_row(const float* p, float (&x)[kVec]) {
  Raw<float> r;
  load(r, p);
  widen(r, x);
}
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&x)[kVec]) {
  Raw<__nv_bfloat16> r;
  load(r, p);
  widen(r, x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// One token for each of the CTA's ng query heads: its logit, then the
// online-softmax update of the lane group's state. In the uniform case every
// logit is the same constant (0), which leaves weight 1 on every position.
template <typename T, int GP>
__device__ __forceinline__ void online_step(const Raw<T>& kr, const Raw<T>& vr,
                                            const float (&qv)[GP][kVec], float (&m)[GP],
                                            float (&l)[GP], float (&acc)[GP][kVec], int ng,
                                            bool uniform, int lanes, unsigned gmask) {
  float kf[kVec], vf[kVec];
  widen(kr, kf);
  widen(vr, vf);
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (g >= ng) break;
    float s = 0.f;
    if (!uniform) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) s = fmaf(qv[g][i], kf[i], s);
      for (int off = lanes >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(gmask, s, off);
    }
    // m_new = max(m, s); the old state scales by exp(m - m_new) and the
    // token weighs exp(s - m_new): one of the two is exp(0) = 1.
    const float e = expf(-fabsf(s - m[g]));
    const bool up = s > m[g];
    const float corr = up ? e : 1.f;
    const float p = up ? 1.f : e;
    m[g] = up ? s : m[g];
    l[g] = fmaf(l[g], corr, p);
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i] * corr);
  }
}

// GP: registers for up to GP query heads (1, 2, 4 or 8); the CTA serves
// ng <= GP of them.
template <typename T, int GP>
__global__ void __launch_bounds__(kThreads)
paged_decode(const T* __restrict__ q, const T* __restrict__ kz, const T* __restrict__ vz,
             const int* __restrict__ zone_table, const int* __restrict__ lengths,
             T* __restrict__ out, int H, int KV, int hd, int NZ, int ZL, int MZ,
             int heads_per_cta, int ctas_per_kv, int lanes, float scale) {
  // per-group state for the final merge; groups * hd <= kThreads * kVec
  __shared__ float s_m[kThreads * GP];
  __shared__ float s_l[kThreads * GP];
  __shared__ float s_acc[kThreads * kVec * GP];

  const int G = H / KV;
  const int chunk = blockIdx.x % ctas_per_kv;
  const int kvh = (blockIdx.x / ctas_per_kv) % KV;
  const int b = blockIdx.x / ctas_per_kv / KV;
  const int h0 = kvh * G + chunk * heads_per_cta;      // first query head
  const int ng = min(heads_per_cta, G - chunk * heads_per_cta);

  const int tid = threadIdx.x;
  const int groups = kThreads / lanes;
  const int grp = tid / lanes;
  const int lane = tid % lanes;
  const int d0 = lane * kVec;
  const bool active = d0 < hd;                        // hd = 80: 6 of 16 lanes idle
  // the lanes of this group within its warp, for the shuffles
  const unsigned gmask = lanes == 32 ? 0xffffffffu
                                     : ((1u << lanes) - 1u) << ((tid & 31) / lanes * lanes);

  float qv[GP][kVec];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) qv[g][i] = 0.f;
    if (g < ng && active) {
      load_row(q + ((size_t)b * H + h0 + g) * hd + d0, qv[g]);
#pragma unroll
      for (int i = 0; i < kVec; ++i) qv[g][i] *= scale;
    }
  }

  const int* row = zone_table + (size_t)b * MZ;
  const int len = lengths[b];
  // Is any position valid? Zone z holds one iff z*ZL < len and its entry >= 0.
  int any = 0;
  for (int z = tid; z < MZ && (long long)z * ZL < len; z += kThreads) any |= row[z] >= 0;
  const bool uniform = __syncthreads_or(any) == 0;
  const int n_walk = uniform ? MZ : (int)min((long long)MZ, ((long long)len + ZL - 1) / ZL);

  float m[GP], l[GP], acc[GP][kVec];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = kMasked;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[g][i] = 0.f;
  }

  const size_t slot_stride = (size_t)KV * hd;
  for (int z = 0; z < n_walk; ++z) {
    int zone = row[z];
    if (!uniform && zone < 0) continue;
    zone = min(max(zone, 0), NZ - 1);
    const int ntok = uniform ? ZL : min(ZL, len - z * ZL);
    const size_t base = ((size_t)zone * ZL * KV + kvh) * hd + d0;
    for (int s = grp; s < ntok; s += 2 * groups) {
      const bool two = s + groups < ntok;
      Raw<T> k0, v0, k1, v1;
      zero(k0); zero(v0); zero(k1); zero(v1);
      if (active) {
        load(k0, kz + base + s * slot_stride);
        load(v0, vz + base + s * slot_stride);
        if (two) {
          load(k1, kz + base + (s + groups) * slot_stride);
          load(v1, vz + base + (s + groups) * slot_stride);
        }
      }
      online_step<T, GP>(k0, v0, qv, m, l, acc, ng, uniform, lanes, gmask);
      if (two) online_step<T, GP>(k1, v1, qv, m, l, acc, ng, uniform, lanes, gmask);
    }
  }

  // Merge the groups' states.
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      s_m[grp * GP + g] = m[g];
      s_l[grp * GP + g] = l[g];
    }
  }
  if (active) {
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int i = 0; i < kVec; ++i) s_acc[(grp * GP + g) * hd + d0 + i] = acc[g][i];
  }
  __syncthreads();
  for (int idx = tid; idx < ng * hd; idx += kThreads) {
    const int g = idx / hd, d = idx % hd;
    float M = kMasked;
    for (int j = 0; j < groups; ++j) M = fmaxf(M, s_m[j * GP + g]);
    float L = 0.f, A = 0.f;
    for (int j = 0; j < groups; ++j) {
      const float w = expf(s_m[j * GP + g] - M);
      L = fmaf(s_l[j * GP + g], w, L);
      A = fmaf(s_acc[(j * GP + g) * hd + d], w, A);
    }
    store(out + ((size_t)b * H + h0 + g) * hd + d, A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int GP>
cudaError_t launch(const void* q, const void* k, const void* v, const int* tab, const int* lens,
                   void* out, int B, int H, int KV, int hd, int NZ, int ZL, int MZ,
                   int heads_per_cta, int ctas_per_kv, int lanes, float scale, cudaStream_t s) {
  const unsigned grid = (unsigned)B * KV * ctas_per_kv;
  paged_decode<T, GP><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), tab, lens,
      static_cast<T*>(out), H, KV, hd, NZ, ZL, MZ, heads_per_cta, ctas_per_kv, lanes, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gp(int gp, const void* q, const void* k, const void* v, const int* tab,
                      const int* lens, void* out, int B, int H, int KV, int hd, int NZ, int ZL,
                      int MZ, int heads_per_cta, int ctas_per_kv, int lanes, float scale,
                      cudaStream_t s) {
  switch (gp) {
    case 1: return launch<T, 1>(q, k, v, tab, lens, out, B, H, KV, hd, NZ, ZL, MZ, heads_per_cta, ctas_per_kv, lanes, scale, s);
    case 2: return launch<T, 2>(q, k, v, tab, lens, out, B, H, KV, hd, NZ, ZL, MZ, heads_per_cta, ctas_per_kv, lanes, scale, s);
    case 4: return launch<T, 4>(q, k, v, tab, lens, out, B, H, KV, hd, NZ, ZL, MZ, heads_per_cta, ctas_per_kv, lanes, scale, s);
    case 8: return launch<T, 8>(q, k, v, tab, lens, out, B, H, KV, hd, NZ, ZL, MZ, heads_per_cta, ctas_per_kv, lanes, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, K, V and out all of it). The caller
// checks shapes, contiguity and 16-byte alignment; scale is hd**-0.5 in
// float32.
extern "C" int pa_paged_attention(int dtype, const void* q, const void* k, const void* v,
                                  const void* zone_table, const void* lengths, void* out,
                                  int B, int H, int KV, int hd, int NZ, int ZL, int MZ,
                                  float scale, void* stream) {
  if (B < 1 || KV < 1 || H < KV || H % KV || hd < kVec || hd > kMaxHeadDim || hd % kVec ||
      NZ < 1 || ZL < 1 || MZ < 1 || (long long)MZ * ZL > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int G = H / KV;
  const int ctas_per_kv = (G + kMaxHeadsPerCta - 1) / kMaxHeadsPerCta;
  const int heads_per_cta = (G + ctas_per_kv - 1) / ctas_per_kv;
  const int gp = heads_per_cta <= 1 ? 1 : heads_per_cta <= 2 ? 2 : heads_per_cta <= 4 ? 4 : 8;
  if ((long long)B * KV * ctas_per_kv > 0x7fffffffLL) return cudaErrorInvalidValue;
  int lanes = 1;
  while (lanes * kVec < hd) lanes <<= 1;
  const int* tab = static_cast<const int*>(zone_table);
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_gp<float>(gp, q, k, v, tab, lens, out, B, H, KV, hd, NZ, ZL, MZ, heads_per_cta, ctas_per_kv, lanes, scale, s);
    case 1: return launch_gp<__nv_bfloat16>(gp, q, k, v, tab, lens, out, B, H, KV, hd, NZ, ZL, MZ, heads_per_cta, ctas_per_kv, lanes, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
