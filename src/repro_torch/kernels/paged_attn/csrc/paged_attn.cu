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
// tokens a sequence) one step reads 1 GiB: 0.32 ms at 3.35 TB/s. The split
// partials add 2 * (splits with a valid position) * G * hd * 4 bytes a
// (sequence, KV head): 2 x 17 MB there, 3 % of the K/V.
//
// Design: split-K (flash-decoding) over fixed runs of zones, two kernels.
//  * Why split. One CTA per (sequence, KV head) walks a whole sequence
//    alone: 512 CTAs at the size above, one wave, each streaming 2 MiB
//    with a few loads in flight a lane, and on ragged batches (32
//    sequences, 256 CTAs for 132 SMs) most SMs wait for the longest rows.
//    Splitting each sequence into runs of zps zones (kernel.py::
//    split_layout: about 256 tokens, so zps = 2 at 128-token zones) gives
//    B*KV*S short CTAs whose count follows the tokens, not the longest row:
//    2,304 working CTAs (4-6 waves) in a serve step of 32 x 2,056 tokens.
//  * paged_partial: one CTA of 128 threads per (sequence, KV head, chunk of
//    at most 8 query heads of that KV head, split). Each CTA decides the
//    row's no-valid-position case from the table itself (every CTA of the
//    row scans the same entries, so the splits agree without talking),
//    walks zones [s*zps, min((s+1)*zps, n_walk)) and reads K/V once for all
//    of its query heads. A token's hd values are split over a lane group of
//    T lanes (T the power of two >= hd/8), 8 values a lane: one 16-byte
//    load per lane in bf16, two in float32. The CTA's 128/T lane groups
//    walk the split's tokens two at a time (four loads a lane in flight),
//    each with its own online-softmax state (m, l, acc) in registers. A
//    token's logit is a dot product of the lane's 8 values, summed over the
//    group with xor shuffles. The update takes one exp a token and head:
//    exp(-|s - m|) is the rescale of the old state when s > m, else the new
//    token's weight. The groups' states merge in shared memory, and the CTA
//    writes its unnormalised (m, l, acc) in float32 to the workspace
//    [rows, S, GP] (m, l) and [rows, S, GP, hd] (acc), rows = B*KV*chunks.
//    A split that reads no position ends with m = -1e30 and l = 0; past the
//    row's zones it returns at once and writes no acc.
//  * paged_combine: one CTA per (sequence, KV head, chunk). For each query
//    head it takes M = max m over the splits and weighs split j by
//    exp(m_j - M), skipping splits with l = 0, sums L and A in split order
//    and writes A / max(L, 1e-30) rounded to q's type. Nothing is atomic:
//    the result is the same from run to run. A no-valid-position row has
//    m = 0 in every split, so the combine gives the uniform mean.
//  * The zone table and the length are read on the card: no host sync.
//
// C interface: pa_workspace_floats(...) gives the workspace's size in
// floats; pa_paged_attention(...) launches both kernels on the caller's
// stream and returns the first cudaGetLastError(); it neither allocates nor
// synchronises.

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
// ng <= GP of them. blockIdx.x = row * S + split, row = (b*KV + kvh) *
// ctas_per_kv + chunk.
template <typename T, int GP>
__global__ void __launch_bounds__(kThreads)
paged_partial(const T* __restrict__ q, const T* __restrict__ kz, const T* __restrict__ vz,
              const int* __restrict__ zone_table, const int* __restrict__ lengths,
              float* __restrict__ ws, int H, int KV, int hd, int NZ, int ZL, int MZ, int zps,
              int S, int heads_per_cta, int ctas_per_kv, int lanes, float scale) {
  // per-group state for the merge; groups * hd <= kThreads * kVec
  __shared__ float s_m[kThreads * GP];
  __shared__ float s_l[kThreads * GP];
  __shared__ float s_acc[kThreads * kVec * GP];

  const int G = H / KV;
  const int split = blockIdx.x % S;
  const int r = blockIdx.x / S;
  const int chunk = r % ctas_per_kv;
  const int kvh = (r / ctas_per_kv) % KV;
  const int b = r / ctas_per_kv / KV;
  const int h0 = kvh * G + chunk * heads_per_cta;      // first query head
  const int ng = min(heads_per_cta, G - chunk * heads_per_cta);
  float* ws_m = ws + (size_t)blockIdx.x * GP;
  float* ws_l = ws_m + (size_t)gridDim.x * GP;
  float* ws_acc = ws + (size_t)gridDim.x * GP * 2 + (size_t)blockIdx.x * GP * hd;

  const int tid = threadIdx.x;
  const int* row = zone_table + (size_t)b * MZ;
  const int len = lengths[b];
  // Is any position of the row valid? Zone z holds one iff z*ZL < len and
  // its entry >= 0. Every split of the row reads the same entries.
  int any = 0;
  for (int z = tid; z < MZ && (long long)z * ZL < len; z += kThreads) any |= row[z] >= 0;
  const bool uniform = __syncthreads_or(any) == 0;
  const int n_walk = uniform ? MZ : (int)min((long long)MZ, ((long long)len + ZL - 1) / ZL);
  const int z0 = split * zps;
  if (z0 >= n_walk) {                                  // past the row's zones
    if (tid < ng) {
      ws_m[tid] = kMasked;
      ws_l[tid] = 0.f;
    }
    return;
  }
  const int z1 = min(z0 + zps, n_walk);

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

  float m[GP], l[GP], acc[GP][kVec];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = kMasked;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[g][i] = 0.f;
  }

  const size_t slot_stride = (size_t)KV * hd;
  for (int z = z0; z < z1; ++z) {
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

  // Merge the groups' states; write the split's unnormalised state.
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
    ws_acc[idx] = A;
    if (d == 0) {
      ws_m[g] = M;
      ws_l[g] = L;
    }
  }
}

// One CTA per workspace row (b, kvh, chunk): the S splits of its ng query
// heads, combined in split order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_combine(const float* __restrict__ ws, T* __restrict__ out, int H, int KV, int hd, int S,
              int GP, int heads_per_cta, int ctas_per_kv) {
  const int G = H / KV;
  const int r = blockIdx.x;
  const int chunk = r % ctas_per_kv;
  const int kvh = (r / ctas_per_kv) % KV;
  const int b = r / ctas_per_kv / KV;
  const int h0 = kvh * G + chunk * heads_per_cta;
  const int ng = min(heads_per_cta, G - chunk * heads_per_cta);
  const size_t cells = (size_t)gridDim.x * S * GP;    // (m, l) entries of the workspace
  const float* m = ws + (size_t)r * S * GP;
  const float* l = m + cells;
  const float* acc = ws + 2 * cells + (size_t)r * S * GP * hd;
  for (int idx = threadIdx.x; idx < ng * hd; idx += kThreads) {
    const int g = idx / hd, d = idx % hd;
    float M = kMasked;
    for (int j = 0; j < S; ++j) M = fmaxf(M, m[j * GP + g]);
    float L = 0.f, A = 0.f;
    for (int j = 0; j < S; ++j) {
      const float lj = l[j * GP + g];
      if (lj == 0.f) continue;                        // read nothing, wrote no acc
      const float w = expf(m[j * GP + g] - M);
      L = fmaf(lj, w, L);
      A = fmaf(acc[(size_t)(j * GP + g) * hd + d], w, A);
    }
    store(out + ((size_t)b * H + h0 + g) * hd + d, A / fmaxf(L, 1e-30f));
  }
}

struct Geometry {
  int ctas_per_kv, heads_per_cta, gp, lanes;
};

// How a row's query heads are split over CTAs, and the lane group width.
Geometry geometry(int H, int KV, int hd) {
  Geometry g;
  const int G = H / KV;
  g.ctas_per_kv = (G + kMaxHeadsPerCta - 1) / kMaxHeadsPerCta;
  g.heads_per_cta = (G + g.ctas_per_kv - 1) / g.ctas_per_kv;
  g.gp = g.heads_per_cta <= 1 ? 1 : g.heads_per_cta <= 2 ? 2 : g.heads_per_cta <= 4 ? 4 : 8;
  g.lanes = 1;
  while (g.lanes * kVec < hd) g.lanes <<= 1;
  return g;
}

bool valid_shapes(int B, int H, int KV, int hd, int S) {
  if (B < 1 || KV < 1 || H < KV || H % KV || hd < kVec || hd > kMaxHeadDim || hd % kVec ||
      S < 1)
    return false;
  return (long long)B * KV * geometry(H, KV, hd).ctas_per_kv * S <= 0x7fffffffLL;
}

template <typename T, int GP>
cudaError_t launch(const void* q, const void* k, const void* v, const int* tab, const int* lens,
                   void* out, float* ws, int B, int H, int KV, int hd, int NZ, int ZL, int MZ,
                   int zps, int S, const Geometry& g, float scale, cudaStream_t s) {
  const unsigned rows = (unsigned)B * KV * g.ctas_per_kv;
  paged_partial<T, GP><<<rows * S, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), tab, lens,
      ws, H, KV, hd, NZ, ZL, MZ, zps, S, g.heads_per_cta, g.ctas_per_kv, g.lanes, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine<T><<<rows, kThreads, 0, s>>>(ws, static_cast<T*>(out), H, KV, hd, S, GP,
                                             g.heads_per_cta, g.ctas_per_kv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gp(const void* q, const void* k, const void* v, const int* tab,
                      const int* lens, void* out, float* ws, int B, int H, int KV, int hd,
                      int NZ, int ZL, int MZ, int zps, int S, const Geometry& g, float scale,
                      cudaStream_t s) {
  switch (g.gp) {
    case 1: return launch<T, 1>(q, k, v, tab, lens, out, ws, B, H, KV, hd, NZ, ZL, MZ, zps, S, g, scale, s);
    case 2: return launch<T, 2>(q, k, v, tab, lens, out, ws, B, H, KV, hd, NZ, ZL, MZ, zps, S, g, scale, s);
    case 4: return launch<T, 4>(q, k, v, tab, lens, out, ws, B, H, KV, hd, NZ, ZL, MZ, zps, S, g, scale, s);
    case 8: return launch<T, 8>(q, k, v, tab, lens, out, ws, B, H, KV, hd, NZ, ZL, MZ, zps, S, g, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of the workspace for S splits: (m, l) [rows, S, GP] each and acc
// [rows, S, GP, hd], rows = B*KV*chunks; -1 for shapes the kernel refuses.
extern "C" long long pa_workspace_floats(int B, int H, int KV, int hd, int S) {
  if (!valid_shapes(B, H, KV, hd, S)) return -1;
  const Geometry g = geometry(H, KV, hd);
  return (long long)B * KV * g.ctas_per_kv * S * g.gp * (hd + 2);
}

// dtype: 0 float32, 1 bfloat16 (q, K, V and out all of it). The caller
// checks shapes, contiguity and 16-byte alignment, passes zps and S =
// ceil(MZ / zps) from kernel.py::split_layout, a float32 workspace of
// pa_workspace_floats(B, H, KV, hd, S) and scale = hd**-0.5 in float32.
extern "C" int pa_paged_attention(int dtype, const void* q, const void* k, const void* v,
                                  const void* zone_table, const void* lengths, void* out,
                                  void* workspace, int B, int H, int KV, int hd, int NZ, int ZL,
                                  int MZ, int zps, int S, float scale, void* stream) {
  if (!valid_shapes(B, H, KV, hd, S) || NZ < 1 || ZL < 1 || MZ < 1 || zps < 1 ||
      (long long)MZ * ZL > 0x7fffffffLL || S != ((long long)MZ + zps - 1) / zps)
    return cudaErrorInvalidValue;
  const Geometry g = geometry(H, KV, hd);
  const int* tab = static_cast<const int*>(zone_table);
  const int* lens = static_cast<const int*>(lengths);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_gp<float>(q, k, v, tab, lens, out, ws, B, H, KV, hd, NZ, ZL, MZ, zps, S, g, scale, s);
    case 1: return launch_gp<__nv_bfloat16>(q, k, v, tab, lens, out, ws, B, H, KV, hd, NZ, ZL, MZ, zps, S, g, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
