// A prompt's K/V copied into its zones of a zoned KV cache, every layer and
// every zone run in one launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's cache (src/repro/serve/
// kv_zones.py) appends one token at a time with .at[].set and admits no
// whole prompt. The port's KVZoneCache.admit copied one zone run of K and
// one of V a call of copy_, each over all L layers of the [L, NZ, ZL, KV,
// hd] pool. A pool of more than 2^31 elements (granite-8b's 36 x 2,048 x
// 128 x 8 x 128 bf16 is 9.7e9) makes PyTorch cut each such copy into
// 32-bit-indexed pieces: about 1,200 launches for one ~2.4k-token prompt,
// each moving well under a MB, so the host's enqueue set the admission's
// time, not the card.
//
// Bound: bytes. A ~2.4k-token granite prompt is 354 MB of K and V, read
// once and written once: 0.21 ms at 3.35 TB/s. The kernel is a pure copy,
// one launch for up to kMaxZones zone runs (the zone ids ride in the
// kernel's parameters, so no host-to-card copy precedes it): a CTA copies
// one chunk of kThreads x kUnroll units of one zone run of one layer of K
// or V, with its kUnroll loads in flight before its stores. A unit is 16
// bytes where every row and stride allows it (2 KiB rows at granite's KV x
// hd x 2), else the largest power of two that divides them all, down to one
// byte: the wrapper chooses it. Every offset is 64-bit. The last run of a
// prompt writes only its own slots; the rest of that zone keeps its bytes,
// as the plain copy leaves them.
//
// C interface: za_admit launches one kernel on the caller's stream and
// returns cudaGetLastError(); it neither allocates nor waits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxZones = 64;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;

struct Admit {
  const char* src[2];           // K, V: token t of layer l at l * src_layer + t * src_token
  char* dst[2];                 // the pools' K, V
  long long src_layer[2], src_token[2];   // bytes
  long long dst_layer, dst_zone;          // bytes; a zone's rows are contiguous
  int row_units;                // units a token's row of KV x hd
  int zone_len;                 // tokens a zone
  int n;                        // tokens of this launch, from zone run 0
  int chunks;                   // CTAs a zone run
  int zones[kMaxZones];         // run r goes to zone zones[r]
};

// grid (runs x chunks, layers, 2 for K and V)
template <typename U>
__global__ void __launch_bounds__(kThreads) zone_admit_kernel(const __grid_constant__ Admit p) {
  const int r = blockIdx.x / p.chunks, chunk = blockIdx.x - r * p.chunks;
  const int layer = blockIdx.y, kv = blockIdx.z;
  const int t0 = r * p.zone_len;
  const int units = min(p.zone_len, p.n - t0) * p.row_units;
  const long long src_token = p.src_token[kv];
  const char* src = p.src[kv] + layer * p.src_layer[kv] + t0 * src_token;
  U* dst = reinterpret_cast<U*>(p.dst[kv] + layer * p.dst_layer + p.zones[r] * p.dst_zone);
  const int first = chunk * (kThreads * kUnroll) + threadIdx.x;
  U buf[kUnroll];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const int i = first + j * kThreads;
    if (i < units) {
      const int t = i / p.row_units, u = i - t * p.row_units;
      buf[j] = *reinterpret_cast<const U*>(src + t * src_token + (long long)u * sizeof(U));
    }
  }
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const int i = first + j * kThreads;
    if (i < units) dst[i] = buf[j];
  }
}

template <typename U>
cudaError_t launch(const Admit& p, int runs, int layers, cudaStream_t s) {
  const dim3 grid((unsigned)(runs * p.chunks), (unsigned)layers, 2);
  zone_admit_kernel<U><<<grid, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// unit: bytes a load (1, 2, 4, 8 or 16), dividing every pointer, stride and
// row; strides in bytes; runs = ceil(n / zone_len) zone ids in zones (at
// most kMaxZones); zone_len * row_units below 2^31; layers at most 65,535.
extern "C" int za_admit(int unit, const void* src_k, const void* src_v, void* dst_k,
                        void* dst_v, long long src_layer_k, long long src_token_k,
                        long long src_layer_v, long long src_token_v, long long dst_layer,
                        long long dst_zone, int layers, int row_units, int zone_len, int n,
                        const int* zones, void* stream) {
  if (layers < 1 || layers > 65535 || row_units < 1 || zone_len < 1 || n < 1)
    return cudaErrorInvalidValue;
  const int runs = (n + zone_len - 1) / zone_len;
  if (runs > kMaxZones || (long long)zone_len * row_units > INT32_MAX) return cudaErrorInvalidValue;
  Admit p;
  p.src[0] = static_cast<const char*>(src_k);
  p.src[1] = static_cast<const char*>(src_v);
  p.dst[0] = static_cast<char*>(dst_k);
  p.dst[1] = static_cast<char*>(dst_v);
  p.src_layer[0] = src_layer_k;
  p.src_token[0] = src_token_k;
  p.src_layer[1] = src_layer_v;
  p.src_token[1] = src_token_v;
  p.dst_layer = dst_layer;
  p.dst_zone = dst_zone;
  p.row_units = row_units;
  p.zone_len = zone_len;
  p.n = n;
  p.chunks = (int)(((long long)zone_len * row_units + kThreads * kUnroll - 1) /
                   (kThreads * kUnroll));
  for (int r = 0; r < kMaxZones; ++r) p.zones[r] = r < runs ? zones[r] : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16: return launch<uint4>(p, runs, layers, s);
    case 8: return launch<uint2>(p, runs, layers, s);
    case 4: return launch<uint32_t>(p, runs, layers, s);
    case 2: return launch<uint16_t>(p, runs, layers, s);
    case 1: return launch<uint8_t>(p, runs, layers, s);
    default: return cudaErrorInvalidValue;
  }
}
