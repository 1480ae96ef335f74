// Filtered reduction over a zone, for Hopper (sm_90a).
//
// Replaces the TPU kernels
//   src/repro/kernels/zone_filter/kernel.py::filtered_reduce_pallas
//   src/repro/kernels/zone_filter/kernel.py::filtered_reduce_pallas_batched
// and the program transform they fuse, ops.py::_program_transform.
//
// What it computes. A zone (or a batch of equal chunks of zones) of
// int32/int64/uint32/float32/float64 elements goes through a verified
// program's ALU/CMP chain, which yields a value and a keep mask per element;
// then one masked count/sum/min/max per chunk. Accumulators follow the
// reference: count -> int32; sum -> float32 for float input (float64 input
// is cast to float32 first), int32 for integer input (wrapping); min/max in
// the input type, with the type's largest/lowest finite value standing in
// for dropped elements.
//
// Bound: memory. Each input byte is read once; the work per element is one
// pass over the short instruction list. For the paper's 256 MiB zone:
// 268,435,456 B / 3.35 TB/s = 80 us on an H100 SXM at its 700 W limit.
//
// Design.
//  * One kernel per (type, kind): 5 x 4 instantiations in one library. The
//    program is data, not code: an int32 opcode array and an array of 8-byte
//    immediates (already cast to the stream type on the host) in device
//    memory. Every thread reads the same word, so each read is a broadcast.
//  * The fold is cut into bpc fold blocks a chunk (bpc from the chunk's
//    size alone, kernel.py::blocks_per_chunk). Fold block lb takes the
//    tiles lb, lb + bpc, lb + 2 bpc, ...: each thread loads kVecLoads
//    16-byte vectors a tile (coalesced), then walks the instruction list
//    once for all of its register values (decoding shared, the switch on
//    the opcode uniform across the warp) and folds them per lane; a
//    warp-shuffle and shared-memory tree gives the fold block's partial.
//  * One launch, deterministic, no atomics on values. A CUDA block runs a
//    group of up to kMaxGroup consecutive fold blocks (more than one only
//    for fold blocks of one tile, while the grid keeps kMinBlocks blocks:
//    a batch of small chunks), its warps each at their own pace until the
//    group's trees meet in shared memory; it writes their partials and
//    takes a ticket from its chunk's counter. The chunk's last block to
//    arrive folds the chunk's bpc partials in a fixed order (strided by
//    kThreads, then the same tree), writes the result and sets the counter
//    back to 0, so the next launch on the stream finds it ready. So every
//    result, float sums included, depends on the data and bpc alone: a
//    batched row is bit-identical to the chunk run alone, whatever the
//    group or the block that arrives last. (Against the two-launch
//    version: one fold launch less. On the array's [512, 64, 1024]
//    dispatch a quarter of the block starts and tickets of one fold block
//    a CUDA block, which takes about 25 % longer there.)
//  * Integer ALU ops wrap (computed in the unsigned type); shifts by at least
//    the type's width give 0 (left, logical right) or the sign fill
//    (arithmetic right); MOD is floor-mod, the result taking the divisor's
//    sign, as jnp's %. Float ALU ops use the _rn intrinsics so that no two
//    program instructions are contracted into one fused multiply-add.
//
// C interface: zf_filtered_reduce(...) returns cudaGetLastError() after the
// one launch on the caller's stream; it neither allocates nor synchronises.
// The caller keeps one partials/tickets workspace per stream: two launches
// in flight at once must not share one.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecLoads = 2;  // 16-byte loads per thread per tile
constexpr int kMinBlocks = 2048;   // about 3 waves of 5 blocks on 132 SMs
constexpr int kMaxGroup = 4;       // fold blocks a CUDA block at most (8 and 16 measured slower)

enum Kind { kCount = 0, kSum = 1, kMin = 2, kMax = 3 };

// opcodes: keep in step with repro_torch/kernels/zone_filter/ref.py INSN_CODES
enum Op {
  ADD = 0, SUB = 1, MUL = 2, AND = 3, OR = 4, XOR = 5, SHL = 6, SHR = 7,
  MOD = 8, ABS = 9, NEG = 10,
  CMP_GT = 11, CMP_GE = 12, CMP_LT = 13, CMP_LE = 14, CMP_EQ = 15, CMP_NE = 16,
};

template <typename T> struct Traits;
template <> struct Traits<int> {
  using U = unsigned int;
  static constexpr bool kFloat = false, kSigned = true;
  static constexpr int kBits = 32;
  __device__ static int highest() { return INT_MAX; }
  __device__ static int lowest() { return INT_MIN; }
};
template <> struct Traits<long long> {
  using U = unsigned long long;
  static constexpr bool kFloat = false, kSigned = true;
  static constexpr int kBits = 64;
  __device__ static long long highest() { return LLONG_MAX; }
  __device__ static long long lowest() { return LLONG_MIN; }
};
template <> struct Traits<unsigned int> {
  using U = unsigned int;
  static constexpr bool kFloat = false, kSigned = false;
  static constexpr int kBits = 32;
  __device__ static unsigned int highest() { return UINT_MAX; }
  __device__ static unsigned int lowest() { return 0u; }
};
template <> struct Traits<float> {
  static constexpr bool kFloat = true, kSigned = true;
  __device__ static float highest() { return FLT_MAX; }
  __device__ static float lowest() { return -FLT_MAX; }
};
template <> struct Traits<double> {
  static constexpr bool kFloat = true, kSigned = true;
  __device__ static double highest() { return DBL_MAX; }
  __device__ static double lowest() { return -DBL_MAX; }
};

// Accumulator type of (input type, kind), as the reference's _acc_dtype.
template <typename T, int KIND> struct Acc { using type = T; };
template <typename T> struct Acc<T, kCount> { using type = int; };
template <typename T> struct Acc<T, kSum> {
  using type = typename std::conditional<Traits<T>::kFloat, float, int>::type;
};

// The neutral element of the fold, and what a dropped element contributes.
// They differ for float min/max: the reference fills dropped elements with
// the largest finite value, and +inf in the data must still win over nothing.
template <typename T, int KIND>
__device__ __forceinline__ typename Acc<T, KIND>::type neutral() {
  using A = typename Acc<T, KIND>::type;
  if constexpr (KIND == kMin) {
    if constexpr (Traits<T>::kFloat) return A(INFINITY); else return Traits<T>::highest();
  } else if constexpr (KIND == kMax) {
    if constexpr (Traits<T>::kFloat) return A(-INFINITY); else return Traits<T>::lowest();
  } else {
    return A(0);
  }
}

template <typename T, int KIND>
__device__ __forceinline__ typename Acc<T, KIND>::type
combine(typename Acc<T, KIND>::type a, typename Acc<T, KIND>::type b) {
  using A = typename Acc<T, KIND>::type;
  if constexpr (KIND == kCount) {
    return a + b;  // counts fit int32 (the reference's result type)
  } else if constexpr (KIND == kSum) {
    if constexpr (Traits<T>::kFloat) return __fadd_rn(a, b);
    else return A((unsigned int)a + (unsigned int)b);  // int32 wraps
  } else if constexpr (KIND == kMin) {
    // NaN propagates, as jnp.min
    if constexpr (Traits<T>::kFloat) return (b < a || b != b) ? b : a;
    else return b < a ? b : a;
  } else {
    if constexpr (Traits<T>::kFloat) return (b > a || b != b) ? b : a;
    else return b > a ? b : a;
  }
}

// One instruction applied to all kV values of a thread.
template <typename T, int kV>
__device__ __forceinline__ void apply(int op, long long raw, T (&v)[kV], bool (&keep)[kV]) {
  T m;
  if constexpr (Traits<T>::kFloat) m = T(__longlong_as_double(raw));
  else m = T(raw);
  switch (op) {
    case CMP_GT:
#pragma unroll
      for (int j = 0; j < kV; ++j) keep[j] = keep[j] && (v[j] > m);
      return;
    case CMP_GE:
#pragma unroll
      for (int j = 0; j < kV; ++j) keep[j] = keep[j] && (v[j] >= m);
      return;
    case CMP_LT:
#pragma unroll
      for (int j = 0; j < kV; ++j) keep[j] = keep[j] && (v[j] < m);
      return;
    case CMP_LE:
#pragma unroll
      for (int j = 0; j < kV; ++j) keep[j] = keep[j] && (v[j] <= m);
      return;
    case CMP_EQ:
#pragma unroll
      for (int j = 0; j < kV; ++j) keep[j] = keep[j] && (v[j] == m);
      return;
    case CMP_NE:
#pragma unroll
      for (int j = 0; j < kV; ++j) keep[j] = keep[j] && (v[j] != m);
      return;
    default:
      break;
  }
  if constexpr (Traits<T>::kFloat) {
    switch (op) {
      case ADD:
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          if constexpr (sizeof(T) == 4) v[j] = __fadd_rn(v[j], m); else v[j] = __dadd_rn(v[j], m);
        }
        return;
      case SUB:
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          if constexpr (sizeof(T) == 4) v[j] = __fsub_rn(v[j], m); else v[j] = __dsub_rn(v[j], m);
        }
        return;
      case MUL:
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          if constexpr (sizeof(T) == 4) v[j] = __fmul_rn(v[j], m); else v[j] = __dmul_rn(v[j], m);
        }
        return;
      case MOD:
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          T r;
          if constexpr (sizeof(T) == 4) r = fmodf(v[j], m); else r = fmod(v[j], m);
          v[j] = (r != T(0) && ((r < T(0)) != (m < T(0)))) ? r + m : r;
        }
        return;
      case ABS:
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          if constexpr (sizeof(T) == 4) v[j] = fabsf(v[j]); else v[j] = fabs(v[j]);
        }
        return;
      case NEG:
#pragma unroll
        for (int j = 0; j < kV; ++j) v[j] = -v[j];
        return;
      default:
        return;  // bitwise ops on floats never pass the verifier
    }
  } else {
    using U = typename Traits<T>::U;
    constexpr int kBits = Traits<T>::kBits;
    const int s = int(raw);  // shift amount, in [0, 64) by the verifier
    switch (op) {
      case ADD:
#pragma unroll
        for (int j = 0; j < kV; ++j) v[j] = T(U(v[j]) + U(m));
        return;
      case SUB:
#pragma unroll
        for (int j = 0; j < kV; ++j) v[j] = T(U(v[j]) - U(m));
        return;
      case MUL:
#pragma unroll
        for (int j = 0; j < kV; ++j) v[j] = T(U(v[j]) * U(m));
        return;
      case AND:
#pragma unroll
        for (int j = 0; j < kV; ++j) v[j] = v[j] & m;
        return;
      case OR:
#pragma unroll
        for (int j = 0; j < kV; ++j) v[j] = v[j] | m;
        return;
      case XOR:
#pragma unroll
        for (int j = 0; j < kV; ++j) v[j] = v[j] ^ m;
        return;
      case SHL:
#pragma unroll
        for (int j = 0; j < kV; ++j) v[j] = s >= kBits ? T(0) : T(U(v[j]) << s);
        return;
      case SHR:
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          if constexpr (Traits<T>::kSigned)
            v[j] = s >= kBits ? (v[j] < 0 ? T(-1) : T(0)) : T(v[j] >> s);  // arithmetic
          else
            v[j] = s >= kBits ? T(0) : T(v[j] >> s);                        // logical
        }
        return;
      case MOD:
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          if constexpr (Traits<T>::kSigned) {
            if (m == T(-1)) { v[j] = T(0); continue; }  // INT_MIN % -1 would trap
            T r = v[j] % m;                              // truncating
            v[j] = (r != 0 && ((r < 0) != (m < 0))) ? T(r + m) : r;
          } else {
            v[j] = v[j] % m;
          }
        }
        return;
      case ABS:
        if constexpr (Traits<T>::kSigned) {
#pragma unroll
          for (int j = 0; j < kV; ++j) v[j] = v[j] < 0 ? T(U(0) - U(v[j])) : v[j];
        }
        return;
      case NEG:
#pragma unroll
        for (int j = 0; j < kV; ++j) v[j] = T(U(0) - U(v[j]));
        return;
      default:
        return;
    }
  }
}

// What one element contributes to the fold.
template <typename T, int KIND>
__device__ __forceinline__ typename Acc<T, KIND>::type contribution(T v, bool keep) {
  using A = typename Acc<T, KIND>::type;
  if constexpr (KIND == kCount) return keep ? 1 : 0;
  else if constexpr (KIND == kSum) {
    if constexpr (Traits<T>::kFloat) return keep ? float(v) : 0.0f;
    else return keep ? A((unsigned int)v) : A(0);
  } else if constexpr (KIND == kMin) return keep ? v : Traits<T>::highest();
  else return keep ? v : Traits<T>::lowest();
}

// Fixed-order warp tree; the result is valid in lane 0.
template <typename T, int KIND>
__device__ __forceinline__ typename Acc<T, KIND>::type
warp_fold(typename Acc<T, KIND>::type a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a = combine<T, KIND>(a, __shfl_down_sync(0xffffffffu, a, off));
  return a;
}

// Fixed-order block tree: each warp's tree, then warp 0's tree over the
// kWarps results (the other lanes neutral); the result is valid in thread 0.
template <typename T, int KIND>
__device__ __forceinline__ typename Acc<T, KIND>::type
block_fold(typename Acc<T, KIND>::type a) {
  using A = typename Acc<T, KIND>::type;
  __shared__ A warp_acc[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_fold<T, KIND>(a);
  if (lane == 0) warp_acc[warp] = a;
  __syncthreads();
  if (warp == 0) a = warp_fold<T, KIND>(lane < kWarps ? warp_acc[lane] : neutral<T, KIND>());
  return a;
}

// A thread's share of fold block lb: the tiles lb, lb + bpc, lb + 2 bpc,
// ... of a chunk, the thread's values folded per lane in the order the
// tiles come, then across lanes.
template <typename T, int KIND>
__device__ __forceinline__ typename Acc<T, KIND>::type
lane_fold(const T* __restrict__ xc, long long chunk_elems, int lb, int bpc,
          const int* __restrict__ ops, const long long* __restrict__ imms, int n_insns) {
  using A = typename Acc<T, KIND>::type;
  constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int kV = kVecLoads * kVec;   // elements per thread per tile
  constexpr long long kTile = (long long)kThreads * kV;
  union Pack { uint4 u; T t[kVec]; };
  const bool aligned = (reinterpret_cast<uintptr_t>(xc) & 15) == 0;
  const long long stride = (long long)bpc * kTile;

  A acc[kV];
#pragma unroll
  for (int j = 0; j < kV; ++j) acc[j] = neutral<T, KIND>();
  for (long long first = (long long)lb * kTile; first < chunk_elems; first += stride) {
    T v[kV];
    bool keep[kV], valid[kV];
#pragma unroll
    for (int l = 0; l < kVecLoads; ++l) {
      const long long e = first + ((long long)l * kThreads + threadIdx.x) * kVec;
      if (aligned && e + kVec <= chunk_elems) {
        Pack p;
        p.u = __ldg(reinterpret_cast<const uint4*>(xc + e));
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          v[l * kVec + k] = p.t[k];
          valid[l * kVec + k] = true;
        }
      } else {  // past the end, the ragged end, or a chunk not 16-byte aligned
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const bool ok = e + k < chunk_elems;
          v[l * kVec + k] = ok ? xc[e + k] : T(0);
          valid[l * kVec + k] = ok;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kV; ++j) keep[j] = true;
    for (int i = 0; i < n_insns; ++i) apply<T, kV>(__ldg(ops + i), __ldg(imms + i), v, keep);
#pragma unroll
    for (int j = 0; j < kV; ++j)
      if (valid[j]) acc[j] = combine<T, KIND>(acc[j], contribution<T, KIND>(v[j], keep[j]));
  }
  A a = acc[0];
#pragma unroll
  for (int j = 1; j < kV; ++j) a = combine<T, KIND>(a, acc[j]);
  return a;
}

// Grid (ceil(bpc / group), n_chunks): each block folds the group of fold
// blocks [blockIdx.x * group, ...) of its chunk. A fold block's partial is
// block_fold's tree: each warp's tree over the fold block, kept in shared
// memory, then, once the whole group is in, one warp's tree over them; so
// a warp goes from one fold block to the next without waiting for the
// others. The block then takes a ticket; the chunk's last block to arrive
// folds the chunk's bpc partials.
template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads)
filtered_reduce(const T* __restrict__ x, long long chunk_elems,
                const int* __restrict__ ops, const long long* __restrict__ imms, int n_insns,
                typename Acc<T, KIND>::type* partials, unsigned int* tickets, int bpc,
                int group, typename Acc<T, KIND>::type* __restrict__ out) {
  using A = typename Acc<T, KIND>::type;
  __shared__ A warp_acc[kMaxGroup][kWarps];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long chunk = blockIdx.y;
  const T* xc = x + chunk * chunk_elems;
  A* pc = partials + chunk * bpc;
  const int lb0 = blockIdx.x * group, n = min(group, bpc - lb0);
  for (int g = 0; g < n; ++g) {
    const A a = warp_fold<T, KIND>(
        lane_fold<T, KIND>(xc, chunk_elems, lb0 + g, bpc, ops, imms, n_insns));
    if (lane == 0) warp_acc[g][warp] = a;
  }
  __syncthreads();
  for (int g = warp; g < n; g += kWarps) {
    const A a = warp_fold<T, KIND>(lane < kWarps ? warp_acc[g][lane] : neutral<T, KIND>());
    if (lane == 0) pc[lb0 + g] = a;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // the block's partials are visible before its ticket is taken
    last = atomicAdd(tickets + chunk, 1u) == gridDim.x - 1;
    if (last) __threadfence();  // and every other block's, to this block
  }
  __syncthreads();
  if (!last) return;
  // The chunk's last block: its partials in a fixed order, read from L2.
  A b = neutral<T, KIND>();
  for (int i = threadIdx.x; i < bpc; i += kThreads) b = combine<T, KIND>(b, __ldcg(pc + i));
  b = block_fold<T, KIND>(b);
  if (threadIdx.x == 0) {
    out[chunk] = b;
    tickets[chunk] = 0;
  }
}

template <typename T, int KIND>
cudaError_t launch(const void* x, long long n_chunks, long long chunk_elems,
                   const int* ops, const long long* imms, int n_insns, void* partials,
                   unsigned int* tickets, int bpc, void* out, cudaStream_t stream) {
  using A = typename Acc<T, KIND>::type;
  constexpr long long kTile = (long long)kThreads * kVecLoads * (16 / sizeof(T));
  const long long tiles = (chunk_elems + kTile - 1) / kTile;   // a chunk
  const long long fold_tiles = (tiles + bpc - 1) / bpc;         // the first fold block
  // Fold blocks a block, where each is one tile: grow while the grid keeps
  // kMinBlocks blocks, so a batch of small chunks pays fewer tickets and
  // block starts (fold blocks of several tiles pay them once a few tiles
  // already). The results do not depend on it.
  int group = 1;
  while (fold_tiles == 1 && group * 2 <= min(bpc, kMaxGroup) &&
         n_chunks * ((bpc + group * 2 - 1) / (group * 2)) >= kMinBlocks)
    group *= 2;
  const dim3 grid((bpc + group - 1) / group, (unsigned)n_chunks);
  filtered_reduce<T, KIND><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), chunk_elems, ops, imms, n_insns, static_cast<A*>(partials),
      tickets, bpc, group, static_cast<A*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_kind(int kind, const void* x, long long n_chunks, long long chunk_elems,
                        const int* ops, const long long* imms, int n_insns,
                        void* partials, unsigned int* tickets, int bpc, void* out,
                        cudaStream_t s) {
  switch (kind) {
    case kCount: return launch<T, kCount>(x, n_chunks, chunk_elems, ops, imms, n_insns, partials, tickets, bpc, out, s);
    case kSum:   return launch<T, kSum>(x, n_chunks, chunk_elems, ops, imms, n_insns, partials, tickets, bpc, out, s);
    case kMin:   return launch<T, kMin>(x, n_chunks, chunk_elems, ops, imms, n_insns, partials, tickets, bpc, out, s);
    case kMax:   return launch<T, kMax>(x, n_chunks, chunk_elems, ops, imms, n_insns, partials, tickets, bpc, out, s);
    default:     return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 int32, 1 int64, 2 uint32, 3 float32, 4 float64.
// kind:  0 count, 1 sum, 2 min, 3 max.
// x is [n_chunks, chunk_elems]; partials holds n_chunks * blocks_per_chunk
// accumulators and out n_chunks of them (int32 for count and integer sum,
// float32 for float sum, the input type for min/max); tickets holds
// n_chunks counters, 0 on entry and left at 0. ops/imms may be null when
// n_insns is 0.
extern "C" int zf_filtered_reduce(int dtype, int kind, const void* x, long long n_chunks,
                                  long long chunk_elems, const void* ops, const void* imms,
                                  int n_insns, void* partials, void* tickets,
                                  int blocks_per_chunk, void* out, void* stream) {
  if (n_chunks < 1 || n_chunks > 65535 || chunk_elems < 1 || blocks_per_chunk < 1 || n_insns < 0)
    return cudaErrorInvalidValue;
  unsigned int* t = static_cast<unsigned int*>(tickets);
  const int* o = static_cast<const int*>(ops);
  const long long* im = static_cast<const long long*>(imms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_kind<int>(kind, x, n_chunks, chunk_elems, o, im, n_insns, partials, t, blocks_per_chunk, out, s);
    case 1: return launch_kind<long long>(kind, x, n_chunks, chunk_elems, o, im, n_insns, partials, t, blocks_per_chunk, out, s);
    case 2: return launch_kind<unsigned int>(kind, x, n_chunks, chunk_elems, o, im, n_insns, partials, t, blocks_per_chunk, out, s);
    case 3: return launch_kind<float>(kind, x, n_chunks, chunk_elems, o, im, n_insns, partials, t, blocks_per_chunk, out, s);
    case 4: return launch_kind<double>(kind, x, n_chunks, chunk_elems, o, im, n_insns, partials, t, blocks_per_chunk, out, s);
    default: return cudaErrorInvalidValue;
  }
}
