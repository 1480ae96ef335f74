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
// partials add 2 * (splits with a valid position) * H * hd * 4 bytes a
// sequence: 2 x 8 MB there, under 2 % of the K/V.
//
// Design: split-K (flash-decoding) over runs of zones, two kernels.
//  * paged_partial: one CTA per (sequence, chunk of KV heads and their query
//    heads, split), one CTA an SM: one producer warp and up to 8 consumer
//    warps, one a column of 4 query heads of one KV head. At granite width
//    a chunk is all 8 KV heads (8 columns), so a token's K for the CTA is
//    one contiguous 2 KiB row of the pool, and the slots [s0, s1) of a zone
//    are one contiguous run.
//    - Bytes in flight. The producer warp walks the split's zones and copies
//      each valid slot's K row and V row into a ring of `ns` (3)
//      shared-memory stages of `tt` tokens (16 at granite bf16: 64 KiB a
//      stage) with 1-D bulk copies (cp.async.bulk ... mbarrier::complete_tx),
//      one a row and lane, which hold no registers and need no tensor map.
//      A row lands `srow` = row + 16 bytes after the last, so 8 tokens' rows
//      fall in 8 different bank groups. Each stage has a `full` mbarrier
//      (the copies' bytes) and an `empty` one (every consumer lane's
//      arrival); the producer stays up to ns stages ahead, so 2 stages
//      (128 KiB) are in flight while one is consumed, several times the
//      ~25 KB an SM needs to stream at 3.35 TB/s.
//    - Work a token. A consumer warp does all of its column's work, so the
//      consumers meet only at the ring's barriers.
//      Logits in bf16 with 16-token stages and hd a multiple of 16: on
//      tensor cores, mma.sync m16n8k16 with the stage's 16 tokens as M
//      (K from shared memory by ldmatrix, conflict-free on the padded
//      rows), the 4 heads padded to 8 as N (q's fragments in registers, as
//      bf16) and hd as K, accumulated in float32 and scaled afterwards in
//      float32 (the reference scales q first: the two differ by float32
//      rounding). Elsewhere (float32 throughout: TF32 would change results)
//      on CUDA cores: the warp's 4 lane groups of 8 lanes take every 4th
//      token, a lane holds q (scaled) for the 4 heads over its 16-byte
//      units of hd in registers, reads its units of the token's K once and
//      makes 4 partial dot products, which a reduce-scatter over the group
//      (4 shuffles, not 4 x 3) leaves as head g's logit in lanes 2g, 2g+1.
//      Softmax by tiles, in registers: one max over the tile's tokens a
//      head (2-3 shuffles), one rescale of the old state a tile and head,
//      and p = exp(s - m) for the tile, written to the warp's 256-byte p
//      buffer. P.V on CUDA cores in float32 (P rounded to bf16 for tensor
//      cores would be a result the reference does not compute): a lane owns
//      one 16-byte unit of hd for the 4 heads (4 x 8 values in bf16) and
//      every (32/units)-th token of the tile; it rescales its accumulator
//      once a tile, then reads each token's V unit and p. The lanes of one
//      unit are summed by shuffles at the end.
//    - The CTA decides the row's no-valid-position case from the table
//      itself (every CTA of the row scans the same entries, so the splits
//      agree without talking) and counts the split's tokens, so the walk
//      packs stages without gaps and every warp knows each stage's size.
//      It writes its unnormalised (m, l, acc) in float32 to the workspace
//      [rows, S, GP] (m, l) and [rows, S, GP, hd] (acc), rows = B*KV*chunks
//      of at most 8 query heads (paged_combine's layout). A split that reads
//      no position writes m = -1e30 and l = 0 and no acc.
//  * paged_combine: one CTA per (sequence, KV head, chunk). For each query
//    head it takes M = max m over the splits and weighs split j by
//    exp(m_j - M), skipping splits with l = 0, sums L and A in split order
//    and writes A / max(L, 1e-30) rounded to q's type. Nothing is atomic:
//    the result is the same from run to run. A no-valid-position row has
//    m = 0 in every split, so the combine gives the uniform mean.
//  * The split count and the CTA's shape come from the host
//    (kernel.py::plan: about 4 waves of CTAs at a full table, S = 1 when
//    the sequences alone fill the card), from shapes and the SM count: the
//    zone table and the lengths are read on the card, no host sync.
//
// C interface: pa_workspace_floats(...) gives the workspace's size in
// floats; pa_smem_bytes(...) the partial kernel's dynamic shared memory for
// a plan; pa_paged_attention(...) launches both kernels on the caller's
// stream and returns the first error; it neither allocates nor synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumerWarps = 8;                  // at most one a column
constexpr int kThreads = (kConsumerWarps + 1) * 32;  // + the producer warp
constexpr int kLaneGroup = 8;                      // lanes of one dot product
constexpr int kHeadsACol = 4;                      // query heads a column
constexpr int kMaxStageTokens = 16;                // 4 a lane group
constexpr int kTokensAGroup = kMaxStageTokens / (32 / kLaneGroup);
constexpr int kMinStages = 3;
constexpr int kMaxSmem = 232448;                   // a block's dynamic shared memory
constexpr int kCombineThreads = 128;
constexpr int kMaxHeadDim = 256;
constexpr int kMaxHeadsPerChunk = 8;               // the workspace's head chunks
constexpr float kMasked = -1e30f;
// tools/paged_attn_variants.py's no_math variant sets this false: the
// consumers then only wait for each stage and release it.
constexpr bool kMath = true;

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
// arrive (the producer's one arrival) and expect `bytes` of copies
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait for the completion of the phase with this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra WAIT;\n"
      "DONE:\n\t}" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned, completed on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// four 8x8 bf16 matrices from shared memory: lane i gives the address of
// row i%8 of matrix i/8 and receives row i/4, columns 2(i%4), 2(i%4)+1 of
// each (mma's A fragment)
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&a)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}
// d += a (16x16 bf16, row-major) . b (16x8 bf16, column-major), float32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------------ 16-byte units

template <typename T> struct Unit;                  // values in 16 bytes
template <> struct Unit<float> { static constexpr int n = 4; };
template <> struct Unit<__nv_bfloat16> { static constexpr int n = 8; };

__device__ __forceinline__ void widen(const void* p, float* x, float) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
}
// bf16 -> f32 is exact: the bf16 bits are the high half of the f32. Element
// 2i is the low half of word i (little-endian).
__device__ __forceinline__ void widen(const void* p, float* x, __nv_bfloat16) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* tab;
  const int* lens;
  float* ws;
  long long cells;          // (m, l) entries of the workspace: rows * S * gp
  int H, KV, hd, NZ, ZL, MZ, zps, S;
  int G, kvc, hgc, hgs, ncol, ctas_per_seq;   // CTA shape: kvc KV heads x hgc columns each
  int tt, ns, row_bytes;    // stage tokens, stages, one token's K (or V) for the CTA
  int srow;                 // a token's row in shared memory: row_bytes + 16
  int cpk, hpc, gp;         // the workspace's head chunks (paged_combine)
  int off_p, off_bar;       // shared-memory layout: the ring, p buffers, barriers
  float scale;
};

// Where head `hl` (< G) of KV head `kvh` keeps its (m, l) cell.
__device__ __forceinline__ long long ws_cell(const Params& p, int b, int kvh, int hl, int split) {
  const long long row = ((long long)b * p.KV + kvh) * p.cpk + hl / p.hpc;
  return (row * p.S + split) * p.gp + hl % p.hpc;
}

// UPL: 16-byte units of hd a lane holds in the logits (hd*itemsize/16
// units over 8 lanes, rounded up to a power of two); PVU: units a lane holds
// in P.V (over 32 lanes). MMA: the logits on tensor cores (bf16, 16 tokens a
// stage, hd a multiple of 16), at most KS = 4*UPL steps of 16 of hd.
template <typename T, int UPL, bool MMA>
__global__ void __launch_bounds__(kThreads, 1) paged_partial(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int VE = Unit<T>::n;
  constexpr int DPL = UPL * VE;
  constexpr int PVU = (UPL + 3) / 4;
  constexpr int KS = 4 * UPL;
  constexpr int isz = sizeof(T);
  const int tid = threadIdx.x;
  const int split = blockIdx.x % p.S;
  const int rc = blockIdx.x / p.S;
  const int c = rc % p.ctas_per_seq;
  const int b = rc / p.ctas_per_seq;
  const int nhc = p.hgs / p.hgc;
  const int kv0 = (c / nhc) * p.kvc;
  const int hg0 = (c % nhc) * p.hgc;

  const int* row = p.tab + (size_t)b * p.MZ;
  const int len = p.lens[b];
  // Is any position of the row valid? Zone z holds one iff z*ZL < len and
  // its entry >= 0. Every split of the row reads the same entries.
  int any = 0;
  for (int z = tid; z < p.MZ && (long long)z * p.ZL < len; z += kThreads) any |= row[z] >= 0;
  const bool uniform = __syncthreads_or(any) == 0;
  const int n_walk = uniform ? p.MZ : (int)min((long long)p.MZ, ((long long)len + p.ZL - 1) / p.ZL);
  const int z0 = split * p.zps;
  const int z1 = min(z0 + p.zps, n_walk);
  // the positions this split reads, counted by every warp alike
  int nw = 0;
  for (int z = z0 + (tid & 31); z < z1; z += 32)
    if (uniform || row[z] >= 0) nw += uniform ? p.ZL : min(p.ZL, len - z * p.ZL);
  nw = __reduce_add_sync(0xffffffffu, nw);
  if (nw == 0) {                                       // reads nothing
    for (int i = tid; i < p.ncol * kHeadsACol; i += kThreads) {
      const int col = i / kHeadsACol;
      const int hl = (hg0 + col % p.hgc) * kHeadsACol + i % kHeadsACol;
      if (hl >= p.G) continue;
      const long long cell = ws_cell(p, b, kv0 + col / p.hgc, hl, split);
      p.ws[cell] = kMasked;
      p.ws[p.cells + cell] = 0.f;
    }
    return;
  }

  unsigned char* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.off_bar);
  uint64_t* empty = full + p.ns;
  const int stage_bytes = 2 * p.tt * p.srow;
  const int n_stages = (nw + p.tt - 1) / p.tt;
  if (tid == 0) {
    for (int s = 0; s < p.ns; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], p.ncol * 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;

  if (warp == kConsumerWarps) {
    // ------------------------------------------------------------ producer
    // One bulk copy a token's K row and one its V row, each into a row of
    // `srow` bytes: the 16 bytes of padding put 8 consecutive tokens' rows
    // in 8 different bank groups (ldmatrix without conflicts).
    const size_t slot_bytes = (size_t)p.KV * p.hd * isz;     // one slot, all KV heads
    const unsigned char* kbase = static_cast<const unsigned char*>(p.k) + (size_t)kv0 * p.hd * isz;
    const unsigned char* vbase = static_cast<const unsigned char*>(p.v) + (size_t)kv0 * p.hd * isz;
    const uint32_t ring_addr = smem_u32(ring);
    int stage = 0, filled = 0;
    for (int z = z0; z < z1; ++z) {
      int zone = row[z];
      if (!uniform && zone < 0) continue;
      zone = min(max(zone, 0), p.NZ - 1);
      const int ntok = uniform ? p.ZL : min(p.ZL, len - z * p.ZL);
      for (int s = 0; s < ntok;) {
        const int r = stage % p.ns;
        if (filled == 0) {
          if (stage >= p.ns) mbar_wait(&empty[r], ((stage / p.ns) - 1) & 1);
          if (lane == 0)
            mbar_arrive_expect(&full[r], 2u * min(p.tt, nw - stage * p.tt) * p.row_bytes);
          __syncwarp();
        }
        const int n = min(p.tt - filled, ntok - s);
        const size_t off = ((size_t)zone * p.ZL + s) * slot_bytes;
        const uint32_t dk = ring_addr + r * stage_bytes + filled * p.srow;
        for (int i = lane; i < n; i += 32) {
          bulk_copy(dk + i * p.srow, kbase + off + i * slot_bytes, p.row_bytes, &full[r]);
          bulk_copy(dk + (p.tt + i) * p.srow, vbase + off + i * slot_bytes, p.row_bytes, &full[r]);
        }
        filled += n;
        s += n;
        if (filled == p.tt || stage * p.tt + filled == nw) {
          ++stage;
          filled = 0;
        }
      }
    }
    return;
  }
  if (warp >= p.ncol) return;                          // no column for this warp

  // ------------------------------------------------ consumer warp = column
  const int col = warp;
  const int kvl = col / p.hgc;
  const int hl0 = (hg0 + col % p.hgc) * kHeadsACol;   // first head of the column in its KV head
  const int units = p.hd / VE;                         // 16-byte units of one head's row
  const size_t head_off = (size_t)kvl * p.hd * isz;   // the KV head's row in a token's row
  float* pbuf = reinterpret_cast<float*>(smem + p.off_p) + col * kMaxStageTokens * kHeadsACol;
  const unsigned char* qcol = static_cast<const unsigned char*>(p.q) +
                              ((size_t)b * p.H + (size_t)(kv0 + kvl) * p.G + hl0) * p.hd * isz;
  // CUDA cores: lane group sub takes tokens sub + 4k, lane l8 units l8 + 8i,
  // q scaled in float32 for the 4 heads; lanes 2g, 2g+1 keep head g.
  const int sub = lane / kLaneGroup, l8 = lane % kLaneGroup;
  const unsigned gmask = 0xffu << (lane & 24);
  float qv[MMA ? 1 : kHeadsACol][MMA ? 1 : DPL];
  // Tensor cores: lane (tg, tq) = (lane/4, lane%4) holds q's B fragments
  // (head tg, dims 2tq, 2tq+1 and 2tq+8, 2tq+9 of each 16) as bf16 and
  // keeps heads 2tq, 2tq+1 of tokens tg and tg+8.
  const int tg = lane >> 2, tq = lane & 3;
  uint32_t qb[MMA ? KS : 1][2];
  if constexpr (MMA) {
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      qb[k][0] = qb[k][1] = 0u;
      if (k * 16 < p.hd && tg < kHeadsACol && hl0 + tg < p.G) {
        const unsigned char* q = qcol + (size_t)tg * p.hd * isz + (k * 16 + 2 * tq) * isz;
        qb[k][0] = *reinterpret_cast<const uint32_t*>(q);
        qb[k][1] = *reinterpret_cast<const uint32_t*>(q + 8 * isz);
      }
    }
  } else {
#pragma unroll
    for (int g = 0; g < kHeadsACol; ++g) {
#pragma unroll
      for (int i = 0; i < DPL; ++i) qv[g][i] = 0.f;
      if (hl0 + g >= p.G) continue;                    // a padding head: q = 0
#pragma unroll
      for (int i = 0; i < UPL; ++i) {
        const int u = l8 + kLaneGroup * i;
        if (u < units) widen(qcol + (size_t)g * p.hd * isz + u * 16, &qv[g][i * VE], T());
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) qv[g][i] *= p.scale;
    }
  }
  // P.V: lane holds units pu + 32j and every tsn-th token from tsb
  const int upl_pv = units < 32 ? units : 32;
  const int tsn = 32 / upl_pv;
  const int pu = lane % upl_pv, tsb = lane / upl_pv;
  const bool pv_on = tsb < tsn;
  float acc[kHeadsACol][PVU * VE];
#pragma unroll
  for (int g = 0; g < kHeadsACol; ++g)
#pragma unroll
    for (int e = 0; e < PVU * VE; ++e) acc[g][e] = 0.f;
  // the softmax state of the lane's heads: (lane%8)/2 on CUDA cores; 2tq
  // and 2tq+1 on tensor cores
  float m_run[2] = {kMasked, kMasked}, l_run[2] = {0.f, 0.f};

  for (int i = 0; i < n_stages; ++i) {
    const int r = i % p.ns;
    const int n = min(p.tt, nw - i * p.tt);
    mbar_wait(&full[r], (i / p.ns) & 1);
    const unsigned char* sk = ring + r * stage_bytes + head_off;
    const unsigned char* sv = sk + p.tt * p.srow;
    if (kMath) {
      float cg[kHeadsACol];                            // each head's rescale this tile
      if constexpr (MMA) {
        // logits of the 16 tokens x 8 heads (4 of them padding) on tensor
        // cores, scaled afterwards in float32
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        if (!uniform) {
          const uint32_t a_addr = smem_u32(sk) +
                                  ((lane & 7) + 8 * ((lane >> 3) & 1)) * p.srow + (lane >> 4) * 16;
#pragma unroll
          for (int k = 0; k < KS; ++k) {
            if (k * 16 >= p.hd) break;
            uint32_t a[4];
            ldmatrix_x4(a_addr + k * 32, a);
            mma_bf16(c, a, qb[k][0], qb[k][1]);
          }
        }
        // [token tg or tg+8][head 2tq or 2tq+1]
        float sv2[2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            sv2[j][h] = tg + 8 * j < n ? (uniform ? 0.f : c[2 * j + h] * p.scale) : kMasked;
        float cr[2];
        __syncwarp();                                  // the last tile's P.V has read pbuf
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mt = fmaxf(sv2[0][h], sv2[1][h]);
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 8));
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 16));
          const float m_new = fmaxf(m_run[h], mt);
          cr[h] = expf(m_run[h] - m_new);
          float ps = 0.f;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (tg + 8 * j >= n) continue;
            const float pj = expf(sv2[j][h] - m_new);
            if (tq < 2) pbuf[(tg + 8 * j) * kHeadsACol + 2 * tq + h] = pj;
            ps += pj;
          }
          ps += __shfl_xor_sync(0xffffffffu, ps, 4);
          ps += __shfl_xor_sync(0xffffffffu, ps, 8);
          ps += __shfl_xor_sync(0xffffffffu, ps, 16);
          l_run[h] = fmaf(l_run[h], cr[h], ps);
          m_run[h] = m_new;
        }
#pragma unroll
        for (int g = 0; g < kHeadsACol; ++g) cg[g] = __shfl_sync(0xffffffffu, cr[g & 1], g >> 1);
      } else {
        // logits: s[k] is head l8/2's logit of token sub + 4k
        float s[kTokensAGroup];
#pragma unroll
        for (int k = 0; k < kTokensAGroup; ++k) {
          const int t = sub + 4 * k;
          s[k] = kMasked;
          if (t >= n) continue;
          if (uniform) {
            s[k] = 0.f;
            continue;
          }
          float kf[DPL];
#pragma unroll
          for (int u = 0; u < UPL; ++u) {
            if (l8 + kLaneGroup * u < units)
              widen(sk + t * p.srow + (l8 + kLaneGroup * u) * 16, &kf[u * VE], T());
            else
#pragma unroll
              for (int e = 0; e < VE; ++e) kf[u * VE + e] = 0.f;
          }
          float d[kHeadsACol];
#pragma unroll
          for (int g = 0; g < kHeadsACol; ++g) {
            d[g] = 0.f;
#pragma unroll
            for (int e = 0; e < DPL; ++e) d[g] = fmaf(qv[g][e], kf[e], d[g]);
          }
          // reduce-scatter over the 8 lanes: lanes 2g, 2g+1 end with head g
          const bool hi = l8 & 4;
          const float w0 = (hi ? d[2] : d[0]) + __shfl_xor_sync(gmask, hi ? d[0] : d[2], 4);
          const float w1 = (hi ? d[3] : d[1]) + __shfl_xor_sync(gmask, hi ? d[1] : d[3], 4);
          const bool odd = l8 & 2;
          const float x = (odd ? w1 : w0) + __shfl_xor_sync(gmask, odd ? w0 : w1, 2);
          s[k] = x + __shfl_xor_sync(gmask, x, 1);
        }
        // softmax by tiles: the tile's max of the lane's head, one rescale
        float mt = s[0];
#pragma unroll
        for (int k = 1; k < kTokensAGroup; ++k) mt = fmaxf(mt, s[k]);
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 8));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 16));
        const float m_new = fmaxf(m_run[0], mt);
        const float corr = expf(m_run[0] - m_new);
        __syncwarp();                                  // the last tile's P.V has read pbuf
        float ps = 0.f;
#pragma unroll
        for (int k = 0; k < kTokensAGroup; ++k) {
          const int t = sub + 4 * k;
          if ((k & 1) != (l8 & 1) || t >= n) continue;  // lanes 2g, 2g+1 split the tokens
          const float pk = expf(s[k] - m_new);
          pbuf[t * kHeadsACol + (l8 >> 1)] = pk;
          ps += pk;
        }
        ps += __shfl_xor_sync(0xffffffffu, ps, 1);
        ps += __shfl_xor_sync(0xffffffffu, ps, 8);
        ps += __shfl_xor_sync(0xffffffffu, ps, 16);
        l_run[0] = fmaf(l_run[0], corr, ps);
        m_run[0] = m_new;
#pragma unroll
        for (int g = 0; g < kHeadsACol; ++g) cg[g] = __shfl_sync(0xffffffffu, corr, 2 * g);
      }
      __syncwarp();                                    // pbuf holds the tile's p
      // P.V: one rescale a tile, then the tile's tokens
      if (pv_on) {
#pragma unroll
        for (int g = 0; g < kHeadsACol; ++g)
#pragma unroll
          for (int e = 0; e < PVU * VE; ++e) acc[g][e] *= cg[g];
        for (int t = tsb; t < n; t += tsn) {
          const float4 p4 = *reinterpret_cast<const float4*>(pbuf + t * kHeadsACol);
          const float pw[kHeadsACol] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int j = 0; j < PVU; ++j) {
            if (pu + 32 * j >= units) break;
            float vf[VE];
            widen(sv + t * p.srow + (pu + 32 * j) * 16, vf, T());
#pragma unroll
            for (int g = 0; g < kHeadsACol; ++g)
#pragma unroll
              for (int e = 0; e < VE; ++e) acc[g][j * VE + e] = fmaf(pw[g], vf[e], acc[g][j * VE + e]);
          }
        }
      }
    }
    mbar_arrive(&empty[r]);
  }

  // Write the split's unnormalised state: (m, l) from the lanes that keep
  // each head, acc summed over the lanes of each unit.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool keeps = MMA ? lane < 2 : (lane < 2 * kHeadsACol && !(lane & 1) && h == 0);
    const int g = MMA ? 2 * lane + h : lane >> 1;
    if (keeps && hl0 + g < p.G) {
      const long long cell = ws_cell(p, b, kv0 + kvl, hl0 + g, split);
      p.ws[cell] = m_run[h];
      p.ws[p.cells + cell] = l_run[h];
    }
  }
  if (tsn > 1) {
    float part[kHeadsACol][PVU * VE];                  // this lane's own tokens
#pragma unroll
    for (int g = 0; g < kHeadsACol; ++g)
#pragma unroll
      for (int e = 0; e < PVU * VE; ++e) part[g][e] = acc[g][e];
    for (int k = 1; k < tsn; ++k) {
#pragma unroll
      for (int g = 0; g < kHeadsACol; ++g)
#pragma unroll
        for (int e = 0; e < PVU * VE; ++e)
          acc[g][e] += __shfl_sync(0xffffffffu, part[g][e], (lane + k * upl_pv) & 31);
    }
  }
  if (tsb == 0) {
#pragma unroll
    for (int g = 0; g < kHeadsACol; ++g) {
      if (hl0 + g >= p.G) break;
      const long long cell = ws_cell(p, b, kv0 + kvl, hl0 + g, split);
      float* dst = p.ws + 2 * p.cells + cell * p.hd;
#pragma unroll
      for (int j = 0; j < PVU; ++j) {
        if (pu + 32 * j >= units) break;
#pragma unroll
        for (int e = 0; e < VE; ++e) dst[(pu + 32 * j) * VE + e] = acc[g][j * VE + e];
      }
    }
  }
}

// One CTA per workspace row (b, kvh, chunk): the S splits of its ng query
// heads, combined in split order.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
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
  for (int idx = threadIdx.x; idx < ng * hd; idx += kCombineThreads) {
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

// The workspace's head chunks: at most 8 query heads of one KV head a row.
struct Geometry {
  int ctas_per_kv, heads_per_cta, gp;
};

Geometry geometry(int H, int KV) {
  Geometry g;
  const int G = H / KV;
  g.ctas_per_kv = (G + kMaxHeadsPerChunk - 1) / kMaxHeadsPerChunk;
  g.heads_per_cta = (G + g.ctas_per_kv - 1) / g.ctas_per_kv;
  g.gp = g.heads_per_cta <= 1 ? 1 : g.heads_per_cta <= 2 ? 2 : g.heads_per_cta <= 4 ? 4 : 8;
  return g;
}

bool valid_shapes(int B, int H, int KV, int hd, int S) {
  if (B < 1 || KV < 1 || H < KV || H % KV || hd < 8 || hd > kMaxHeadDim || hd % 8 || S < 1)
    return false;
  return (long long)B * KV * geometry(H, KV).ctas_per_kv * S <= 0x7fffffffLL;
}

// The partial kernel's shared memory for a plan, with its offsets; -1 for a
// plan the kernel does not take. Kept equal to kernel.py::smem_bytes.
long long smem_layout(int isz, int H, int KV, int hd, int kvc, int hgc, int tt, int ns,
                      int* off_p, int* off_bar) {
  const int G = H / KV;
  const int hgs = (G + kHeadsACol - 1) / kHeadsACol;
  if (kvc < 1 || KV % kvc || hgc < 1 || hgs % hgc || kvc * hgc > kConsumerWarps || tt < 1 ||
      tt > kMaxStageTokens || ns < kMinStages)
    return -1;
  const long long ring = (long long)ns * 2 * tt * ((long long)kvc * hd * isz + 16);
  const long long p_at = ring;                             // a p buffer a consumer warp
  const long long bar_at = p_at + (long long)kConsumerWarps * kMaxStageTokens * kHeadsACol * 4;
  const long long bytes = bar_at + 2LL * ns * 8;
  if (bytes > kMaxSmem) return -1;
  if (off_p) {
    *off_p = (int)p_at;
    *off_bar = (int)bar_at;
  }
  return bytes;
}

template <typename T, int UPL, bool MMA>
cudaError_t launch(const Params& p, int B, void* out, int smem, const Geometry& g,
                   cudaStream_t s) {
  auto kern = paged_partial<T, UPL, MMA>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)((long long)B * p.ctas_per_seq * p.S), kThreads, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned rows = (unsigned)B * p.KV * g.ctas_per_kv;
  paged_combine<T><<<rows, kCombineThreads, 0, s>>>(p.ws, static_cast<T*>(out), p.H, p.KV,
                                                    p.hd, p.S, g.gp, g.heads_per_cta,
                                                    g.ctas_per_kv);
  return cudaGetLastError();
}

// The instance for hd: tensor cores for the logits in bf16 where a stage
// is 16 tokens and hd a multiple of 16, CUDA cores otherwise.
template <typename T>
cudaError_t launch_upl(const Params& p, int B, void* out, int smem, const Geometry& g,
                       cudaStream_t s) {
  const int units = p.hd * (int)sizeof(T) / 16;
  const int upl = (units + kLaneGroup - 1) / kLaneGroup;
  if constexpr (sizeof(T) == 2) {
    if (p.tt == kMaxStageTokens && p.hd % 16 == 0) {
      if (upl <= 1) return launch<T, 1, true>(p, B, out, smem, g, s);
      if (upl <= 2) return launch<T, 2, true>(p, B, out, smem, g, s);
      if (upl <= 4) return launch<T, 4, true>(p, B, out, smem, g, s);
    }
  }
  if (upl <= 1) return launch<T, 1, false>(p, B, out, smem, g, s);
  if (upl <= 2) return launch<T, 2, false>(p, B, out, smem, g, s);
  if (upl <= 4) return launch<T, 4, false>(p, B, out, smem, g, s);
  if constexpr (sizeof(T) == 4) {
    if (upl <= 8) return launch<T, 8, false>(p, B, out, smem, g, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Floats of the workspace for S splits: (m, l) [rows, S, GP] each and acc
// [rows, S, GP, hd], rows = B*KV*chunks; -1 for shapes the kernel refuses.
extern "C" long long pa_workspace_floats(int B, int H, int KV, int hd, int S) {
  if (!valid_shapes(B, H, KV, hd, S)) return -1;
  const Geometry g = geometry(H, KV);
  return (long long)B * KV * g.ctas_per_kv * S * g.gp * (hd + 2);
}

// Dynamic shared memory of paged_partial for a plan (dtype 0 float32, 1
// bfloat16); -1 for a plan it does not take.
extern "C" long long pa_smem_bytes(int dtype, int H, int KV, int hd, int kvc, int hgc, int tt,
                                   int ns) {
  if (dtype < 0 || dtype > 1 || KV < 1 || H < KV || H % KV || hd < 8 || hd > kMaxHeadDim ||
      hd % 8)
    return -1;
  return smem_layout(dtype ? 2 : 4, H, KV, hd, kvc, hgc, tt, ns, nullptr, nullptr);
}

// dtype: 0 float32, 1 bfloat16 (q, K, V and out all of it). The caller
// checks shapes, contiguity and 16-byte alignment, and passes the plan of
// kernel.py::plan: zps zones a split and S = ceil(MZ / zps) splits, kvc KV
// heads and hgc columns of 4 query heads a CTA, tt tokens a stage and ns
// stages; a float32 workspace of pa_workspace_floats(B, H, KV, hd, S) and
// scale = hd**-0.5 in float32.
extern "C" int pa_paged_attention(int dtype, const void* q, const void* k, const void* v,
                                  const void* zone_table, const void* lengths, void* out,
                                  void* workspace, int B, int H, int KV, int hd, int NZ, int ZL,
                                  int MZ, int zps, int S, int kvc, int hgc, int tt, int ns,
                                  float scale, void* stream) {
  if (dtype < 0 || dtype > 1 || !valid_shapes(B, H, KV, hd, S) || NZ < 1 || ZL < 1 || MZ < 1 ||
      zps < 1 || (long long)MZ * ZL > 0x7fffffffLL || S != ((long long)MZ + zps - 1) / zps)
    return cudaErrorInvalidValue;
  const int isz = dtype ? 2 : 4;
  Params p;
  const long long smem = smem_layout(isz, H, KV, hd, kvc, hgc, tt, ns, &p.off_p, &p.off_bar);
  const Geometry g = geometry(H, KV);
  p.G = H / KV;
  p.hgs = (p.G + kHeadsACol - 1) / kHeadsACol;
  p.ctas_per_seq = (KV / (kvc > 0 ? kvc : 1)) * (p.hgs / (hgc > 0 ? hgc : 1));
  if (smem < 0 || (long long)B * p.ctas_per_seq * S > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.q = q;
  p.k = k;
  p.v = v;
  p.tab = static_cast<const int*>(zone_table);
  p.lens = static_cast<const int*>(lengths);
  p.ws = static_cast<float*>(workspace);
  p.cells = (long long)B * KV * g.ctas_per_kv * S * g.gp;
  p.H = H; p.KV = KV; p.hd = hd; p.NZ = NZ; p.ZL = ZL; p.MZ = MZ; p.zps = zps; p.S = S;
  p.kvc = kvc; p.hgc = hgc; p.ncol = kvc * hgc;
  p.tt = tt; p.ns = ns; p.row_bytes = kvc * hd * isz; p.srow = p.row_bytes + 16;
  p.cpk = g.ctas_per_kv; p.hpc = g.heads_per_cta; p.gp = g.gp;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_upl<float>(p, B, out, (int)smem, g, s);
  return launch_upl<__nv_bfloat16>(p, B, out, (int)smem, g, s);
}
