// Paged decode attention for Hopper: one query token per row attends over a
// KV cache scattered across a block pool through a block table.
//
// Replaces the Pallas kernel paged_attention_bkgh (_kernel) in
// src/repro/kernels/paged_attention/paged_attention.py: q (B, K, G, H) bf16;
// pools (num_blocks, bs, K, H) bf16, or int8 with (num_blocks, bs, K) f32
// scales (the product is that of the values with their scales multiplied
// in); block_tables (B, nb) int32; lengths (B,) int32. q scaled as it is
// loaded, q / sqrt(H) in bf16 by the root rounded to bf16 (the JAX package's
// `(q / jnp.sqrt(H)).astype(f32)` of its dense decode, whose weakly typed
// root takes q's dtype; its Pallas kernel scales S in f32), the
// tanh softcap before the mask, sliding window `pos > len - 1 - window`,
// finite -1e30 mask, online softmax, row sum clamped at 1e-37, blocks past
// `len` skipped, dead rows read the scratch block 0; out bf16 in q's layout.
//
// What bounds it on an H100. A decode step reads every live KV position
// once per kv head and does ~2 G flops per position and head value, far
// below the card's ~295 flop/byte ridge, so bytes bound it; at the serving
// shapes (4 rows of <= 256 positions, ~0.4 MB) the bytes take ~0.4 us and
// the chain of dependent latencies (lengths and table -> copies -> products
// -> the split merge) sets the time. The design:
//
// - A grid that fills the card. Blocks are (split, kv head, row); `plan` in
//   kernels/paged_attention/ops.py cuts each row's chain into splits of
//   whole pool blocks so that the grid covers the SMs (at the serving shape
//   16 splits of one block: 256 blocks). A split whose chunk holds no live
//   position (past the row's length, or wholly outside the window) does no
//   work and records a partial that weighs exactly zero.
// - Copies in flight while a tile computes. A block's `warps` warps take the
//   chunk's live 16-position tiles round robin. Each warp owns a ring of
//   STAGES tiles in shared memory filled by 16-byte cp.async (a position's
//   stripe is H contiguous values, positions K * H apart; int8 codes stay
//   int8, their scale stripes beside them), so the copies of its next two
//   tiles are in flight while it computes one; a warp needs no block-wide
//   barrier until its chunk is done. The split's block-table entries are
//   read once, ahead of every copy.
// - GQA on the tensor cores. The G <= 8 query heads of the kv head are rows
//   0..G-1 of one m16 tile (rows G..15 zero): S = Q K^T and O += P V are
//   mma.sync.m16n8k16 bf16 -> f32, K and V fragments by ldmatrix (V
//   transposed) from rows padded to an odd number of 16-byte chunks, so
//   the 8 rows of a matrix hit 8 different banks. int8 codes convert to
//   bf16 exactly (two bit operations and one bf16x2 add a pair, mma.cuh),
//   reading int8 K with its k order permuted inside each 16-value step,
//   which Q's fragments follow; k_scale multiplies S column by column after
//   Q K^T and v_scale multiplies P before P V. At H 256 Q's fragments sit
//   in shared memory, which leaves O's fragments their registers (no
//   spills).
// - One instantiation per pool type and HMAX, H rounded up to 64, 128 or
//   256: ring rows are HMAX values wide, their columns past H zeroed once a
//   launch, so the products take HMAX / 16 steps with no test in the loop.
// - The online softmax on S's fragment in registers: a row's 16 scores of
//   a tile sit in one lane quad (two shuffles for the max); the mask and
//   softcap are per-element tests on the lane's 4 positions; exp is the
//   accurate expf of the plain version, on natural-log scores.
// - P to f32's precision. An output that the kernel and the plain version
//   compute apart by more than a few f32 ulps rounds to another bf16 value
//   whenever the two straddle a rounding boundary, and one bf16 ulp
//   exceeds the tolerances (2^-9 at |out| >= 0.25, which most rows reach,
//   against 1e-3 for bf16 pools; 2^-6 at |out| >= 2, which a dead row's
//   single value reaches, against 1e-2 for int8): P rounded to bf16 (2^-9)
//   or split in two (2^-16) flips such outputs. So P (with v_scale folded
//   in, for int8) is split into three bf16 parts, P to 2^-24, and P V is
//   three products, smallest first. They start from zero each tile, and
//   the tile's sum is added to O in f32, rounded to nearest: the tensor
//   core does not round its accumulation to nearest, and chaining O through
//   it over a long chain's tiles put the kernel further from the f64 result
//   than the plain version (PERF.md §6, PR 27). At HMAX 256 the registers
//   hold no tile sum without spilling, so O stays the accumulator there.
// - One launch, bit-identical repeats. The live warps of a block meet in
//   shared memory, combined in warp order. With one split the block writes
//   bf16;
//   otherwise it writes its partial to the workspace, fences, and counts
//   itself in at a per-(row, kv head) counter; the last block to arrive
//   merges every split's partial, max-rebased, in split order (their loads
//   in flight a batch at a time), writes bf16 and resets the counter for
//   the next launch.
//
// Launches on the caller's stream and allocates nothing; the wrapper
// (kernels/paged_attention/ops.py) owns the output, the workspace and the
// counters, and `plan` there picks the split and the warps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "wgmma.cuh"

namespace {

// a / d rounded to nearest in f32, from rcp = 1 / d rounded to nearest: the
// product's remainder by one FMA, corrected by another (Markstein), three
// instructions where the IEEE division is a call
__device__ __forceinline__ float div_rn(float a, float d, float rcp) {
  const float q = a * rcp;
  return fmaf(fmaf(-q, d, a), rcp, q);
}

// a pair of bf16 q values divided by q_div, each quotient rounded to bf16
__device__ __forceinline__ uint32_t scale_q2(uint32_t w, float q_div,
                                             float q_rcp) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
  __nv_bfloat162 r = __floats2bfloat162_rn(div_rn(f.x, q_div, q_rcp),
                                           div_rn(f.y, q_div, q_rcp));
  return *reinterpret_cast<uint32_t*>(&r);
}

// a fragment's four q values scaled (the halves' order does not matter)
__device__ __forceinline__ uint2 scale_q4(uint2 a, float q_div, float q_rcp) {
  return make_uint2(scale_q2(a.x, q_div, q_rcp), scale_q2(a.y, q_div, q_rcp));
}

using bf16 = __nv_bfloat16;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 16;            // positions a warp takes at a time
constexpr int STAGES = 3;           // tiles in a warp's ring
constexpr int G_MAX = 8;            // query heads per kv head: rows of m16
constexpr int MERGE_BATCH = 16;     // partials a merging thread loads at once
constexpr int SMEM_MAX = 222 * 1024;  // dynamic shared memory of a block
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const bf16* q;
  const uint8_t* k_pool;
  const uint8_t* v_pool;
  const float* k_scale;         // null for bf16 pools
  const float* v_scale;
  const int* block_tables;
  const int* lengths;
  float* ws_acc;                // (B * K * splits, G, H) partial sums
  float* ws_ml;                 // (B * K * splits, G, 2): max, sum
  unsigned* counters;           // (B * K) arrivals, zero between launches
  bf16* out;
  int K, G, H, bs, nb, splits, bps, warps;
  int row_bytes, pitch, stage_bytes;
  float q_div, q_rcp, cap;      // bf16(sqrt(H)), its reciprocal; softcap
  int window;
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ float lo_f32(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float hi_f32(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

__device__ __forceinline__ void axpy4(float4& a, float w, const float4& v) {
  a.x += w * v.x;
  a.y += w * v.y;
  a.z += w * v.z;
  a.w += w * v.w;
}

// a / l as 4 bf16 at out (8-byte aligned)
__device__ __forceinline__ void store_out(bf16* out, const float4& a,
                                          float l) {
  const float r = 1.f / fmaxf(l, 1e-37f);
  *reinterpret_cast<uint2*>(out) =
      make_uint2(pack_bf16x2(a.x * r, a.y * r), pack_bf16x2(a.z * r, a.w * r));
}

// HMAX: H rounded up to 64, 128 or 256. The products always take HMAX / 16
// steps: a ring row is HMAX values wide, and its columns past H hold zeros,
// which meet zero Q columns in S and make O columns that are never stored.
// Lane (g, qd) = (lane / 4, lane % 4) holds row g of the m16
// fragments: S columns 8 nt + 2 qd + e (nt, e in {0, 1}) and O columns
// 8 n + 2 qd + e of n8 tile n (bf16 V), or 16 k + 4 qd + 0..3 of 16-column
// step k (int8 V, whose n8 tiles are the even and the odd columns).
template <bool INT8, int HMAX>
__global__ void __launch_bounds__(THREADS)
    paged_decode_kernel(const Params p) {
  constexpr int KS = HMAX / 16;   // 16-column steps of Q K^T and of P V
  constexpr int NT = HMAX / 8;    // n8 tiles of O
  constexpr int PARTS = 3;                 // bf16 parts of P
  constexpr bool Q_SMEM = HMAX >= 256;     // Q's fragments in shared memory
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float m_w[WARPS][G_MAX], l_w[WARPS][G_MAX];
  __shared__ int last;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int G = p.G, H = p.H, bs = p.bs, ks_n = H >> 4;
  const size_t pair = (size_t)b * p.K + kh;
  const size_t part = pair * p.splits + split;
  // 0. zero the warp's ring rows past H, once, while few registers are live
  // (later in the kernel it pushed bf16 HMAX 256 into spills)
  if (H < HMAX && warp < p.warps) {
    const int pad = (HMAX * (INT8 ? 1 : 2) - p.row_bytes) >> 4;  // chunks
    uint8_t* ring = smem + warp * STAGES * p.stage_bytes;
    for (int e = lane; e < STAGES * 2 * TILE * pad; e += 32) {
      const int r = e / pad;  // row of the ring: stage r / 32, K then V
      *reinterpret_cast<uint4*>(ring + (r / (2 * TILE)) * p.stage_bytes +
                                (r % (2 * TILE)) * p.pitch + p.row_bytes +
                                16 * (e - r * pad)) = make_uint4(0, 0, 0, 0);
    }
  }

  // 1. the split's chunk of the chain: its table entries, and the tiles
  // that hold live positions
  const int j0 = split * p.bps, j1 = min(p.nb, j0 + p.bps);
  int* bt_s = reinterpret_cast<int*>(smem + p.warps * STAGES * p.stage_bytes);
  for (int i = tid; i < j1 - j0; i += THREADS)
    bt_s[i] = __ldg(p.block_tables + (size_t)b * p.nb + j0 + i);
  const int len = __ldg(p.lengths + b);
  const int lo = p.window > 0 ? max(0, len - p.window) : 0;
  const int first = max(j0 * bs, lo), end = min(j1 * bs, len);
  const int t0 = first / TILE;
  const int ntiles = end > first ? (end + TILE - 1) / TILE - t0 : 0;
  const int mine = warp < p.warps && ntiles > warp
                       ? (ntiles - warp + p.warps - 1) / p.warps
                       : 0;

  // Q's A fragments (a0, a2: row g of each k step; rows 8..15 are zero), in
  // registers, or at H 256 in shared memory (written by warp 0; the same
  // for every warp), which leaves the O fragments their registers; scaled
  // once the ring's first copies are in flight, so that the wait for the
  // q loads overlaps theirs
  __shared__ uint2 q_s[Q_SMEM ? KS : 1][32];
  uint2 qa[Q_SMEM ? 1 : KS];
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    uint2 a = make_uint2(0u, 0u);
    if (k < ks_n && g < G) {
      const bf16* qr = p.q + (pair * G + g) * H + 16 * k;
      if (INT8) {  // k order permuted as the int8 K fragments are:
        // columns 4qd and 4qd + 2, then 4qd + 1 and 4qd + 3
        const uint2 v = *reinterpret_cast<const uint2*>(qr + 4 * qd);
        a = make_uint2(__byte_perm(v.x, v.y, 0x5410),
                       __byte_perm(v.x, v.y, 0x7632));
      } else {
        a = make_uint2(*reinterpret_cast<const uint32_t*>(qr + 2 * qd),
                       *reinterpret_cast<const uint32_t*>(qr + 8 + 2 * qd));
      }
    }
    if constexpr (Q_SMEM) {
      if (warp == 0) q_s[k][lane] = a;
    } else {
      qa[k] = a;
    }
  }
  __syncthreads();  // bt_s

  // 2. the warp's tiles t0 + warp + i * warps through its ring. Chunk
  // e = lane + 32 i of a tile's copy is position e / cpr, 16-byte column
  // e % cpr of the stripes: the lane's pool and ring offsets step by fixed
  // amounts, with one wrap when the column passes the stripe's end.
  uint8_t* ring = smem + warp * STAGES * p.stage_bytes;
  const int cpr = p.row_bytes >> 4;
  const int r0 = lane / cpr, c0 = lane - r0 * cpr, c_step = 32 % cpr;
  const size_t pos_bytes = (size_t)p.K * p.row_bytes;
  const size_t src_first = r0 * pos_bytes + 16 * c0;
  const size_t src_step = (32 / cpr) * pos_bytes + 16 * c_step;
  const size_t src_wrap = pos_bytes - 16 * cpr;
  const int dst_first = r0 * p.pitch + 16 * c0;
  const int dst_step = (32 / cpr) * p.pitch + 16 * c_step;
  const int dst_wrap = p.pitch - 16 * cpr;
  const int tpb = bs / TILE;  // tiles of a pool block
  // the next tile to copy: chain block jt, tile ot of it
  int jt = (t0 + warp) / tpb, ot = (t0 + warp) % tpb;
  auto issue = [&](int i) {
    if (i < mine) {
      const size_t row0 = (size_t)bt_s[jt - j0] * bs + ot * TILE;
      size_t src = (row0 * p.K + kh) * p.row_bytes + src_first;
      uint8_t* st = ring + (i % STAGES) * p.stage_bytes;
      int dst = dst_first, c = c0;
      for (int e = lane; e < TILE * cpr; e += 32) {
        cp_async16(st + dst, p.k_pool + src, true);
        cp_async16(st + TILE * p.pitch + dst, p.v_pool + src, true);
        src += src_step;
        dst += dst_step;
        c += c_step;
        if (c >= cpr) {
          c -= cpr;
          src += src_wrap;
          dst += dst_wrap;
        }
      }
      if (INT8)  // k scales of the 16 positions, then v scales
        cp_async4(st + 2 * TILE * p.pitch + 4 * lane,
                  (lane < TILE ? p.k_scale : p.v_scale) +
                      (row0 + (lane & 15)) * p.K + kh);
      for (ot += p.warps; ot >= tpb; ot -= tpb) ++jt;
    }
    cp_async_commit();
  };

  float acc[NT][2];  // O's rows 0..7 (m16 rows 8..15 are zero)
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = 0.f;
  float m_run = NEG_INF, lsum = 0.f;  // row g: running max, lane's sum

#pragma unroll 1
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  if constexpr (Q_SMEM) {
    if (warp == 0) {
#pragma unroll
      for (int k = 0; k < KS; ++k)
        q_s[k][lane] = scale_q4(q_s[k][lane], p.q_div, p.q_rcp);
    }
    __syncthreads();  // q_s scaled
  } else {
#pragma unroll
    for (int k = 0; k < KS; ++k) qa[k] = scale_q4(qa[k], p.q_div, p.q_rcp);
  }
#pragma unroll 1
  for (int i = 0; i < mine; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncwarp();
    issue(i + STAGES - 1);  // into the slot tile i - 1 used
    const uint8_t* kt = ring + (i % STAGES) * p.stage_bytes;
    const uint8_t* vt = kt + TILE * p.pitch;
    const float* kscale = reinterpret_cast<const float*>(vt + TILE * p.pitch);
    const int pos0 = (t0 + warp + i * p.warps) * TILE;

    // S = Q K^T: n8 tile nt holds positions 8 nt .. 8 nt + 7
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      uint32_t kb[2][2];
      if (INT8) {  // 4 codes (columns 16k + 4qd ..) of position 8nt + g
        uint32_t r[2];
        ldsm_x2(r, kt + (lane & 15) * p.pitch + 16 * k);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          kb[nt][0] = s8x2_bf16(r[nt]);
          kb[nt][1] = s8x2_bf16(r[nt] >> 8);
        }
      } else {
        uint32_t r[4];
        ldsm_x4(r, kt + (8 * (lane >> 4) + (lane & 7)) * p.pitch + 32 * k +
                       16 * ((lane >> 3) & 1));
        kb[0][0] = r[0];
        kb[0][1] = r[1];
        kb[1][0] = r[2];
        kb[1][1] = r[3];
      }
      uint2 qf;
      if constexpr (Q_SMEM) {
        qf = q_s[k][lane];
      } else {
        qf = qa[k];
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        mma_bf16(s[nt], qf.x, 0u, qf.y, 0u, kb[nt][0], kb[nt][1]);
    }

    // online softmax of row g over the tile's 16 positions
    float x[2][2], mt = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * nt + 2 * qd + e, pos = pos0 + c;
        float v = s[nt][e];
        if (INT8) v *= kscale[c];
        if (p.cap > 0.f) v = tanhf(v / p.cap) * p.cap;
        v = (pos < len && pos >= lo) ? v : NEG_INF;
        x[nt][e] = v;
        mt = fmaxf(mt, v);
      }
    mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 2));
    const float mn = fmaxf(m_run, mt);
    const float alpha = expf(m_run - mn);
    m_run = mn;
    float pr[2][2], ps = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        pr[nt][e] = expf(x[nt][e] - mn);
        ps += pr[nt][e];
      }
    lsum = lsum * alpha + ps;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha;
      acc[n][1] *= alpha;
    }

    // P's A fragments: positions 2qd, 2qd + 1 (a0) and 8 + 2qd, 9 + 2qd
    // (a2), as PARTS bf16 parts: P to 2^-24, as f32 holds it
    uint32_t pp[PARTS][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float p0 = pr[nt][0], p1 = pr[nt][1];
      if (INT8) {
        p0 *= kscale[TILE + 8 * nt + 2 * qd];
        p1 *= kscale[TILE + 8 * nt + 2 * qd + 1];
      }
#pragma unroll
      for (int part = 0; part < PARTS; ++part) {
        pp[part][nt] = pack_bf16x2(p0, p1);
        p0 -= lo_f32(pp[part][nt]);
        p1 -= hi_f32(pp[part][nt]);
      }
    }

    // O += P V, 16 columns a step: the tile's P V from zero (P's parts
    // smallest first), then added to O in f32
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      uint32_t vb[2][2];  // n8 tiles 2k and 2k + 1: b0, b1
      if (INT8) {  // tile 2k: columns 16k + 2g; tile 2k + 1: 16k + 2g + 1
        uint32_t r[2];
        ldsm_x2_t(r, vt + (lane & 15) * p.pitch + 16 * k);
        vb[0][0] = s8x2_bf16(r[0]);
        vb[0][1] = s8x2_bf16(r[1]);
        vb[1][0] = s8x2_bf16(r[0] >> 8);
        vb[1][1] = s8x2_bf16(r[1] >> 8);
      } else {
        uint32_t r[4];
        ldsm_x4_t(r, vt + (8 * ((lane >> 3) & 1) + (lane & 7)) * p.pitch +
                         32 * k + 16 * (lane >> 4));
        vb[0][0] = r[0];
        vb[0][1] = r[1];
        vb[1][0] = r[2];
        vb[1][1] = r[3];
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (Q_SMEM) {  // no registers for a tile sum: chained
          d[0] = acc[2 * k + t][0];
          d[1] = acc[2 * k + t][1];
        }
#pragma unroll
        for (int part = PARTS - 1; part >= 0; --part)
          mma_bf16(d, pp[part][0], 0u, pp[part][1], 0u, vb[t][0], vb[t][1]);
        if constexpr (Q_SMEM) {
          acc[2 * k + t][0] = d[0];
          acc[2 * k + t][1] = d[1];
        } else {
          acc[2 * k + t][0] += d[0];
          acc[2 * k + t][1] += d[1];
        }
      }
    }
  }
  cp_async_wait<0>();

  // 3. the block's state: one live warp holds it in registers; more meet
  // in shared memory (over the rings), combined in warp order
  lsum += __shfl_xor_sync(FULL, lsum, 1);
  lsum += __shfl_xor_sync(FULL, lsum, 2);
  const int live = min(p.warps, ntiles);
  const int quads = G * H / 4;
  // the lane's row-g values as column pairs (column, v0, v1)
  auto row_pairs = [&](auto&& f) {
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      if (k >= ks_n) continue;
      if (INT8) {
        f(16 * k + 4 * qd, acc[2 * k][0], acc[2 * k + 1][0]);
        f(16 * k + 4 * qd + 2, acc[2 * k][1], acc[2 * k + 1][1]);
      } else {
        f(16 * k + 2 * qd, acc[2 * k][0], acc[2 * k][1]);
        f(16 * k + 8 + 2 * qd, acc[2 * k + 1][0], acc[2 * k + 1][1]);
      }
    }
  };
  if (live == 1) {
    if (warp == 0 && g < G) {
      if (p.splits == 1) {
        bf16* o = p.out + (pair * G + g) * H;
        const float r = 1.f / fmaxf(lsum, 1e-37f);
        row_pairs([&](int c, float v0, float v1) {
          *reinterpret_cast<uint32_t*>(o + c) = pack_bf16x2(v0 * r, v1 * r);
        });
      } else {
        float* o = p.ws_acc + (part * G + g) * H;
        row_pairs([&](int c, float v0, float v1) {
          __stcg(reinterpret_cast<float2*>(o + c), make_float2(v0, v1));
        });
        if (qd == 0)
          __stcg(reinterpret_cast<float2*>(p.ws_ml + (part * G + g) * 2),
                 make_float2(m_run, lsum));
      }
    }
  } else {
    float* red = reinterpret_cast<float*>(smem);  // [warp][g][H]
    if (live > 1) {
      __syncthreads();  // every warp is done with its ring
      if (warp < live && g < G) {
        float* row = red + (warp * G + g) * H;
        row_pairs([&](int c, float v0, float v1) {
          *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
        });
        if (qd == 0) {
          m_w[warp][g] = m_run;
          l_w[warp][g] = lsum;
        }
      }
      __syncthreads();
    }
    // a dead split (live == 0) records m = -1e30, l = 0, acc = 0
    for (int e = tid; e < quads; e += THREADS) {
      const int gg = 4 * e / H, h = 4 * e - gg * H;
      float mb = NEG_INF;
      for (int w = 0; w < live; ++w) mb = fmaxf(mb, m_w[w][gg]);
      float lb = 0.f;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int w = 0; w < live; ++w) {
        const float wt = expf(m_w[w][gg] - mb);
        lb += wt * l_w[w][gg];
        axpy4(a, wt,
              *reinterpret_cast<const float4*>(red + (w * G + gg) * H + h));
      }
      if (p.splits == 1) {
        store_out(p.out + (pair * G + gg) * H + h, a, lb);
      } else {
        __stcg(reinterpret_cast<float4*>(p.ws_acc + (part * G + gg) * H + h),
               a);
        if (h == 0)
          __stcg(reinterpret_cast<float2*>(p.ws_ml + (part * G + gg) * 2),
                 make_float2(mb, lb));
      }
    }
  }
  if (p.splits == 1) return;

  // 4. the last block of this (row, kv head) to arrive merges the splits'
  // partials in split order, whichever block it is
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(p.counters + pair, 1u) == (unsigned)(p.splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* ml = p.ws_ml + pair * p.splits * G * 2;
  const float* pa = p.ws_acc + pair * p.splits * G * H;
  for (int e = tid; e < quads; e += THREADS) {
    const int gg = 4 * e / H, h = 4 * e - gg * H;
    float m = NEG_INF, l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < p.splits; s0 += MERGE_BATCH) {
      // a batch's loads all in flight at once; a dead split weighs 0
      float2 mlb[MERGE_BATCH];
      float4 ab[MERGE_BATCH];
#pragma unroll
      for (int j = 0; j < MERGE_BATCH; ++j) {
        if (s0 + j >= p.splits) continue;
        const int i = (s0 + j) * G + gg;
        mlb[j] = __ldcg(reinterpret_cast<const float2*>(ml + 2 * i));
        ab[j] = __ldcg(reinterpret_cast<const float4*>(pa + i * H + h));
      }
      float mb = m;
#pragma unroll
      for (int j = 0; j < MERGE_BATCH; ++j)
        if (s0 + j < p.splits) mb = fmaxf(mb, mlb[j].x);
      const float r = expf(m - mb);
      l *= r;
      a = make_float4(a.x * r, a.y * r, a.z * r, a.w * r);
#pragma unroll
      for (int j = 0; j < MERGE_BATCH; ++j) {
        if (s0 + j >= p.splits) continue;
        const float wt = expf(mlb[j].x - mb);
        l += wt * mlb[j].y;
        axpy4(a, wt, ab[j]);
      }
      m = mb;
    }
    store_out(p.out + (pair * G + gg) * H + h, a, l);
  }
  if (tid == 0) p.counters[pair] = 0u;  // ready for the next launch
}

template <bool INT8, int HMAX>
int launch(const Params& p, dim3 grid, int smem, cudaStream_t stream) {
  static int granted = 0;
  static bool carved = false;
  auto kernel = paged_decode_kernel<INT8, HMAX>;
  if (!carved) {  // the most shared memory an SM has: more blocks
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (e != cudaSuccess) return (int)e;
    carved = true;
  }
  const int err = ensure_smem(kernel, smem, granted);
  if (err != 0) return err;
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// One launch. k_scale/v_scale null for bf16 pools. The chain is cut into
// splits of `bps` pool blocks (the last ragged); `warps` (1..4) warps of a
// block take its tiles. With more than one split, ws holds
// B * K * splits * G * (H + 2) floats and counters B * K zeroed ints (the
// kernel leaves them zeroed). Dynamic shared memory: warps * STAGES * stage
// + the split's table entries, stage = 2 * 16 * pitch (+ 128 for int8
// scales), pitch = the bytes of HMAX values (H rounded up to 64, 128 or 256)
// rounded to an odd count of 16 bytes.
extern "C" int paged_attention(const void* q, const void* k_pool,
                               const void* v_pool, const void* k_scale,
                               const void* v_scale, const void* block_tables,
                               const void* lengths, void* ws, void* counters,
                               void* out, int B, int K, int G, int H, int bs,
                               int nb, int bps, int warps, float cap,
                               int window, void* stream) {
  const bool int8 = k_scale != nullptr;
  if (B <= 0 || B > 65535 || K <= 0 || K > 65535 || G <= 0 || G > G_MAX ||
      H < 16 || H > 256 || H % 16 != 0 || bs < 16 || bs > 128 ||
      bs % 16 != 0 || nb <= 0 || bps <= 0 || bps > nb || warps < 1 ||
      warps > WARPS || warps * TILE > bps * bs || window < 0 ||
      (int8 && v_scale == nullptr) || !aligned16(q) || !aligned16(k_pool) ||
      !aligned16(v_pool) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const int splits = (nb + bps - 1) / bps;
  if (splits > 1 && (ws == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = reinterpret_cast<const bf16*>(q);
  p.k_pool = reinterpret_cast<const uint8_t*>(k_pool);
  p.v_pool = reinterpret_cast<const uint8_t*>(v_pool);
  p.k_scale = reinterpret_cast<const float*>(k_scale);
  p.v_scale = reinterpret_cast<const float*>(v_scale);
  p.block_tables = reinterpret_cast<const int*>(block_tables);
  p.lengths = reinterpret_cast<const int*>(lengths);
  p.ws_acc = reinterpret_cast<float*>(ws);
  p.ws_ml = splits > 1 ? p.ws_acc + (size_t)B * K * splits * G * H : nullptr;
  p.counters = reinterpret_cast<unsigned*>(counters);
  p.out = reinterpret_cast<bf16*>(out);
  p.K = K;
  p.G = G;
  p.H = H;
  p.bs = bs;
  p.nb = nb;
  p.splits = splits;
  p.bps = bps;
  p.warps = warps;
  p.row_bytes = H * (int8 ? 1 : 2);
  const int hmax = H <= 64 ? 64 : H <= 128 ? 128 : 256;
  p.pitch = 16 * ((hmax * (int8 ? 1 : 2) / 16) | 1);
  p.stage_bytes = 2 * TILE * p.pitch + (int8 ? 2 * TILE * 4 : 0);
  p.q_div = __bfloat162float(__float2bfloat16_rn(sqrtf((float)H)));
  p.q_rcp = 1.0f / p.q_div;
  p.cap = cap;
  p.window = window;
  const int smem = warps * STAGES * p.stage_bytes + 16 * ((4 * bps + 15) / 16);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid(splits, K, B);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (int8) {
    if (hmax == 64) return launch<true, 64>(p, grid, smem, st);
    if (hmax == 128) return launch<true, 128>(p, grid, smem, st);
    return launch<true, 256>(p, grid, smem, st);
  }
  if (hmax == 64) return launch<false, 64>(p, grid, smem, st);
  if (hmax == 128) return launch<false, 128>(p, grid, smem, st);
  return launch<false, 256>(p, grid, smem, st);
}
