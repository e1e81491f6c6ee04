// Tensor-core prefill attention for Hopper, in the model layout.
//
// Replaces the Pallas kernel flash_attention_bnh (_kernel) in
// src/repro/kernels/flash_attention/flash_attention.py: q (B, Sq, N, H),
// k/v (B, Skv, K, H) bf16 -> (B, Sq, N, H) bf16, with its semantics: scale
// 1/sqrt(H); optional softcap tanh(s / cap) * cap on the scaled score before
// the mask; causal mask q_pos >= k_pos at q_pos = q_offset + i; optional
// window q_pos - k_pos < window; a finite NEG_INF = -1e30 for masked scores
// (a row that a tile masks entirely weighs that tile's keys equally, as the
// reference does, and gives no NaN); online softmax in f32; the row sum
// clamped at 1e-37; KV tiles that the mask empties for every row of a
// block skipped. GQA reads kv head n / (N / K) with no copy.
//
// What bounds it on an H100. At the serving engine's prompt buckets (S 32 to
// 256, B <= 4, 28 x 128 heads) the work is a few hundred MFLOP and a few MB:
// the bound is the latency of one short launch, so the kernel must fill the
// card with blocks that each finish in a few microseconds. At long prompts
// (S in the thousands) it is the tensor cores: 4 S^2 N H / 2 flops (causal)
// against the bf16 rate.
//
// Design:
// - Both products on the tensor cores with wgmma (m64nNk16, f32
//   accumulators). A block is one warpgroup that owns 64 query rows of one
//   head and takes K/V tiles of 64 keys.
//   S = Q K^T reads Q (A) and the K tile (B) from shared memory, both
//   K-major. O += P V takes P as the register A operand: the S accumulator
//   after the online-softmax update, packed to bf16 in place (the wgmma D
//   fragment of a 16-column pair is the A fragment of a k16 step), and V as
//   an MN-major B operand (the transpose bit), so V needs no transpose.
// - Q, K and V sit in shared memory as bf16 in 64-column slabs of 128-byte
//   rows with the canonical 128-byte swizzle (wgmma.cuh), so the tensor
//   cores read without bank conflicts; the head dim is zero-padded to whole
//   slabs (H 16 and 112 included). K/V tiles arrive by 16-byte cp.async
//   copies in a ring of 3 stages, one tile ahead of its products. Q loads
//   once per block; rows past Skv are zero-filled.
// - A software pipeline: S_t = Q K_t^T and O += P_{t-1} V_{t-1} are issued
//   together, and the softmax of S_t runs while P V runs (at H 256 after
//   it: registers). The first tile's P V is of P = 0, so no wgmma sits in a
//   branch (ptxas serializes wgmmas that do).
// - Online softmax in registers: a thread holds two rows of S; the row max
//   is reduced across the 4 lanes that share a row by shuffles, the row sum
//   is kept per thread and reduced once at the end. log2(e) is folded into
//   the scale and exp2 runs on the special-function unit; O is rescaled
//   only when a row's max moved. The scaling (softcap or not) and the mask
//   (per-row column bounds) are chosen once a tile, so an unmasked tile pays
//   for neither.
// - Tiles past the diagonal (causal) or before the window are skipped for
//   the whole block. Blocks run the longest row tiles of every head first.
//   The G query heads of a kv head read its K/V tiles in separate blocks;
//   the re-reads hit L2 (packing a group's heads into a tile's rows measured
//   no faster at the serving buckets, PERF.md).
// - The output goes through shared memory (the Q tile's space) so that each
//   row leaves in 16-byte stores. No split over keys and no atomics: a
//   repeat launch gives equal bits.
//
// Numbers that differ from the Pallas kernel: Q K^T multiplies the bf16 q
// and k exactly (f32 accumulation) and applies the scale to the f32 score,
// where the Pallas kernel scaled q in f32 first; P enters P V as bf16 (the
// tensor cores' operand type), where the Pallas kernel kept it in f32; the
// row sum adds the f32 P. Both differences are within the one-ulp scale of
// a bf16 output.
//
// The launch runs on the caller's stream and allocates nothing.
// `flash_products` runs the two products alone on one tile, so that each
// can be checked against a plain matmul.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BK = 64;                  // keys a K/V tile
constexpr int SMEM_MAX = 227 * 1024;    // dynamic shared memory of a block

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  int B, Sq, Skv, N, K, H, G;
  int causal, window, q_offset;
  float cap, scale;
};

// Shared memory of a block: its 64 query rows (HP columns) and a ring of
// STAGES pairs of K/V tiles (BK x HP), all bf16. A tile loads
// AHEAD = STAGES - 2 tiles before its products: the ring also holds the
// tile whose V the pipeline still reads and the one being computed.
template <int HP>
struct Smem {
  static constexpr int STAGES = 3;
  static constexpr int AHEAD = STAGES - 2;
  static constexpr int Q = 64 * HP * 2;
  static constexpr int KV = BK * HP * 2;
  static constexpr int TOTAL = Q + STAGES * 2 * KV;
};

// Byte offset of 16-byte chunk c (of HP / 8) of row r in a tile of ROWS
// rows: 64-column slabs of ROWS swizzled 128-byte rows.
template <int ROWS>
__device__ __forceinline__ int tile_off(int r, int c) {
  return (c >> 3) * (ROWS * 128) + sw128(r, c & 7);
}

// 2^x on the special-function unit (2 ulp; 0 for x below -126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ROWS rows of H values (hc = H / 8 chunks), `stride` values apart, from
// each of n_src sources into the tile at dst + i * dst_step; rows from
// `valid` on, and the columns from H up to HP, are zero-filled. Each thread
// copies one chunk column, every THREADS / HC-th row; at HP = 256 the loop
// is left rolled in part so its addresses do not all stay in registers.
template <int ROWS, int HP, int THREADS, int NSRC>
__device__ __forceinline__ void load_rows(uint8_t* dst, int dst_step,
                                          const bf16* const (&src)[NSRC],
                                          size_t stride, int valid, int hc,
                                          int tid) {
  constexpr int HC = HP / 8, STEP = THREADS / HC;
  const int c = tid % HC, r0 = tid / HC;
  const bool col = c < hc;
  const size_t off0 = col ? (size_t)r0 * stride + 8 * c : 0;
  constexpr int UNROLL = HP > 128 ? 4 : ROWS / STEP;
#pragma unroll UNROLL
  for (int j = 0; j < ROWS / STEP; ++j) {
    const int r = r0 + j * STEP;
    const bool ok = col && r < valid;
    const size_t off = ok ? off0 + (size_t)(j * STEP) * stride : 0;
    const int d = tile_off<ROWS>(r, c);
#pragma unroll
    for (int i = 0; i < NSRC; ++i)
      cp_async16(dst + i * dst_step + d, src[i] + off, ok);
  }
}

// Issue S (64 x BK) = Q K^T over the padded head dim (the pad is zero):
// qs a 64-row Q tile, ks a K tile.
template <int HP>
__device__ __forceinline__ void qk_issue(float (&s)[BK / 2],
                                         const uint8_t* qs,
                                         const uint8_t* ks) {
#pragma unroll
  for (int kk = 0; kk < HP / 16; ++kk) {
    const uint64_t da = desc_sw128(qs + (kk >> 2) * (64 * 128)) + 2 * (kk & 3);
    const uint64_t db = desc_sw128(ks + (kk >> 2) * (BK * 128)) + 2 * (kk & 3);
    wgmma_bf16_ss(s, da, db, kk > 0);
  }
}

// Issue O (64 x HP) += P V: P in registers (pf[kk]: the A fragment of keys
// 16 kk..16 kk + 15), vs a V tile read MN-major, one n = HP product a k16
// step that moves between 64-column slabs by the leading byte offset.
template <int HP>
__device__ __forceinline__ void pv_issue(float (&o)[HP / 2],
                                         const uint32_t (&pf)[BK / 16][4],
                                         const uint8_t* vs) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_bf16<1>(o, pf[kk][0], pf[kk][1], pf[kk][2], pf[kk][3],
                  desc_sw128_mn(vs + kk * 2048, BK * 128), 1);
}

// A tile's scores in log2 units (scaled, or softcapped), masked where MASK
// outside each row's kept columns [lo, hi] of the tile, and each of the
// thread's two rows' maxima. One copy per (CAP, MASK), chosen once a tile,
// so no element pays for either test.
template <bool CAP, bool MASK>
__device__ __forceinline__ void scores(float (&s)[BK / 2], float& mx0,
                                       float& mx1, float2 sc, int lo0,
                                       int hi0, int lo1, int hi1) {
  mx0 = mx1 = NEG_INF;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = CAP ? tanhf(s[4 * j + e] * sc.x) * sc.y : s[4 * j + e] * sc.x;
      if (MASK) {
        const int col = 8 * j + (e & 1);  // less the thread's 2 qd
        const bool ok = e < 2 ? col >= lo0 && col <= hi0
                              : col >= lo1 && col <= hi1;
        x = ok ? x : NEG_INF;
      }
      s[4 * j + e] = x;
      if (e < 2)
        mx0 = fmaxf(mx0, x);
      else
        mx1 = fmaxf(mx1, x);
    }
  }
}

template <int HP>
__global__ void __launch_bounds__(128, 1)
flash_kernel(const Params p) {
  using S = Smem<HP>;
  constexpr int THREADS = 128, BM = 64;
  // the softmax runs while P V runs, except at HP = 256, where the P
  // fragments, S and O would not all fit in registers at once
  constexpr bool OVERLAP = HP <= 128;
  extern __shared__ __align__(1024) uint8_t fa_smem[];
  uint8_t* q_s = fa_smem;
  uint8_t* kv_s = fa_smem + S::Q;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
  // one block a (row tile, head, batch), the longest row tiles of every
  // head first (under a causal mask the last rows take the most keys)
  const int n = blockIdx.x % p.N, rest = blockIdx.x / p.N;
  const int b = rest % p.B;
  const int r0 = (gridDim.x / (p.N * p.B) - 1 - rest / p.B) * BM;
  const int kh = n / p.G;

  // the keys the mask leaves to the block's rows, in whole tiles
  const int pos_lo = p.q_offset + r0;
  const int pos_hi = p.q_offset + min(r0 + BM, p.Sq) - 1;
  const int k_end = p.causal ? min(p.Skv, pos_hi + 1) : p.Skv;
  const int k_beg = p.window > 0 ? max(0, pos_lo - p.window + 1) : 0;
  const int t_beg = k_beg / BK;
  const int t_end = k_end > k_beg ? (k_end + BK - 1) / BK : t_beg;
  // this thread's two rows' positions
  const int pos_a = pos_lo + 16 * warp + g;
  const int pos_b = pos_a + 8;

  const size_t kv_stride = (size_t)p.K * p.H;
  const size_t kv_base = (size_t)b * p.Skv * kv_stride + (size_t)kh * p.H;
  auto load_tile = [&](int t, uint8_t* st) {
    const size_t off = kv_base + (size_t)t * BK * kv_stride;
    const bf16* const src[2] = {p.k + off, p.v + off};
    load_rows<BK, HP, THREADS, 2>(st, S::KV, src, kv_stride, p.Skv - t * BK,
                                  p.H / 8, tid);
  };

  // the ring: tile t in stage cur, t - 1 in prev (the first tile's P V, of
  // P = 0, reads its own V); tile t_beg + i starts in stage i
  auto stage = [&](int i) { return kv_s + i * 2 * S::KV; };
  int cur = 0, prev = 0;
  const size_t q_stride = (size_t)p.N * p.H;
  const bf16* const q_src[1] = {p.q + ((size_t)b * p.Sq + r0) * q_stride +
                                (size_t)n * p.H};
  load_rows<BM, HP, THREADS, 1>(q_s, 0, q_src, q_stride, p.Sq - r0, p.H / 8,
                                tid);
#pragma unroll
  for (int i = 0; i < S::AHEAD; ++i) {
    if (t_beg + i < t_end) load_tile(t_beg + i, stage(i));
    cp_async_commit();
  }

  float o[HP / 2];
#pragma unroll
  for (int i = 0; i < HP / 2; ++i) o[i] = 0.f;
  uint32_t pf[BK / 16][4];  // P of the previous tile, bf16, as A fragments
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) pf[kk][i] = 0u;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const bool capped = p.cap > 0.f;
  // the score's factors: s * scale * log2(e), or tanh(s * scale / cap) *
  // cap * log2(e) under a softcap
  const float2 sc = capped ? make_float2(p.scale / p.cap, p.cap * LOG2E)
                           : make_float2(p.scale * LOG2E, 0.f);

  // Software pipeline over the block's tiles: issue S = Q K_t^T and
  // O += P_{t-1} V_{t-1} together, run the softmax of S_t while P V runs,
  // then rescale O. Tile t + AHEAD loads meanwhile, into the stage that
  // held t - 2. Every row takes every tile of the block: a tile the mask
  // empties for a row weighs nothing once the row has met a kept key, and
  // what it adds before that is rescaled to zero when the first kept key
  // comes.
  for (int t = t_beg; t < t_end; ++t) {
    cp_async_wait<S::AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();  // tile t landed; every warp is done with t - 2
    if (t + S::AHEAD < t_end)
      load_tile(t + S::AHEAD, stage((cur + S::AHEAD) % S::STAGES));
    cp_async_commit();

    float s[BK / 2];
    fence_regs(s);
    fence_regs(o);
    wgmma_fence();
    qk_issue<HP>(s, q_s, stage(cur));
    wgmma_commit();
    pv_issue<HP>(o, pf, stage(prev) + S::KV);
    wgmma_commit();
    if constexpr (OVERLAP)
      wgmma_wait<1>();
    else
      wgmma_wait<0>();
    fence_regs(s);

    // scores in log2 units; the element mask only where the tile crosses it
    const int k0 = t * BK;
    const bool masked = k0 + BK > p.Skv ||
                        (p.causal && k0 + BK - 1 > pos_lo) ||
                        (p.window > 0 && k0 <= pos_hi - p.window);
    float mx0, mx1;
    // a row keeps keys up to its position (causal) and Skv - 1, and from
    // position - window + 1 on (window): columns of this thread's elements
    // (8 j + 2 qd + 0/1) inside [lo, hi]
    const int base = k0 + 2 * qd;
    const int lim = p.Skv - 1 - base;
    const int hi0 = p.causal ? min(pos_a - base, lim) : lim;
    const int hi1 = p.causal ? min(pos_b - base, lim) : lim;
    const int lo0 = p.window > 0 ? pos_a - p.window + 1 - base : -BK;
    const int lo1 = p.window > 0 ? pos_b - p.window + 1 - base : -BK;
    if (capped) {
      if (masked)
        scores<true, true>(s, mx0, mx1, sc, lo0, hi0, lo1, hi1);
      else
        scores<true, false>(s, mx0, mx1, sc, lo0, hi0, lo1, hi1);
    } else {
      if (masked)
        scores<false, true>(s, mx0, mx1, sc, lo0, hi0, lo1, hi1);
      else
        scores<false, false>(s, mx0, mx1, sc, lo0, hi0, lo1, hi1);
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // P = 2^(s - m), in place in s while P_{t-1} V_{t-1} runs; packed to
    // bf16 A fragments once that product has retired
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[4 * j] = ex2(s[4 * j] - mn0);
      s[4 * j + 1] = ex2(s[4 * j + 1] - mn0);
      s[4 * j + 2] = ex2(s[4 * j + 2] - mn1);
      s[4 * j + 3] = ex2(s[4 * j + 3] - mn1);
      sum0 += s[4 * j] + s[4 * j + 1];
      sum1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
    wgmma_wait<0>();  // P_{t-1} V_{t-1} is in O
    keep_live(pf);
    fence_regs(o);
    // rescale O where a row's max moved (warp-uniform)
    if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {
#pragma unroll
      for (int j = 0; j < HP / 8; ++j) {
        o[4 * j] *= al0;
        o[4 * j + 1] *= al0;
        o[4 * j + 2] *= al1;
        o[4 * j + 3] *= al1;
      }
    }
    // the S fragment of keys 16 kk.. is the A fragment of k16 step kk
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pf[kk][0] = pack_bf16x2(s[8 * kk], s[8 * kk + 1]);
      pf[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
      pf[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
      pf[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
    }
    prev = cur;
    cur = cur + 1 == S::STAGES ? 0 : cur + 1;
  }
  if (t_end > t_beg) {  // the last tile's P V
    fence_regs(o);
    wgmma_fence();
    pv_issue<HP>(o, pf, stage(prev) + S::KV);
    wgmma_commit();
    wgmma_wait<0>();
    keep_live(pf);
    fence_regs(o);
  }
  cp_async_wait<0>();

  // epilogue: O / l as bf16 into the Q tile's space, then 16-byte stores
#pragma unroll
  for (int o_ = 1; o_ < 4; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float i0 = 1.f / fmaxf(l0, 1e-37f), i1 = 1.f / fmaxf(l1, 1e-37f);
  __syncthreads();  // every warp is done reading Q
  const int lr = 16 * warp + g;
#pragma unroll
  for (int j = 0; j < HP / 8; ++j) {
    *reinterpret_cast<uint32_t*>(q_s + tile_off<BM>(lr, j) + 4 * qd) =
        pack_bf16x2(o[4 * j] * i0, o[4 * j + 1] * i0);
    *reinterpret_cast<uint32_t*>(q_s + tile_off<BM>(lr + 8, j) + 4 * qd) =
        pack_bf16x2(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
  }
  __syncthreads();
  constexpr int HC = HP / 8, STEP = THREADS / HC;
  const int c = tid % HC;
  if (c >= p.H / 8) return;
#pragma unroll
  for (int j = 0; j < BM / STEP; ++j) {
    const int r = tid / HC + j * STEP;
    if (r0 + r < p.Sq)
      *reinterpret_cast<uint4*>(
          p.out + (((size_t)b * p.Sq + r0 + r) * p.N + n) * p.H + 8 * c) =
          *reinterpret_cast<const uint4*>(q_s + tile_off<BM>(r, c));
  }
}

// The two products on one tile, alone: S = Q K^T (64 x BK, f32) and
// O = bf16(S) V (64 x H, f32), q (64, H), k and v (BK, H) bf16 rows.
template <int HP>
__global__ void __launch_bounds__(128)
products_kernel(const bf16* q, const bf16* k, const bf16* v, float* s_out,
                float* o_out, int H) {
  extern __shared__ __align__(1024) uint8_t pr_smem[];
  uint8_t* q_s = pr_smem;
  uint8_t* k_s = q_s + 64 * HP * 2;
  uint8_t* v_s = k_s + BK * HP * 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const bf16* const qsrc[1] = {q};
  const bf16* const kvsrc[2] = {k, v};
  load_rows<64, HP, 128, 1>(q_s, 0, qsrc, H, 64, H / 8, tid);
  load_rows<BK, HP, 128, 2>(k_s, BK * HP * 2, kvsrc, H, BK, H / 8, tid);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  float s[BK / 2];
  fence_regs(s);
  wgmma_fence();
  qk_issue<HP>(s, q_s, k_s);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  const int ra = 16 * warp + g;
  uint32_t pf[BK / 16][4];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s_out[(ra + 8 * (e >> 1)) * BK + 8 * j + 2 * qd + (e & 1)] = s[4 * j + e];
    pf[j / 2][2 * (j & 1)] = pack_bf16x2(s[4 * j], s[4 * j + 1]);
    pf[j / 2][2 * (j & 1) + 1] = pack_bf16x2(s[4 * j + 2], s[4 * j + 3]);
  }
  float o[HP / 2];
#pragma unroll
  for (int i = 0; i < HP / 2; ++i) o[i] = 0.f;
  fence_regs(o);
  wgmma_fence();
  pv_issue<HP>(o, pf, v_s);
  wgmma_commit();
  wgmma_wait<0>();
  keep_live(pf);
  fence_regs(o);
#pragma unroll
  for (int j = 0; j < HP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * qd + (e & 1);
      if (col < H) o_out[(ra + 8 * (e >> 1)) * H + col] = o[4 * j + e];
    }
  }
}

template <int HP>
int launch(const Params& p, cudaStream_t stream) {
  static int granted = 0;
  auto kernel = flash_kernel<HP>;
  constexpr int smem = Smem<HP>::TOTAL;
  static_assert(smem <= SMEM_MAX, "tile does not fit in shared memory");
  static bool carved = false;
  if (!carved) {  // the most shared memory an SM has, so 2 blocks fit
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (e != cudaSuccess) return (int)e;
    carved = true;
  }
  const int err = ensure_smem(kernel, smem, granted);
  if (err != 0) return err;
  const long long blocks = (long long)((p.Sq + 63) / 64) * p.N * p.B;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, 128, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int HP>
int launch_products(const bf16* q, const bf16* k, const bf16* v, float* s,
                    float* o, int H, cudaStream_t stream) {
  static int granted = 0;
  auto kernel = products_kernel<HP>;
  constexpr int smem = (64 + 2 * BK) * HP * 2;
  const int err = ensure_smem(kernel, smem, granted);
  if (err != 0) return err;
  kernel<<<1, 128, smem, stream>>>(q, k, v, s, o, H);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The head dim padded to whole 64-column slabs, or 0 if not taken.
int head_pad(int H) {
  if (H < 16 || H > 256 || H % 16 != 0) return 0;
  return H <= 64 ? 64 : H <= 128 ? 128 : 256;
}

}  // namespace

// One launch: q (B, Sq, N, H), k/v (B, Skv, K, H), out (B, Sq, N, H), all
// bf16, contiguous and 16-byte aligned; H a multiple of 16 up to 256,
// N % K == 0, q_offset >= 0, window >= 0 (0: none), cap > 0 for a softcap.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Sq, int Skv, int N, int K,
                               int H, int causal, int window, float cap,
                               int q_offset, void* stream) {
  const int hp = head_pad(H);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || N <= 0 || K <= 0 || N % K != 0 ||
      hp == 0 || q_offset < 0 || window < 0 || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = reinterpret_cast<const bf16*>(q);
  p.k = reinterpret_cast<const bf16*>(k);
  p.v = reinterpret_cast<const bf16*>(v);
  p.out = reinterpret_cast<bf16*>(out);
  p.B = B;
  p.Sq = Sq;
  p.Skv = Skv;
  p.N = N;
  p.K = K;
  p.H = H;
  p.G = N / K;
  p.causal = causal != 0;
  p.window = window;
  p.q_offset = q_offset;
  p.cap = cap;
  p.scale = 1.0f / sqrtf((float)H);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (hp == 64) return launch<64>(p, st);
  if (hp == 128) return launch<128>(p, st);
  return launch<256>(p, st);
}

// The two products on one tile (see products_kernel): q (64, H), k and v
// (64, H) bf16, s (64, 64) and o (64, H) f32, all contiguous.
extern "C" int flash_products(const void* q, const void* k, const void* v,
                              void* s, void* o, int H, void* stream) {
  const int hp = head_pad(H);
  if (hp == 0 || !aligned16(q) || !aligned16(k) || !aligned16(v))
    return (int)cudaErrorInvalidValue;
  const bf16* qb = reinterpret_cast<const bf16*>(q);
  const bf16* kb = reinterpret_cast<const bf16*>(k);
  const bf16* vb = reinterpret_cast<const bf16*>(v);
  float* sf = reinterpret_cast<float*>(s);
  float* of = reinterpret_cast<float*>(o);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (hp == 64) return launch_products<64>(qb, kb, vb, sf, of, H, st);
  if (hp == 128) return launch_products<128>(qb, kb, vb, sf, of, H, st);
  return launch_products<256>(qb, kb, vb, sf, of, H, st);
}
