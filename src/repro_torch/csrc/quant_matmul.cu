// Fused dequant matmul for Hopper: x (M, K) bf16 @ W -> (M, N) bf16.
//
// Replaces the Pallas kernels in src/repro/kernels/quant_matmul/quant_matmul.py:
//   q8_matmul (:56, _q8_kernel): W (K, N) int8, per-column f32 scale (1, N)
//       applied once to the f32 sum, result cast to bf16;
//   q4_matmul (:108, _q4_kernel): W packed (K/2, N) uint8, even k in the low
//       nibble, odd k in the high nibble; per 128-row group an f32 scale and
//       zero (K/g, N); each group adds s * (x @ q) + (sum x) * z to the f32 sum.
//
// Both formats run on the tensor cores (bf16 operands, f32 accumulation:
// mma.sync.m16n8k16 at decode, wgmma at prefill). The codes are exact in
// bf16 (int8 -127..127, uint4 0..15) and a bf16 x bf16 product is exact in
// f32, so only the order of the f32 sums differs from the plain version.
// The q8 column scale is applied to the final sum. q4 applies the group
// terms as the plain version does, s * acc_g + z * sum(x_g) from a group
// accumulator of its own, rather than dequantizing q * s + z: no weight is
// rounded, at the cost of a second accumulator set (32 registers a lane at
// M <= 8, 64 at M <= 16 and at prefill; no kernel spills). One call is one
// kernel launch, in one of two regimes:
//
// Decode (M <= 16 rows, qmm_decode_kernel). Bound by the weight bytes: 2 M
// flops per weight, far below the ~295 flop/byte ridge; on the tensor cores
// M = 16 costs what M = 1 does (a CUDA-core GEMV would be bound by its
// arithmetic past M ~ 8). The design keeps the byte stream full: each block
// owns 128 columns and a K chunk; its 8 warps split the chunk (warp w takes
// the w-th eighth of its units of 32 or 64 k) and each lane issues 16-byte
// loads of 4 k-rows x 16 columns (q8) or 2 packed rows (q4) per 16 k,
// neighbouring lanes on neighbouring columns, 128 bytes a lane in flight
// (q8 at M <= 8 loads the next unit while it converts and multiplies this
// one). The lane's weights are the A operand as loaded: the k order inside
// an mma is a free permutation, so A row g <-> the lane group's column pair
// and k-slots 2q,2q+1,2q+8,2q+9 <-> k rows 4q..4q+3 (q = lane % 4); B is
// x^T from shared memory with the same k map, one 8-byte load per 8 x rows.
// The block's x rows for its K chunk are staged in shared memory once.
// Warps' partials meet in shared memory and are summed in warp order. Where
// the column tiles alone cannot fill the card, K is also split across
// blocks (grid.y): each block writes its f32 partial to a workspace the
// wrapper keeps per device, and the last block of a column tile to arrive
// (a per-tile counter, reset by that block) sums the partials in split
// order, applies the q8 scale and writes bf16. No second kernel, no atomics
// on the output, and the result is bit-identical from launch to launch. q4
// gets sum(x) per k slice from one more mma against a ones A fragment, so a
// warp may fold any k slice of a group: the fold is linear.
//
// Prefill (M > 16, qmm_prefill_kernel). Bound by bf16 tensor-core operations
// (2 M K N). wgmma on the transposed product, out^T = W^T x^T, as mixed-input
// GEMMs do: the dequantized weight is the A operand, built in registers, and
// x is the B operand, read by the tensor cores from shared memory. A block
// of two warpgroups owns 128 weight columns (64 each) x BM rows, one
// m64nBMk16 wgmma per 16 k: BM = 128, or 64 for M <= 64 (1.4-1.6x faster
// there). K tiles of 64 (x bf16 in the canonical 128-byte swizzle, the codes
// as stored, rows padded) arrive by cp.async in a 4-stage ring in dynamic
// shared memory. Each lane builds its A fragment for the next 16 k from the
// codes (two adjacent columns, 8 codes) while the previous wgmma runs; the
// block waits for its wgmmas once per K tile. The q8 column scale is
// applied in the epilogue; q4 folds s * acc_g + sum(x_g) * z at each
// group's end (K tiles of 64 divide the group), sum(x_g) taken from the x
// tiles in shared memory. Ragged M and N edges are zero-filled on load and
// masked on store.
//
// The kernels launch on the caller's stream and allocate nothing; the
// wrapper (kernels/quant_matmul/ops.py) owns the output and the workspace,
// and `plan` there picks the regime, the K split and the chunk.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kQ8 = 0, kQ4 = 1;

// ---------------------------------------------------------------------------
// helpers
// ---------------------------------------------------------------------------

// Byte `byte` of vx (int8 codes xor 0x80, i.e. biased to 0..255) as an exact
// f32: 0x4B0000uu is 2^23 + u.
__device__ __forceinline__ float s8_f32(uint32_t vx, uint32_t byte) {
  return __uint_as_float(__byte_perm(vx, 0x4B000000u, 0x7440u | byte)) -
         8388736.f;
}

// bf16x2 {128 + a, 128 + b} -> {a, b}, exact.
__device__ __forceinline__ uint32_t minus128(uint32_t t) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(t), "r"(0x3F803F80u), "r"(0xC300C300u));
  return d;
}

// Nibbles in bits 0-3 and 16-19 of t -> bf16x2 of their values, exact.
__device__ __forceinline__ uint32_t nib2_bf16(uint32_t t) {
  return minus128((t & 0x000F000Fu) | 0x43004300u);
}

__device__ __forceinline__ uint4 ld_stream16(const uint8_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ uint2 ld_stream8(const uint8_t* p) {
  uint2 v;
  asm("ld.global.nc.L1::no_allocate.v2.u32 {%0,%1}, [%2];\n"
      : "=r"(v.x), "=r"(v.y)
      : "l"(p));
  return v;
}

// 16 weight bytes at p, of which `valid` (<= 0: none) lie inside the row.
// VEC16: one 16-byte load (N % 16 == 0, 16-byte aligned weight); else two
// 8-byte loads, so any N % 8 == 0 works.
template <bool VEC16>
__device__ __forceinline__ uint4 load_w16(const uint8_t* p, int valid) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (VEC16) {
    if (valid > 0) v = ld_stream16(p);
  } else {
    if (valid > 0) {
      const uint2 a = ld_stream8(p);
      v.x = a.x;
      v.y = a.y;
    }
    if (valid > 8) {
      const uint2 b = ld_stream8(p + 8);
      v.z = b.x;
      v.w = b.y;
    }
  }
  return v;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 ldg4_or0(const float* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const float4*>(p))
            : make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

// ---------------------------------------------------------------------------
// decode regime: M <= 16
// ---------------------------------------------------------------------------

constexpr int DEC_THREADS = 256;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_COLS = 128;  // columns per block: 8 lane groups x 16

template <int FMT, int NT>
struct DecodeShape {
  static constexpr int MP = 8 * NT;  // x rows, padded to the mma's n8 tiles
  // k16 steps per unit of a warp's slice, and whether the next unit's
  // weights are loaded while this one is computed. Chosen on an H100 among
  // units of 1, 2 and 4 steps with and without that prefetch: q8 at M <= 8
  // keeps 128 B a lane in flight by prefetching units of 2 steps (128
  // registers, 2 blocks an SM); q4 loads units of 4 steps (128 B a lane) and
  // then computes them, which beat prefetching units of 2 by 11%. M <= 16
  // has no registers to spare for either.
  static constexpr int U = FMT == kQ8 ? 2 : (NT == 1 ? 4 : 2);
  static constexpr bool PREFETCH = FMT == kQ8 && NT == 1;
  static constexpr int UK = 16 * U;
  static constexpr int LOADS = FMT == kQ8 ? 4 : 2;  // 16-B rows per k16 step
};

// q4: acc += s * accg + z * sum(x) for the lane's 16 columns, then clear
// accg and the sums. sc / zc point at the group's row, at the lane's first
// column; `valid` columns of 16 exist.
template <int NT>
__device__ __forceinline__ void fold_q4(float (&acc)[NT][8][4],
                                        float (&accg)[NT][8][4],
                                        float (&sx)[NT][4],
                                        const float* sc, const float* zc,
                                        int valid) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {  // columns 4m..4m+3: mma i = 2m, 2m+1
    const float4 s4 = ldg4_or0(sc + 4 * m, 4 * m < valid);
    const float4 z4 = ldg4_or0(zc + 4 * m, 4 * m < valid);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 2 * m + h;
      const float s0 = comp(s4, 2 * h), s1 = comp(s4, 2 * h + 1);
      const float z0 = comp(z4, 2 * h), z1 = comp(z4, 2 * h + 1);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        // c0, c1: column 2i, x rows 2q, 2q+1; c2, c3: column 2i + 1
        acc[t][i][0] += s0 * accg[t][i][0] + z0 * sx[t][0];
        acc[t][i][1] += s0 * accg[t][i][1] + z0 * sx[t][1];
        acc[t][i][2] += s1 * accg[t][i][2] + z1 * sx[t][2];
        acc[t][i][3] += s1 * accg[t][i][3] + z1 * sx[t][3];
      }
    }
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sx[t][e] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) accg[t][i][e] = 0.f;
  }
}

template <int FMT, int NT, bool VEC16>
__global__ void __launch_bounds__(DEC_THREADS)
qmm_decode_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
                  const float* __restrict__ scale,
                  const float* __restrict__ zero, float* __restrict__ ws,
                  unsigned* __restrict__ counters, bf16* __restrict__ out,
                  int M, int K, int N, int group, int k_chunk, int splits) {
  using S = DecodeShape<FMT, NT>;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ unsigned is_last;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  // row pitch k_chunk + 16 elements: 2 k_chunk is a multiple of 128 bytes,
  // so the 32-byte offset puts the 4 rows a half-warp reads on distinct banks
  const int xpitch = k_chunk + 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int n0 = blockIdx.x * DEC_COLS;
  const int split = blockIdx.y;
  const int kb0 = split * k_chunk;
  const int kb1 = min(K, kb0 + k_chunk);

  // 1. the block's x rows for its K chunk, once; zero past M and past kb1
  const int cpr = k_chunk >> 3;
  for (int i = tid; i < S::MP * cpr; i += DEC_THREADS) {
    const int r = i / cpr, c = i - r * cpr;
    const int k = kb0 + (c << 3);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < M && k < kb1)
      v = __ldg(reinterpret_cast<const uint4*>(x + (size_t)r * K + k));
    *reinterpret_cast<uint4*>(xs + r * xpitch + (c << 3)) = v;
  }
  __syncthreads();

  // 2. each warp streams its slice of the chunk through the tensor cores
  const int col = n0 + 16 * g;  // the lane's 16 columns
  const int valid = N - col;
  const int units = (kb1 - kb0 + S::UK - 1) / S::UK;
  const int u0 = warp * units / DEC_WARPS;
  const int u1 = (warp + 1) * units / DEC_WARPS;
  const uint8_t* wl = w + col;

  float acc[NT][8][4];
  float accg[NT][8][4];
  float sx[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sx[t][e] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][i][e] = accg[t][i][e] = 0.f;
  }

  // the weights of unit u: 16-byte rows, zero past kb1 and past N
  auto load_unit = [&](uint4 (&wv)[S::U][S::LOADS], int u) {
    const int kl = u * S::UK;
#pragma unroll
    for (int s = 0; s < S::U; ++s) {
#pragma unroll
      for (int r = 0; r < S::LOADS; ++r) {
        if constexpr (FMT == kQ8) {
          const int k = kb0 + kl + 16 * s + 4 * q + r;
          wv[s][r] = load_w16<VEC16>(wl + (size_t)k * N, k < kb1 ? valid : 0);
        } else {
          const int kp = ((kb0 + kl + 16 * s) >> 1) + 2 * q + r;
          wv[s][r] = load_w16<VEC16>(wl + (size_t)kp * N,
                                     2 * kp < kb1 ? valid : 0);
        }
      }
    }
  };
  uint4 wv[S::U][S::LOADS], wn[S::U][S::LOADS];
  if (S::PREFETCH && u0 < u1) load_unit(wv, u0);
#pragma unroll 1
  for (int u = u0; u < u1; ++u) {
    const int kl = u * S::UK;  // the unit's first k, local to the chunk
    if (S::PREFETCH) {
      if (u + 1 < u1) load_unit(wn, u + 1);
    } else {
      load_unit(wv, u);
    }
#pragma unroll
    for (int s = 0; s < S::U; ++s) {
      uint32_t b[NT][2];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const uint2 bv = *reinterpret_cast<const uint2*>(
            xs + (g + 8 * t) * xpitch + kl + 16 * s + 4 * q);
        b[t][0] = bv.x;
        b[t][1] = bv.y;
      }
      if constexpr (FMT == kQ8) {
        // rows 4q..4q+3 of the step, biased to unsigned bytes
        uint32_t r0[4], r1[4], r2[4], r3[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          r0[i] = word(wv[s][0], i) ^ 0x80808080u;
          r1[i] = word(wv[s][1], i) ^ 0x80808080u;
          r2[i] = word(wv[s][2], i) ^ 0x80808080u;
          r3[i] = word(wv[s][3], i) ^ 0x80808080u;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int wi = i >> 1;
          const uint32_t c0 = 2 * (i & 1), c1 = c0 + 1;  // columns 2i, 2i+1
          const uint32_t a0 = pack_bf16(s8_f32(r0[wi], c0), s8_f32(r1[wi], c0));
          const uint32_t a1 = pack_bf16(s8_f32(r0[wi], c1), s8_f32(r1[wi], c1));
          const uint32_t a2 = pack_bf16(s8_f32(r2[wi], c0), s8_f32(r3[wi], c0));
          const uint32_t a3 = pack_bf16(s8_f32(r2[wi], c1), s8_f32(r3[wi], c1));
#pragma unroll
          for (int t = 0; t < NT; ++t)
            mma_bf16(acc[t][i], a0, a1, a2, a3, b[t][0], b[t][1]);
        }
      } else {
        // packed rows 2q (k 4q, 4q+1) and 2q+1 (k 4q+2, 4q+3): one byte
        // gives the (k, k+1) pair of one column
        uint32_t p0[4], p1[4], p0s[4], p1s[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p0[i] = word(wv[s][0], i);
          p1[i] = word(wv[s][1], i);
          p0s[i] = p0[i] >> 4;
          p1s[i] = p1[i] >> 4;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int wi = i >> 1;
          const uint32_t c0 = 2 * (i & 1), c1 = c0 + 1;
          // bytes c of v (low nibble) and of v >> 4 (high) at bits 0 and 16
          const uint32_t sel0 = 0x4400u + 0x1111u * c0;
          const uint32_t sel1 = 0x4400u + 0x1111u * c1;
          const uint32_t a0 = nib2_bf16(__byte_perm(p0[wi], p0s[wi], sel0));
          const uint32_t a1 = nib2_bf16(__byte_perm(p0[wi], p0s[wi], sel1));
          const uint32_t a2 = nib2_bf16(__byte_perm(p1[wi], p1s[wi], sel0));
          const uint32_t a3 = nib2_bf16(__byte_perm(p1[wi], p1s[wi], sel1));
#pragma unroll
          for (int t = 0; t < NT; ++t)
            mma_bf16(accg[t][i], a0, a1, a2, a3, b[t][0], b[t][1]);
        }
        // sum(x) over the step's 16 k for every x row: A = ones
#pragma unroll
        for (int t = 0; t < NT; ++t)
          mma_bf16(sx[t], 0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u,
                   b[t][0], b[t][1]);
      }
    }
    if (S::PREFETCH) {
#pragma unroll
      for (int st = 0; st < S::U; ++st)
#pragma unroll
        for (int r = 0; r < S::LOADS; ++r) wv[st][r] = wn[st][r];
    }
    if (FMT == kQ4) {
      const int kg = kb0 + kl;  // a unit never crosses a group boundary
      if ((kg + S::UK) % group == 0 || u + 1 == u1) {
        const size_t off = (size_t)(kg / group) * N + col;
        fold_q4<NT>(acc, accg, sx, scale + off, zero + off, valid);
      }
    }
  }

  // 3. the warps' partials meet in shared memory, summed in warp order
  __syncthreads();  // every warp is done with xs
  float* red = reinterpret_cast<float*>(smem);  // [warp][x row][column]
  constexpr int PER_WARP = S::MP * DEC_COLS;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[warp * PER_WARP + (8 * t + 2 * q + (e & 1)) * DEC_COLS + 16 * g +
            2 * i + (e >> 1)] = acc[t][i][e];
  __syncthreads();
  for (int e = tid; e < PER_WARP; e += DEC_THREADS) {
    const int j = e / DEC_COLS, n = n0 + e % DEC_COLS;
    float v = 0.f;
#pragma unroll
    for (int wp = 0; wp < DEC_WARPS; ++wp) v += red[wp * PER_WARP + e];
    if (j < M && n < N) {
      if (splits == 1)
        out[(size_t)j * N + n] =
            __float2bfloat16_rn(FMT == kQ8 ? v * __ldg(scale + n) : v);
      else
        ws[((size_t)split * M + j) * N + n] = v;
    }
  }
  if (splits == 1) return;

  // 4. K split across blocks: the last block of this column tile sums the
  // splits' partials in split order (whichever block arrives last)
  __threadfence();
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(counters + blockIdx.x, 1u) == (unsigned)(splits - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int e = tid; e < M * DEC_COLS; e += DEC_THREADS) {
    const int j = e / DEC_COLS, n = n0 + e % DEC_COLS;
    if (n >= N) continue;
    float v = 0.f;
    for (int sp = 0; sp < splits; ++sp)
      v += __ldcg(ws + ((size_t)sp * M + j) * N + n);
    out[(size_t)j * N + n] =
        __float2bfloat16_rn(FMT == kQ8 ? v * __ldg(scale + n) : v);
  }
  if (tid == 0) counters[blockIdx.x] = 0u;  // ready for the next launch
}

// ---------------------------------------------------------------------------
// prefill regime: M > 16
// ---------------------------------------------------------------------------

constexpr int PF_THREADS = 256;  // two warpgroups
constexpr int PF_BN = 128, PF_BK = 64, PF_STAGES = 4;
constexpr int PF_WPITCH = PF_BN + 16;  // code rows padded: conflict-free reads

// BM x rows per block: the wgmma's n (128, or 64 for q4 and for few rows)
template <int FMT, int BM>
struct PrefillSmem {
  static constexpr int X = BM * PF_BK * 2;  // x tile, bf16, 128B-swizzled
  static constexpr int W = (FMT == kQ8 ? PF_BK : PF_BK / 2) * PF_WPITCH;
  static constexpr int STAGE = (X + W + 1023) / 1024 * 1024;  // 1 KB aligned
  static constexpr int TOTAL = PF_STAGES * STAGE + BM * 4;
};

// x tile (BM rows of PF_BK bf16 = 128 bytes): 16-byte chunk c of row r at
// chunk c ^ (r % 8), the canonical 128-byte swizzle of a K-major wgmma
// operand (8-row atoms of 1 KB, the tile 1 KB aligned)
__device__ __forceinline__ int swz(int r, int c) {
  return sw128(r, c) >> 1;  // PF_BK bf16 = 128-byte rows
}

template <int FMT, int BM, bool VEC16>
__device__ __forceinline__ void prefill_load(uint8_t* stage, const bf16* x,
                                             const uint8_t* w, int M, int K,
                                             int N, int m0, int n0, int kt,
                                             int tid) {
  using S = PrefillSmem<FMT, BM>;
  bf16* xs = reinterpret_cast<bf16*>(stage);
  uint8_t* wq = stage + S::X;
  const int k0 = kt * PF_BK;
#pragma unroll
  for (int j = 0; j < BM * (PF_BK / 8) / PF_THREADS; ++j) {
    const int i = tid + j * PF_THREADS;
    const int r = i >> 3, c = i & 7;
    const int row = m0 + r, k = k0 + 8 * c;
    const bool ok = row < M && k < K;
    cp_async16(xs + swz(r, c), ok ? x + (size_t)row * K + k : x, ok);
  }
  constexpr int ROWS = FMT == kQ8 ? PF_BK : PF_BK / 2;
  const int rows_total = FMT == kQ8 ? K : K / 2;
  const int r0 = FMT == kQ8 ? k0 : k0 / 2;
#pragma unroll
  for (int j = 0; j < (ROWS * (PF_BN / 16) + PF_THREADS - 1) / PF_THREADS;
       ++j) {
    const int i = tid + j * PF_THREADS;
    const int r = i >> 3, c = i & 7;
    const int kr = r0 + r, n = n0 + 16 * c;
    const uint8_t* src = w + (size_t)kr * N + n;
    uint8_t* dst = wq + r * PF_WPITCH + 16 * c;
    if (VEC16) {
      const bool ok = kr < rows_total && n < N;
      cp_async16(dst, ok ? src : w, ok);
    } else {
      const bool ok0 = kr < rows_total && n < N;
      const bool ok1 = kr < rows_total && n + 8 < N;
      cp_async8(dst, ok0 ? src : w, ok0);
      cp_async8(dst + 8, ok1 ? src + 8 : w, ok1);
    }
  }
}

__device__ __forceinline__ float bf16x2_sum(uint32_t v) {
  return __uint_as_float(v << 16) + __uint_as_float(v & 0xFFFF0000u);
}

__device__ __forceinline__ uint32_t lds_u16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// The A fragment of k16 step ks for this lane: A rows g, g + 8 <-> weight
// columns col, col + 1 (col = the lane's column pair in the tile), k-slots
// 2q, 2q+1, 2q+8, 2q+9 in natural order (B, x^T, comes from shared memory).
template <int FMT>
__device__ __forceinline__ void prefill_afrag(const uint8_t* wq, int ks,
                                              int q, int col,
                                              uint32_t (&a)[4]) {
  if constexpr (FMT == kQ8) {
    const uint8_t* p = wq + (16 * ks + 2 * q) * PF_WPITCH + col;
    // bytes: (k, col), (k, col+1), (k+1, col), (k+1, col+1), biased
    const uint32_t w01 =
        (lds_u16(p) | (lds_u16(p + PF_WPITCH) << 16)) ^ 0x80808080u;
    const uint32_t w89 = (lds_u16(p + 8 * PF_WPITCH) |
                          (lds_u16(p + 9 * PF_WPITCH) << 16)) ^
                         0x80808080u;
    a[0] = pack_bf16(s8_f32(w01, 0), s8_f32(w01, 2));
    a[1] = pack_bf16(s8_f32(w01, 1), s8_f32(w01, 3));
    a[2] = pack_bf16(s8_f32(w89, 0), s8_f32(w89, 2));
    a[3] = pack_bf16(s8_f32(w89, 1), s8_f32(w89, 3));
  } else {
    // packed row 8 ks + q holds k = 16 ks + 2q (low) and + 1 (high)
    const uint8_t* p = wq + (8 * ks + q) * PF_WPITCH + col;
    const uint32_t v0 = lds_u16(p), v1 = lds_u16(p + 4 * PF_WPITCH);
    // byte b of v and of v >> 4: its (low, high) nibbles at bits 0 and 16
    a[0] = nib2_bf16(__byte_perm(v0, v0 >> 4, 0x0400u));
    a[1] = nib2_bf16(__byte_perm(v0, v0 >> 4, 0x0501u));
    a[2] = nib2_bf16(__byte_perm(v1, v1 >> 4, 0x0400u));
    a[3] = nib2_bf16(__byte_perm(v1, v1 >> 4, 0x0501u));
  }
}

template <int FMT, int BM, bool VEC16>
__global__ void __launch_bounds__(PF_THREADS, FMT == kQ8 ? 2 : 1)
qmm_prefill_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ zero, bf16* __restrict__ out,
                   int M, int K, int N, int group) {
  using S = PrefillSmem<FMT, BM>;
  constexpr int NACC = BM / 2;  // accumulators a thread: 64 x BM / 128
  // its own name: the decode kernel's dynamic shared memory is 16-byte
  // aligned, this one must be 1 KB aligned for the 128-byte swizzle
  extern __shared__ __align__(1024) uint8_t pf_smem[];
  uint8_t* smem = pf_smem;
  float* sxs = reinterpret_cast<float*>(smem + PF_STAGES * S::STAGE);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * PF_BN;
  // warpgroup wg, warp w4 in it: weight columns n0 + 64 wg + 16 w4 + 0..15;
  // this lane's A rows g and g + 8 are its columns col and col + 1
  const int col = 64 * (warp >> 2) + 16 * (warp & 3) + 2 * g;
  const int ktiles = (K + PF_BK - 1) / PF_BK;

  float acc[NACC], accg[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = accg[i] = 0.f;
  // q4: tile kt is tile tig of group gi (K tiles of 64 divide the group)
  const int tpg = FMT == kQ4 ? group / PF_BK : 1;
  int tig = 0, gi = 0;
  float sx_run = 0.f;  // q4: this thread's x row sum over the group
  // q4: the group's scale and zero for this lane's two columns, loaded when
  // the group starts so the fold does not wait on them
  float2 s2 = make_float2(0.f, 0.f), z2 = s2;

#pragma unroll
  for (int s = 0; s < PF_STAGES - 1; ++s) {
    if (s < ktiles)
      prefill_load<FMT, BM, VEC16>(smem + s * S::STAGE, x, w, M, K, N, m0, n0,
                                   s, tid);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<PF_STAGES - 2>();
    fence_proxy_async();
    __syncthreads();  // tile kt landed; every warpgroup is done with kt - 1
    {
      const int nk = kt + PF_STAGES - 1;
      if (nk < ktiles)
        prefill_load<FMT, BM, VEC16>(smem + (nk % PF_STAGES) * S::STAGE, x, w,
                                     M, K, N, m0, n0, nk, tid);
      cp_async_commit();
    }
    const uint8_t* stage = smem + (kt % PF_STAGES) * S::STAGE;
    const bf16* xs = reinterpret_cast<const bf16*>(stage);
    const uint8_t* wq = stage + S::X;
    const bool group_end = FMT == kQ4 && tig == tpg - 1;
    // dequantize on the way to the tensor cores: each k16 step's A fragment
    // is built in registers while the previous step's wgmma runs
    const uint64_t desc = desc_sw128(xs);
    uint32_t a[PF_BK / 16][4];
#pragma unroll
    for (int ks = 0; ks < PF_BK / 16; ++ks) {
      prefill_afrag<FMT>(wq, ks, q, col, a[ks]);
      wgmma_fence();
      if constexpr (FMT == kQ8)
        wgmma_bf16(acc, a[ks][0], a[ks][1], a[ks][2], a[ks][3], desc + 2 * ks,
                   1);
      else  // a group's first product overwrites the last group's, folded
        wgmma_bf16(accg, a[ks][0], a[ks][1], a[ks][2], a[ks][3],
                   desc + 2 * ks, ks > 0 || tig > 0);
      wgmma_commit();
    }
    if constexpr (FMT == kQ4) {  // the group's x row sums, while they run
      if (tig == 0) {  // a group starts: its scale and zero early
        sx_run = 0.f;
        if (n0 + col < N) {
          const size_t off = (size_t)gi * N + n0 + col;
          s2 = __ldg(reinterpret_cast<const float2*>(scale + off));
          z2 = __ldg(reinterpret_cast<const float2*>(zero + off));
        }
      }
      constexpr int TPR = PF_THREADS / BM;  // threads a row: 2 or 4
      const int r = tid / TPR, h = tid % TPR;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8 / TPR; ++c) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            xs + swz(r, (8 / TPR) * h + c));
        sum += bf16x2_sum(v.x) + bf16x2_sum(v.y) + bf16x2_sum(v.z) +
               bf16x2_sum(v.w);
      }
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sx_run += sum;
      if (group_end && h == 0) sxs[r] = sx_run;
    }

    wgmma_wait<0>();
    keep_live(a);
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      fence_reg(acc[i]);
      fence_reg(accg[i]);
    }

    if (group_end) {  // q4: fold s * acc_g + sum(x_g) * z
      __syncthreads();  // the group's row sums are in sxs
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const float2 sx = *reinterpret_cast<const float2*>(sxs + 8 * j + 2 * q);
        // d[4j + e]: x row 8j + 2q + (e & 1), column col + (e >> 1)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sc = e < 2 ? s2.x : s2.y, zc = e < 2 ? z2.x : z2.y;
          const float xe = e & 1 ? sx.y : sx.x;
          acc[4 * j + e] =
              fmaf(sc, accg[4 * j + e], fmaf(zc, xe, acc[4 * j + e]));
        }
      }
    }
    if (++tig == tpg) {
      tig = 0;
      ++gi;
    }
  }
  cp_async_wait<0>();

  // epilogue: q8 column scale, bf16, ragged edges masked
  const int n = n0 + col;
  if (n >= N) return;
  float2 sc = make_float2(1.f, 1.f);
  if (FMT == kQ8) sc = __ldg(reinterpret_cast<const float2*>(scale + n));
#pragma unroll
  for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = m0 + 8 * j + 2 * q + e;
      if (row < M)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + n) =
            __floats2bfloat162_rn(acc[4 * j + e] * sc.x,
                                  acc[4 * j + 2 + e] * sc.y);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Args {
  const bf16* x;
  const uint8_t* w;
  const float* scale;
  const float* zero;
  float* ws;
  unsigned* counters;
  bf16* out;
  int M, K, N, group, splits, k_chunk;
  cudaStream_t stream;
};

int decode_smem(int rows, int k_chunk) {
  const int xs = rows * (k_chunk + 16) * 2;
  const int red = DEC_WARPS * rows * DEC_COLS * 4;
  return xs > red ? xs : red;
}

template <int FMT, int NT, bool VEC16>
int launch_decode(const Args& a) {
  static int granted = 0;
  auto kernel = qmm_decode_kernel<FMT, NT, VEC16>;
  const int smem = decode_smem(8 * NT, a.k_chunk);
  const int err = ensure_smem(kernel, smem, granted);
  if (err != 0) return err;
  const dim3 grid((a.N + DEC_COLS - 1) / DEC_COLS, a.splits);
  kernel<<<grid, DEC_THREADS, smem, a.stream>>>(
      a.x, a.w, a.scale, a.zero, a.ws, a.counters, a.out, a.M, a.K, a.N,
      a.group, a.k_chunk, a.splits);
  return (int)cudaGetLastError();
}

template <int FMT, int BM, bool VEC16>
int launch_prefill(const Args& a) {
  static int granted = 0;
  auto kernel = qmm_prefill_kernel<FMT, BM, VEC16>;
  const int smem = PrefillSmem<FMT, BM>::TOTAL;
  const int err = ensure_smem(kernel, smem, granted);
  if (err != 0) return err;
  // row tiles fastest: the blocks that share a weight tile run together
  const dim3 grid((a.M + BM - 1) / BM, (a.N + PF_BN - 1) / PF_BN);
  kernel<<<grid, PF_THREADS, smem, a.stream>>>(a.x, a.w, a.scale, a.zero,
                                               a.out, a.M, a.K, a.N, a.group);
  return (int)cudaGetLastError();
}

// The prefill row tile: 64 for M <= 64, else 128.
template <int FMT, bool VEC16>
int launch_prefill_rows(const Args& a) {
  if (a.M <= 64) return launch_prefill<FMT, 64, VEC16>(a);
  return launch_prefill<FMT, 128, VEC16>(a);
}

template <int FMT>
int dispatch(const Args& a, bool decode, bool vec16) {
  if (decode) {
    if (a.M <= 8)
      return vec16 ? launch_decode<FMT, 1, true>(a)
                   : launch_decode<FMT, 1, false>(a);
    return vec16 ? launch_decode<FMT, 2, true>(a)
                 : launch_decode<FMT, 2, false>(a);
  }
  return vec16 ? launch_prefill_rows<FMT, true>(a)
               : launch_prefill_rows<FMT, false>(a);
}

}  // namespace

// One launch of the q8 (fmt 0) or q4 (fmt 1) kernel: x (M, K) bf16, w (K, N)
// int8 or (K/2, N) packed uint8, scale (1, N) or (K/group, N) f32, zero
// (K/group, N) f32 for q4, out (M, N) bf16. decode != 0 takes the decode
// regime (M <= 16) with `splits` K chunks of `k_chunk` (a multiple of 64, of
// the group for q4); splits > 1 needs ws (splits * M * N f32) and counters
// (one zeroed unsigned per 128 columns, left zeroed). K % 8 == 0, N % 8 == 0,
// x 16-byte aligned, w 8-byte aligned, scale and zero 16-byte aligned.
extern "C" int quant_matmul(int fmt, const void* x, const void* w,
                            const void* scale, const void* zero, void* ws,
                            void* counters, void* out, int M, int K, int N,
                            int group, int decode, int splits, int k_chunk,
                            void* stream) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  const uintptr_t sa = reinterpret_cast<uintptr_t>(scale);
  const uintptr_t za = reinterpret_cast<uintptr_t>(zero);
  if ((fmt != kQ8 && fmt != kQ4) || M <= 0 || K <= 0 || N <= 0 ||
      K % 8 != 0 || N % 8 != 0 || xa % 16 != 0 || wa % 8 != 0 ||
      sa % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (fmt == kQ4 && (zero == nullptr || za % 16 != 0 || group <= 0 ||
                     group % 64 != 0 || K % group != 0))
    return (int)cudaErrorInvalidValue;
  if (decode) {
    const int unit = fmt == kQ4 ? group : 64;
    if (M > 16 || splits <= 0 || k_chunk <= 0 || k_chunk % unit != 0 ||
        (long long)(splits - 1) * k_chunk >= K ||
        (long long)splits * k_chunk < K ||
        decode_smem(M <= 8 ? 8 : 16, k_chunk) > 227 * 1024 ||
        (splits > 1 && (ws == nullptr || counters == nullptr)))
      return (int)cudaErrorInvalidValue;
  }
  const Args a{reinterpret_cast<const bf16*>(x),
               reinterpret_cast<const uint8_t*>(w),
               reinterpret_cast<const float*>(scale),
               reinterpret_cast<const float*>(zero),
               reinterpret_cast<float*>(ws),
               reinterpret_cast<unsigned*>(counters),
               reinterpret_cast<bf16*>(out),
               M, K, N, fmt == kQ4 ? group : 64, decode ? splits : 1,
               k_chunk, reinterpret_cast<cudaStream_t>(stream)};
  const bool vec16 = N % 16 == 0 && wa % 16 == 0;
  return fmt == kQ8 ? dispatch<kQ8>(a, decode != 0, vec16)
                    : dispatch<kQ4>(a, decode != 0, vec16);
}
