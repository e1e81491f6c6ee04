// Mamba2 SSD chunk scan for Hopper: a chunk-parallel scan on the tensor
// cores, in one cooperative launch.
//
// Replaces the Pallas kernel ssd_bshp (_kernel) in src/repro/kernels/ssd/ssd.py:
// x (B,S,H,P) bf16, dt (B,S,H) f32 after softplus, A (H,) f32 negative, and
// B, C (B,S,G,N) bf16, where head h reads group h / (H/G). With chunks of Q
// tokens (S % Q == 0, Q <= 128) and a (P, N) f32 state per (batch, head):
//     cs    = inclusive cumsum of dt * A over the chunk
//     y     = ((C B^T) o L) (x dt) + (C state^T) o exp(cs),
//             L[i,j] = exp(cs_i - cs_j) for i >= j, else 0
//     state = state exp(cs_Q) + (x dt)^T (B o exp(cs_Q - cs))
// -> y (B,S,H,P) f32 and the final state (B,H,P,N) f32. The Pallas grid runs
// the chunks of a (batch, head) in order and carries the state in VMEM.
//
// What bounds it on an H100. Per chunk and head the chunked form needs
// 2 T N flops for C B^T (T = Q(Q+1)/2 pairs on and below the diagonal), 2 T P
// for the masked product with x dt, and 2 Q P N each for C state^T and the
// state update; at mamba2-370m's widths (Q 128, P 64, N 128) that is 5.3
// MFLOP on 24 KB of bf16 inputs and 32 KB of f32 output, so on the tensor
// cores the scan is bound by its bytes (y in f32 is two thirds of them).
// The chunked form adds the states it passes between chunks: each is
// written, read, rewritten and read again through L2 (4 x 32 KB a chunk
// and head at N 128), which is as much traffic again as the inputs and y.
//
// Design: the Mamba2 paper's chunked split (arXiv:2405.21060, section 6) in
// three phases over one persistent grid of one block an SM (two
// warpgroups), sized so that every block is resident
// (cudaLaunchCooperativeKernel refuses a grid that is not); a grid-wide
// barrier separates the phases. Phases 1 and 3 take items of HG heads of one
// group in one chunk, so the heads share the chunk's B and C tiles (and,
// in phase 3, C B^T).
//   1. Chunk states: per item, B's chunk rows once; then each warpgroup
//      takes every other head: local = (x dt exp(cs_Q - cs))^T B on wgmma
//      into the workspace, with the chunk's total cs_Q. With one chunk
//      (S = Q) the local state is the final state, phase 2 and both
//      barriers drop out, and phase 3 reads nothing phase 1 wrote.
//   2. State passing, each float4 of a (b, h) state: the only sequential
//      part, nc fused multiply-adds an element,
//      S_c = S_{c-1} exp(cs_Q,c-1) + local_{c-1}; the state entering each
//      chunk replaces that chunk's local state in place, already split
//      for phase 3's products, and the last one is the final state.
//   3. Chunk outputs: per item, warpgroup r owns chunk rows 64 r .. 64 r +
//      63 and computes its blocks of C B^T once, into shared memory; then
//      for each head, while the next head's x and entering state load:
//      y = exp(cs) o (C S^T) + (L dt o C B^T) x, the mask L and dt applied
//      to each thread's own C B^T accumulator while C S^T runs, the result
//      feeding the product with x as the register A operand.
// Each phase is bound by its share of the traffic above (PERF.md).
// Precision. The check is absolute (0.05 on y, whose size reaches ~25), so
// the f32 operands cannot go to the tensor cores as bf16 (0.09 measured on
// the CPU by emulation). Each product keeps one factor that is exactly
// bf16: C B^T multiplies bf16 C and B (exact products, f32 accumulation);
// dt moves to the f32 side (x dt w B = (x dt w) B, L x dt = (L dt) x), so B,
// x and C enter as they are, and the f32 factor (x dt w, L dt, the state)
// is split into bf16 hi + lo parts: two products, the tensor-core time of
// one TF32 product, with the f32 factor held to 2^-16 instead of TF32's
// 2^-11.
// Layout. Operands sit in shared memory in 128-byte-swizzled tiles of
// 64-column slabs (wgmma.cuh), rows of tokens for x, B and C and rows of p
// for the state; x and B are read where they need a transpose with the
// wgmma's transpose bits, so nothing is transposed by hand. Rows past Q and
// columns past P and N are zero-filled to the 64-row, k16 tile; a row past
// Q is computed and never stored. exp(cs_i - cs_j) is taken only on and
// below the diagonal (the upper triangle can overflow, and 0 * inf is
// NaN). Every sum has a fixed order and no atomics are used, so a repeat
// launch gives equal bits.
//
// The workspace (caller-owned, not zeroed) holds B * nc * H states of
// (P, N) f32 and B * nc * H chunk totals. Launches on the caller's stream
// and allocates nothing.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int WG = 128;            // threads of a warpgroup
constexpr int THREADS = 2 * WG;    // two warpgroups a block
constexpr int QMAX = 128;          // chunk rows a tile holds
constexpr int PP = 64;             // head dim padded to one 64-column slab
constexpr int HG_MAX = 8;          // heads of an item
constexpr int ROWV = 4 * QMAX;     // floats of a head's row vectors
constexpr int SMEM_MAX = 227 * 1024;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const bf16* x;
  const float* dt;
  const float* A;
  const bf16* Bm;
  const bf16* Cm;
  float* y;
  float* fs;
  float* st;    // (B, nc, H, P, N): local states, then entering states
  float* cq;    // (B, nc, H): each chunk's total cs_Q
  int Bb, S, H, P, G, N, Q, nc, hg;
};

// Shared memory of a block for a state dim padded to NP (64 or 128), bytes:
// C's 128 chunk rows as two 64-row tiles and B's 128 rows (phase 1 reads
// the same B tile), two head buffers (phase 3: x's 128 rows and the
// entering state's hi and lo parts, 64 rows p; phase 1: each warpgroup's
// x dt w in hi and lo parts), phase 3's C B^T accumulators (warpgroup 0:
// its one column block; warpgroup 1: both), and HG_MAX heads' row vectors
// (cs in log2 units, dt, exp(cs), dt exp(cs_Q - cs)).
template <int NP>
struct Layout {
  static constexpr int TILE64 = 64 * NP * 2;     // a 64-row tile of C
  static constexpr int C = 0;
  static constexpr int BT = C + 2 * TILE64;
  static constexpr int X = 0;                     // in a head buffer
  static constexpr int SH = X + QMAX * PP * 2;
  static constexpr int SL = SH + TILE64;
  static constexpr int XH = 0;                    // phase 1
  static constexpr int XL = QMAX * PP * 2;
  static constexpr int BUF = SL + TILE64 > XL + QMAX * PP * 2
                                 ? SL + TILE64 : XL + QMAX * PP * 2;
  static constexpr int BUF0 = BT + QMAX * NP * 2;
  static constexpr int CB = BUF0 + 2 * BUF;
  static constexpr int ROWS = CB + 3 * 32 * WG * 4;
  static constexpr int TOTAL = ROWS + HG_MAX * ROWV * 4;
};

// D (64 x n, f32) = A (64 x 16, bf16, shared memory, MN-major) * B (16 x n,
// bf16, shared memory, MN-major) + (accumulate ? D : 0); n = 64 or 128:
// both transpose bits set.
__device__ __forceinline__ void wgmma_bf16_tt(float (&d)[32],
                                              uint64_t desc_a,
                                              uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_bf16_tt(float (&d)[64],
                                              uint64_t desc_a,
                                              uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}


// Byte offset of 16-byte chunk c of row r in a tile of ROWS rows: 64-column
// slabs of ROWS swizzled 128-byte rows (the layout of flash_attention.cu).
template <int ROWS>
__device__ __forceinline__ int tile_off(int r, int c) {
  return (c >> 3) * (ROWS * 128) + sw128(r, c & 7);
}

// A wgmma descriptor moved by `bytes` within shared memory: the start
// address field holds the address / 16, and no tile here crosses its top.
__device__ __forceinline__ uint64_t desc_at(uint64_t desc, int bytes) {
  return desc + (uint64_t)(bytes >> 4);
}

// the named barrier of warpgroup w (barrier 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int w) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(w + 1), "n"(WG) : "memory");
}

// 2^x on the special-function unit (2 ulp; 0 for x below -126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// an f32 pair -> its bf16 rounding (hi) and the bf16 rounding of the rest
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16x2(a - f.x, b - f.y);
}

// ROWS_USED rows of a chunk operand (CHUNKS 16-byte chunks a row) by
// cp.async from all threads of the block into a tile of TROWS rows: row r
// reads src + r * stride, chunk c its 8 values from 8 c; rows from `rows`
// on and chunks from `chunks` on are zero-filled (and read nothing; `base`
// stands in as their address).
template <int ROWS_USED, int TROWS, int CHUNKS>
__device__ __forceinline__ void load_tile(uint8_t* dst, const bf16* src,
                                          const bf16* base, size_t stride,
                                          int rows, int chunks) {
  constexpr int PER = ROWS_USED * CHUNKS / THREADS;
  static_assert(PER * THREADS == ROWS_USED * CHUNKS, "tile / threads");
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int e = threadIdx.x + k * THREADS;
    const int r = e / CHUNKS, c = e % CHUNKS;
    const bool ok = r < rows && c < chunks;
    cp_async16(dst + tile_off<TROWS>(r, c),
               ok ? src + r * stride + 8 * c : base, ok);
  }
}

// One warp: the row vectors of head h in chunk tok0 (rows past Q hold dt 0
// and carry cs_{Q-1}): cs in log2 units, dt, exp(cs), dt exp(cs_Q - cs).
// Returns cs_{Q-1} (natural units).
__device__ __forceinline__ float chunk_rows(const Params& p, size_t tok0,
                                            int h, float* rows) {
  const int lane = threadIdx.x & 31;
  const float a = p.A[h];
  float v[4], d[4];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = lane * 4 + k;
    d[k] = i < p.Q ? p.dt[(tok0 + i) * p.H + h] : 0.f;
    run += d[k] * a;
    v[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  const float excl = incl - run;
  const float total = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = lane * 4 + k;
    const float c = v[k] + excl;
    rows[i] = c * LOG2E;
    rows[QMAX + i] = d[k];
    rows[2 * QMAX + i] = expf(c);
    rows[3 * QMAX + i] = d[k] * expf(total - c);
  }
  return total;
}

// Every warp of the block: the row vectors of the item's heads h0 + k,
// warp w taking k = w, w + 8, ...; for phase 1 also each chunk total, to cq.
__device__ __forceinline__ void item_rows(const Params& p, size_t tok0,
                                          int h0, float* rows, int bc,
                                          bool phase1) {
  const int warp = threadIdx.x >> 5;
  for (int k = warp; k < p.hg; k += THREADS / 32) {
    const float total = chunk_rows(p, tok0, h0 + k, rows + k * ROWV);
    if (phase1 && (threadIdx.x & 31) == 0)
      p.cq[(size_t)bc * p.H + h0 + k] = total;
  }
}

// x's 128 chunk rows of head h (8 chunks of 8 p each) for thread wt of a
// warpgroup, zero past Q and P.
constexpr int X_PER = QMAX * (PP / 8) / WG;
__device__ __forceinline__ void load_x_rows(const Params& p, size_t tok0,
                                            int h, int wt,
                                            uint4 (&xr)[X_PER]) {
#pragma unroll
  for (int i = 0; i < X_PER; ++i) {
    const int e = wt + i * WG;
    const int j = e / (PP / 8), cc = e % (PP / 8);
    xr[i] = j < p.Q && cc < p.P / 8
        ? __ldg(reinterpret_cast<const uint4*>(
              p.x + ((tok0 + j) * p.H + h) * p.P + 8 * cc))
        : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Phase 1, item (b, c, heads h0 .. h0 + hg - 1): for each head,
// local = (x dt exp(cs_Q - cs))^T B, a (P, N) state, into the workspace.
template <int NP>
__device__ __forceinline__ void chunk_states(const Params& p, uint8_t* sm,
                                             int b, int c, int h0) {
  using L = Layout<NP>;
  const int tid = threadIdx.x, w = tid / WG, wt = tid % WG;
  const int g = h0 / (p.H / p.G);
  float* rows = reinterpret_cast<float*>(sm + L::ROWS);
  const size_t tok0 = (size_t)b * p.S + (size_t)c * p.Q;
  const int bc = b * p.nc + c;

  load_tile<QMAX, QMAX, NP / 8>(sm + L::BT, p.Bm + (tok0 * p.G + g) * p.N,
                                p.Bm, (size_t)p.G * p.N, p.Q, p.N / 8);
  cp_async_commit();
  // x's chunk rows of the warpgroup's next head, in registers: loaded while
  // the head before runs its product
  uint4 xr[X_PER];
  if (w < p.hg) load_x_rows(p, tok0, h0 + w, wt, xr);
  item_rows(p, tok0, h0, rows, bc, true);
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  uint8_t* buf = sm + L::BUF0 + w * L::BUF;
  const int warp = wt >> 5, lane = tid & 31, gq = lane >> 2, qd = lane & 3;
  for (int k = w; k < p.hg; k += 2) {
    const int h = h0 + k;
    // x scaled by dt exp(cs_Q - cs) and split into hi and lo parts: the
    // MN-major A operand (rows j)
    const float* wq = rows + k * ROWV + 3 * QMAX;
#pragma unroll
    for (int i = 0; i < X_PER; ++i) {
      const int e = wt + i * WG;
      const int j = e / (PP / 8), cc = e % (PP / 8);
      const float s = wq[j];
      const uint32_t words[4] = {xr[i].x, xr[i].y, xr[i].z, xr[i].w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)  // bf16 -> f32 is exact: the high half
        split2(__uint_as_float(words[q] << 16) * s,
               __uint_as_float(words[q] & 0xffff0000u) * s, hi[q], lo[q]);
      *reinterpret_cast<uint4*>(buf + L::XH + tile_off<QMAX>(j, cc)) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(buf + L::XL + tile_off<QMAX>(j, cc)) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    if (k + 2 < p.hg) load_x_rows(p, tok0, h + 2, wt, xr);
    fence_proxy_async();
    wg_sync(w);

    float d[NP / 2];
    const uint64_t dh = desc_sw128_mn(buf + L::XH, QMAX * 128);
    const uint64_t dl = desc_sw128_mn(buf + L::XL, QMAX * 128);
    const uint64_t db = desc_sw128_mn(sm + L::BT, QMAX * 128);
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QMAX / 16; ++kk) {
      wgmma_bf16_tt(d, desc_at(dh, kk * 2048), desc_at(db, kk * 2048),
                    kk > 0);
      wgmma_bf16_tt(d, desc_at(dl, kk * 2048), desc_at(db, kk * 2048), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);

    // one chunk: its state is the final state, and phase 2 has no work
    float* out = p.nc == 1 ? p.fs + ((size_t)b * p.H + h) * p.P * p.N
                           : p.st + ((size_t)bc * p.H + h) * p.P * p.N;
#pragma unroll
    for (int jj = 0; jj < NP / 8; ++jj) {
      const int col = 8 * jj + 2 * qd;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = 16 * warp + gq + 8 * half;
        if (row < p.P && col < p.N)
          *reinterpret_cast<float2*>(out + row * p.N + col) =
              make_float2(d[4 * jj + 2 * half], d[4 * jj + 2 * half + 1]);
      }
    }
    wg_sync(w);  // the warpgroup's buffer is free for its next head
  }
  __syncthreads();  // B's tile and the row vectors are free again
}

// Phase 2: each float4 of a (b, h) state walks the chunks in order. The
// state entering chunk c replaces that chunk's local state in place, as
// bf16 hi and lo parts ready for phase 3's products: each 8 elements of a
// state row (the 32 bytes of two neighbouring lanes' float4s) become 16
// bytes of hi, then 16 of lo, the lanes trading halves by a shuffle, so
// every load and store of a warp is 512 contiguous bytes. The last state is
// the final one, in f32. A thread takes RUNS float4s at a time and loads
// BATCH chunks ahead of the sums (16 loads in flight). The local states are
// read through L2 (other SMs wrote them in this launch).
template <int RUNS, int BATCH>
__device__ __forceinline__ void pass_states_t(const Params& p) {
  const int pn4 = p.P * p.N / 4;
  const int units = p.Bb * p.H * pn4;
  const int stride = gridDim.x * THREADS;
  const size_t cstride = (size_t)p.H * pn4;        // float4s between chunks
  const bool odd = threadIdx.x & 1;
  // every lane runs every iteration (the shuffles need the whole warp); a
  // float4 and its neighbour are live together (pn4 is even)
  for (int u0 = blockIdx.x * THREADS + threadIdx.x;
       u0 - (int)(threadIdx.x & 31) < units; u0 += RUNS * stride) {
    float4* ptr[RUNS];
    const float* cq[RUNS];
    float* out[RUNS];
    bool live[RUNS];
    float4 s[RUNS];
#pragma unroll
    for (int k = 0; k < RUNS; ++k) {
      const int u = u0 + k * stride;
      live[k] = u < units;
      const int uu = live[k] ? u : 0;
      const int e4 = uu % pn4;
      const int bh = uu / pn4;
      const int h = bh % p.H, b = bh / p.H;
      ptr[k] = reinterpret_cast<float4*>(
          p.st + ((size_t)b * p.nc * p.H + h) * p.P * p.N) + e4;
      cq[k] = p.cq + (size_t)b * p.nc * p.H + h;
      out[k] = p.fs + ((size_t)b * p.H + h) * p.P * p.N + 4 * e4;
      s[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int c0 = 0; c0 < p.nc; c0 += BATCH) {
      float4 v[RUNS][BATCH];
      float dec[RUNS][BATCH];
#pragma unroll
      for (int k = 0; k < RUNS; ++k)
#pragma unroll
        for (int i = 0; i < BATCH; ++i)
          if (live[k] && c0 + i < p.nc) {
            v[k][i] = __ldcg(ptr[k] + (c0 + i) * cstride);
            dec[k][i] = expf(__ldcg(cq[k] + (size_t)(c0 + i) * p.H));
          }
#pragma unroll
      for (int k = 0; k < RUNS; ++k)
#pragma unroll
        for (int i = 0; i < BATCH; ++i)
          if (c0 + i < p.nc) {   // uniform across the warp
            // the state entering chunk 0 is zero: phase 3 does not read it
            uint32_t hi[2], lo[2];
            split2(s[k].x, s[k].y, hi[0], lo[0]);
            split2(s[k].z, s[k].w, hi[1], lo[1]);
            // the even lane keeps the hi parts, the odd lane the lo parts
            const uint32_t give0 = odd ? hi[0] : lo[0];
            const uint32_t give1 = odd ? hi[1] : lo[1];
            const uint32_t got0 = __shfl_xor_sync(0xffffffffu, give0, 1);
            const uint32_t got1 = __shfl_xor_sync(0xffffffffu, give1, 1);
            if (live[k]) {
              if (c0 + i > 0)
                *reinterpret_cast<uint4*>(ptr[k] + (c0 + i) * cstride) =
                    odd ? make_uint4(got0, got1, lo[0], lo[1])
                        : make_uint4(hi[0], hi[1], got0, got1);
              s[k].x = fmaf(s[k].x, dec[k][i], v[k][i].x);
              s[k].y = fmaf(s[k].y, dec[k][i], v[k][i].y);
              s[k].z = fmaf(s[k].z, dec[k][i], v[k][i].z);
              s[k].w = fmaf(s[k].w, dec[k][i], v[k][i].w);
            }
          }
    }
#pragma unroll
    for (int k = 0; k < RUNS; ++k)
      if (live[k]) *reinterpret_cast<float4*>(out[k]) = s[k];
  }
}

// Phase 2 with the float4s a thread takes at once set by the chunk count,
// so that a thread has 16 loads in flight: 4 float4s up to 4 chunks, else 1
// (at 3 and 4 chunks, 1 float4 a thread read 7-11% slower; PERF.md).
__device__ __forceinline__ void pass_states(const Params& p) {
  if (p.nc <= 4)
    pass_states_t<4, 4>(p);
  else
    pass_states_t<1, 16>(p);
}

// Phase 3, the block's loads of head h into a head buffer (chunk 0's
// zero state is zero-filled, not read): x's 128 chunk rows (MN-major B
// operand) and the entering state's hi and lo parts (K-major B operand,
// rows p), as phase 2 left them: each 8 values of a state row as 16 bytes
// of hi, then 16 of lo; neighbouring threads copy the two halves.
template <int NP>
__device__ __forceinline__ void load_head(const Params& p, uint8_t* buf,
                                          size_t tok0, int bc, int h) {
  using L = Layout<NP>;
  constexpr int NC = NP / 8;
  load_tile<QMAX, QMAX, PP / 8>(buf + L::X, p.x + (tok0 * p.H + h) * p.P,
                                p.x, (size_t)p.H * p.P, p.Q, p.P / 8);
  const uint8_t* s_in = reinterpret_cast<const uint8_t*>(
      p.st + ((size_t)bc * p.H + h) * p.P * p.N);
  const bool first = bc % p.nc == 0;   // chunk 0 enters with a zero state
#pragma unroll
  for (int k = 0; k < 2 * 64 * NC / THREADS; ++k) {
    const int e = threadIdx.x + k * THREADS;
    const int part = e & 1, pr = (e >> 1) / NC, cc = (e >> 1) % NC;
    const bool ok = !first && pr < p.P && cc < p.N / 8;
    cp_async16(buf + (part ? L::SL : L::SH) + tile_off<64>(pr, cc),
               ok ? s_in + (size_t)(pr * p.N + 8 * cc) * 4 + 16 * part
                  : s_in,
               ok);
  }
}

// (L dt) o C B^T of one 64 x 64 block (chunk rows i0 and i1 of the thread,
// columns j0 .. j0 + 63), split into bf16 hi and lo parts: the wgmma D
// fragment of 16 columns is the A fragment of a k16 step. cbs holds the
// block's C B^T accumulator (the thread's float4 jj at cbs[jj * WG]), rv
// the head's row vectors; the exponent is taken only where j <= i.
__device__ __forceinline__ void mask_block(const float4* cbs, int j0,
                                           const float* rv, int i0, int i1,
                                           float cs0, float cs1, int qd,
                                           uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int j = j0 + 8 * jj + 2 * qd;
    const float2 csj = *reinterpret_cast<const float2*>(rv + j);
    const float2 dtj = *reinterpret_cast<const float2*>(rv + QMAX + j);
    const float4 v = cbs[jj * WG];
    // rows i0 (v.x, v.y) and i1 (v.z, v.w), columns j and j + 1
    const float m00 = j <= i0 ? v.x * ex2(cs0 - csj.x) * dtj.x : 0.f;
    const float m01 = j + 1 <= i0 ? v.y * ex2(cs0 - csj.y) * dtj.y : 0.f;
    const float m10 = j <= i1 ? v.z * ex2(cs1 - csj.x) * dtj.x : 0.f;
    const float m11 = j + 1 <= i1 ? v.w * ex2(cs1 - csj.y) * dtj.y : 0.f;
    split2(m00, m01, hi[jj >> 1][2 * (jj & 1)], lo[jj >> 1][2 * (jj & 1)]);
    split2(m10, m11, hi[jj >> 1][2 * (jj & 1) + 1],
           lo[jj >> 1][2 * (jj & 1) + 1]);
    // load the second half's operands only now: registers are short
    if (jj == 3) asm volatile("" ::: "memory");
  }
}

// Issue y (+)= ((L dt) o C B^T of one block) x, both parts (the first
// wgmma overwrites y when `first`), x's rows j0 .. j0 + 63 read MN-major
// from the head buffer.
template <int NP>
__device__ __forceinline__ void issue_mx(float (&y)[PP / 2],
                                         const uint32_t (&hi)[4][4],
                                         const uint32_t (&lo)[4][4],
                                         const uint8_t* buf, int j0,
                                         bool first) {
  using L = Layout<NP>;
  const uint64_t dx = desc_sw128_mn(buf + L::X, QMAX * 128);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = desc_at(dx, (j0 / 16 + kk) * 2048);
    wgmma_bf16<1>(y, hi[kk][0], hi[kk][1], hi[kk][2], hi[kk][3], db,
                  !(first && kk == 0));
    wgmma_bf16<1>(y, lo[kk][0], lo[kk][1], lo[kk][2], lo[kk][3], db, 1);
  }
}

// Issue y = C S^T for the 64-row C tile c_tile, from the entering state's
// hi and lo parts in the head buffer (K-major over the padded state dim).
template <int NP>
__device__ __forceinline__ void issue_cs(float (&y)[PP / 2],
                                         const uint8_t* c_tile,
                                         const uint8_t* buf) {
  using L = Layout<NP>;
  const uint64_t dc = desc_sw128(c_tile), dh = desc_sw128(buf + L::SH),
                 dl = desc_sw128(buf + L::SL);
#pragma unroll
  for (int kk = 0; kk < NP / 16; ++kk) {
    const int off = (kk >> 2) * (64 * 128) + 32 * (kk & 3);
    wgmma_bf16_ss(y, desc_at(dc, off), desc_at(dh, off), kk > 0);
    wgmma_bf16_ss(y, desc_at(dc, off), desc_at(dl, off), 1);
  }
}

// y rows i0 and i1 of head h.
__device__ __forceinline__ void store_rows(const Params& p, size_t tok0,
                                           int h, int i0, int i1, int qd,
                                           const float (&y)[PP / 2]) {
#pragma unroll
  for (int j = 0; j < PP / 8; ++j) {
    const int col = 8 * j + 2 * qd;
    if (col < p.P) {
      if (i0 < p.Q)
        *reinterpret_cast<float2*>(p.y + ((tok0 + i0) * p.H + h) * p.P +
                                   col) = make_float2(y[4 * j], y[4 * j + 1]);
      if (i1 < p.Q)
        *reinterpret_cast<float2*>(p.y + ((tok0 + i1) * p.H + h) * p.P +
                                   col) =
            make_float2(y[4 * j + 2], y[4 * j + 3]);
    }
  }
}

// Phase 3, item (b, c, heads h0 .. h0 + hg - 1): y = exp(cs) o (C S^T) +
// (L dt o C B^T) x for every head, S the state entering the chunk.
// Warpgroup r owns chunk rows 64 r .. 64 r + 63. C B^T does not depend on
// the head: its blocks on and below the diagonal (warpgroup 0: columns
// 0..63; warpgroup 1: 0..127) are computed once and kept in shared memory,
// each thread reading back its own accumulator. For each head, while the
// next head's x and entering state load (two head buffers): C S^T, with the
// mask and split of the warpgroup's blocks running beside it, then the
// masked product.
template <int NP>
__device__ __forceinline__ void chunk_outputs(const Params& p, uint8_t* sm,
                                              int b, int c, int h0) {
  using L = Layout<NP>;
  constexpr int NC = NP / 8;
  const int tid = threadIdx.x, r = tid / WG, wt = tid % WG;
  const int warp = wt >> 5, lane = tid & 31, gq = lane >> 2, qd = lane & 3;
  const int g = h0 / (p.H / p.G);
  float* rows = reinterpret_cast<float*>(sm + L::ROWS);
  const size_t tok0 = (size_t)b * p.S + (size_t)c * p.Q;
  const int bc = b * p.nc + c;
  const size_t bc_stride = (size_t)p.G * p.N;
  const bf16* c_src = p.Cm + (tok0 * p.G + g) * p.N;
  const uint8_t* c_tile = sm + L::C + r * L::TILE64;

  load_tile<64, 64, NC>(sm + L::C, c_src, p.Cm, bc_stride, p.Q, p.N / 8);
  load_tile<64, 64, NC>(sm + L::C + L::TILE64, c_src + 64 * bc_stride, p.Cm,
                        bc_stride, p.Q - 64, p.N / 8);
  load_tile<QMAX, QMAX, NC>(sm + L::BT, p.Bm + (tok0 * p.G + g) * p.N, p.Bm,
                            bc_stride, p.Q, p.N / 8);
  cp_async_commit();
  load_head<NP>(p, sm + L::BUF0, tok0, bc, h0);
  cp_async_commit();
  if (p.hg > 1) load_head<NP>(p, sm + L::BUF0 + L::BUF, tok0, bc, h0 + 1);
  cp_async_commit();
  item_rows(p, tok0, h0, rows, bc, false);
  cp_async_wait<2>();
  fence_proxy_async();
  __syncthreads();

  // C B^T of this warpgroup's rows, column blocks jb = 0, 1 (B's block jb
  // starts at its row 64 jb of every slab), one block at a time: warpgroup
  // 0 keeps block 0, warpgroup 1 both, at float4s (8 q + jj) * WG + wt of
  // the CB region (q = 0: rows 0..63 x columns 0..63; 1: rows 64..127 x
  // 0..63; 2: rows 64..127 x 64..127); warpgroup 0's second block (past
  // the diagonal) is computed and dropped
  float4* cbs = reinterpret_cast<float4*>(sm + L::CB) + 8 * r * WG + wt;
  const uint64_t dcb = desc_sw128(c_tile), dbt = desc_sw128(sm + L::BT);
#pragma unroll
  for (int jb = 0; jb < 2; ++jb) {
    float cb[32];
    fence_regs(cb);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk)
      wgmma_bf16_ss(cb, desc_at(dcb, (kk >> 2) * (64 * 128) + 32 * (kk & 3)),
                    desc_at(dbt, (kk >> 2) * (QMAX * 128) + jb * (64 * 128) +
                                     32 * (kk & 3)),
                    kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(cb);
    if (jb <= r) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        cbs[(8 * jb + jj) * WG] = make_float4(cb[4 * jj], cb[4 * jj + 1],
                                              cb[4 * jj + 2], cb[4 * jj + 3]);
    }
  }

  const int i0 = 64 * r + 16 * warp + gq, i1 = i0 + 8;
  for (int k = 0; k < p.hg; ++k) {
    const int h = h0 + k;
    uint8_t* buf = sm + L::BUF0 + (k & 1) * L::BUF;
    cp_async_wait<1>();  // head k's loads (the next head's may run on)
    fence_proxy_async();
    __syncthreads();

    // C S^T from the state's two parts; meanwhile the warpgroup's blocks
    // of (L dt) o C B^T in bf16 parts (warpgroup 0's second block is zero)
    const float* rv = rows + k * ROWV;
    float y[PP / 2];
    fence_regs(y);
    wgmma_fence();
    issue_cs<NP>(y, c_tile, buf);
    wgmma_commit();
    const float cs0 = rv[i0], cs1 = rv[i1];
    uint32_t hf[2][4][4], lf[2][4][4];
    mask_block(cbs, 0, rv, i0, i1, cs0, cs1, qd, hf[0], lf[0]);
    if (r > 0) {
      mask_block(cbs + 8 * WG, 64, rv, i0, i1, cs0, cs1, qd, hf[1], lf[1]);
    } else {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) hf[1][a][e] = lf[1][a][e] = 0u;
    }
    wgmma_wait<0>();
    fence_regs(y);
    const float e0 = rv[2 * QMAX + i0], e1 = rv[2 * QMAX + i1];
#pragma unroll
    for (int j = 0; j < PP / 8; ++j) {
      y[4 * j] *= e0;
      y[4 * j + 1] *= e0;
      y[4 * j + 2] *= e1;
      y[4 * j + 3] *= e1;
    }
    // y += the masked product
    fence_regs(y);
    wgmma_fence();
    issue_mx<NP>(y, hf[0], lf[0], buf, 0, false);
    issue_mx<NP>(y, hf[1], lf[1], buf, 64, false);
    wgmma_commit();
    wgmma_wait<0>();
    keep_live(hf[0]);
    keep_live(lf[0]);
    keep_live(hf[1]);
    keep_live(lf[1]);
    fence_regs(y);
    __syncthreads();  // head k's buffer is free for head k + 2
    if (k + 2 < p.hg) load_head<NP>(p, buf, tok0, bc, h + 2);
    cp_async_commit();
    store_rows(p, tok0, h, i0, i1, qd, y);
  }
  cp_async_wait<0>();
}

template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
ssd_kernel(const Params p) {
  extern __shared__ __align__(1024) uint8_t ssd_smem[];
  cg::grid_group grid = cg::this_grid();
  // items (b, c, group of hg heads), the heads fastest (the work order
  // that tests/test_torch_ssd.py checks for coverage)
  const int per_bc = p.H / p.hg, items = p.Bb * p.nc * per_bc;
  for (int t = blockIdx.x; t < items; t += gridDim.x)
    chunk_states<NP>(p, ssd_smem, t / (per_bc * p.nc), (t / per_bc) % p.nc,
                     (t % per_bc) * p.hg);
  if (p.nc > 1) {  // the same branch in every block
    grid.sync();
    pass_states(p);
    grid.sync();
  }
  for (int t = blockIdx.x; t < items; t += gridDim.x)
    chunk_outputs<NP>(p, ssd_smem, t / (per_bc * p.nc), (t / per_bc) % p.nc,
                      (t % per_bc) * p.hg);
}

// Blocks of ssd_kernel<NP> that are resident at once on the current device
// (cached per device), after opting in to its shared memory.
template <int NP>
int resident_blocks(int& out) {
  constexpr int MAX_DEVICES = 64;
  static int cache[MAX_DEVICES] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < MAX_DEVICES && cache[dev] > 0) {
    out = cache[dev];
    return 0;
  }
  auto kernel = ssd_kernel<NP>;
  constexpr int smem = Layout<NP>::TOTAL;
  static_assert(smem <= SMEM_MAX, "tile does not fit in shared memory");
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * sms <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  out = per_sm * sms;
  if (dev < MAX_DEVICES) cache[dev] = out;
  return 0;
}

template <int NP>
int launch(Params p, int grid, cudaStream_t stream) {
  int resident = 0;
  const int err = resident_blocks<NP>(resident);
  if (err != 0) return err;
  if (grid > resident) grid = resident;   // every block must be resident
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel((const void*)ssd_kernel<NP>,
                                          dim3(grid), dim3(THREADS), args,
                                          Layout<NP>::TOTAL, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// x (B,S,H,P) bf16, dt (B,S,H) f32, A (H,) f32, Bm/Cm (B,S,G,N) bf16, all
// contiguous -> y (B,S,H,P) f32, fs (B,H,P,N) f32; ws the workspace of
// B * (S/Q) * H * (P * N + 1) f32. P in {16, 32, 64}, N in {16, 32, 64,
// 128}, 1 <= Q <= 128, S % Q == 0, H % G == 0; hg (heads an item) divides
// H / G, at most 16; x, B, C, fs and ws 16-byte aligned. `grid` is the
// planned number of blocks; the launch takes at most as many as can be
// resident at once.
extern "C" int ssd_bshp(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, void* y, void* fs,
                        void* ws, int Bb, int S, int H, int P, int G, int N,
                        int Q, int hg, int grid, void* stream) {
  if (Bb <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || Q <= 0 ||
      Q > QMAX || S % Q != 0 || grid <= 0 || hg <= 0 || hg > HG_MAX ||
      (H / G) % hg != 0 || (P != 16 && P != 32 && P != 64) ||
      (N != 16 && N != 32 && N != 64 && N != 128) ||
      (long long)Bb * H * P * N / 4 >= (1ll << 30) || !aligned16(x) ||
      !aligned16(Bm) || !aligned16(Cm) || !aligned16(fs) || !aligned16(ws) ||
      reinterpret_cast<uintptr_t>(y) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = reinterpret_cast<const bf16*>(x);
  p.dt = reinterpret_cast<const float*>(dt);
  p.A = reinterpret_cast<const float*>(A);
  p.Bm = reinterpret_cast<const bf16*>(Bm);
  p.Cm = reinterpret_cast<const bf16*>(Cm);
  p.y = reinterpret_cast<float*>(y);
  p.fs = reinterpret_cast<float*>(fs);
  p.Bb = Bb;
  p.S = S;
  p.H = H;
  p.P = P;
  p.G = G;
  p.N = N;
  p.Q = Q;
  p.nc = S / Q;
  p.hg = hg;
  p.st = reinterpret_cast<float*>(ws);
  p.cq = p.st + (size_t)Bb * p.nc * H * P * N;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return N <= 64 ? launch<64>(p, grid, st) : launch<128>(p, grid, st);
}
