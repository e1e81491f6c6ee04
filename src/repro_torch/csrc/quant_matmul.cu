// Fused dequant matmul for Hopper: x (M, K) bf16 @ W -> (M, N) bf16.
//
// Replaces the Pallas kernels in src/repro/kernels/quant_matmul/quant_matmul.py:
//   q8_matmul (_q8_kernel): W (K, N) int8, per-column f32 scale (1, N) applied
//                           once to the f32 sum, result cast to bf16;
//   q4_matmul (_q4_kernel): W packed (K/2, N) uint8, even k in the low nibble,
//                           odd k in the high nibble; per 128-row group an f32
//                           scale and zero (K/g, N); each group adds
//                           s * (x @ q) + (sum x) * z to the f32 sum.
//
// What bounds it on an H100: at decode (M <= 8 rows) the weight bytes. A Q8
// step of the full-width model streams ~7 GB of int8, a Q4 step ~4 GB, and the
// arithmetic is 2 flops per weight byte per row, far below the ~295 flop/byte
// ridge. So the design streams each weight byte from device memory once per
// 8-row block with coalesced 8-byte loads (8 columns per thread, neighbouring
// threads on neighbouring columns), dequantizes in registers and keeps the
// x rows in f32 registers/L1. Small N gets parallelism from split-K: grid.z
// cuts K into chunks whose f32 partials land in a workspace, and a second
// pass sums them in a fixed order (deterministic), applies the q8 column
// scale and casts to bf16. Row blocks run fastest in the grid, so blocks that
// share a weight tile run together and re-read it from L2 when M > 8
// (prefill). Prefill rows are compute on CUDA cores here, not tensor cores:
// right and simple first; PERF.md carries its time beside its bound.
//
// The kernels launch on the caller's stream and allocate nothing; the
// wrapper (kernels/quant_matmul/ops.py) owns every buffer.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;                   // x rows per block
constexpr int COLS = 8;                   // output columns per thread
constexpr int THREADS = 64;               // threads per block
constexpr int BLOCK_COLS = COLS * THREADS;

__device__ __forceinline__ float load_bf16(const __nv_bfloat16* p) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

__device__ __forceinline__ unsigned byte_of(const uint2& v, int c) {
  const unsigned word = c < 4 ? v.x : v.y;
  return (word >> (8 * (c & 3))) & 0xffu;
}

__global__ void __launch_bounds__(THREADS)
q8_partial_kernel(const __nv_bfloat16* __restrict__ x,
                  const int8_t* __restrict__ w,
                  float* __restrict__ part,
                  int M, int K, int N, int k_chunk) {
  const int row0 = blockIdx.x * ROWS;
  const int col0 = (blockIdx.y * THREADS + threadIdx.x) * COLS;
  const int split = blockIdx.z;
  if (col0 >= N) return;
  const int rows = min(ROWS, M - row0);
  const int k0 = split * k_chunk;
  const int k1 = min(K, k0 + k_chunk);
  float acc[ROWS][COLS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = 0.f;
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const uint2 packed =
        __ldg(reinterpret_cast<const uint2*>(w + (size_t)k * N + col0));
    float wf[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      wf[c] = (float)(int8_t)(uint8_t)byte_of(packed, c);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < rows) {
        const float xv = load_bf16(x + (size_t)(row0 + r) * K + k);
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[r][c] = fmaf(xv, wf[c], acc[r][c]);
      }
    }
  }
  float* out = part + (size_t)split * M * N;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r < rows) {
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        out[(size_t)(row0 + r) * N + col0 + c] = acc[r][c];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
q4_partial_kernel(const __nv_bfloat16* __restrict__ x,
                  const uint8_t* __restrict__ w,
                  const float* __restrict__ scale,
                  const float* __restrict__ zero,
                  float* __restrict__ part,
                  int M, int K, int N, int k_chunk, int group) {
  const int row0 = blockIdx.x * ROWS;
  const int col0 = (blockIdx.y * THREADS + threadIdx.x) * COLS;
  const int split = blockIdx.z;
  if (col0 >= N) return;
  const int rows = min(ROWS, M - row0);
  const int k0 = split * k_chunk;
  const int k1 = min(K, k0 + k_chunk);
  float acc[ROWS][COLS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = 0.f;
  for (int g0 = k0; g0 < k1; g0 += group) {
    float accg[ROWS][COLS];
    float xs[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      xs[r] = 0.f;
#pragma unroll
      for (int c = 0; c < COLS; ++c) accg[r][c] = 0.f;
    }
#pragma unroll 2
    for (int k = g0; k < g0 + group; k += 2) {
      const uint2 packed = __ldg(
          reinterpret_cast<const uint2*>(w + (size_t)(k >> 1) * N + col0));
      float lo[COLS], hi[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const unsigned b = byte_of(packed, c);
        lo[c] = (float)(b & 0xfu);
        hi[c] = (float)(b >> 4);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < rows) {
          const __nv_bfloat16* xr = x + (size_t)(row0 + r) * K + k;
          const float x0 = load_bf16(xr);
          const float x1 = load_bf16(xr + 1);
          xs[r] += x0 + x1;
#pragma unroll
          for (int c = 0; c < COLS; ++c)
            accg[r][c] = fmaf(x1, hi[c], fmaf(x0, lo[c], accg[r][c]));
        }
      }
    }
    const size_t gi = (size_t)(g0 / group) * N + col0;
    float s[COLS], z[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      s[c] = __ldg(scale + gi + c);
      z[c] = __ldg(zero + gi + c);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        acc[r][c] += s[c] * accg[r][c] + xs[r] * z[c];
  }
  float* out = part + (size_t)split * M * N;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r < rows) {
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        out[(size_t)(row0 + r) * N + col0 + c] = acc[r][c];
    }
  }
}

// Sum the split-K partials in split order, apply the optional per-column
// scale (q8) and cast to bf16.
__global__ void splitk_reduce_kernel(const float* __restrict__ part,
                                     const float* __restrict__ col_scale,
                                     __nv_bfloat16* __restrict__ out,
                                     int M, int N, int splits) {
  const size_t total = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += part[(size_t)sp * total + i];
  if (col_scale != nullptr) s *= col_scale[i % N];
  out[i] = __float2bfloat16(s);
}

int launch_reduce(const float* part, const float* col_scale,
                  __nv_bfloat16* out, int M, int N, int splits,
                  cudaStream_t stream) {
  const size_t total = (size_t)M * N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  splitk_reduce_kernel<<<blocks, threads, 0, stream>>>(part, col_scale, out,
                                                       M, N, splits);
  return (int)cudaGetLastError();
}

dim3 partial_grid(int M, int N, int splits) {
  return dim3((M + ROWS - 1) / ROWS, (N + BLOCK_COLS - 1) / BLOCK_COLS,
              splits);
}

}  // namespace

// x (M,K) bf16, w (K,N) int8, scale (N) f32, part (splits,M,N) f32 workspace,
// out (M,N) bf16. N % 8 == 0 and 8-byte aligned rows are the caller's checks.
extern "C" int q8_matmul(const void* x, const void* w, const void* scale,
                         void* part, void* out, int M, int K, int N,
                         int splits, int k_chunk, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || N % COLS != 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  q8_partial_kernel<<<partial_grid(M, N, splits), THREADS, 0, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(x),
      reinterpret_cast<const int8_t*>(w), reinterpret_cast<float*>(part), M,
      K, N, k_chunk);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_reduce(reinterpret_cast<const float*>(part),
                       reinterpret_cast<const float*>(scale),
                       reinterpret_cast<__nv_bfloat16*>(out), M, N, splits, s);
}

// x (M,K) bf16, w (K/2,N) uint8, scale/zero (K/group,N) f32, part
// (splits,M,N) f32 workspace, out (M,N) bf16. k_chunk % group == 0.
extern "C" int q4_matmul(const void* x, const void* w, const void* scale,
                         const void* zero, void* part, void* out, int M, int K,
                         int N, int group, int splits, int k_chunk,
                         void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || N % COLS != 0 || splits <= 0 ||
      group <= 0 || group % 2 != 0 || K % group != 0 || k_chunk % group != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  q4_partial_kernel<<<partial_grid(M, N, splits), THREADS, 0, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(x),
      reinterpret_cast<const uint8_t*>(w),
      reinterpret_cast<const float*>(scale),
      reinterpret_cast<const float*>(zero), reinterpret_cast<float*>(part), M,
      K, N, k_chunk, group);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_reduce(reinterpret_cast<const float*>(part), nullptr,
                       reinterpret_cast<__nv_bfloat16*>(out), M, N, splits, s);
}
