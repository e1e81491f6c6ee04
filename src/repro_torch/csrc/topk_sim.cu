// Tool-retrieval scores (paper Eq. 3) for Hopper.
//
// Replaces the Pallas kernel sim_scores (_kernel) in
// src/repro/kernels/topk_sim/topk_sim.py: tools (N, d) f32 and queries (m, d)
// f32, both L2-normalised, -> scores (N,) f32 with
//     scores[j] = max_i <tools[j], queries[i]>.
// Only the (N,) max vector is written; the (N, m) similarity matrix never
// exists.
//
// What bounds it on an H100: every tool row is read once and the queries are
// tiny (m <= 32 rows), so the kernel is bound by the N * d * 4 bytes of the
// tool matrix (20 us at N = 65536, d = 256); at the runtime's catalog (N = 256)
// it is bound by its launch. The design is the simple one for that: the
// queries are staged once per block in shared memory (MQ * d * 4 bytes, where
// MQ is m rounded up to 1, 2, 4, 8, 16 or 32 with copies of row 0: 8 KiB at
// m = 8, d = 256); each warp takes one tool row at a time, grid-strided,
// loads it with float4s (two per lane at d = 256), keeps one partial dot per
// query in registers, reduces them by warp shuffle and writes the max over
// queries. The dots accumulate in f32 in the kernel itself. Any N works (no
// tile multiple, no host padding); a row length that is not a multiple of 4,
// or a base that is not 16-byte aligned, takes the scalar-load variant.
//
// Launches on the caller's stream and allocates nothing.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;      // 8 warps, one tool row each at a time
constexpr int WARPS = THREADS / 32;
constexpr int MAX_M = 32;         // query rows: one partial dot each per lane

template <int MQ, bool VEC>
__global__ void __launch_bounds__(THREADS)
sim_scores_kernel(const float* __restrict__ tools,
                  const float* __restrict__ queries, float* __restrict__ out,
                  int N, int d, int m) {
  // MQ query rows in shared memory; rows past m repeat row 0, which leaves
  // the max unchanged and keeps every loop over queries free of branches
  extern __shared__ float4 q_smem4[];
  float* q_smem = reinterpret_cast<float*>(q_smem4);
  for (int i = threadIdx.x; i < MQ * d; i += THREADS) {
    const int row = i / d;
    q_smem[i] = queries[(row < m ? row : 0) * d + i % d];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int nwarps = gridDim.x * WARPS;
  for (int j = blockIdx.x * WARPS + (threadIdx.x >> 5); j < N; j += nwarps) {
    float acc[MQ];
#pragma unroll
    for (int i = 0; i < MQ; ++i) acc[i] = 0.0f;
    if (VEC) {
      const int d4 = d >> 2;
      const float4* row = reinterpret_cast<const float4*>(tools + (size_t)j * d);
      for (int c = lane; c < d4; c += 32) {
        const float4 t = __ldg(row + c);
#pragma unroll
        for (int i = 0; i < MQ; ++i) {
          const float4 q = q_smem4[i * d4 + c];
          acc[i] = fmaf(t.x, q.x, acc[i]);
          acc[i] = fmaf(t.y, q.y, acc[i]);
          acc[i] = fmaf(t.z, q.z, acc[i]);
          acc[i] = fmaf(t.w, q.w, acc[i]);
        }
      }
    } else {
      const float* row = tools + (size_t)j * d;
      for (int c = lane; c < d; c += 32) {
        const float t = __ldg(row + c);
#pragma unroll
        for (int i = 0; i < MQ; ++i) acc[i] = fmaf(t, q_smem[i * d + c], acc[i]);
      }
    }
    float best = __int_as_float(0xff800000);  // -inf
#pragma unroll
    for (int i = 0; i < MQ; ++i) {
      float v = acc[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      best = fmaxf(best, v);
    }
    if (lane == 0) out[j] = best;
  }
}

template <int MQ, bool VEC>
cudaError_t launch(const float* tools, const float* queries, float* out, int N,
                   int d, int m, int sms, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)MQ * d;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sim_scores_kernel<MQ, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  // one warp per row up to 8 resident blocks per SM; further rows grid-stride
  const int want = (N + WARPS - 1) / WARPS;
  const int grid = want < 8 * sms ? want : 8 * sms;
  sim_scores_kernel<MQ, VEC><<<grid, THREADS, smem, stream>>>(tools, queries,
                                                              out, N, d, m);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t dispatch_m(const float* tools, const float* queries, float* out,
                       int N, int d, int m, int sms, cudaStream_t stream) {
  if (m <= 1) return launch<1, VEC>(tools, queries, out, N, d, m, sms, stream);
  if (m <= 2) return launch<2, VEC>(tools, queries, out, N, d, m, sms, stream);
  if (m <= 4) return launch<4, VEC>(tools, queries, out, N, d, m, sms, stream);
  if (m <= 8) return launch<8, VEC>(tools, queries, out, N, d, m, sms, stream);
  if (m <= 16)
    return launch<16, VEC>(tools, queries, out, N, d, m, sms, stream);
  return launch<MAX_M, VEC>(tools, queries, out, N, d, m, sms, stream);
}

}  // namespace

extern "C" int sim_scores(const void* tools, const void* queries, void* out,
                          int N, int d, int m, int sms, void* stream) {
  if (N <= 0 || d <= 0 || m <= 0 || m > MAX_M || sms <= 0)
    return (int)cudaErrorInvalidValue;
  const float* t = reinterpret_cast<const float*>(tools);
  const float* q = reinterpret_cast<const float*>(queries);
  float* o = reinterpret_cast<float*>(out);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && reinterpret_cast<size_t>(tools) % 16 == 0;
  return (int)(vec ? dispatch_m<true>(t, q, o, N, d, m, sms, s)
                   : dispatch_m<false>(t, q, o, N, d, m, sms, s));
}
