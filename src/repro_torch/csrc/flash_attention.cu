// Blockwise causal prefill attention for Hopper, in the model layout.
//
// Replaces the Pallas kernel flash_attention_bnh (_kernel) in
// src/repro/kernels/flash_attention/flash_attention.py: q (B, Sq, N, H),
// k/v (B, Skv, K, H) bf16 -> (B, Sq, N, H) bf16; GQA reads kv head
// n // (N / K) with no copy; causal mask at absolute query positions
// q_offset + i, optional sliding window (q_pos - k_pos < window), optional
// tanh softcap, online softmax in f32, and KV tiles that the mask empties for
// every query of the tile are skipped.
//
// What bounds it on an H100: at the serving engine's prompt buckets
// (Sq = 32..128, H = 128) the work is tiny (2 * B * N * Sq * Skv * H * 2
// flops, a few GFLOP) and the bound is launch and latency, not the tensor
// cores. So the design is the simple one: one block of 128 threads per
// (batch, head, 16-query tile), a loop over 32-key tiles staged in shared
// memory as f32 (rows padded by one word so the score loop reads without bank
// conflicts), scores on CUDA cores, the online-softmax statistics per query
// row, and P @ V with one thread per head-dim column. Tensor cores and a
// pipelined TMA ring are later work; PERF.md carries its time beside its bound.
//
// Launches on the caller's stream and allocates nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int BQ = 16;            // query rows per block
constexpr int BK = 32;            // keys per tile
constexpr int H_PER_THREAD = 2;   // head dim <= 256
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float bf2f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__global__ void __launch_bounds__(THREADS)
flash_attn_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out,
                  int Sq, int Skv, int N, int K, int H, int causal, int window,
                  float cap, float scale, int q_offset) {
  const int b = blockIdx.x, n = blockIdx.y, iq = blockIdx.z;
  const int kh = n / (N / K);
  const int t = threadIdx.x;
  const int HP = H + 1;
  extern __shared__ float smem[];
  float* q_s = smem;               // BQ * HP
  float* k_s = q_s + BQ * HP;      // BK * HP
  float* v_s = k_s + BK * HP;      // BK * H
  float* p_s = v_s + BK * H;       // BQ * BK
  float* m_s = p_s + BQ * BK;      // BQ
  float* l_s = m_s + BQ;           // BQ
  float* a_s = l_s + BQ;           // BQ

  const int q0 = iq * BQ;
  for (int i = t; i < BQ * H; i += THREADS) {
    const int r = i / H, h = i - r * H;
    const int qi = q0 + r;
    q_s[r * HP + h] =
        qi < Sq ? bf2f(q[(((size_t)b * Sq + qi) * N + n) * H + h]) * scale : 0.f;
  }
  if (t < BQ) {
    m_s[t] = NEG_INF;
    l_s[t] = 0.f;
  }
  float acc[BQ][H_PER_THREAD];
#pragma unroll
  for (int r = 0; r < BQ; ++r)
#pragma unroll
    for (int j = 0; j < H_PER_THREAD; ++j) acc[r][j] = 0.f;
  __syncthreads();

  const int qpos_lo = q_offset + q0;
  const int qpos_hi = q_offset + min(q0 + BQ, Sq) - 1;
  const int n_tiles = (Skv + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    const int k_last = min(Skv, k0 + BK) - 1;
    if (causal && k0 > qpos_hi) break;                 // later tiles too
    if (window > 0 && qpos_lo - k_last >= window) continue;
    for (int i = t; i < BK * H; i += THREADS) {
      const int r = i / H, h = i - r * H;
      const int kp = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kp < Skv) {
        const size_t off = (((size_t)b * Skv + kp) * K + kh) * H + h;
        kv = bf2f(k[off]);
        vv = bf2f(v[off]);
      }
      k_s[r * HP + h] = kv;
      v_s[r * H + h] = vv;
    }
    __syncthreads();
    {
      const int qi = t % BQ;
      const int qp = q_offset + q0 + qi;
#pragma unroll
      for (int r = 0; r < BK / (THREADS / BQ); ++r) {
        const int kj = t / BQ + (THREADS / BQ) * r;
        float d = 0.f;
        for (int h = 0; h < H; ++h) d += q_s[qi * HP + h] * k_s[kj * HP + h];
        if (cap > 0.f) d = tanhf(d / cap) * cap;
        const int kp = k0 + kj;
        bool ok = kp < Skv;
        if (causal) ok = ok && qp >= kp;
        if (window > 0) ok = ok && (qp - kp) < window;
        p_s[qi * BK + kj] = ok ? d : NEG_INF;
      }
    }
    __syncthreads();
    if (t < BQ) {
      float* row = p_s + t * BK;
      const float m_prev = m_s[t];
      float m_cur = NEG_INF;
      for (int j = 0; j < BK; ++j) m_cur = fmaxf(m_cur, row[j]);
      const float m_new = fmaxf(m_prev, m_cur);
      float sum = 0.f;
      for (int j = 0; j < BK; ++j) {
        const float e = expf(row[j] - m_new);
        row[j] = e;
        sum += e;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[t] = l_s[t] * alpha + sum;
      m_s[t] = m_new;
      a_s[t] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int jh = 0; jh < H_PER_THREAD; ++jh) {
      const int h = t + jh * THREADS;
      if (h < H) {
#pragma unroll
        for (int r = 0; r < BQ; ++r) {
          float a = acc[r][jh] * a_s[r];
          for (int j = 0; j < BK; ++j) a += p_s[r * BK + j] * v_s[j * H + h];
          acc[r][jh] = a;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int jh = 0; jh < H_PER_THREAD; ++jh) {
    const int h = t + jh * THREADS;
    if (h < H) {
#pragma unroll
      for (int r = 0; r < BQ; ++r) {
        const int qi = q0 + r;
        if (qi < Sq) {
          out[(((size_t)b * Sq + qi) * N + n) * H + h] =
              __float2bfloat16(acc[r][jh] / fmaxf(l_s[r], 1e-37f));
        }
      }
    }
  }
}

}  // namespace

extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Sq, int Skv, int N, int K,
                               int H, int causal, int window, float cap,
                               int q_offset, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || N <= 0 || K <= 0 || N % K != 0 ||
      H <= 0 || H > THREADS * H_PER_THREAD)
    return (int)cudaErrorInvalidValue;
  const int HP = H + 1;
  const size_t smem =
      sizeof(float) * (size_t)(BQ * HP + BK * HP + BK * H + BQ * BK + 3 * BQ);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B, N, (Sq + BQ - 1) / BQ);
  flash_attn_kernel<<<grid, THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(q),
      reinterpret_cast<const __nv_bfloat16*>(k),
      reinterpret_cast<const __nv_bfloat16*>(v),
      reinterpret_cast<__nv_bfloat16*>(out), Sq, Skv, N, K, H, causal, window,
      cap, 1.0f / sqrtf((float)H), q_offset);
  return (int)cudaGetLastError();
}
