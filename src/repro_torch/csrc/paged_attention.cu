// Paged decode attention for Hopper: one query token per row attends over a
// KV cache scattered across a block pool through a block table.
//
// Replaces the Pallas kernel paged_attention_bkgh (_kernel) in
// src/repro/kernels/paged_attention/paged_attention.py: q (B, K, G, H) bf16;
// pools (num_blocks, bs, K, H) bf16, or int8 with (num_blocks, bs, K) f32
// scales multiplied in right after the load; block_tables (B, nb) int32;
// lengths (B,) int32. 1/sqrt(H) scale, optional tanh softcap, sliding window
// `pos > len - 1 - window`, online softmax, blocks past `len` skipped, dead
// rows read the scratch block 0. Split-K (`splits` chunks of the block chain)
// parks a per-split (m, l, acc) partial; a merge pass combines them
// max-rebased, and a split that saw no key weighs exactly zero.
//
// What bounds it on an H100: bytes. Each decode step reads every live KV
// position once (G = 7 query heads share one KV head, ~2 flops per byte), so
// the design reads each KV block once per (row, kv head, split): one thread
// block of 128 threads loads a (bs, H) stripe of K and V into shared memory
// (dequantizing int8 there, so device-memory traffic stays int8), computes
// the G x bs scores with one warp per position, updates the online softmax
// and accumulates P @ V with one thread per head-dim column. The grid
// (B, K, splits) gives the card B*K*splits blocks; split-K is what fills it
// when the batch is small and chains are long.
//
// Launches on the caller's stream and allocates nothing; the wrapper
// (kernels/paged_attention/ops.py) owns the output and split partials.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int G_MAX = 8;        // query heads per kv head
constexpr int H_PER_THREAD = 2; // head dim <= 256
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float bf2f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <bool QUANT>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const __nv_bfloat16* __restrict__ q,
                  const void* __restrict__ k_pool,
                  const void* __restrict__ v_pool,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int* __restrict__ block_tables,
                  const int* __restrict__ lengths,
                  float* __restrict__ m_part, float* __restrict__ l_part,
                  float* __restrict__ acc_part,
                  __nv_bfloat16* __restrict__ out,
                  int K, int G, int H, int bs, int nb, int nbs, int splits,
                  float scale, float cap, int window) {
  const int b = blockIdx.x, kh = blockIdx.y, sp = blockIdx.z;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  extern __shared__ float smem[];
  float* q_s = smem;              // G * H
  float* k_s = q_s + G * H;       // bs * H
  float* v_s = k_s + bs * H;      // bs * H
  float* p_s = v_s + bs * H;      // G * bs
  float* m_s = p_s + G * bs;      // G
  float* l_s = m_s + G;           // G
  float* a_s = l_s + G;           // G

  const int length = lengths[b];
  const __nv_bfloat16* qb = q + ((size_t)(b * K + kh) * G) * H;
  for (int i = t; i < G * H; i += THREADS) q_s[i] = bf2f(qb[i]) * scale;
  if (t < G) {
    m_s[t] = NEG_INF;
    l_s[t] = 0.f;
  }
  float acc[G_MAX][H_PER_THREAD];
#pragma unroll
  for (int g = 0; g < G_MAX; ++g)
#pragma unroll
    for (int j = 0; j < H_PER_THREAD; ++j) acc[g][j] = 0.f;
  __syncthreads();

  const int j0 = sp * nbs;
  const int j1 = min(nb, j0 + nbs);
  for (int j = j0; j < j1; ++j) {
    const int start = j * bs;
    if (start >= length) break;                 // the rest of the chain too
    if (window > 0 && start + bs - 1 <= length - 1 - window)
      continue;                                 // whole block outside window
    const int bid = block_tables[(size_t)b * nb + j];
    for (int i = t; i < bs * H; i += THREADS) {
      const int p = i / H, h = i - p * H;
      const size_t row = ((size_t)bid * bs + p) * K + kh;
      const size_t off = row * H + h;
      if (QUANT) {
        k_s[i] = (float)reinterpret_cast<const int8_t*>(k_pool)[off] *
                 k_scale[row];
        v_s[i] = (float)reinterpret_cast<const int8_t*>(v_pool)[off] *
                 v_scale[row];
      } else {
        k_s[i] = bf2f(reinterpret_cast<const __nv_bfloat16*>(k_pool)[off]);
        v_s[i] = bf2f(reinterpret_cast<const __nv_bfloat16*>(v_pool)[off]);
      }
    }
    __syncthreads();
    for (int p = warp; p < bs; p += WARPS) {
      const int pos = start + p;
      const bool ok =
          pos < length && (window <= 0 || pos > length - 1 - window);
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
        for (int h = lane; h < H; h += 32) d += q_s[g * H + h] * k_s[p * H + h];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        if (lane == 0) {
          if (cap > 0.f) d = tanhf(d / cap) * cap;
          p_s[g * bs + p] = ok ? d : NEG_INF;
        }
      }
    }
    __syncthreads();
    if (t < G) {
      float* row = p_s + t * bs;
      const float m_prev = m_s[t];
      float m_cur = NEG_INF;
      for (int p = 0; p < bs; ++p) m_cur = fmaxf(m_cur, row[p]);
      const float m_new = fmaxf(m_prev, m_cur);
      float sum = 0.f;
      for (int p = 0; p < bs; ++p) {
        const float e = expf(row[p] - m_new);
        row[p] = e;
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
        for (int g = 0; g < G_MAX; ++g) {
          if (g < G) {
            float a = acc[g][jh] * a_s[g];
            for (int p = 0; p < bs; ++p) a += p_s[g * bs + p] * v_s[p * H + h];
            acc[g][jh] = a;
          }
        }
      }
    }
    __syncthreads();
  }

  if (splits == 1) {
#pragma unroll
    for (int jh = 0; jh < H_PER_THREAD; ++jh) {
      const int h = t + jh * THREADS;
      if (h < H) {
#pragma unroll
        for (int g = 0; g < G_MAX; ++g) {
          if (g < G) {
            const float l = fmaxf(l_s[g], 1e-37f);
            out[((size_t)(b * K + kh) * G + g) * H + h] =
                __float2bfloat16(acc[g][jh] / l);
          }
        }
      }
    }
    return;
  }
  const size_t idx = ((size_t)(b * K + kh) * splits + sp) * G;
  if (t < G) {
    m_part[idx + t] = m_s[t];
    l_part[idx + t] = l_s[t];
  }
#pragma unroll
  for (int jh = 0; jh < H_PER_THREAD; ++jh) {
    const int h = t + jh * THREADS;
    if (h < H) {
#pragma unroll
      for (int g = 0; g < G_MAX; ++g)
        if (g < G) acc_part[(idx + g) * H + h] = acc[g][jh];
    }
  }
}

// One block per (row, kv head): max-rebased merge of the split partials.
__global__ void __launch_bounds__(THREADS)
paged_merge_kernel(const float* __restrict__ m_part,
                   const float* __restrict__ l_part,
                   const float* __restrict__ acc_part,
                   __nv_bfloat16* __restrict__ out, int G, int H, int splits) {
  const size_t bk = blockIdx.x;
  for (int g = 0; g < G; ++g) {
    float m_tot = NEG_INF;
    for (int s = 0; s < splits; ++s)
      m_tot = fmaxf(m_tot, m_part[(bk * splits + s) * G + g]);
    for (int h = threadIdx.x; h < H; h += THREADS) {
      float l_tot = 0.f, a_tot = 0.f;
      for (int s = 0; s < splits; ++s) {
        const size_t i = (bk * splits + s) * G + g;
        const float w = expf(m_part[i] - m_tot);
        l_tot += l_part[i] * w;
        a_tot += acc_part[i * H + h] * w;
      }
      out[(bk * G + g) * H + h] = __float2bfloat16(a_tot / fmaxf(l_tot, 1e-37f));
    }
  }
}

}  // namespace

// k_scale/v_scale null for bf16 pools. m_part/l_part (B,K,splits,G) and
// acc_part (B,K,splits,G,H) f32 are read only when splits > 1.
extern "C" int paged_attention(const void* q, const void* k_pool,
                               const void* v_pool, const void* k_scale,
                               const void* v_scale, const void* block_tables,
                               const void* lengths, void* m_part, void* l_part,
                               void* acc_part, void* out, int B, int K, int G,
                               int H, int bs, int nb, int splits, float cap,
                               int window, void* stream) {
  if (B <= 0 || K <= 0 || G <= 0 || G > G_MAX || H <= 0 ||
      H > THREADS * H_PER_THREAD || bs <= 0 || nb <= 0 || splits <= 0 ||
      splits > nb)
    return (int)cudaErrorInvalidValue;
  const int nbs = (nb + splits - 1) / splits;
  const float scale = 1.0f / sqrtf((float)H);
  const size_t smem = sizeof(float) * (size_t)(G * H + 2 * bs * H + G * bs + 3 * G);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(B, K, splits);
  const auto* qp = reinterpret_cast<const __nv_bfloat16*>(q);
  const auto* bt = reinterpret_cast<const int*>(block_tables);
  const auto* ln = reinterpret_cast<const int*>(lengths);
  auto* mp = reinterpret_cast<float*>(m_part);
  auto* lp = reinterpret_cast<float*>(l_part);
  auto* ap = reinterpret_cast<float*>(acc_part);
  auto* op = reinterpret_cast<__nv_bfloat16*>(out);
  if (k_scale != nullptr) {
    paged_attn_kernel<true><<<grid, THREADS, smem, s>>>(
        qp, k_pool, v_pool, reinterpret_cast<const float*>(k_scale),
        reinterpret_cast<const float*>(v_scale), bt, ln, mp, lp, ap, op, K, G,
        H, bs, nb, nbs, splits, scale, cap, window);
  } else {
    paged_attn_kernel<false><<<grid, THREADS, smem, s>>>(
        qp, k_pool, v_pool, nullptr, nullptr, bt, ln, mp, lp, ap, op, K, G, H,
        bs, nb, nbs, splits, scale, cap, window);
  }
  int err = (int)cudaGetLastError();
  if (err != 0 || splits == 1) return err;
  paged_merge_kernel<<<B * K, THREADS, 0, s>>>(mp, lp, ap, op, G, H, splits);
  return (int)cudaGetLastError();
}
