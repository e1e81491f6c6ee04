// Mamba2 SSD chunk scan for Hopper.
//
// Replaces the Pallas kernel ssd_bshp (_kernel) in src/repro/kernels/ssd/ssd.py:
// x (B,S,H,P) bf16, dt (B,S,H) f32 after softplus, A (H,) f32 negative, and
// B, C (B,S,G,N) bf16, where head h reads group h / (H/G). With chunks of Q
// tokens (S % Q == 0, Q <= 128) and a (P, N) f32 state per (batch, head):
//     cs    = inclusive cumsum of dt * A over the chunk
//     y     = ((C B^T) o L) (x dt) + (C state^T) o exp(cs),
//             L[i,j] = exp(cs_i - cs_j) for i >= j, else 0
//     state = state exp(cs_Q) + (x dt)^T (B o exp(cs_Q - cs))
// -> y (B,S,H,P) f32 and the final state (B,H,P,N) f32.
//
// What bounds it on an H100: per chunk and head it does 2Q^2N + 2Q^2P + 4QPN
// flops (10.5 MFLOP at Q = 128, P = 64, N = 128) on 27 KB of inputs, so in
// f32 on the CUDA cores it is bound by operations, not bytes (80 us against
// 8 us for one mamba2-370m layer at S = 2048). The design is the simple one:
// one block of 256 threads per (batch, head) walks the chunks in order, as
// the Pallas grid's sequential chunk axis did, and keeps the state in shared
// memory in f32 across chunks. Per chunk it stages x*dt (f32), B and C (bf16,
// as they arrive) and cs in shared memory, then runs the three products as a
// 16 x 16 thread grid with register tiles: C B^T masked by L into a (Q, Q)
// f32 tile, y from that tile and the state, then the state update. Every
// product and sum is f32; exp(cs_i - cs_j) is taken only where i >= j (the
// upper triangle can overflow, and 0 * inf is NaN). Rows past Q (a chunk
// shorter than 128) are zero and never written out.
//
// Not done, and left to performance work: at batch 1 there are only H
// blocks (32 for mamba2-370m) for 132 SMs; the Mamba2 paper's three-phase
// split (chunk states in parallel, a short scan over them, chunk outputs in
// parallel) would fill the card. C B^T is recomputed by each of the H/G
// heads of a group, and the products run on the CUDA cores, not the tensor
// cores.
//
// Launches on the caller's stream and allocates nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;     // a 16 x 16 grid of threads in every phase
constexpr int QMAX = 128;        // chunk rows held in shared memory
constexpr int MS = QMAX + 16;    // row stride of the (Q, Q) tile: the two
                                 // thread rows of a warp land 16 banks apart

template <int P, int N>
struct Layout {
  static constexpr int NB = N + 2;   // bf16 row stride of B and C: an odd
                                     // number of words, so 16 rows read at
                                     // one column hit 16 banks
  static constexpr int NS = N + 1;   // f32 row stride of the state
  static constexpr size_t floats = (size_t)P * NS + (size_t)QMAX * P
      + (size_t)QMAX * MS + 3 * QMAX;
  static constexpr size_t bytes = floats * 4 + 2 * (size_t)QMAX * NB * 2;
};

template <int P, int N>
__global__ void __launch_bounds__(THREADS, 1)
ssd_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
           const __nv_bfloat16* __restrict__ Cm, float* __restrict__ y,
           float* __restrict__ fs, int S, int H, int G, int Q) {
  using Lay = Layout<P, N>;
  constexpr int NB = Lay::NB, NS = Lay::NS;
  constexpr int PT = P / 16, NT = N / 16;
  extern __shared__ float4 smem4[];
  float* st = reinterpret_cast<float*>(smem4);   // (P, NS) carried state
  float* xdt = st + P * NS;                       // (QMAX, P) x * dt
  float* M = xdt + QMAX * P;                      // (QMAX, MS) (C B^T) o L
  float* cs = M + QMAX * MS;                      // (QMAX) cumsum of dt * A
  float* ecs = cs + QMAX;                         // exp(cs)
  float* wq = ecs + QMAX;                         // exp(cs_Q - cs)
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(wq + QMAX);  // (QMAX, NB)
  __nv_bfloat16* Cs = Bs + QMAX * NB;

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int t = threadIdx.x;
  const int hi = t / 16, lo = t % 16;
  const float a = A[h];

  // rows past Q stay zero for the whole launch (Q is fixed per launch)
  for (int e = t; e < P * NS; e += THREADS) st[e] = 0.f;
  for (int e = t; e < QMAX * P; e += THREADS) xdt[e] = 0.f;
  for (int e = t; e < QMAX * NB; e += THREADS) {
    Bs[e] = __float2bfloat16(0.f);
    Cs[e] = __float2bfloat16(0.f);
  }
  __syncthreads();

  for (int c0 = 0; c0 < S; c0 += Q) {
    const long tok0 = (long)b * S + c0;           // flat token of chunk row 0

    // -- 1. stage the chunk ------------------------------------------------
    for (int e = t; e < Q * P; e += THREADS) {
      const int i = e / P, p = e % P;
      const long tok = tok0 + i;
      xdt[i * P + p] = __bfloat162float(x[(tok * H + h) * P + p])
                       * dt[tok * H + h];
    }
    for (int e = t; e < Q * N; e += THREADS) {
      const int i = e / N, n = e % N;
      const long src = ((tok0 + i) * G + g) * N + n;
      Bs[i * NB + n] = Bm[src];
      Cs[i * NB + n] = Cm[src];
    }
    if (t < 32) {
      // inclusive cumsum over the chunk: 4 rows a lane, then a warp scan;
      // rows past Q add 0, so they carry cs_{Q-1}
      float v[4];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = t * 4 + k;
        run += i < Q ? dt[(tok0 + i) * H + h] * a : 0.f;
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (t >= off) incl += o;
      }
      const float excl = incl - run;
#pragma unroll
      for (int k = 0; k < 4; ++k) cs[t * 4 + k] = v[k] + excl;
      __syncwarp();
      const float total = cs[Q - 1];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = t * 4 + k;
        ecs[i] = expf(cs[i]);
        wq[i] = expf(total - cs[i]);
      }
    }
    __syncthreads();

    // -- 2. M = (C B^T) o L: thread (hi, lo) owns rows hi + 16 ia and
    //       columns lo + 16 jb -------------------------------------------------
    {
      float acc[8][8];
#pragma unroll
      for (int ia = 0; ia < 8; ++ia)
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) acc[ia][jb] = 0.f;
#pragma unroll 2
      for (int k = 0; k < N; k += 2) {
        float2 cv[8], bv[8];
#pragma unroll
        for (int ia = 0; ia < 8; ++ia)
          cv[ia] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              &Cs[(hi + 16 * ia) * NB + k]));
#pragma unroll
        for (int jb = 0; jb < 8; ++jb)
          bv[jb] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              &Bs[(lo + 16 * jb) * NB + k]));
#pragma unroll
        for (int ia = 0; ia < 8; ++ia)
#pragma unroll
          for (int jb = 0; jb < 8; ++jb)
            acc[ia][jb] = fmaf(cv[ia].y, bv[jb].y,
                               fmaf(cv[ia].x, bv[jb].x, acc[ia][jb]));
      }
#pragma unroll
      for (int ia = 0; ia < 8; ++ia) {
        const int i = hi + 16 * ia;
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          const int j = lo + 16 * jb;
          M[i * MS + j] = j <= i ? acc[ia][jb] * expf(cs[i] - cs[j]) : 0.f;
        }
      }
    }
    __syncthreads();

    // -- 3. y = exp(cs) o (C state^T) + M (x dt): rows hi + 16 ia, columns
    //       lo + 16 pb --------------------------------------------------------
    {
      float acc[8][PT];
#pragma unroll
      for (int ia = 0; ia < 8; ++ia)
#pragma unroll
        for (int pb = 0; pb < PT; ++pb) acc[ia][pb] = 0.f;
#pragma unroll 2
      for (int n = 0; n < N; n += 2) {
        float2 cv[8];
#pragma unroll
        for (int ia = 0; ia < 8; ++ia)
          cv[ia] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              &Cs[(hi + 16 * ia) * NB + n]));
#pragma unroll
        for (int pb = 0; pb < PT; ++pb) {
          const float s0 = st[(lo + 16 * pb) * NS + n];
          const float s1 = st[(lo + 16 * pb) * NS + n + 1];
#pragma unroll
          for (int ia = 0; ia < 8; ++ia)
            acc[ia][pb] = fmaf(cv[ia].y, s1, fmaf(cv[ia].x, s0, acc[ia][pb]));
        }
      }
#pragma unroll
      for (int ia = 0; ia < 8; ++ia) {
        const float e = ecs[hi + 16 * ia];
#pragma unroll
        for (int pb = 0; pb < PT; ++pb) acc[ia][pb] *= e;
      }
      // M[i][j] is 0 for j > i, so the columns past the thread's last row
      // add nothing; the loop stops at the chunk's end
      for (int j = 0; j < Q; ++j) {
        float xv[PT];
#pragma unroll
        for (int pb = 0; pb < PT; ++pb) xv[pb] = xdt[j * P + lo + 16 * pb];
#pragma unroll
        for (int ia = 0; ia < 8; ++ia) {
          const float m = M[(hi + 16 * ia) * MS + j];
#pragma unroll
          for (int pb = 0; pb < PT; ++pb)
            acc[ia][pb] = fmaf(m, xv[pb], acc[ia][pb]);
        }
      }
#pragma unroll
      for (int ia = 0; ia < 8; ++ia) {
        const int i = hi + 16 * ia;
        if (i < Q) {
          const long row = ((tok0 + i) * H + h) * P;
#pragma unroll
          for (int pb = 0; pb < PT; ++pb) y[row + lo + 16 * pb] = acc[ia][pb];
        }
      }
    }
    __syncthreads();

    // -- 4. state = state exp(cs_Q) + (x dt)^T (B o exp(cs_Q - cs)): thread
    //       (hi, lo) owns state rows hi + 16 pa, columns lo + 16 nb ---------------
    {
      float acc[PT][NT];
#pragma unroll
      for (int pa = 0; pa < PT; ++pa)
#pragma unroll
        for (int nb = 0; nb < NT; ++nb) acc[pa][nb] = 0.f;
      for (int j = 0; j < Q; ++j) {
        const float w = wq[j];
        float xv[PT], bv[NT];
#pragma unroll
        for (int pa = 0; pa < PT; ++pa) xv[pa] = xdt[j * P + hi + 16 * pa];
#pragma unroll
        for (int nb = 0; nb < NT; ++nb)
          bv[nb] = __bfloat162float(Bs[j * NB + lo + 16 * nb]) * w;
#pragma unroll
        for (int pa = 0; pa < PT; ++pa)
#pragma unroll
          for (int nb = 0; nb < NT; ++nb)
            acc[pa][nb] = fmaf(xv[pa], bv[nb], acc[pa][nb]);
      }
      const float decay = expf(cs[Q - 1]);
#pragma unroll
      for (int pa = 0; pa < PT; ++pa)
#pragma unroll
        for (int nb = 0; nb < NT; ++nb) {
          float* s = &st[(hi + 16 * pa) * NS + lo + 16 * nb];
          *s = fmaf(*s, decay, acc[pa][nb]);
        }
    }
    __syncthreads();
  }

  float* out = fs + ((long)b * H + h) * P * N;
  for (int e = t; e < P * N; e += THREADS) out[e] = st[(e / N) * NS + e % N];
}

template <int P, int N>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, void* y, void* fs, int Bb, int S, int H,
                   int G, int Q, cudaStream_t stream) {
  auto kernel = ssd_kernel<P, N>;
  const size_t smem = Layout<P, N>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, Bb), THREADS, smem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(x),
      reinterpret_cast<const float*>(dt), reinterpret_cast<const float*>(A),
      reinterpret_cast<const __nv_bfloat16*>(Bm),
      reinterpret_cast<const __nv_bfloat16*>(Cm), reinterpret_cast<float*>(y),
      reinterpret_cast<float*>(fs), S, H, G, Q);
  return cudaGetLastError();
}

template <int P>
cudaError_t dispatch_n(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, void* y, void* fs,
                       int Bb, int S, int H, int G, int N, int Q,
                       cudaStream_t s) {
  switch (N) {
    case 16: return launch<P, 16>(x, dt, A, Bm, Cm, y, fs, Bb, S, H, G, Q, s);
    case 32: return launch<P, 32>(x, dt, A, Bm, Cm, y, fs, Bb, S, H, G, Q, s);
    case 64: return launch<P, 64>(x, dt, A, Bm, Cm, y, fs, Bb, S, H, G, Q, s);
    case 128: return launch<P, 128>(x, dt, A, Bm, Cm, y, fs, Bb, S, H, G, Q, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B,S,H,P) bf16, dt (B,S,H) f32, A (H,) f32, Bm/Cm (B,S,G,N) bf16, all
// contiguous -> y (B,S,H,P) f32, fs (B,H,P,N) f32. P in {16, 32, 64}, N in
// {16, 32, 64, 128}, 1 <= Q <= 128, S % Q == 0, H % G == 0.
extern "C" int ssd_bshp(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, void* y, void* fs,
                        int Bb, int S, int H, int P, int G, int N, int Q,
                        void* stream) {
  if (Bb <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || Q <= 0
      || Q > QMAX || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (P) {
    case 16: return (int)dispatch_n<16>(x, dt, A, Bm, Cm, y, fs, Bb, S, H, G, N, Q, s);
    case 32: return (int)dispatch_n<32>(x, dt, A, Bm, Cm, y, fs, Bb, S, H, G, N, Q, s);
    case 64: return (int)dispatch_n<64>(x, dt, A, Bm, Cm, y, fs, Bb, S, H, G, N, Q, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
