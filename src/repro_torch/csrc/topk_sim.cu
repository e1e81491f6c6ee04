// Tool retrieval for Hopper: the similarity max of paper Eq. 3 and the top k
// over it, each in one launch.
//
// Replaces the Pallas kernel sim_scores (_kernel) in
// src/repro/kernels/topk_sim/topk_sim.py, and the jax.lax.top_k that
// src/repro/kernels/topk_sim/ops.py::topk_tools runs after it. Two entries
// share one scoring core:
//   sim_scores: tools (N, d) f32 and unit queries (m, d) f32 -> (N,) f32,
//               scores[j] = max_i <tools[j], queries[i]>;
//   topk_tools: tools and raw queries -> the k best (score, index) pairs,
//               highest first, where a query row counts as x / max(|x|, 1e-9)
//               (its dots are divided by that norm) and scores order by the
//               total order jax.lax.top_k uses: +0.0 above -0.0, equal bits
//               by lower index. NaN scores are out of scope.
// Only k pairs leave the launch; neither the (N, m) similarities nor, for
// k <= 32, the (N,) scores exist in device memory.
//
// What bounds it on an H100: each tool row is read once and the queries are
// a few rows, so the work is bound by the N * d * 4 bytes of the tool matrix
// (20 us at N = 65536, d = 256); at the runtime's N = 256 a call is bound by
// its launch. The design keeps every tool byte off shared memory:
//   - a warp takes 4 tool rows at a time in a slab of 256 columns, 8 a lane
//     (two float4s, or eight floats where rows are not 16-byte aligned, read
//     past L1), so each warp has 4 KB of loads in flight, and the lane keeps
//     its 8 columns of a group of MQ <= 4 queries in registers: with one
//     group and one slab (m <= 4, d <= 256) they are loaded once a warp,
//     otherwise once a batch from L1 while the tool slab stays in registers
//     across groups (groups of 8 cost 128 registers and spilled beside the
//     top-k lists);
//   - the 4 x MQ partial dots of a batch are summed across the warp by a
//     transposing butterfly (V values in V - 1 shuffles, then 5 - log2 V
//     plain steps, every index a constant), which leaves each lane one full
//     dot, then maxed over the group's lanes;
//   - top k (k <= 32): every warp keeps its best 32 keys (64 bits: the order
//     key of the score, then the inverted row), one a lane, sorted across
//     the lanes; it stages 32 new keys and merges them by bitonic networks on
//     shuffles only when one beats its 32nd; the block's warps merge their
//     lists in shared memory, and the last block to arrive (an arrival
//     counter it resets) merges the blocks' lists and writes the k pairs. A
//     k above 32 writes all N keys and the last block sorts them (in shared
//     memory up to 8192 keys, in device memory past it): correct for every
//     k, fast at the main path's N = 256 (lists of 64 keys, two a lane, met
//     the 128-register cap and spilled).
// Every dot is summed in the same order whatever its place in a batch, so
// equal tool rows get equal bits and repeats are bit-identical.
//
// Launches on the caller's stream and allocates nothing: the top-k scratch
// (block lists or all keys) and the zeroed counter come from the caller, one
// set per device, so top-k launches on one device must not overlap.
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;
constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int SLAB = 256;               // columns of a row a warp holds at once
constexpr int SORT_SMEM_KEYS = 8192;    // the sort path sorts in shared memory
constexpr int MAX_SMEM = 227 * 1024;
constexpr unsigned FULL = 0xffffffffu;

constexpr int ROWS = 4;                 // tool rows a warp scores at once
constexpr int MAX_MQ = 4;               // query rows a lane holds at once
__host__ __device__ constexpr int log2c(int x) {
  return x <= 1 ? 0 : 1 + log2c(x / 2);
}

struct Params {
  const float* tools;    // (N, d)
  const float* queries;  // (m, d)
  float* scores;         // sim_scores: (N,); topk_tools: (k,)
  long long* idx;        // topk_tools: (k,)
  u64* keys;             // topk_tools: the blocks' lists, or all N keys
  unsigned* counter;     // topk_tools: arrivals, zero between launches
  int N, d, m, k;
  int groups;            // ceil(m / MQ)
  int slabs;             // ceil(d / SLAB)
  int nbatch;            // ceil(N / ROWS)
};

// The order key: larger is better. The high word orders the score's bits as
// jax.lax.top_k does (+0.0 above -0.0); the low word inverts the row, so
// equal scores put the lower row first. Key 0 is below every real key.
__device__ __forceinline__ u64 order_key(float s, int row) {
  int b = __float_as_int(s);
  b ^= (b >> 31) & 0x7fffffff;
  return ((u64)((unsigned)b ^ 0x80000000u) << 32) |
         (0xffffffffu - (unsigned)row);
}

__device__ __forceinline__ void write_pair(const Params& p, int e, u64 key) {
  int b = (int)((unsigned)(key >> 32) ^ 0x80000000u);
  b ^= (b >> 31) & 0x7fffffff;            // its own inverse
  p.scores[e] = __int_as_float(b);
  p.idx[e] = (long long)(0xffffffffu - (unsigned)key);
}

// ---------------------------------------------------------------------------
// scoring core
// ---------------------------------------------------------------------------

// Tool rows are read once, so they bypass L1 and leave it to the queries
// that m > 4 or d > 256 reload every batch.
__device__ __forceinline__ float4 ld_stream(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}
__device__ __forceinline__ float ld_stream(const float* p) {
  float v;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// Slab s of NR rows from `base` into v[r][0..8): lane holds columns
// s*256 + 4*(32j + lane) + (0..3) for j < 2 (VEC), or s*256 + 32j + lane for
// j < 8; columns past d and rows past `valid` read as 0. STREAM: past L1.
template <bool VEC, int NR, bool STREAM>
__device__ __forceinline__ void load_slab(float (&v)[NR][8],
                                          const float* base, int first,
                                          int valid, int d, int s, int lane) {
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const bool ok = first + r < valid;
    const float* row = base + (size_t)(first + r) * d;
    if (VEC) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = s * (SLAB / 4) + j * 32 + lane;
        const float4* at = reinterpret_cast<const float4*>(row) + c;
        float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok && 4 * c < d) t = STREAM ? ld_stream(at) : __ldg(at);
        v[r][4 * j] = t.x;
        v[r][4 * j + 1] = t.y;
        v[r][4 * j + 2] = t.z;
        v[r][4 * j + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = s * SLAB + j * 32 + lane;
        v[r][j] = ok && c < d ? (STREAM ? ld_stream(row + c) : __ldg(row + c))
                              : 0.f;
      }
    }
  }
}

// Query group g, slab s: rows past m repeat row 0, which leaves the max over
// the group unchanged.
template <bool VEC, int MQ>
__device__ __forceinline__ void load_queries(float (&q)[MQ][8], const Params& p,
                                             int g, int s, int lane) {
#pragma unroll
  for (int i = 0; i < MQ; ++i) {
    const int qi = g * MQ + i;
    float one[1][8];
    load_slab<VEC, 1, false>(
        one, p.queries + (size_t)(qi < p.m ? qi : 0) * p.d, 0, 1, p.d, s,
        lane);
#pragma unroll
    for (int e = 0; e < 8; ++e) q[i][e] = one[0][e];
  }
}

// One level of the transposing butterfly: lanes apart by OFF swap halves of
// their first 2H values, each keeping the half its OFF bit names. The
// levels are template arguments so that every index is a constant (as a
// loop, nvcc left the first levels rolled, indexing the registers by
// predicated moves).
template <int V, int H, int OFF>
__device__ __forceinline__ void transpose_level(float (&v)[V], int lane) {
  const bool upper = lane & OFF;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, OFF);
  }
  if constexpr (H > 1) transpose_level<V, H / 2, OFF / 2>(v, lane);
}

// V partial sums a lane -> the full sum of value (lane >> (5 - log2 V)), on
// every lane. Each value is summed over the lanes by the same tree.
template <int V>
__device__ __forceinline__ float transpose_sum(float (&v)[V], int lane) {
  if constexpr (V > 1) transpose_level<V, V / 2, 16>(v, lane);
  float s = v[0];
#pragma unroll
  for (int off = 16 / V; off >= 1; off /= 2) s += __shfl_xor_sync(FULL, s, off);
  return s;
}

// The best score over every query of the batch's row held by this lane's
// group (row0 + (lane >> 3)). NORM divides each dot by its query row's norm
// in `nrm`.
template <bool VEC, int MQ, bool NORM>
__device__ __forceinline__ float score_batch(const Params& p, int row0,
                                             float (&q)[MQ][8], bool hoisted,
                                             const float* nrm, int lane) {
  constexpr int V = ROWS * MQ;
  constexpr int SH = 5 - log2c(V);      // lane >> SH: this lane's value
  float t[ROWS][8];
  float best = __int_as_float(0xff800000);   // -inf
  for (int g = 0; g < p.groups; ++g) {
    float acc[ROWS][MQ];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int i = 0; i < MQ; ++i) acc[r][i] = 0.f;
    for (int s = 0; s < p.slabs; ++s) {
      if (!hoisted) load_queries<VEC, MQ>(q, p, g, s, lane);
      // one slab: the tool rows stay in registers across the query groups
      if (g == 0 || p.slabs > 1)
        load_slab<VEC, ROWS, true>(t, p.tools, row0, p.N, p.d, s, lane);
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int i = 0; i < MQ; ++i)
            acc[r][i] = fmaf(t[r][e], q[i][e], acc[r][i]);
    }
    float v[V];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int i = 0; i < MQ; ++i) v[r * MQ + i] = acc[r][i];
    float dot = transpose_sum<V>(v, lane);
    if (NORM) {
      const int qi = g * MQ + ((lane >> SH) & (MQ - 1));
      dot = dot / nrm[qi < p.m ? qi : 0];
    }
#pragma unroll
    for (int off = 1 << SH; off < (1 << (SH + log2c(MQ))); off <<= 1)
      dot = fmaxf(dot, __shfl_xor_sync(FULL, dot, off));
    best = fmaxf(best, dot);
  }
  return best;
}

template <bool VEC, int MQ>
__global__ void __launch_bounds__(THREADS, 1) sim_scores_kernel(Params p) {
  constexpr int RSH = 5 - log2c(ROWS);  // lane >> RSH: its row
  const int lane = threadIdx.x & 31;
  const bool hoisted = p.groups == 1 && p.slabs == 1;
  float q[MQ][8];
  if (hoisted) load_queries<VEC, MQ>(q, p, 0, 0, lane);
  for (int b = blockIdx.x * WARPS + (threadIdx.x >> 5); b < p.nbatch;
       b += gridDim.x * WARPS) {
    const int row0 = b * ROWS;
    const float best = score_batch<VEC, MQ, false>(p, row0, q, hoisted,
                                                   nullptr, lane);
    const int row = row0 + (lane >> RSH);
    if ((lane & ((1 << RSH) - 1)) == 0 && row < p.N) p.scores[row] = best;
  }
}

// ---------------------------------------------------------------------------
// top k: a warp's list of 32 keys, one a lane, sorted descending by lane
// ---------------------------------------------------------------------------

// Compare-exchange steps S, S/2, ..., 1 of a bitonic network over the 32
// lanes: pairs (lane, lane ^ s), descending where (lane & SZ) == 0.
template <int SZ, int S>
__device__ __forceinline__ void steps(u64& v, int lane) {
  const u64 o = __shfl_xor_sync(FULL, v, S);
  const bool keep_max = ((lane & SZ) == 0) == ((lane & S) == 0);
  v = keep_max ? (v > o ? v : o) : (v < o ? v : o);
  if constexpr (S > 1) steps<SZ, S / 2>(v, lane);
}

// Bitonic sort, descending: stages of 2, 4, ..., 32 lanes.
template <int SZ = 2>
__device__ __forceinline__ void sort_desc(u64& v, int lane) {
  steps<SZ, SZ / 2>(v, lane);
  if constexpr (SZ < 32) sort_desc<2 * SZ>(v, lane);
}

// l (sorted) and b (sorted, reversed: lane e holds b's element 31 - e) ->
// the 32 best of both, sorted: their elementwise max is bitonic.
__device__ __forceinline__ void merge_rev(u64& l, u64 b, int lane) {
  l = l > b ? l : b;
  steps<64, 16>(l, lane);
}

// The staged keys (unsorted) into the warp's list, if one beats its 32nd.
__device__ __forceinline__ void flush(u64& l, u64& st, int lane) {
  if (__any_sync(FULL, st > __shfl_sync(FULL, l, 31))) {
    sort_desc(st, lane);
    merge_rev(l, __shfl_xor_sync(FULL, st, 31), lane);
  }
  st = 0;
}

// The block's warps' lists, through shared memory, into warp 0's `l`.
__device__ __forceinline__ void block_merge(u64& l, u64* lists, int warp,
                                            int lane) {
  lists[warp * 32 + lane] = l;
  __syncthreads();
#pragma unroll
  for (int h = 1; h < WARPS; h <<= 1) {
    if ((warp & (2 * h - 1)) == 0) {
      merge_rev(l, lists[(warp + h) * 32 + 31 - lane], lane);
      lists[warp * 32 + lane] = l;
    }
    __syncthreads();
  }
}

// Bitonic sort of buf[0, P) descending by the whole block; GLOBAL keeps the
// keys in device memory (through L2) when they do not fit shared memory.
template <bool GLOBAL>
__device__ void block_sort(u64* buf, int P) {
  for (int sz = 2; sz <= P; sz <<= 1)
    for (int s = sz >> 1; s > 0; s >>= 1) {
      for (int t = threadIdx.x; t < P / 2; t += THREADS) {
        const int lo = 2 * t - (t & (s - 1));
        const bool desc = (lo & sz) == 0;
        const u64 a = GLOBAL ? __ldcg(buf + lo) : buf[lo];
        const u64 b = GLOBAL ? __ldcg(buf + lo + s) : buf[lo + s];
        if (desc ? a < b : a > b) {
          if (GLOBAL) {
            __stcg(buf + lo, b);
            __stcg(buf + lo + s, a);
          } else {
            buf[lo] = b;
            buf[lo + s] = a;
          }
        }
      }
      __syncthreads();
    }
}

__host__ __device__ inline int pow2ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// LISTS (k <= 32): each warp keeps its best 32 keys, each block merges its
// warps' lists and writes one to p.keys, the last block merges those.
// Otherwise every key goes to p.keys and the last block sorts them all.
template <bool VEC, int MQ, bool LISTS>
__global__ void __launch_bounds__(THREADS, 1) topk_kernel(Params p) {
  constexpr int RSH = 5 - log2c(ROWS);
  extern __shared__ u64 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int P = pow2ceil(p.N);
  const int nkeys = LISTS ? WARPS * 32 : (P <= SORT_SMEM_KEYS ? P : 0);
  float* nrm = reinterpret_cast<float*>(smem + nkeys);

  // the query rows' norms, max(|x|, 1e-9), as _normalize takes them
  for (int i = warp; i < p.m; i += WARPS) {
    const float* x = p.queries + (size_t)i * p.d;
    float ss = 0.f;
    for (int c = lane; c < p.d; c += 32) ss = fmaf(x[c], x[c], ss);
#pragma unroll
    for (int off = 16; off >= 1; off /= 2) ss += __shfl_xor_sync(FULL, ss, off);
    if (lane == 0) nrm[i] = fmaxf(sqrtf(ss), 1e-9f);
  }
  __syncthreads();

  const bool hoisted = p.groups == 1 && p.slabs == 1;
  float q[MQ][8];
  if (hoisted) load_queries<VEC, MQ>(q, p, 0, 0, lane);
  u64 l = 0, st = 0;                     // the warp's list, staged keys
  int fill = 0;                          // staged keys, warp-uniform
  for (int b = blockIdx.x * WARPS + warp; b < p.nbatch;
       b += gridDim.x * WARPS) {
    const int row0 = b * ROWS;
    const float best = score_batch<VEC, MQ, true>(p, row0, q, hoisted, nrm,
                                                  lane);
    const int row = row0 + (lane >> RSH);
    const u64 key = row < p.N ? order_key(best, row) : 0;
    if constexpr (!LISTS) {
      if ((lane & ((1 << RSH) - 1)) == 0 && row < p.N) p.keys[row] = key;
    } else {
      // row r's key (on lanes r << RSH and up) to staged lane fill + r
      const int r = lane - fill;
      const u64 got = __shfl_sync(FULL, key, (r & (ROWS - 1)) << RSH);
      if (r >= 0 && r < ROWS) st = got;
      fill += ROWS;
      if (fill == 32) {
        flush(l, st, lane);
        fill = 0;
      }
    }
  }

  __shared__ bool last;
  if constexpr (LISTS) {
    if (fill > 0) flush(l, st, lane);
    block_merge(l, smem, warp, lane);
    if (gridDim.x == 1) {
      if (warp == 0 && lane < p.k) write_pair(p, lane, l);
      return;
    }
    if (warp == 0) p.keys[blockIdx.x * 32 + lane] = l;
  }
  __threadfence();
  __syncthreads();
  if (gridDim.x > 1) {
    if (threadIdx.x == 0)
      last = atomicAdd(p.counter, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
  }

  if constexpr (LISTS) {
    // the last block: every block's list, WARPS lists a warp at a time,
    // the next one loading while this one merges
    l = 0;
    const int G = gridDim.x;
    u64 next = warp < G ? __ldcg(p.keys + warp * 32 + 31 - lane) : 0;
    for (int b = warp; b < G; b += WARPS) {
      const u64 cur = next;
      if (b + WARPS < G) next = __ldcg(p.keys + (b + WARPS) * 32 + 31 - lane);
      merge_rev(l, cur, lane);
    }
    block_merge(l, smem, warp, lane);
    if (warp == 0 && lane < p.k) write_pair(p, lane, l);
  } else {
    if (P <= SORT_SMEM_KEYS) {
      for (int i = threadIdx.x; i < P; i += THREADS)
        smem[i] = i < p.N ? __ldcg(p.keys + i) : 0;
      __syncthreads();
      block_sort<false>(smem, P);
      for (int i = threadIdx.x; i < p.k; i += THREADS)
        write_pair(p, i, smem[i]);
    } else {
      for (int i = p.N + threadIdx.x; i < P; i += THREADS)
        __stcg(p.keys + i, 0ull);
      __syncthreads();
      block_sort<true>(p.keys, P);
      for (int i = threadIdx.x; i < p.k; i += THREADS)
        write_pair(p, i, __ldcg(p.keys + i));
    }
  }
  if (threadIdx.x == 0) *p.counter = 0u;   // ready for the next launch
}

template <bool VEC, int MQ>
cudaError_t run_scores(const Params& p, int grid, cudaStream_t stream) {
  sim_scores_kernel<VEC, MQ><<<grid, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <bool VEC, int MQ, bool LISTS>
cudaError_t run_topk(const Params& p, int grid, cudaStream_t stream) {
  const int P = pow2ceil(p.N);
  const size_t nkeys = LISTS ? (size_t)WARPS * 32
                             : (P <= SORT_SMEM_KEYS ? (size_t)P : 0);
  const size_t smem = nkeys * sizeof(u64) + (size_t)p.m * sizeof(float);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        topk_kernel<VEC, MQ, LISTS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  topk_kernel<VEC, MQ, LISTS><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool VEC, int MQ>
cudaError_t dispatch_lists(const Params& p, int lists, int grid,
                           cudaStream_t s) {
  return lists ? run_topk<VEC, MQ, true>(p, grid, s)
               : run_topk<VEC, MQ, false>(p, grid, s);
}

// Checks and fills the shared fields; vec is 1 for 16-byte rows.
bool make_params(Params& p, const void* tools, const void* queries, int N,
                 int d, int m, int mq, int vec, int grid) {
  if (N <= 0 || d <= 0 || m <= 0 || grid <= 0) return false;
  if (mq != 1 && mq != 2 && mq != MAX_MQ) return false;
  if (vec && (d % 4 || reinterpret_cast<size_t>(tools) % 16 ||
              reinterpret_cast<size_t>(queries) % 16))
    return false;
  if (!vec && mq != MAX_MQ) return false;  // the scalar rows: groups of 4
  p.tools = reinterpret_cast<const float*>(tools);
  p.queries = reinterpret_cast<const float*>(queries);
  p.N = N;
  p.d = d;
  p.m = m;
  p.groups = (m + mq - 1) / mq;
  p.slabs = (d + SLAB - 1) / SLAB;
  p.nbatch = (N + ROWS - 1) / ROWS;
  return true;
}

}  // namespace

// tools (N, d) f32, unit queries (m, d) f32 -> out (N,) f32. mq: queries a
// lane holds at once (1, 2 or 4; 4 where vec is 0); grid: blocks of
// WARPS warps (kernels/topk_sim/ops.py::plan).
extern "C" int sim_scores(const void* tools, const void* queries, void* out,
                          int N, int d, int m, int mq, int vec, int grid,
                          void* stream) {
  Params p{};
  if (!make_params(p, tools, queries, N, d, m, mq, vec, grid))
    return (int)cudaErrorInvalidValue;
  p.scores = reinterpret_cast<float*>(out);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (!vec) e = run_scores<false, MAX_MQ>(p, grid, s);
  else if (mq == 1) e = run_scores<true, 1>(p, grid, s);
  else if (mq == 2) e = run_scores<true, 2>(p, grid, s);
  else e = run_scores<true, MAX_MQ>(p, grid, s);
  return (int)e;
}

// tools (N, d) f32, raw queries (m, d) f32 -> the k best scores (f32) and
// rows (int64), highest first. lists: 1 for warp lists (k <= 32), 0 to sort
// all N keys; keys: grid * 32 keys (lists) or pow2ceil(N); counter: one
// zeroed unsigned, left zeroed.
extern "C" int topk_tools(const void* tools, const void* queries,
                          void* out_scores, void* out_idx, int N, int d, int m,
                          int k, int mq, int vec, int lists, int grid,
                          void* keys, void* counter, void* stream) {
  Params p{};
  if (!make_params(p, tools, queries, N, d, m, mq, vec, grid) || k < 1 ||
      k > N || (lists && k > 32))
    return (int)cudaErrorInvalidValue;
  p.scores = reinterpret_cast<float*>(out_scores);
  p.idx = reinterpret_cast<long long*>(out_idx);
  p.keys = reinterpret_cast<u64*>(keys);
  p.counter = reinterpret_cast<unsigned*>(counter);
  p.k = k;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (!vec) e = dispatch_lists<false, MAX_MQ>(p, lists, grid, s);
  else if (mq == 1) e = dispatch_lists<true, 1>(p, lists, grid, s);
  else if (mq == 2) e = dispatch_lists<true, 2>(p, lists, grid, s);
  else e = dispatch_lists<true, MAX_MQ>(p, lists, grid, s);
  return (int)e;
}
