// One batch of B stream arrivals against all L sieve levels of G stacked
// sieves (the checkpoints of a sliding window, the lanes of the
// continuous mode, or one stream), in ONE launch.
//
// Replaces the Pallas kernel src/repro/kernels/stream_filter.py:
// stream_filter_pallas (_kernel, _body): build the (N, B) ground x
// arrival matrix, take each arrival's singleton gain against the empty
// solution's row0, update the running max m and slide the exponent
// window (ref.sieve_reanchor: expired levels restart from row0), then
// walk the B arrivals IN ORDER, admitting arrival b into level l when
// sieve_admit says so (gain against the level's row, the threshold
// (v_l/2 - f(S_l)) / (k - |S_l|), or its knapsack form) and folding it
// into the level's row. Variants: f32 ground (D features), int8 ground
// with f32 row scales (_kernel :120-125), and bitmaps (rt_stream_filter_
// bits: arrivals are W words, no ground); each with or without the
// knapsack cost mode (a template parameter).
//
// What bounds it on the H100. Feature rules: the build, by operations:
// at the k-medoid stream (N = 16,384 evaluation rows, B = 256, D =
// 12,288) 2*N*B*D = 103 GFLOP of fp32 FMA, 1.54 ms at 67 TFLOP/s. The
// admission is B sequential decisions per level, each a reduction over
// N row entries: latency, not throughput (72 levels x 256 arrivals x
// 16,384 entries = 0.3 G gain parts). Bitmaps: bytes and latency; each
// batch reads 256 x 1,290 words (1.3 MB) and makes 56 x 256 decisions.
//
// What the design does about it. The TPU walked the B arrivals once for
// all L levels at a time, with the (L, N) rows in VMEM. Levels never
// interact inside a batch (a level's admissions depend only on its own
// row, value, count, spent and grid value), so here each (sieve, level)
// gets its own block, which keeps the level's row in shared memory
// (64 KB at N = 16,384) and walks the arrivals in order with one
// __syncthreads a decision: each thread owns the row entries n = tid +
// 256 j, sums its gain parts in float64, a warp reduces by shuffles and
// the 8 warp sums are added in warp order by every thread (the same bits
// everywhere). An admitted arrival is folded by the same threads into
// the same entries, so the row needs no further barrier. The matrix is
// shared by all levels, so the launch is cooperative, in two phases:
// phase 1 spreads the (N/64) x (B/64) tiles of every arrival set over
// all blocks of the card with the resident build's 64x64 fp32 tile
// (pairwise_tile.cuh, float64 norms; its dot products summed in two
// levels of f32, 256 features a partial, as the plain version's cuBLAS
// product splits its long sums), stores the slab arrival-major
// (A, B, N) into an L2-sized scratch (16.8 MB at the k-medoid shape) and
// sums each tile column's singleton gain parts in float64 into a (A,
// N/64, B) partial; one grid barrier later, phase 2 runs the levels.
// Every level block re-adds the singleton partials in tile order, so all
// of them find the same m and the same window. int8 ground rows are
// widened as the tile stages them (rt_entry), so that variant equals
// this kernel on the dequantized ground bit for bit.
//
// The global-memory tier. A level's row lives in shared memory only
// while it fits a block beside the build's static scratch (N up to ~54,000
// f32 rows; plans.stream_smem_bytes is the gate). Beyond it (the reference
// launcher's whole-stream evaluation set: N = 100,000, a 400 KB row) the
// same kernel, instantiated with GROWS, keeps each level's row in its own
// row of the output state (G, L, N) in device memory: the block copies the
// row in, and each thread reads (through L2, __ldcg) and writes only the
// entries it owns, as on chip, so no barrier is added and the outputs
// equal the shared-memory tier's bit for bit. It launches with no dynamic
// shared memory, so more blocks share an SM during the build. The slab
// (A, B, N) no longer fits L2 there (102 MB a batch at N = 100,000); it
// is still the wrapper's torch.empty scratch.
//
// Bitmaps need no build and no grid barrier: the arrivals' words are
// read in place; a block takes 8 levels of one sieve, its 8 warps first
// count every arrival's singleton gain (popcounts against row0, exact),
// then each warp walks the arrivals for its level with the level's
// words in shared memory (5 KB at kosarak's W = 1,290): gains are exact
// integer popcount sums (rt_warp_bits_gain), so kernel and plain version
// agree bit for bit. Their global-memory tier (beyond 8 level rows, row0
// and the B gains in a block: W above ~6,400 words at B = 256) keeps each
// warp's level words in its row of the output state and reads row0 in
// place; only the B singleton gains stay in shared memory.
//
// Rounding. The window exponent ceil(log(m) / eps_log) and the grid value
// exp(expo * eps_log) use logf/expf (built without --use_fast_math, as the
// plain version on the card); eps_log is the f32 of log(1 + eps), a
// division and a product in f32 as the reference's weakly typed Python
// scalar gives. Every threshold operation is an explicit _rn intrinsic:
// nvcc would otherwise contract v*0.5 - f or thresh*cost into an FMA,
// which rounds otherwise than the plain version's separate operations.
#include <cooperative_groups.h>

#include "pairwise_tile.cuh"

namespace cg = cooperative_groups;

#define RT_WARPS (RT_THREADS / 32)
// feature slices (of 16) per f32 partial of the slab's dot products
// (pairwise_tile.cuh: two-level sums, 256 features a partial)
#define RT_STREAM_FOLD 16

// The sieve state of one level after this batch's re-anchor, computed
// alike by every thread that needs it (ref.sieve_reanchor).
struct RtAnchor {
  int expo;      // the level's grid exponent after the slide
  bool expired;  // the level restarts from row0
  float vgrid;   // exp(expo * eps_log)
};

__device__ __forceinline__ RtAnchor rt_reanchor(const int* __restrict__ E,
                                                int L, int l, float m_old,
                                                float m_new, float eps_log) {
  int low;
  if (m_new > 0.f) {
    low = (int)ceilf(__fdiv_rn(logf(fmaxf(m_new, 1e-30f)), eps_log));
  } else {
    low = E[0];
    for (int j = 1; j < L; ++j) low = min(low, E[j]);
  }
  // the first anchor: every slot is still empty, the window may jump
  const bool first = m_old == 0.f && m_new > 0.f;
  const int base_l = first ? low + l : E[l];
  int old_high = first ? low : E[0];
  int rank = 0;
  for (int j = 0; j < L; ++j) {
    const int bj = first ? low + j : E[j];
    old_high = max(old_high, bj);
    rank += (bj < low && bj < base_l);
  }
  RtAnchor a;
  a.expired = base_l < low;
  a.expo = a.expired ? max(old_high + 1, low) + rank : base_l;
  a.vgrid = expf(__fmul_rn((float)a.expo, eps_log));
  return a;
}

// sieve_admit's threshold test for a level with value f, count c and
// spent s, on a gain already known to be positive-or-not: the plain
// form (v/2 - f) / max(k - c, 1) or, in cost mode, gain >= thresh * cost
// with thresh = (v/2 - f) / max(max(budget - s, 0), 1e-30). Liveness
// (valid arrival, c < k, and for costs 0 < cost <= room) is checked by
// the caller before the gain is computed.
template <bool COST>
__device__ __forceinline__ bool rt_sieve_admit(float gain, float vgrid,
                                               float f, int c, int k,
                                               float cost, float room) {
  const float num = __fsub_rn(__fmul_rn(vgrid, 0.5f), f);
  if constexpr (COST) {
    const float thresh = __fdiv_rn(num, fmaxf(room, 1e-30f));
    return gain >= __fmul_rn(thresh, cost) && gain > 0.f;
  } else {
    const float thresh = __fdiv_rn(num, (float)max(k - c, 1));
    return gain >= thresh && gain > 0.f;
  }
}

// ---------------------------------------------------------------------------
// feature rules (f32 or int8 ground)
// ---------------------------------------------------------------------------

struct RtStreamArgs {
  const float* arrivals;     // (A, B, D) f32
  const float* row0;         // (N,) the empty solution's row
  const float* rows_in;      // (G, L, N)
  const float* values_in;    // (G, L) raw f(S)
  const int* counts_in;      // (G, L)
  const int* expos_in;       // (G, L)
  const float* m_in;         // (G,) running max singleton gain
  const unsigned char* bvalid;  // (A, B) 0/1
  const float* costs;        // (A, B) cost mode
  const float* spent_in;     // (G, L) cost mode
  float* mat;                // (A, B, N) scratch: the slab, arrival-major
  double* partials;          // (A, ceil(N/64), B) singleton partials
  float* rows_out;
  float* values_out;
  int* counts_out;
  unsigned char* admits;     // (G, L, B) 0/1
  int* expos_out;
  float* m_out;              // (G,)
  unsigned char* expired;    // (G, L) 0/1
  float* spent_out;
  int G, L, N, B, A, D, k, mode;
  float eps_log, budget;
  RtRule rule;
};

// GROWS: the global-memory tier. A level block keeps its state row in
// its own row of rows_out (device memory, read through L2 by __ldcg)
// instead of dynamic shared memory; each entry is still read and written
// only by the thread that owns it, so the arithmetic, its order and the
// barriers are the shared-memory tier's, and the outputs equal bit for bit.
template <class TG, bool COST, bool GROWS>
__global__ void __launch_bounds__(RT_THREADS)
    rt_stream_filter_kernel(const TG* __restrict__ ground,
                            const float* __restrict__ gscale,
                            RtStreamArgs p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ __align__(16) RtTileSmem ts;
  __shared__ double colsum[16][RT_TILE];
  __shared__ double wsum[2][RT_WARPS];
  __shared__ float r0[RT_TILE];
  __shared__ float smax[RT_WARPS];
  extern __shared__ float srow[];  // (N,) the level's state row (!GROWS)
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int N = p.N, B = p.B, L = p.L;
  const int tn = (N + RT_TILE - 1) / RT_TILE;
  const int tb = (B + RT_TILE - 1) / RT_TILE;

  // phase 1: the slab of every arrival set, tile by tile over the card
  const long long tiles = (long long)p.A * tn * tb;
  for (long long it = blockIdx.x; it < tiles; it += gridDim.x) {
    const int a = (int)(it / ((long long)tn * tb));
    const int rem = (int)(it % ((long long)tn * tb));
    const int qn = rem / tb;
    const int n0 = qn * RT_TILE;
    const int b0 = (rem % tb) * RT_TILE;
    if (t < RT_TILE) r0[t] = n0 + t < N ? p.row0[n0 + t] : 0.f;
    // r0 is read only in the epilogue, after rt_tile's barriers
    rt_tile<RT_STREAM_FOLD>(
        ground, gscale, p.arrivals + (size_t)a * B * p.D, N, B, p.D, n0, b0,
        p.mode, ts, [&](float (&acc)[4][4]) {
              const int tx = t % 16, ty = t / 16;
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int lb = tx * 4 + j;
                double sum = 0.0;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const int lr = ty * 4 + i;
                  if (n0 + lr < N && b0 + lb < B) {
                    const float m = rt_tile_entry(ts, acc[i][j], lr, lb,
                                                  p.mode);
                    p.mat[((size_t)a * B + b0 + lb) * N + n0 + lr] = m;
                    sum += (double)rt_gain_part(r0[lr], m, p.rule);
                  }
                }
                colsum[ty][lb] = sum;
              }
            });
    // rt_tile ends with a barrier: every colsum entry is written
    if (t < RT_TILE && b0 + t < B) {
      double s = 0.0;
      for (int g = 0; g < 16; ++g) s += colsum[g][t];
      p.partials[((size_t)a * tn + qn) * B + b0 + t] = s;
    }
    __syncthreads();
  }
  grid.sync();

  // phase 2: one block a (sieve, level), the arrivals in order
  for (int item = blockIdx.x; item < p.G * L; item += gridDim.x) {
    const int g = item / L;
    const int l = item % L;
    const int a = p.A == 1 ? 0 : g;
    // the batch's max valid singleton gain: the partials in tile order
    float mx = 0.f;
    for (int b = t; b < B; b += blockDim.x) {
      double s = 0.0;
      for (int q = 0; q < tn; ++q)
        s += __ldcg(&p.partials[((size_t)a * tn + q) * B + b]);
      if (p.bvalid[(size_t)a * B + b]) mx = fmaxf(mx, (float)s);
    }
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) smax[warp] = mx;
    __syncthreads();
    mx = smax[0];
    for (int w = 1; w < RT_WARPS; ++w) mx = fmaxf(mx, smax[w]);
    const float m_old = p.m_in[g];
    const float m_new = fmaxf(m_old, mx);
    const RtAnchor an = rt_reanchor(p.expos_in + (size_t)g * L, L, l, m_old,
                                    m_new, p.eps_log);
    const size_t gl = (size_t)g * L + l;
    const float* rin = an.expired ? p.row0 : p.rows_in + gl * N;
    float* rows = GROWS ? p.rows_out + gl * N : srow;
    auto row_at = [&](int n) -> float {
      if constexpr (GROWS)
        return __ldcg(rows + n);
      else
        return rows[n];
    };
    for (int n = t; n < N; n += blockDim.x) rows[n] = rin[n];
    float f = an.expired ? 0.f : p.values_in[gl];
    int c = an.expired ? 0 : p.counts_in[gl];
    float spent = 0.f;
    if constexpr (COST) spent = an.expired ? 0.f : p.spent_in[gl];
    const float* M = p.mat + (size_t)a * B * N;
    // warp sums alternate between two buffers, one per live decision: a
    // buffer is written again only after every thread passed the barrier
    // of the decision in between, i.e. finished reading it
    int buf = 0;
    for (int b = 0; b < B; ++b) {
      bool live = p.bvalid[(size_t)a * B + b] && c < p.k;
      float cost = 0.f, room = 0.f;
      if constexpr (COST) {
        cost = p.costs[(size_t)a * B + b];
        room = fmaxf(__fsub_rn(p.budget, spent), 0.f);
        live = live && cost > 0.f && cost <= room;
      }
      bool admit = false;
      if (live) {  // uniform over the block
        const float* col = M + (size_t)b * N;
        double acc = 0.0;
        for (int n = t; n < N; n += blockDim.x)
          acc += (double)rt_gain_part(row_at(n), __ldcg(&col[n]), p.rule);
        for (int off = 16; off > 0; off >>= 1)
          acc += __shfl_down_sync(0xffffffffu, acc, off);
        if (lane == 0) wsum[buf][warp] = acc;
        __syncthreads();
        double tot = 0.0;
        for (int w = 0; w < RT_WARPS; ++w) tot += wsum[buf][w];
        buf ^= 1;
        const float gain = (float)tot;
        admit = rt_sieve_admit<COST>(gain, an.vgrid, f, c, p.k, cost, room);
        if (admit) {
          for (int n = t; n < N; n += blockDim.x)
            rows[n] = rt_fold(row_at(n), __ldcg(&col[n]), p.rule);
          f = __fadd_rn(f, gain);
          c += 1;
          if constexpr (COST) spent = __fadd_rn(spent, cost);
        }
      }
      if (t == 0) p.admits[gl * B + b] = admit;
    }
    if constexpr (!GROWS)
      for (int n = t; n < N; n += blockDim.x)
        p.rows_out[gl * N + n] = rows[n];
    if (t == 0) {
      p.values_out[gl] = f;
      p.counts_out[gl] = c;
      p.expos_out[gl] = an.expo;
      p.expired[gl] = an.expired;
      if constexpr (COST) p.spent_out[gl] = spent;
      if (l == 0) p.m_out[g] = m_new;
    }
    __syncthreads();  // rows and smax are rewritten by the next item
  }
}

template <class TG, bool COST>
static void* rt_stream_kernel_ptr(int global_rows) {
  return global_rows ? (void*)rt_stream_filter_kernel<TG, COST, true>
                     : (void*)rt_stream_filter_kernel<TG, COST, false>;
}

static void* rt_stream_kernel_for(int storage, int cost_mode,
                                  int global_rows) {
  if (storage == RT_STORE_INT8)
    return cost_mode ? rt_stream_kernel_ptr<int8_t, true>(global_rows)
                     : rt_stream_kernel_ptr<int8_t, false>(global_rows);
  if (storage == RT_STORE_F32)
    return cost_mode ? rt_stream_kernel_ptr<float, true>(global_rows)
                     : rt_stream_kernel_ptr<float, false>(global_rows);
  return nullptr;
}

// The dynamic shared memory of a feature block: the level's (N,) row on
// the shared-memory tier, none on the global tier.
static int rt_stream_smem(int N, int global_rows) {
  return global_rows ? 0 : N * (int)sizeof(float);
}

// Blocks of the (storage, cost_mode, tier) kernel an SM holds with its
// dynamic shared memory for N rows, and the SM count.
extern "C" int rt_stream_filter_occupancy(int storage, int cost_mode,
                                          int global_rows, int N,
                                          int* blocks_per_sm, int* sms) {
  void* fn = rt_stream_kernel_for(storage, cost_mode, global_rows);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const int smem_bytes = rt_stream_smem(N, global_rows);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                    RT_THREADS, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// ground: (N, D) f32 (storage RT_STORE_F32, gscale null) or int8
// (RT_STORE_INT8, gscale (N,) f32 row scales). State (G sieves of L
// levels): rows (G, L, N) f32, values (G, L), counts / expos (G, L)
// int32, m (G,); arrivals (A, B, D) with A = 1 (shared by all sieves)
// or A = G; bvalid (A, B) 0/1 bytes; costs (A, B) and spent (G, L) in
// cost mode (null otherwise). mat (A, B, N) f32 and partials (A,
// ceil(N/64), B) float64 scratch. global_rows: the global-memory tier
// (the level rows live in rows_out, which may be rows_in itself). grid:
// blocks to launch, all co-resident. Returns the cudaError_t.
extern "C" int rt_stream_filter(
    const void* ground, const float* gscale, const float* arrivals,
    const float* row0, const float* rows_in, const float* values_in,
    const int* counts_in, const int* expos_in, const float* m_in,
    const unsigned char* bvalid, const float* costs, const float* spent_in,
    float* mat, double* partials, float* rows_out, float* values_out,
    int* counts_out, unsigned char* admits, int* expos_out, float* m_out,
    unsigned char* expired, float* spent_out, int G, int L, int N, int B,
    int A, int D, int k, int mode, int storage, int fold, float cap,
    float lam, float lam1, float eps_log, int cost_mode, float budget,
    int global_rows, int grid, void* stream) {
  if (G == 0 || L == 0) return 0;
  void* fn = rt_stream_kernel_for(storage, cost_mode, global_rows);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  RtStreamArgs p{arrivals, row0,    rows_in,   values_in,  counts_in,
                 expos_in, m_in,    bvalid,    costs,      spent_in,
                 mat,      partials, rows_out, values_out, counts_out,
                 admits,   expos_out, m_out,   expired,    spent_out,
                 G,        L,       N,         B,          A,
                 D,        k,       mode,      eps_log,    budget,
                 RtRule{fold, cap, lam, lam1}};
  const int smem = rt_stream_smem(N, global_rows);
  cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&ground, (void*)&gscale, (void*)&p};
  e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(RT_THREADS), args,
                                  (size_t)smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the bitmap rule (coverage)
// ---------------------------------------------------------------------------

struct RtStreamBitsArgs {
  const unsigned* arrivals;  // (A, B, W) words
  const unsigned* row0;      // (W,)
  const unsigned* rows_in;   // (G, L, W)
  const float* values_in;
  const int* counts_in;
  const int* expos_in;
  const float* m_in;
  const unsigned char* bvalid;
  const float* costs;
  const float* spent_in;
  unsigned* rows_out;
  float* values_out;
  int* counts_out;
  unsigned char* admits;
  int* expos_out;
  float* m_out;
  unsigned char* expired;
  float* spent_out;
  int G, L, W, B, A, k;
  float eps_log, budget;
};

// grid (ceil(L / 8), G): block (x, g) runs levels 8x .. 8x + 7 of sieve
// g, a warp each. Dynamic shared memory: 8 level rows and row0 (W words
// each) and the B singleton gains; on the global-memory tier (GROWS) the
// B gains only: each warp keeps its level's words in its row of rows_out
// (every word read and written by one lane) and row0 is read in place.
template <bool COST, bool GROWS>
__global__ void __launch_bounds__(RT_THREADS)
    rt_stream_filter_bits_kernel(RtStreamBitsArgs p) {
  extern __shared__ unsigned sbits[];
  const int W = p.W, B = p.B, L = p.L;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = blockIdx.y;
  const int a = p.A == 1 ? 0 : g;
  unsigned* r0 = sbits;                                  // (W,)
  float* single = (float*)(sbits + W);                   // (B,)
  unsigned* row = sbits + W + B + (size_t)warp * W;      // (W,)
  // The shared-memory tier's statements are kept as they were before the
  // global tier existed: with the pointers chosen by GROWS elsewhere, nvcc
  // scheduled the decision loop's loads worse (1.08 against 0.73 ms a
  // kosarak batch on an H100 SXM, chip_smoke.py's timing_stream_coverage).
  if constexpr (GROWS) {
    r0 = const_cast<unsigned*>(p.row0);
    single = (float*)sbits;
  } else {
    for (int w = threadIdx.x; w < W; w += blockDim.x) r0[w] = p.row0[w];
  }
  __syncthreads();
  const unsigned* arr = p.arrivals + (size_t)a * B * W;
  for (int b = warp; b < B; b += RT_WARPS) {
    const int s = rt_warp_bits_gain(arr + (size_t)b * W, r0, W);
    if (lane == 0) single[b] = p.bvalid[(size_t)a * B + b] ? (float)s : 0.f;
  }
  __syncthreads();
  float mx = 0.f;
  for (int b = 0; b < B; ++b) mx = fmaxf(mx, single[b]);
  const int l = blockIdx.x * RT_WARPS + warp;
  if (l >= L) return;  // whole warps leave together; no barrier follows
  const float m_old = p.m_in[g];
  const float m_new = fmaxf(m_old, mx);
  const RtAnchor an = rt_reanchor(p.expos_in + (size_t)g * L, L, l, m_old,
                                  m_new, p.eps_log);
  const size_t gl = (size_t)g * L + l;
  const unsigned* rin = an.expired ? r0 : p.rows_in + gl * W;
  if constexpr (GROWS) row = p.rows_out + gl * W;
  for (int w = lane; w < W; w += 32) row[w] = rin[w];
  __syncwarp();
  float f = an.expired ? 0.f : p.values_in[gl];
  int c = an.expired ? 0 : p.counts_in[gl];
  float spent = 0.f;
  if constexpr (COST) spent = an.expired ? 0.f : p.spent_in[gl];
  for (int b = 0; b < B; ++b) {
    bool live = p.bvalid[(size_t)a * B + b] && c < p.k;
    float cost = 0.f, room = 0.f;
    if constexpr (COST) {
      cost = p.costs[(size_t)a * B + b];
      room = fmaxf(__fsub_rn(p.budget, spent), 0.f);
      live = live && cost > 0.f && cost <= room;
    }
    bool admit = false;
    if (live) {  // uniform over the warp
      const unsigned* col = arr + (size_t)b * W;
      // every lane reads and folds only the words w = lane (mod 32)
      const float gain = (float)rt_warp_bits_gain(col, row, W);
      admit = rt_sieve_admit<COST>(gain, an.vgrid, f, c, p.k, cost, room);
      if (admit) {
        for (int w = lane; w < W; w += 32)
          row[w] = rt_bits_fold(row[w], col[w]);
        f = __fadd_rn(f, gain);
        c += 1;
        if constexpr (COST) spent = __fadd_rn(spent, cost);
      }
    }
    if (lane == 0) p.admits[gl * B + b] = admit;
  }
  if constexpr (!GROWS) {
    __syncwarp();
    for (int w = lane; w < W; w += 32) p.rows_out[gl * W + w] = row[w];
  }
  if (lane == 0) {
    p.values_out[gl] = f;
    p.counts_out[gl] = c;
    p.expos_out[gl] = an.expo;
    p.expired[gl] = an.expired;
    if constexpr (COST) p.spent_out[gl] = spent;
    if (l == 0) p.m_out[g] = m_new;
  }
}

// Bitmap state: rows (G, L, W) words, arrivals (A, B, W) words read in
// place (A = 1 or G), the rest as rt_stream_filter (global_rows: the
// global-memory tier). Returns the cudaError_t.
extern "C" int rt_stream_filter_bits(
    const unsigned* arrivals, const unsigned* row0, const unsigned* rows_in,
    const float* values_in, const int* counts_in, const int* expos_in,
    const float* m_in, const unsigned char* bvalid, const float* costs,
    const float* spent_in, unsigned* rows_out, float* values_out,
    int* counts_out, unsigned char* admits, int* expos_out, float* m_out,
    unsigned char* expired, float* spent_out, int G, int L, int W, int B,
    int A, int k, float eps_log, int cost_mode, float budget,
    int global_rows, void* stream) {
  if (G == 0 || L == 0) return 0;
  RtStreamBitsArgs p{arrivals,  row0,       rows_in,  values_in, counts_in,
                     expos_in,  m_in,       bvalid,   costs,     spent_in,
                     rows_out,  values_out, counts_out, admits,  expos_out,
                     m_out,     expired,    spent_out, G,        L,
                     W,         B,          A,        k,         eps_log,
                     budget};
  const int smem =
      (int)sizeof(unsigned) * (global_rows ? B : (RT_WARPS + 1) * W + B);
  void* fn;
  if (global_rows)
    fn = cost_mode ? (void*)rt_stream_filter_bits_kernel<true, true>
                   : (void*)rt_stream_filter_bits_kernel<false, true>;
  else
    fn = cost_mode ? (void*)rt_stream_filter_bits_kernel<true, false>
                   : (void*)rt_stream_filter_bits_kernel<false, false>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((L + RT_WARPS - 1) / RT_WARPS, G);
  void* args[] = {(void*)&p};
  e = cudaLaunchKernel(fn, grid, dim3(RT_THREADS), args, (size_t)smem,
                       (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the solution slots (streaming/sieve.py:_scatter_slots)
// ---------------------------------------------------------------------------

// After a batch: an expired level's id and payload slots are cleared, then
// each level's admitted arrivals land in order at slots counts_before,
// counts_before + 1, ... (the kernel admits sequentially). One block a
// (sieve, level) writes only what changed: the admitted rows and an
// expired level's slots, in place, instead of rewriting all G*L*k payload
// rows (708 MB a batch at the k-medoid stream) as a one-hot scatter
// would. Rows are `row_words` 32-bit words (f32 features or bitmap words).
__global__ void __launch_bounds__(RT_THREADS) rt_scatter_slots_kernel(
    const unsigned char* __restrict__ admits,
    const unsigned char* __restrict__ expired,
    const int* __restrict__ counts_before,
    const long long* __restrict__ batch_ids,
    const unsigned* __restrict__ batch_pay, long long* __restrict__ ids,
    unsigned* __restrict__ pay, int L, int B, int A, int k, int row_words) {
  const int gl = blockIdx.x;
  const int a = A == 1 ? 0 : gl / L;
  long long* lids = ids + (size_t)gl * k;
  unsigned* lpay = pay + (size_t)gl * k * row_words;
  const bool exp = expired[gl];
  if (exp) {
    for (int j = threadIdx.x; j < k; j += blockDim.x) lids[j] = -1;
    for (size_t i = threadIdx.x; i < (size_t)k * row_words; i += blockDim.x)
      lpay[i] = 0u;
    __syncthreads();
  }
  int pos = exp ? 0 : counts_before[gl];
  for (int b = 0; b < B && pos < k; ++b) {
    if (!admits[(size_t)gl * B + b]) continue;
    const unsigned* src = batch_pay + ((size_t)a * B + b) * row_words;
    unsigned* dst = lpay + (size_t)pos * row_words;
    for (int w = threadIdx.x; w < row_words; w += blockDim.x) dst[w] = src[w];
    if (threadIdx.x == 0) lids[pos] = batch_ids[(size_t)a * B + b];
    ++pos;
  }
}

// admits (G, L, B), expired (G, L) 0/1 bytes; counts_before (G, L) the
// counts before the batch; batch_ids (A, B) int64, batch_pay (A, B,
// row_words); ids (G, L, k) int64 and pay (G, L, k, row_words) updated in
// place. Returns the cudaError_t.
extern "C" int rt_scatter_slots(const unsigned char* admits,
                                const unsigned char* expired,
                                const int* counts_before,
                                const long long* batch_ids,
                                const unsigned* batch_pay, long long* ids,
                                unsigned* pay, int G, int L, int B, int A,
                                int k, int row_words, void* stream) {
  if (G == 0 || L == 0 || k == 0) return 0;
  rt_scatter_slots_kernel<<<G * L, RT_THREADS, 0, (cudaStream_t)stream>>>(
      admits, expired, counts_before, batch_ids, batch_pay, ids, pay, L, B, A,
      k, row_words);
  return (int)cudaGetLastError();
}
