// One batch of B stream arrivals against all L sieve levels of G stacked
// sieves (the checkpoints of a sliding window, the lanes of the
// continuous mode, or one stream).
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
// What bounds it on the H100. Feature rules: the slab, by operations: at
// the k-medoid stream against all 100,000 images (B = 256, D = 12,288)
// 2*N*B*D = 629 GFLOP of fp32 FMA, 9.4 ms at 67 TFLOP/s (1.54 ms at the
// 16,384-row evaluation set). The admissions are B sequential decisions a
// level, each a reduction over the level's N row entries against the
// arrival's slab column: latency and L2/HBM bytes. Bitmaps: bytes and
// latency; each batch reads 256 x 1,290 words (1.3 MB) and makes 56 x 256
// decisions.
//
// What the design does about it (feature rules), in four launches a batch
// on the caller's stream:
//  1. rt_row_norms_few_kernel (tile128.cuh, 'dist' only): the arrivals'
//     float64 norms, a warp a row. The ground's are computed once per
//     evaluation set by the caller (rt_stream_norms) and passed in.
//  2. rt_stream_slab_kernel: the (A, B, N) slab on the pairwise kernel's
//     128x128 tile (tile128.cuh) with its two-level f32 sums (FOLD, 256
//     features a partial), stored arrival-major, and each 64-row group's
//     singleton gain parts summed in float64 into an (A, ceil(N/64), B)
//     partial: the 64x64 tile's bits (rt_stream_slab64_kernel keeps that
//     tile as the yardstick).
//  3. rt_stream_singles_kernel: each arrival's singleton gain, the
//     partials added in tile order, once a batch (not once in every
//     level block); each level block takes the batch's max valid one
//     from those B values.
//  4. rt_stream_decide_kernel: a thread-block cluster of 8 blocks
//     (cudaLaunchKernelEx) a (sieve, level). Block r of the cluster keeps
//     chunk r of the level's row in its shared memory, and the blocks
//     walk the arrivals in order together,
//     evaluating ahead in windows of up to RT_WINDOW live arrivals: each
//     block reduces its chunks' gain parts for every arrival of the window
//     (one read of each row vector for all its columns, their loads in
//     flight together), the chunk sums are exchanged through distributed
//     shared memory after one cluster barrier, and every thread of the
//     cluster adds the 8 chunk sums of each arrival in chunk order and
//     applies sieve_admit in arrival order up to the first admission,
//     whose entries their owners fold; the next window starts after it.
//     Between admissions a level's value, count and spent are constant,
//     so each verdict of a window stands alone: the result is the
//     sequential walk's.
//
// The gain's float64 order is fixed by the entry index alone, not by the
// tier: the row is cut into 8
// chunks of CH = ceil(N/8) (rounded up to a multiple of 4) entries; in a
// chunk thread t of 256 sums the entries 4t + 1024i + e (i, then e < 4,
// ascending) into one float64 chain, the 32 lanes of a warp are added by
// a shuffle tree, the 8 warp sums in warp order, and the 8 chunk sums in
// chunk order. So both tiers give the same bits.
//
// The device-memory tier (GROWS): a level's row beyond what a cluster's
// shared memory holds (plans.stream_tier: N above ~454,000 f32 rows)
// lives in its row of the output state (G, L, N); each thread reads
// (through L2, __ldcg) and writes only the entries it owns, as on chip,
// and the kernel launches with no dynamic shared memory. Same bits.
//
// Bitmaps (rt_stream_filter_bits), in two launches: rt_stream_bits_prep_
// kernel counts every arrival's singleton gain (popcounts against row0)
// once, and compacts each arrival's nonzero words into an (index, word)
// list (a kosarak set of ~8 items touches ~8 of its 1,290 words); then
// rt_stream_bits_level_kernel gives each (sieve, level) a block, with
// the level's words in shared memory (or, GROWS, in its row of the
// output state), and evaluates ahead: the gains of all remaining live
// arrivals against the level's current row in one parallel pass (a
// thread an arrival over its list, a warp where the list is long, the
// words themselves where it is dense), then warp 0 finds the first
// admission with ballots (between admissions the level's value, count and
// spent are constant, so each arrival's verdict is independent), folds
// it, and the next pass starts after it. A batch costs one pass more than
// its admissions. Gains are exact integer popcount sums, so kernel and
// plain version agree bit for bit in any decomposition.
//
// Rounding. The window exponent ceil(log(m) / eps_log) and the grid value
// exp(expo * eps_log) use logf/expf (built without --use_fast_math, as the
// plain version on the card); eps_log is the f32 of log(1 + eps), a
// division and a product in f32 as the reference's weakly typed Python
// scalar gives. Every threshold operation is an explicit _rn intrinsic:
// nvcc would otherwise contract v*0.5 - f or thresh*cost into an FMA,
// which rounds otherwise than the plain version's separate operations.
#include <cooperative_groups.h>

#include "tile128.cuh"

namespace cg = cooperative_groups;

#define RT_WARPS (RT_THREADS / 32)
// feature slices a f32 partial of the slab's dot products (256 features:
// 32 slices of 8 on the 128x128 tile; 16 of 16 on the 64x64 yardstick)
#define RT_STREAM_FOLD 32
#define RT_STREAM_FOLD64 16
// the chunks of a level's row, a block of a portable cluster each
#define RT_CHUNKS 8
// the longest word list a thread walks alone in a bitmap pass (longer
// ones take a warp)
#define RT_BITS_SHORT 16
// the most arrivals a feature decision window evaluates at once
#define RT_WINDOW 8

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

// Block-wide max of v >= 0 (every thread gets it); red holds 8 floats.
__device__ __forceinline__ float rt_block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < RT_WARPS; ++w) v = fmaxf(v, red[w]);
  return v;
}

// ---------------------------------------------------------------------------
// feature rules (f32 or int8 ground): the slab
// ---------------------------------------------------------------------------

// One arrival set's slab on the 128x128 tile. Grid (ceil(B/128),
// ceil(N/128), A). ground (N, D) f32 or int8 (+ gscale (N,)); gnorm (N,)
// and anorm (A, B) the f32 norms ('dist'); arrivals (A, B, D). Writes
// mat (A, B, N) and partials (A, ceil(N/64), B): for each 64-row group of
// rows and each arrival, the float64 sum of its 16 four-row groups'
// sums, in order, of the singleton gain parts against row0 (as the 64x64
// tile's epilogue grouped them). Dynamic shared memory: the tile's outer
// sums, reused for the (2, 16, 128) float64 four-row sums.
template <class TG, bool VEC>
__global__ void __launch_bounds__(RT_THREADS, 2)
    rt_stream_slab_kernel(const TG* __restrict__ ground,
                          const float* __restrict__ gscale,
                          const float* __restrict__ gnorm,
                          const float* __restrict__ arrivals,
                          const float* __restrict__ anorm,
                          const float* __restrict__ row0,
                          float* __restrict__ mat,
                          double* __restrict__ partials, int N, int B, int D,
                          int mode, RtRule rule) {
  __shared__ __align__(16) RtTile128Smem ts;
  extern __shared__ __align__(16) float outer[];
  const int t = threadIdx.x;
  const int tx = t & 15;
  const int ty = t >> 4;
  const int a = blockIdx.z;
  const int n0 = blockIdx.y * RT_T128;
  const int b0 = blockIdx.x * RT_T128;
  const int tn = (N + RT_TILE - 1) / RT_TILE;
  const bool dist = mode == RT_MODE_DIST;
  const bool vstore = (N & 3) == 0;
  rt_tile128<TG, VEC, RT_STREAM_FOLD>(
      ground, gscale, arrivals + (size_t)a * B * D, N, B, D, n0, b0, ts,
      outer, [&](float (&acc)[8][8]) {
        double* colsum = reinterpret_cast<double*>(outer);  // (2, 16, 128)
        float gn[8], r0[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = n0 + (i >> 2) * 64 + ty * 4 + (i & 3);
          gn[i] = dist && r < N ? gnorm[r] : 0.f;
          r0[i] = r < N ? row0[r] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int lb = (j >> 2) * 64 + tx * 4 + (j & 3);
          const int b = b0 + lb;
          const float cn = dist && b < B ? anorm[(size_t)a * B + b] : 0.f;
          float* mcol = mat + ((size_t)a * B + b) * N;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = n0 + h * 64 + ty * 4;
            float v[4];
            double sum = 0.0;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              v[q] = rt_entry_value(gn[h * 4 + q], cn, acc[h * 4 + q][j],
                                    mode);
              if (r + q < N && b < B)
                sum += (double)rt_gain_part(r0[h * 4 + q], v[q], rule);
            }
            if (b < B) {
              if (vstore && r + 3 < N) {
                *reinterpret_cast<float4*>(mcol + r) =
                    make_float4(v[0], v[1], v[2], v[3]);
              } else {
#pragma unroll
                for (int q = 0; q < 4; ++q)
                  if (r + q < N) mcol[r + q] = v[q];
              }
            }
            colsum[(h * 16 + ty) * RT_T128 + lb] = sum;
          }
        }
        __syncthreads();
        // thread t: the 64-row group h = t / 128 of tile column t % 128
        const int h = t >> 7, lb = t & 127;
        const int qn = n0 / RT_TILE + h;
        if (qn < tn && b0 + lb < B) {
          double s = 0.0;
          for (int g = 0; g < 16; ++g) s += colsum[(h * 16 + g) * RT_T128 + lb];
          partials[((size_t)a * tn + qn) * B + b0 + lb] = s;
        }
      });
}

// The yardstick of the slab: the 64x64 tile (pairwise_tile.cuh) with its
// two-level sums (FOLD 16 slices of 16) and inline float64 norms, one
// tile a block, the same outputs as rt_stream_slab_kernel. Kept only so a
// test can hold the 128x128 slab to it bit for bit.
template <class TG>
__global__ void __launch_bounds__(RT_THREADS)
    rt_stream_slab64_kernel(const TG* __restrict__ ground,
                            const float* __restrict__ gscale,
                            const float* __restrict__ arrivals,
                            const float* __restrict__ row0,
                            float* __restrict__ mat,
                            double* __restrict__ partials, int N, int B,
                            int D, int mode, RtRule rule) {
  __shared__ __align__(16) RtTileSmem ts;
  __shared__ double colsum[16][RT_TILE];
  __shared__ float r0[RT_TILE];
  const int t = threadIdx.x;
  const int tn = (N + RT_TILE - 1) / RT_TILE;
  const int tb = (B + RT_TILE - 1) / RT_TILE;
  const int a = blockIdx.x / (tn * tb);
  const int rem = blockIdx.x % (tn * tb);
  const int qn = rem / tb;
  const int n0 = qn * RT_TILE;
  const int b0 = (rem % tb) * RT_TILE;
  if (t < RT_TILE) r0[t] = n0 + t < N ? row0[n0 + t] : 0.f;
  // r0 is read only in the epilogue, after rt_tile's barriers
  rt_tile<RT_STREAM_FOLD64>(
      ground, gscale, arrivals + (size_t)a * B * D, N, B, D, n0, b0, mode,
      ts, [&](float (&acc)[4][4]) {
        const int tx = t % 16, ty = t / 16;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int lb = tx * 4 + j;
          double sum = 0.0;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int lr = ty * 4 + i;
            if (n0 + lr < N && b0 + lb < B) {
              const float m = rt_tile_entry(ts, acc[i][j], lr, lb, mode);
              mat[((size_t)a * B + b0 + lb) * N + n0 + lr] = m;
              sum += (double)rt_gain_part(r0[lr], m, rule);
            }
          }
          colsum[ty][lb] = sum;
        }
      });
  // rt_tile ends with a barrier: every colsum entry is written
  if (t < RT_TILE && b0 + t < B) {
    double s = 0.0;
    for (int g = 0; g < 16; ++g) s += colsum[g][t];
    partials[((size_t)a * tn + qn) * B + b0 + t] = s;
  }
}

// Each arrival's singleton gain (0 for an invalid arrival): its partials
// added in tile order (float64), cast to f32. A warp a block, one thread
// an arrival, grid (ceil(B/32), A): each thread's loads run ahead of its
// chain of adds, and the warps of a batch spread over the SMs.
__global__ void __launch_bounds__(32)
    rt_stream_singles_kernel(const double* __restrict__ partials,
                             const unsigned char* __restrict__ bvalid,
                             float* __restrict__ singles, int tn, int B) {
  const int a = blockIdx.y;
  const int b = blockIdx.x * 32 + threadIdx.x;
  if (b >= B) return;
  const double* col = partials + (size_t)a * tn * B + b;
  double s = 0.0;
#pragma unroll 16
  for (int q = 0; q < tn; ++q) s += col[(size_t)q * B];
  singles[(size_t)a * B + b] = bvalid[(size_t)a * B + b] ? (float)s : 0.f;
}

// ---------------------------------------------------------------------------
// feature rules: the decisions, a thread-block cluster a level
// ---------------------------------------------------------------------------

struct RtDecideArgs {
  const float* mat;          // (A, B, N) the slab, arrival-major
  const float* singles;      // (A, B) singleton gains (0 when invalid)
  const float* row0;         // (N,) the empty solution's row
  const float* rows_in;      // (G, L, N)
  const float* values_in;    // (G, L) raw f(S)
  const int* counts_in;      // (G, L)
  const int* expos_in;       // (G, L)
  const float* m_in;         // (G,) running max singleton gain
  const unsigned char* bvalid;  // (A, B) 0/1
  const float* costs;        // (A, B) cost mode
  const float* spent_in;     // (G, L) cost mode
  float* rows_out;
  float* values_out;
  int* counts_out;
  unsigned char* admits;     // (G, L, B) 0/1
  int* expos_out;
  float* m_out;              // (G,)
  unsigned char* expired;    // (G, L) 0/1
  float* spent_out;
  int G, L, N, B, A, k, chunk, vec;
  float eps_log, budget;
  RtRule rule;
};

// Four row entries n .. n + 3 of the block's slice (local index i).
template <bool GROWS>
__device__ __forceinline__ float4 rt_row4(const float* rows, int i) {
  if constexpr (GROWS)
    return __ldcg(reinterpret_cast<const float4*>(rows + i));
  else
    return *reinterpret_cast<const float4*>(rows + i);
}
template <bool GROWS>
__device__ __forceinline__ float rt_row1(const float* rows, int i) {
  if constexpr (GROWS)
    return __ldcg(rows + i);
  else
    return rows[i];
}

// This thread's float64 chains of gain parts over its entries of the
// block's chunk [cs, ce) (entries cs + 4t + 1024i + e, ascending), one
// chain against each of the window's nw slab columns M + wb[u] * N;
// `rows` is indexed from cs. Each row vector is read once for the nw
// columns, whose 16-byte loads are in flight together.
template <bool GROWS>
__device__ __forceinline__ void rt_chunk_parts(
    const float* M, size_t N, const int (&wb)[RT_WINDOW], int nw,
    const float* rows, int cs, int ce, bool vec, RtRule rule,
    double (&acc)[RT_WINDOW]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int u = 0; u < RT_WINDOW; ++u) acc[u] = 0.0;
  if (vec) {
    for (int n = cs + 4 * t; n < ce; n += 4 * RT_THREADS) {
      const float4 r = rt_row4<GROWS>(rows, n - cs);
      float4 m[RT_WINDOW];
#pragma unroll
      for (int u = 0; u < RT_WINDOW; ++u)
        if (u < nw)
          m[u] = __ldg(reinterpret_cast<const float4*>(M + wb[u] * N + n));
#pragma unroll
      for (int u = 0; u < RT_WINDOW; ++u) {
        if (u < nw) {
          acc[u] += (double)rt_gain_part(r.x, m[u].x, rule);
          acc[u] += (double)rt_gain_part(r.y, m[u].y, rule);
          acc[u] += (double)rt_gain_part(r.z, m[u].z, rule);
          acc[u] += (double)rt_gain_part(r.w, m[u].w, rule);
        }
      }
    }
  } else {
    for (int n = cs + 4 * t; n < ce; n += 4 * RT_THREADS)
      for (int e = 0; e < 4 && n + e < ce; ++e) {
        const float r = rt_row1<GROWS>(rows, n + e - cs);
#pragma unroll
        for (int u = 0; u < RT_WINDOW; ++u)
          if (u < nw)
            acc[u] += (double)rt_gain_part(r, __ldg(M + wb[u] * N + n + e),
                                           rule);
      }
  }
}

// Fold column col into this thread's entries of the chunk [cs, ce)
// (`rows` indexed from cs).
template <bool GROWS>
__device__ __forceinline__ void rt_chunk_fold(const float* col, float* rows,
                                              int cs, int ce, bool vec,
                                              RtRule rule) {
  const int t = threadIdx.x;
  for (int n = cs + 4 * t; n < ce; n += 4 * RT_THREADS) {
    if (vec) {
      const float4 m = __ldg(reinterpret_cast<const float4*>(col + n));
      const float4 r = rt_row4<GROWS>(rows, n - cs);
      *reinterpret_cast<float4*>(rows + n - cs) =
          make_float4(rt_fold(r.x, m.x, rule), rt_fold(r.y, m.y, rule),
                      rt_fold(r.z, m.z, rule), rt_fold(r.w, m.w, rule));
    } else {
      for (int e = 0; e < 4 && n + e < ce; ++e)
        rows[n + e - cs] =
            rt_fold(rt_row1<GROWS>(rows, n + e - cs), __ldg(col + n + e),
                    rule);
    }
  }
}

// Grid: a cluster of RT_CHUNKS blocks a (sieve, level) (block x: item
// x / 8, rank x % 8). Dynamic shared memory: the block's chunk of the
// level's row (!GROWS), none on the device-memory tier.
//
// The arrivals are decided in windows: the next `win` live arrivals (the
// level's state is constant until an admission, so liveness and each
// verdict stand alone) get their gains in one pass, one barrier and one
// exchange; the first admitted one is folded and the next window starts
// after it. A window follows an admission with 1 arrival and doubles,
// to RT_WINDOW, after each window that admits none: admission-heavy
// batches pay no reads they discard, the rest one exchange a window.
template <bool COST, bool GROWS>
__global__ void __launch_bounds__(RT_THREADS, 3)
    rt_stream_decide_kernel(RtDecideArgs p) {
  __shared__ double wsum[RT_WINDOW][RT_WARPS];
  // chunk sums, two buffers: one is rewritten only after every block of
  // the cluster passed the barrier of the window in between, i.e. read it
  __shared__ double csum[2][RT_WINDOW];
  __shared__ float red[RT_WARPS];
  extern __shared__ __align__(16) float srow[];
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int rank = (int)cluster.block_rank();
  const int item = blockIdx.x / RT_CHUNKS;
  const int N = p.N, B = p.B, L = p.L, CH = p.chunk;
  const bool vec = p.vec != 0;
  const int g = item / L;
  const int l = item % L;
  const int a = p.A == 1 ? 0 : g;
  // the batch's max valid singleton gain (the same in every block)
  float mx = 0.f;
  for (int b = t; b < B; b += RT_THREADS)
    mx = fmaxf(mx, p.singles[(size_t)a * B + b]);
  mx = rt_block_max(mx, red);
  const float m_old = p.m_in[g];
  const float m_new = fmaxf(m_old, mx);
  const RtAnchor an = rt_reanchor(p.expos_in + (size_t)g * L, L, l, m_old,
                                  m_new, p.eps_log);
  const size_t gl = (size_t)g * L + l;
  const float* rin = an.expired ? p.row0 : p.rows_in + gl * N;
  const int base = rank * CH, end = min(N, base + CH);
  float* rows = GROWS ? p.rows_out + gl * N + base : srow;
  // every thread copies in, and later reads and writes, only its entries
  for (int n = base + 4 * t; n < end; n += 4 * RT_THREADS)
    for (int e = 0; e < 4 && n + e < end; ++e) rows[n + e - base] = rin[n + e];
  if (rank == 0)
    for (int b = t; b < B; b += RT_THREADS) p.admits[gl * B + b] = 0;
  float f = an.expired ? 0.f : p.values_in[gl];
  int c = an.expired ? 0 : p.counts_in[gl];
  float spent = 0.f;
  if constexpr (COST) spent = an.expired ? 0.f : p.spent_in[gl];
  const float* M = p.mat + (size_t)a * B * N;
  const unsigned char* valid = p.bvalid + (size_t)a * B;
  const float* costs = COST ? p.costs + (size_t)a * B : nullptr;
  int cur = 0, win = RT_WINDOW, buf = 0;
  while (cur < B && c < p.k) {  // uniform over the cluster
    float room = 0.f;
    if constexpr (COST) room = fmaxf(__fsub_rn(p.budget, spent), 0.f);
    // the window: the next `win` live arrivals from cur
    int wb[RT_WINDOW] = {};
    int nw = 0, b = cur;
    for (; b < B && nw < win; ++b) {
      bool live = valid[b];
      if constexpr (COST) live = live && costs[b] > 0.f && costs[b] <= room;
      if (!live) continue;
#pragma unroll
      for (int u = 0; u < RT_WINDOW; ++u)
        if (u == nw) wb[u] = b;
      ++nw;
    }
    if (nw == 0) break;
    double v[RT_WINDOW];
    rt_chunk_parts<GROWS>(M, (size_t)N, wb, nw, rows, base, end, vec, p.rule,
                          v);
#pragma unroll
    for (int u = 0; u < RT_WINDOW; ++u) {
      if (u < nw) {
        double x = v[u];
        for (int off = 16; off > 0; off >>= 1)
          x += __shfl_down_sync(0xffffffffu, x, off);
        if (lane == 0) wsum[u][warp] = x;
      }
    }
    __syncthreads();
    if (t < nw) {
      double s = 0.0;
      for (int w = 0; w < RT_WARPS; ++w) s += wsum[t][w];
      csum[buf][t] = s;
    }
    cluster.sync();
    // walk the window in order to its first admission
    int first = -1;
    float gain = 0.f, cost = 0.f;
#pragma unroll
    for (int u = 0; u < RT_WINDOW; ++u) {
      if (u < nw && first < 0) {
        double tot = 0.0;
#pragma unroll
        for (int J = 0; J < RT_CHUNKS; ++J)
          tot += *cluster.map_shared_rank(&csum[buf][u], J);
        const float gu = (float)tot;
        const float cu = COST ? costs[wb[u]] : 0.f;
        if (rt_sieve_admit<COST>(gu, an.vgrid, f, c, p.k, cu, room)) {
          first = u;
          gain = gu;
          cost = cu;
        }
      }
    }
    buf ^= 1;
    if (first < 0) {
      cur = b;
      win = min(2 * win, RT_WINDOW);
      continue;
    }
    int fb = wb[0];
#pragma unroll
    for (int u = 1; u < RT_WINDOW; ++u)
      if (u == first) fb = wb[u];
    rt_chunk_fold<GROWS>(M + (size_t)fb * N, rows, base, end, vec, p.rule);
    f = __fadd_rn(f, gain);
    c += 1;
    if constexpr (COST) spent = __fadd_rn(spent, cost);
    if (rank == 0 && t == 0) p.admits[gl * B + fb] = 1;
    cur = fb + 1;
    win = 1;
  }
  if constexpr (!GROWS) {
    for (int n = base + 4 * t; n < end; n += 4 * RT_THREADS)
      for (int e = 0; e < 4 && n + e < end; ++e)
        p.rows_out[gl * N + n + e] = rows[n + e - base];
  }
  if (rank == 0 && t == 0) {
    p.values_out[gl] = f;
    p.counts_out[gl] = c;
    p.expos_out[gl] = an.expo;
    p.expired[gl] = an.expired;
    if constexpr (COST) p.spent_out[gl] = spent;
    if (l == 0) p.m_out[g] = m_new;
  }
  // no block leaves while another may still read its chunk sums
  cluster.sync();
}

// The gain's chunk: ceil(N / 8) rounded up to a multiple of 4.
static int rt_stream_chunk(int N) {
  const int c = (N + RT_CHUNKS - 1) / RT_CHUNKS;
  return (c + 3) / 4 * 4;
}

template <class TG>
static cudaError_t rt_slab_launch(const TG* ground, const float* gscale,
                                  const float* gnorm, const float* arrivals,
                                  const float* anorm, const float* row0,
                                  float* mat, double* partials, int N, int B,
                                  int A, int D, int mode, RtRule rule,
                                  cudaStream_t st) {
  const size_t align = rt_scaled<TG>() ? 4 : 16;
  const bool vec = D % 4 == 0 && (uintptr_t)ground % align == 0 &&
                   (uintptr_t)arrivals % 16 == 0;
  const int smem = RT_T128_OUTER_FLOATS * (int)sizeof(float);
  void* fn = vec ? (void*)rt_stream_slab_kernel<TG, true>
                 : (void*)rt_stream_slab_kernel<TG, false>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((B + RT_T128 - 1) / RT_T128, (N + RT_T128 - 1) / RT_T128, A);
  if (vec)
    rt_stream_slab_kernel<TG, true><<<grid, RT_THREADS, smem, st>>>(
        ground, gscale, gnorm, arrivals, anorm, row0, mat, partials, N, B, D,
        mode, rule);
  else
    rt_stream_slab_kernel<TG, false><<<grid, RT_THREADS, smem, st>>>(
        ground, gscale, gnorm, arrivals, anorm, row0, mat, partials, N, B, D,
        mode, rule);
  return cudaGetLastError();
}

// x: (R, D) f32 (storage RT_STORE_F32) or int8 (RT_STORE_INT8, xscale
// (R,) row scales); nrm (R,) f32: each row's float64 squared norm, cast
// once (the ground's, once per evaluation set). Returns the cudaError_t.
extern "C" int rt_stream_norms(const void* x, const float* xscale,
                               float* nrm, long long R, int D, int storage,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (storage == RT_STORE_F32)
    return (int)rt_norms((const float*)x, (const float*)nullptr, nrm, R, D,
                         st);
  if (storage == RT_STORE_INT8)
    return (int)rt_norms((const int8_t*)x, xscale, nrm, R, D, st);
  return (int)cudaErrorInvalidValue;
}

// The slab alone (a check's or a timing's entry): mat (A, B, N), partials
// (A, ceil(N/64), B) as rt_stream_filter builds them; gnorm (N,) and
// anorm (A*B,) the norms for 'dist' (anorm is computed here), null for
// 'dot'. reference != 0 runs the 64x64-tile yardstick instead (its norms
// inline; gnorm and anorm unused). Returns the cudaError_t.
extern "C" int rt_stream_slab(const void* ground, const float* gscale,
                              const float* gnorm, const float* arrivals,
                              float* anorm, const float* row0, float* mat,
                              double* partials, int N, int B, int A, int D,
                              int mode, int storage, int fold, float cap,
                              float lam, float lam1, int reference,
                              void* stream) {
  if (N == 0 || B == 0 || A == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const RtRule rule{fold, cap, lam, lam1};
  if (storage != RT_STORE_F32 && storage != RT_STORE_INT8)
    return (int)cudaErrorInvalidValue;
  if (reference) {
    const int tn = (N + RT_TILE - 1) / RT_TILE;
    const int tb = (B + RT_TILE - 1) / RT_TILE;
    const unsigned grid = (unsigned)A * tn * tb;
    if (storage == RT_STORE_F32)
      rt_stream_slab64_kernel<float><<<grid, RT_THREADS, 0, st>>>(
          (const float*)ground, gscale, arrivals, row0, mat, partials, N, B,
          D, mode, rule);
    else
      rt_stream_slab64_kernel<int8_t><<<grid, RT_THREADS, 0, st>>>(
          (const int8_t*)ground, gscale, arrivals, row0, mat, partials, N, B,
          D, mode, rule);
    return (int)cudaGetLastError();
  }
  if (mode == RT_MODE_DIST) {
    if (gnorm == nullptr || anorm == nullptr)
      return (int)cudaErrorInvalidValue;
    cudaError_t e = rt_norms(arrivals, (const float*)nullptr, anorm,
                             (long long)A * B, D, st);
    if (e != cudaSuccess) return (int)e;
  }
  if (storage == RT_STORE_F32)
    return (int)rt_slab_launch((const float*)ground, gscale, gnorm, arrivals,
                               anorm, row0, mat, partials, N, B, A, D, mode,
                               rule, st);
  return (int)rt_slab_launch((const int8_t*)ground, gscale, gnorm, arrivals,
                             anorm, row0, mat, partials, N, B, A, D, mode,
                             rule, st);
}

// One batch: ground (N, D) f32 or int8 (+ gscale (N,)), gnorm (N,) the
// ground's norms ('dist'; null for 'dot'). State (G sieves of L levels):
// rows (G, L, N) f32, values (G, L), counts / expos (G, L) int32, m (G,);
// arrivals (A, B, D) with A = 1 (shared by all sieves) or A = G; bvalid
// (A, B) 0/1 bytes; costs (A, B) and spent (G, L) in cost mode (null
// otherwise). Scratch: mat (A, B, N) f32, partials (A, ceil(N/64), B)
// float64, anorm (A*B,) f32 ('dist'), singles (A, B) f32. global_rows:
// the device-memory tier (the level rows live in rows_out). Four launches
// on `stream`. Returns the cudaError_t.
extern "C" int rt_stream_filter(
    const void* ground, const float* gscale, const float* gnorm,
    const float* arrivals, const float* row0, const float* rows_in,
    const float* values_in, const int* counts_in, const int* expos_in,
    const float* m_in, const unsigned char* bvalid, const float* costs,
    const float* spent_in, float* mat, double* partials, float* anorm,
    float* singles, float* rows_out, float* values_out, int* counts_out,
    unsigned char* admits, int* expos_out, float* m_out,
    unsigned char* expired, float* spent_out, int G, int L, int N, int B,
    int A, int D, int k, int mode, int storage, int fold, float cap,
    float lam, float lam1, float eps_log, int cost_mode, float budget,
    int global_rows, void* stream) {
  if (G == 0 || L == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  void* fn =
      cost_mode
          ? (global_rows ? (void*)rt_stream_decide_kernel<true, true>
                         : (void*)rt_stream_decide_kernel<true, false>)
          : (global_rows ? (void*)rt_stream_decide_kernel<false, true>
                         : (void*)rt_stream_decide_kernel<false, false>);
  int err = rt_stream_slab(ground, gscale, gnorm, arrivals, anorm, row0, mat,
                           partials, N, B, A, D, mode, storage, fold, cap,
                           lam, lam1, 0, stream);
  if (err != 0) return err;
  const int tn = (N + RT_TILE - 1) / RT_TILE;
  rt_stream_singles_kernel<<<dim3((B + 31) / 32, A), 32, 0, st>>>(
      partials, bvalid, singles, tn, B);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int chunk = rt_stream_chunk(N);
  const bool vec = N % 4 == 0 && (uintptr_t)mat % 16 == 0 &&
                   (uintptr_t)row0 % 16 == 0 && (uintptr_t)rows_in % 16 == 0 &&
                   (uintptr_t)rows_out % 16 == 0;
  RtDecideArgs p{mat,       singles,  row0,       rows_in,    values_in,
                 counts_in, expos_in, m_in,       bvalid,     costs,
                 spent_in,  rows_out, values_out, counts_out, admits,
                 expos_out, m_out,    expired,    spent_out,  G,
                 L,         N,        B,          A,          k,
                 chunk,     (int)vec, eps_log,    budget,
                 RtRule{fold, cap, lam, lam1}};
  const int smem = global_rows ? 0 : chunk * (int)sizeof(float);
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)RT_CHUNKS * G * L);
  cfg.blockDim = dim3(RT_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = RT_CHUNKS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {(void*)&p};
  e = cudaLaunchKernelExC(&cfg, fn, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the bitmap rule (coverage)
// ---------------------------------------------------------------------------

// One warp an arrival (grid ceil(A*B / 8)): its singleton gain against
// row0 (0 for an invalid arrival) and its nonzero words compacted in
// ascending order into lidx / lword (A, B, W), their number in lcnt.
__global__ void __launch_bounds__(RT_THREADS)
    rt_stream_bits_prep_kernel(const unsigned* __restrict__ arrivals,
                               const unsigned* __restrict__ row0,
                               const unsigned char* __restrict__ bvalid,
                               int* __restrict__ lidx,
                               unsigned* __restrict__ lword,
                               int* __restrict__ lcnt,
                               float* __restrict__ single, int AB, int W) {
  const int lane = threadIdx.x & 31;
  const int ab = blockIdx.x * RT_WARPS + (threadIdx.x >> 5);
  if (ab >= AB) return;  // whole warps leave together
  const unsigned* x = arrivals + (size_t)ab * W;
  int* li = lidx + (size_t)ab * W;
  unsigned* lw = lword + (size_t)ab * W;
  const unsigned below = (1u << lane) - 1u;
  int s = 0, cnt = 0;
  for (int w0 = 0; w0 < W; w0 += 128) {
    unsigned m[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int w = w0 + 32 * u + lane;
      m[u] = w < W ? x[w] : 0u;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int w = w0 + 32 * u + lane;
      if (w < W) s += rt_bits_part(row0[w], m[u]);
      const unsigned nz = __ballot_sync(0xffffffffu, m[u] != 0u);
      if (m[u] != 0u) {
        const int at = cnt + __popc(nz & below);
        li[at] = w;
        lw[at] = m[u];
      }
      cnt += __popc(nz);
    }
  }
  s = __reduce_add_sync(0xffffffffu, s);
  if (lane == 0) {
    lcnt[ab] = cnt;
    single[ab] = bvalid[ab] ? (float)s : 0.f;
  }
}

struct RtStreamBitsArgs {
  const unsigned* arrivals;  // (A, B, W) words
  const int* lidx;           // (A, B, W) the arrivals' nonzero words
  const unsigned* lword;
  const int* lcnt;           // (A, B)
  const float* single;       // (A, B) singleton gains (0 when invalid)
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

// One block a (sieve, level), grid G * L. Dynamic shared memory: the B
// gains, the B admission flags and (!GROWS) the level's W words; on the
// device-memory tier the words live in the level's row of rows_out.
template <bool COST, bool GROWS>
__global__ void __launch_bounds__(RT_THREADS)
    rt_stream_bits_level_kernel(RtStreamBitsArgs p) {
  extern __shared__ __align__(16) int sgain[];  // (B,) then words
  __shared__ float red[RT_WARPS];
  __shared__ int sfirst;
  const int W = p.W, B = p.B, L = p.L;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int g = blockIdx.x / L;
  const int l = blockIdx.x % L;
  const int a = p.A == 1 ? 0 : g;
  unsigned char* adm = reinterpret_cast<unsigned char*>(sgain + B);  // (B,)
  unsigned* srow = reinterpret_cast<unsigned*>(sgain + B + (B + 3) / 4);
  float mx = 0.f;
  for (int b = t; b < B; b += RT_THREADS)
    mx = fmaxf(mx, p.single[(size_t)a * B + b]);
  mx = rt_block_max(mx, red);
  const float m_old = p.m_in[g];
  const float m_new = fmaxf(m_old, mx);
  const RtAnchor an = rt_reanchor(p.expos_in + (size_t)g * L, L, l, m_old,
                                  m_new, p.eps_log);
  const size_t gl = (size_t)g * L + l;
  const unsigned* rin = an.expired ? p.row0 : p.rows_in + gl * W;
  unsigned* row = GROWS ? p.rows_out + gl * W : srow;
  for (int w = t; w < W; w += RT_THREADS) row[w] = rin[w];
  for (int b = t; b < B; b += RT_THREADS) adm[b] = 0;
  float f = an.expired ? 0.f : p.values_in[gl];
  int c = an.expired ? 0 : p.counts_in[gl];
  float spent = 0.f;
  if constexpr (COST) spent = an.expired ? 0.f : p.spent_in[gl];
  const unsigned char* valid = p.bvalid + (size_t)a * B;
  const float* costs = COST ? p.costs + (size_t)a * B : nullptr;
  const unsigned* arr = p.arrivals + (size_t)a * B * W;
  const int* lidx = p.lidx + (size_t)a * B * W;
  const unsigned* lword = p.lword + (size_t)a * B * W;
  const int* lcnt = p.lcnt + (size_t)a * B;
  __syncthreads();
  int cur = 0;
  while (cur < B && c < p.k) {
    float room = 0.f;
    if constexpr (COST) room = fmaxf(__fsub_rn(p.budget, spent), 0.f);
    // evaluate ahead: every remaining candidate's gain against the row; a
    // short word list (a kosarak set: ~8 words) a thread, a long one a
    // warp, a dense one (over half the words) read as words
    auto need = [&](int b) {
      bool ok = valid[b];
      if constexpr (COST) ok = ok && costs[b] > 0.f && costs[b] <= room;
      return ok;
    };
    for (int b = cur + t; b < B; b += RT_THREADS) {
      const int n = lcnt[b];
      if (!need(b) || n > RT_BITS_SHORT) continue;
      const int* ib = lidx + (size_t)b * W;
      const unsigned* wb = lword + (size_t)b * W;
      int s = 0;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int w = ib[j];
        s += rt_bits_part(GROWS ? __ldcg(row + w) : row[w], wb[j]);
      }
      sgain[b] = s;
    }
    for (int b = cur + warp; b < B; b += RT_WARPS) {
      const int n = lcnt[b];
      if (!need(b) || n <= RT_BITS_SHORT) continue;  // uniform over the warp
      int s = 0;
      if (2 * n > W) {  // dense: the words themselves, half the bytes
        const unsigned* xb = arr + (size_t)b * W;
#pragma unroll 4
        for (int w = lane; w < W; w += 32)
          s += rt_bits_part(GROWS ? __ldcg(row + w) : row[w], xb[w]);
      } else {
        const int* ib = lidx + (size_t)b * W;
        const unsigned* wb = lword + (size_t)b * W;
#pragma unroll 4
        for (int j = lane; j < n; j += 32) {
          const int w = ib[j];
          s += rt_bits_part(GROWS ? __ldcg(row + w) : row[w], wb[j]);
        }
      }
      s = __reduce_add_sync(0xffffffffu, s);
      if (lane == 0) sgain[b] = s;
    }
    __syncthreads();
    // the first admission from cur on: the level's state is constant
    // until it, so each arrival's verdict stands alone
    if (warp == 0) {
      int first = B;
      for (int b0 = cur; b0 < B; b0 += 32) {
        const int b = b0 + lane;
        bool ok = false;
        if (b < B && valid[b]) {
          float cost = 0.f;
          bool live = true;
          if constexpr (COST) {
            cost = costs[b];
            live = cost > 0.f && cost <= room;
          }
          ok = live && rt_sieve_admit<COST>((float)sgain[b], an.vgrid, f, c,
                                            p.k, cost, room);
        }
        const unsigned hit = __ballot_sync(0xffffffffu, ok);
        if (hit) {
          first = b0 + __ffs(hit) - 1;
          break;
        }
      }
      if (lane == 0) sfirst = first;
    }
    __syncthreads();
    const int first = sfirst;
    if (first >= B) break;
    // fold it: its nonzero words into the row (distinct words, no race)
    const float gain = (float)sgain[first];
    const int n = lcnt[first];
    const int* ib = lidx + (size_t)first * W;
    const unsigned* wb = lword + (size_t)first * W;
    for (int j = t; j < n; j += RT_THREADS) {
      const int w = ib[j];
      row[w] = rt_bits_fold(GROWS ? __ldcg(row + w) : row[w], wb[j]);
    }
    if (t == 0) adm[first] = 1;
    f = __fadd_rn(f, gain);
    c += 1;
    if constexpr (COST) spent = __fadd_rn(spent, costs[first]);
    cur = first + 1;
    __syncthreads();  // the row and sfirst are read again next pass
  }
  __syncthreads();
  for (int b = t; b < B; b += RT_THREADS) p.admits[gl * B + b] = adm[b];
  if constexpr (!GROWS)
    for (int w = t; w < W; w += RT_THREADS) p.rows_out[gl * W + w] = row[w];
  if (t == 0) {
    p.values_out[gl] = f;
    p.counts_out[gl] = c;
    p.expos_out[gl] = an.expo;
    p.expired[gl] = an.expired;
    if constexpr (COST) p.spent_out[gl] = spent;
    if (l == 0) p.m_out[g] = m_new;
  }
}

// Bitmap state: rows (G, L, W) words, arrivals (A, B, W) words (A = 1 or
// G), the rest as rt_stream_filter; scratch lidx / lword (A, B, W), lcnt
// (A, B) int32 and single (A, B) f32. global_rows: the device-memory
// tier. Two launches on `stream`. Returns the cudaError_t.
extern "C" int rt_stream_filter_bits(
    const unsigned* arrivals, const unsigned* row0, const unsigned* rows_in,
    const float* values_in, const int* counts_in, const int* expos_in,
    const float* m_in, const unsigned char* bvalid, const float* costs,
    const float* spent_in, int* lidx, unsigned* lword, int* lcnt,
    float* single, unsigned* rows_out, float* values_out, int* counts_out,
    unsigned char* admits, int* expos_out, float* m_out,
    unsigned char* expired, float* spent_out, int G, int L, int W, int B,
    int A, int k, float eps_log, int cost_mode, float budget,
    int global_rows, void* stream) {
  if (G == 0 || L == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int ab = A * B;
  rt_stream_bits_prep_kernel<<<(ab + RT_WARPS - 1) / RT_WARPS, RT_THREADS, 0,
                               st>>>(arrivals, row0, bvalid, lidx, lword,
                                     lcnt, single, ab, W);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  RtStreamBitsArgs p{arrivals,  lidx,      lword,     lcnt,     single,
                     row0,
                     rows_in,   values_in, counts_in, expos_in,  m_in,
                     bvalid,    costs,     spent_in, rows_out,   values_out,
                     counts_out, admits,   expos_out, m_out,     expired,
                     spent_out, G,         L,        W,          B,
                     A,         k,         eps_log,  budget};
  const int smem = (int)sizeof(int) * (B + (B + 3) / 4 + (global_rows ? 0 : W));
  void* fn;
  if (global_rows)
    fn = cost_mode ? (void*)rt_stream_bits_level_kernel<true, true>
                   : (void*)rt_stream_bits_level_kernel<false, true>;
  else
    fn = cost_mode ? (void*)rt_stream_bits_level_kernel<true, false>
                   : (void*)rt_stream_bits_level_kernel<false, false>;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&p};
  e = cudaLaunchKernel(fn, dim3((unsigned)(G * L)), dim3(RT_THREADS), args,
                       (size_t)smem, st);
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
