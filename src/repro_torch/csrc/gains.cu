// Per-step marginal gains without a cache: (B, N, D) ground, (B, N) state
// rows, (B, C, D) candidates -> (B, C) raw gain sums, f32.
//
// Replaces the Pallas kernel src/repro/kernels/pairwise.py:gains_pallas
// (_gains_kernel), the step engine's gains pass: for every candidate c,
// sum over ground rows n of part(row_n, M_nc), where M is the rule's
// pairwise entry ('dist' for kmedoid, 'dot' for the similarity rules)
// and part the rule's gain part (rules.cuh). Invalid candidates are set
// to -inf by the wrapper; this kernel only masks its ragged edges.
//
// What bounds it on the H100: operations. At the stochastic leaf shape
// of the Tiny-ImageNet configuration (32 leaves, N = 3,125 ground rows,
// a 72-candidate sample, D = 12,288) one step is 2*B*N*C*D ~ 1.8e11
// fp32 flops (~2.6 ms at 67 TFLOP/s; TF32 would keep ~3 digits of a
// 'dist' expansion that cancels heavily) against ~4.9 GB of ground rows
// read once (~1.5 ms at 3.35 TB/s).
//
// What the design does about it. The TPU grid walked (candidate block,
// ground block) with the ground block innermost, accumulating into the
// revisited output block in order. Here every (64 ground rows x CW
// candidates) tile is its own block, grid (N/64, C/CW, B), built on a
// variant of tile128.cuh's loop: 128 threads, each an 8 x (4 + E)
// register micro-tile (rows ty*4 + {0..3, 32..35}, columns tx*4 + {0..3}
// and 64 + tx*E + {0..E-1}), the features walked in slices of 8 staged
// k-major in a two-stage shared-memory ring with one barrier a slice,
// each thread's 16-byte global loads of the next slice in flight in
// registers during the multiply (scalar loads when D % 4 != 0 or an
// operand is not aligned: template flag VEC). The candidate width CW =
// 64 + 16E (E in {0, 1}: 64 or 80 columns) is the one that pads the
// step's sample least: the stochastic leaf's 72 candidates take one
// 80-wide tile (1.11x the useful products, where two 64-wide tiles took
// 1.78x). 32 or 40 accumulators, at most 128 registers a thread
// (__launch_bounds__(128, 4)), 8.5 or 9.5 KB of staging and 8 or 10 KB
// of float64 column sums: 4 blocks (16 warps) an SM. At the leaf
// that is 32 greedies x 49 row tiles = 1,568 blocks against 528 resident:
// 2.97 waves, where 128-row tiles would give 800 blocks on 264 slots
// (3.03 waves, the fourth nearly empty).
//
// The norms ('dist') are not computed by the tile: the ground's come
// from rt_gains_norms, once per greedy (the step engine keeps them beside
// its state: the ground does not change over a greedy's steps), the
// candidates' from the same pass run per call before the tile. Each is
// the row's float64 fma(v, v, .) chain in ascending feature order, cast
// once to f32 (for int8, of the widened entries): the chain the 64x64
// tile (pairwise_tile.cuh) runs inline.
//
// The epilogue turns the tile's registers into f32 gain parts against
// the tile's 64 state-row entries and sums them over the tile's rows in
// float64 (4 rows a thread, then the 16 four-row groups in order),
// writing one (CW,) float64 partial per block. The last block of each
// (greedy, candidate tile) to finish - counted with an atomic int after
// a __threadfence - sums the N/64 partials in row-tile order and rounds
// once to f32, so runs repeat bit for bit (no float atomics) in one
// launch. Every entry is one f32 fmaf chain over ascending features from
// 0, as on the 64x64 tile, and the float64 sums group the parts as its
// epilogue grouped them, so the kernel equals the 64x64-tile build
// (rt_gains64_kernel, kept as the yardstick of a test) bit for bit.
//
// The int8 ground (_gains_kernel_quant, pairwise.py:93: the step engine
// under a forced int8 rung) is the same kernel over int8 ground rows and
// their (B, N) f32 row scales: each staged entry is widened by
// __fmul_rn(q, scale) (tile128.cuh: rt_load4), then the same fp32 tile,
// float64 sums and last-block reduction, so it equals this kernel on the
// dequantized ground bit for bit. Its bound at the stochastic leaf shape
// is the f32 kernel's, by operations: int8 rows cut the bytes read (1.2
// GB instead of 4.9 GB), not the products.
//
// The bitmap rule (coverage) runs a kernel of its own, rt_gains_bits: the
// bitmap branch of _gains_kernel (grid (C/TC, W/TW) there), raw sums of
// popc(cand[c, w] & ~row[w]) over (B, C, W) candidate words and (B, W)
// covered words. It has no matrix product: each block copies its
// greedy's covered words into shared memory and gives each candidate to
// one warp, which streams the candidate's words (coalesced) and sums the
// bit counts in int32 (exact), converted once to f32 (exact while a gain
// is at most 2^24, which the wrapper checks). Bound by bytes: the
// candidate words are read once, at the stochastic kcover leaf
// 32 x 2,227 x 1,290 words x 4 B = 368 MB, 0.11 ms at 3.35 TB/s.
#include "tile128.cuh"

#define RT_G_ROWS 64   // ground rows a tile: one group of the row sum
#define RT_G_THREADS 128
#define RT_G_TK 8      // features a slice
#define RT_G_LDA (RT_G_ROWS + 4)

// The candidate tile: CW = 64 + 16E columns, NJ = 4 + E a thread, the
// staging rows padded by 4 floats (the loader's two halves then store to
// distinct banks), NB candidate loader slots a thread.
template <int E>
struct RtGainsTile {
  static constexpr int CW = 64 + 16 * E;
  static constexpr int LDB = CW + 4;
  static constexpr int NJ = 4 + E;
  static constexpr int NB = (2 * CW + RT_G_THREADS - 1) / RT_G_THREADS;
};

// The (64 x CW) gain tile of greedy blockIdx.z, rows blockIdx.x * 64,
// candidates blockIdx.y * CW (module comment). gnorm (B, N) and cnorm
// (B, C): the f32 norms ('dist' only).
template <class TG, bool VEC, int E>
__global__ void __launch_bounds__(RT_G_THREADS, 4)
    rt_gains_kernel(const TG* __restrict__ ground,
                    const float* __restrict__ gscale,
                    const float* __restrict__ gnorm,
                    const float* __restrict__ row,
                    const float* __restrict__ cands,
                    const float* __restrict__ cnorm,
                    double* __restrict__ partials,
                    int* __restrict__ arrivals, float* __restrict__ out,
                    int N, int C, int D, int mode, RtRule rule) {
  using T = RtGainsTile<E>;
  constexpr int CW = T::CW, NJ = T::NJ, NB = T::NB;
  __shared__ __align__(16) float sa[2][RT_G_TK][RT_G_LDA];
  __shared__ __align__(16) float sb[2][RT_G_TK][T::LDB];
  __shared__ double colsum[16][CW];
  __shared__ int is_last;
  const int t = threadIdx.x;
  const int tx = t & 15;
  const int ty = t >> 4;
  const int nq = gridDim.x;
  const int qn = blockIdx.x;
  const int ct = blockIdx.y;
  const size_t b = blockIdx.z;
  const int n0 = qn * RT_G_ROWS;
  const int c0 = ct * CW;
  const TG* G = ground + b * N * D;
  const float* Cd = cands + b * C * D;

  // loaders: slot s stages features lk .. lk + 3 of tile row s >> 1; the
  // ground has 128 slots (one a thread), the candidates 2 * CW (NB a
  // thread: slots t + 128 u, all with t's lk)
  const int lk = (t & 1) * 4;
  const int lr = t >> 1;
  const bool gin = n0 + lr < N;
  const TG* gp = G + (size_t)(gin ? n0 + lr : 0) * D + lk;
  float gsc = 0.f;
  if constexpr (rt_scaled<TG>()) gsc = gin ? gscale[b * N + n0 + lr] : 0.f;
  bool cin[NB];
  const float* cp[NB];
#pragma unroll
  for (int u = 0; u < NB; ++u) {
    const int r = (t + RT_G_THREADS * u) >> 1;
    cin[u] = r < CW && c0 + r < C;
    cp[u] = Cd + (size_t)(cin[u] ? c0 + r : 0) * D + lk;
  }
  float ra[4], rb[NB][4];
  auto load = [&](int k0) {
    if constexpr (VEC) {
      // D % 4 == 0: the 4 features are all in or all out
      const bool kin = k0 + lk < D;
      if (gin && kin) {
        rt_load4(gp + k0, gsc, ra);
      } else {
        ra[0] = ra[1] = ra[2] = ra[3] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        if (cin[u] && kin) {
          rt_load4(cp[u] + k0, 0.f, rb[u]);
        } else {
          rb[u][0] = rb[u][1] = rb[u][2] = rb[u][3] = 0.f;
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool kin = k0 + lk + q < D;
        ra[q] = gin && kin ? rt_entry(gp, (size_t)(k0 + q), gsc) : 0.f;
#pragma unroll
        for (int u = 0; u < NB; ++u)
          rb[u][q] = cin[u] && kin ? __ldg(cp[u] + k0 + q) : 0.f;
      }
    }
  };
  auto stage = [&](int st) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      sa[st][lk + q][lr] = ra[q];
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        const int r = (t + RT_G_THREADS * u) >> 1;
        if (r < CW) sb[st][lk + q][r] = rb[u][q];
      }
    }
  };

  float acc[8][NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  load(0);
  stage(0);
  __syncthreads();
  int st = 0;
  for (int k0 = 0; k0 < D; k0 += RT_G_TK) {
    const bool more = k0 + RT_G_TK < D;
    if (more) load(k0 + RT_G_TK);  // in flight during the multiply
#pragma unroll
    for (int kk = 0; kk < RT_G_TK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sa[st][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sa[st][kk][32 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sb[st][kk][tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[NJ];
      bv[0] = b0.x, bv[1] = b0.y, bv[2] = b0.z, bv[3] = b0.w;
      if constexpr (E == 1) bv[4] = sb[st][kk][64 + tx];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    if (more) stage(st ^ 1);
    // one barrier a slice: the other stage is written, and every thread
    // is done reading this one before the next slice overwrites it
    __syncthreads();
    st ^= 1;
  }

  // epilogue: the gain parts of the thread's 8 rows x NJ columns, summed
  // in float64 over each of its two four-row groups (group h * 8 + ty)
  const bool dist = mode == RT_MODE_DIST;
  float gn[8], rw[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = n0 + (i >> 2) * 32 + ty * 4 + (i & 3);
    gn[i] = dist && r < N ? gnorm[b * N + r] : 0.f;
    rw[i] = r < N ? row[b * N + r] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int lc = j < 4 ? tx * 4 + j : 64 + tx * E + (j - 4);
    const int c = c0 + lc;
    const float cn = dist && c < C ? cnorm[b * C + c] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      double sum = 0.0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = h * 4 + q;
        if (n0 + h * 32 + ty * 4 + q < N && c < C)
          sum += (double)rt_gain_part(
              rw[i], rt_entry_value(gn[i], cn, acc[i][j], mode), rule);
      }
      colsum[h * 8 + ty][lc] = sum;
    }
  }
  __syncthreads();
  if (t < CW && c0 + t < C) {
    double p = 0.0;
    for (int g = 0; g < 16; ++g) p += colsum[g][t];
    partials[(b * nq + qn) * C + c0 + t] = p;
  }
  __threadfence();
  __syncthreads();
  int* arrived = arrivals + b * gridDim.y + ct;
  if (t == 0) is_last = atomicAdd(arrived, 1) == nq - 1;
  __syncthreads();
  if (!is_last) return;
  if (t < CW && c0 + t < C) {
    double g = 0.0;
    for (int q = 0; q < nq; ++q)
      g += __ldcg(&partials[(b * nq + q) * C + c0 + t]);
    out[b * C + c0 + t] = (float)g;
  }
  if (t == 0) *arrived = 0;  // ready for the next launch
}

// The yardstick: the same gains on the 64x64 tile (pairwise_tile.cuh)
// with its inline float64 norms, grid (C/64, N/64, B), the same partials
// and last-block reduction. Kept only so a test can hold rt_gains_kernel
// to it bit for bit.
template <class TG>
__global__ void __launch_bounds__(RT_THREADS)
    rt_gains64_kernel(const TG* __restrict__ ground,
                      const float* __restrict__ gscale,
                      const float* __restrict__ row,
                      const float* __restrict__ cands,
                      double* __restrict__ partials,
                      int* __restrict__ arrivals, float* __restrict__ out,
                      int N, int C, int D, int mode, RtRule rule) {
  __shared__ __align__(16) RtTileSmem s;
  __shared__ float rows[RT_TILE];
  __shared__ double colsum[16][RT_TILE];
  __shared__ int is_last;
  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  const int nblocks = gridDim.y;
  const size_t b = blockIdx.z;
  const int n0 = blockIdx.y * RT_TILE;
  const int c0 = blockIdx.x * RT_TILE;

  if (t < RT_TILE) rows[t] = n0 + t < N ? row[b * N + n0 + t] : 0.f;
  // rows[] is read only in the epilogue, after rt_tile's barriers
  rt_tile(ground + b * N * D, rt_scaled<TG>() ? gscale + b * N : nullptr,
          cands + b * C * D, N, C, D, n0, c0, mode, s,
          [&](float (&acc)[4][4]) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int lc = tx * 4 + j;
              double sum = 0.0;
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int lr = ty * 4 + i;
                if (n0 + lr < N && c0 + lc < C)
                  sum += (double)rt_gain_part(
                      rows[lr], rt_tile_entry(s, acc[i][j], lr, lc, mode),
                      rule);
              }
              colsum[ty][lc] = sum;
            }
          });
  // rt_tile ends with a barrier: every colsum entry is written
  if (t < RT_TILE && c0 + t < C) {
    double p = 0.0;
    for (int g = 0; g < 16; ++g) p += colsum[g][t];
    partials[(b * nblocks + blockIdx.y) * C + c0 + t] = p;
  }
  __threadfence();
  __syncthreads();
  int* arrived = arrivals + b * gridDim.x + blockIdx.x;
  if (t == 0) is_last = atomicAdd(arrived, 1) == nblocks - 1;
  __syncthreads();
  if (!is_last) return;
  if (t < RT_TILE && c0 + t < C) {
    double g = 0.0;
    for (int q = 0; q < nblocks; ++q)
      g += __ldcg(&partials[(b * nblocks + q) * C + c0 + t]);
    out[b * C + c0 + t] = (float)g;
  }
  if (t == 0) *arrived = 0;  // ready for the next launch
}

// The candidate width that pads C least (CW = 64 + 16E; on a tie the
// wider tile): E in {0, 1}.
static int rt_gains_e(int C) {
  return (C + 79) / 80 * 80 <= (C + 63) / 64 * 64 ? 1 : 0;
}

template <class TG, bool VEC, int E>
static cudaError_t rt_gains_tile_launch(const TG* ground,
                                        const float* gscale,
                                        const float* gnorm, const float* row,
                                        const float* cands,
                                        const float* cnorm, double* partials,
                                        int* arrivals, float* out, int B,
                                        int N, int C, int D, int mode,
                                        RtRule rule, cudaStream_t st) {
  constexpr int CW = RtGainsTile<E>::CW;
  dim3 grid((N + RT_G_ROWS - 1) / RT_G_ROWS, (C + CW - 1) / CW, B);
  rt_gains_kernel<TG, VEC, E><<<grid, RT_G_THREADS, 0, st>>>(
      ground, gscale, gnorm, row, cands, cnorm, partials, arrivals, out, N,
      C, D, mode, rule);
  return cudaGetLastError();
}

template <class TG, bool VEC>
static cudaError_t rt_gains_width(int e, const TG* ground,
                                  const float* gscale, const float* gnorm,
                                  const float* row, const float* cands,
                                  const float* cnorm, double* partials,
                                  int* arrivals, float* out, int B, int N,
                                  int C, int D, int mode, RtRule rule,
                                  cudaStream_t st) {
  if (e == 0)
    return rt_gains_tile_launch<TG, VEC, 0>(ground, gscale, gnorm, row,
                                            cands, cnorm, partials, arrivals,
                                            out, B, N, C, D, mode, rule, st);
  return rt_gains_tile_launch<TG, VEC, 1>(ground, gscale, gnorm, row, cands,
                                          cnorm, partials, arrivals, out, B,
                                          N, C, D, mode, rule, st);
}

template <class TG>
static cudaError_t rt_gains_launch(const TG* ground, const float* gscale,
                                   const float* gnorm, const float* row,
                                   const float* cands, float* cnorm,
                                   double* partials, int* arrivals,
                                   float* out, int B, int N, int C, int D,
                                   int mode, RtRule rule, int reference,
                                   cudaStream_t st) {
  if (reference) {
    dim3 grid((C + RT_TILE - 1) / RT_TILE, (N + RT_TILE - 1) / RT_TILE, B);
    rt_gains64_kernel<TG><<<grid, RT_THREADS, 0, st>>>(
        ground, gscale, row, cands, partials, arrivals, out, N, C, D, mode,
        rule);
    return cudaGetLastError();
  }
  if (mode == RT_MODE_DIST) {
    if (gnorm == nullptr || cnorm == nullptr) return cudaErrorInvalidValue;
    cudaError_t e = rt_norms(cands, (const float*)nullptr, cnorm,
                             (long long)B * C, D, st);
    if (e != cudaSuccess) return e;
  }
  const size_t align = rt_scaled<TG>() ? 4 : 16;
  const bool vec = D % 4 == 0 && (uintptr_t)ground % align == 0 &&
                   (uintptr_t)cands % 16 == 0;
  const int e = rt_gains_e(C);
  if (vec)
    return rt_gains_width<TG, true>(e, ground, gscale, gnorm, row, cands,
                                    cnorm, partials, arrivals, out, B, N, C,
                                    D, mode, rule, st);
  return rt_gains_width<TG, false>(e, ground, gscale, gnorm, row, cands,
                                   cnorm, partials, arrivals, out, B, N, C,
                                   D, mode, rule, st);
}

// ground: (B, N, D) f32 (storage RT_STORE_F32, gscale null) or int8
// (RT_STORE_INT8, gscale (B, N) f32 row scales); gnorm (B, N) the
// ground's norms (rt_gains_norms) and cnorm (B, C) scratch for the
// candidates' ('dist'; null for 'dot'); partials: (B, ceil(N/64), C)
// float64 scratch; arrivals: (B, ceil(C/64)) int32, zero on entry and
// left zero. reference != 0 runs the 64x64-tile yardstick (its norms
// inline; gnorm and cnorm unused). Returns the cudaError_t.
extern "C" int rt_gains(const void* ground, const float* gscale,
                        const float* gnorm, const float* row,
                        const float* cands, float* cnorm, double* partials,
                        int* arrivals, float* out, int B, int N, int C,
                        int D, int mode, int storage, int fold, float cap,
                        float lam, float lam1, int reference, void* stream) {
  if (B == 0 || N == 0 || C == 0) return 0;
  const RtRule rule{fold, cap, lam, lam1};
  cudaStream_t st = (cudaStream_t)stream;
  if (storage == RT_STORE_INT8)
    return (int)rt_gains_launch((const int8_t*)ground, gscale, gnorm, row,
                                cands, cnorm, partials, arrivals, out, B, N,
                                C, D, mode, rule, reference, st);
  if (storage == RT_STORE_F32)
    return (int)rt_gains_launch((const float*)ground, gscale, gnorm, row,
                                cands, cnorm, partials, arrivals, out, B, N,
                                C, D, mode, rule, reference, st);
  return (int)cudaErrorInvalidValue;
}

// The ground's norms once per greedy: x (R, D) f32 (RT_STORE_F32) or int8
// (RT_STORE_INT8, xscale (R,) row scales) -> nrm (R,) f32, each row's
// float64 squared norm cast once. Returns the cudaError_t.
extern "C" int rt_gains_norms(const void* x, const float* xscale,
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

__global__ void __launch_bounds__(RT_THREADS)
    rt_gains_bits_kernel(const unsigned* __restrict__ cands,
                         const unsigned* __restrict__ row,
                         float* __restrict__ out, int C, int W) {
  extern __shared__ unsigned covered[];  // (W,) this greedy's state row
  const size_t b = blockIdx.y;
  for (int w = threadIdx.x; w < W; w += blockDim.x)
    covered[w] = row[b * W + w];
  __syncthreads();
  const int warps = blockDim.x >> 5;
  const int c = blockIdx.x * warps + (threadIdx.x >> 5);
  if (c >= C) return;  // whole warps leave together
  const int g = rt_warp_bits_gain(cands + (b * C + c) * W, covered, W);
  if ((threadIdx.x & 31) == 0) out[b * C + c] = (float)g;
}

// cands (B, C, W) and row (B, W) 32-bit words; out (B, C) f32. Returns
// the cudaError_t.
extern "C" int rt_gains_bits(const unsigned* cands, const unsigned* row,
                             float* out, int B, int C, int W, void* stream) {
  if (B == 0 || C == 0) return 0;
  const int smem = W * (int)sizeof(unsigned);
  cudaError_t e = cudaFuncSetAttribute(
      rt_gains_bits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const int warps = RT_THREADS / 32;
  dim3 grid((C + warps - 1) / warps, B);
  rt_gains_bits_kernel<<<grid, RT_THREADS, (size_t)smem,
                         (cudaStream_t)stream>>>(cands, row, out, C, W);
  return (int)cudaGetLastError();
}
