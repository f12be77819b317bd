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
// What the design does about it: the TPU grid walked (candidate block,
// ground block) with the ground block innermost, accumulating into the
// revisited output block in order. Here every (64 ground rows x 64
// candidates) tile is its own block - grid (C/64, N/64, B), so even 72
// candidates spread over the whole card instead of one block per
// candidate column - built with the resident build's 64x64 fp32 tile
// (pairwise_tile.cuh, float64 norms). The epilogue turns the tile's
// registers into f32 gain parts against the tile's 64 state-row entries
// and sums them over the tile's rows in float64 (4 rows per thread, then
// the 16 row groups), writing one (64,) float64 partial per block. The
// last block of each (greedy, candidate tile) to finish - counted with
// an atomic int after a __threadfence - sums the N/64 partials in block
// order and rounds once to f32, so runs repeat bit for bit (no float
// atomics) in one launch. The float64 sum costs ~20 adds per thread per
// tile against its 16*D f32 FMAs; an f32 sum in three sequential stages
// would add rounding that the plain version's reduction does not.
//
// The int8 ground (_gains_kernel_quant, pairwise.py:93: the step engine
// under a forced int8 rung) is the same kernel over int8 ground rows and
// their (B, N) f32 row scales: the tile stages a tile's 64 scales in
// shared memory and widens each staged entry by __fmul_rn(q, scale)
// (pairwise_tile.cuh), then runs the same fp32 tile, float64 sums and
// last-block reduction, so it equals this kernel on the dequantized
// ground bit for bit. Its bound at the stochastic leaf shape is the f32
// kernel's, by operations: int8 rows cut the bytes read (1.2 GB instead
// of 4.9 GB), not the products.
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
#include "pairwise_tile.cuh"

template <class TG>
__global__ void __launch_bounds__(RT_THREADS)
    rt_gains_kernel(const TG* __restrict__ ground,
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

// ground: (B, N, D) f32 (storage RT_STORE_F32, gscale null) or int8
// (RT_STORE_INT8, gscale (B, N) f32 row scales); partials: (B,
// ceil(N/64), C) float64 scratch; arrivals: (B, ceil(C/64)) int32, zero
// on entry and left zero. Returns the cudaError_t.
extern "C" int rt_gains(const void* ground, const float* gscale,
                        const float* row, const float* cands,
                        double* partials, int* arrivals, float* out, int B,
                        int N, int C, int D, int mode, int storage, int fold,
                        float cap, float lam, float lam1, void* stream) {
  if (B == 0 || N == 0 || C == 0) return 0;
  RtRule rule{fold, cap, lam, lam1};
  dim3 grid((C + RT_TILE - 1) / RT_TILE, (N + RT_TILE - 1) / RT_TILE, B);
  if (storage == RT_STORE_INT8)
    rt_gains_kernel<int8_t><<<grid, RT_THREADS, 0, (cudaStream_t)stream>>>(
        (const int8_t*)ground, gscale, row, cands, partials, arrivals, out, N,
        C, D, mode, rule);
  else if (storage == RT_STORE_F32)
    rt_gains_kernel<float><<<grid, RT_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)ground, gscale, row, cands, partials, arrivals, out, N,
        C, D, mode, rule);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
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
