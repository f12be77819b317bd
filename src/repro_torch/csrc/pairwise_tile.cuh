// One 64x64 tile of the ground x candidate matrix, fp32 FMA (no TF32).
//
// The build phase of the resident loop kernel (greedy_loop_resident.cu)
// runs it: `rt_tile` accumulates a tile and hands its registers to an
// epilogue; `rt_pairwise_tile` is the epilogue that stores the entries
// (the resident build). The pairwise kernel and the stream filter's slab
// run the larger tile of tile128.cuh, built for the H100's fp32 pipes,
// and the per-step gains a 64-row variant of it (gains.cu), with the same
// arithmetic per entry: one f32 fmaf chain over ascending features, the
// same float64 norms and `rt_entry_value`, so their entries equal this
// tile's bit for bit (stream_filter.cu and gains.cu keep a 64x64 build,
// rt_stream_slab64_kernel and rt_gains64_kernel, as their checks'
// yardsticks).
// 256 threads; each owns a 4x4 register micro-tile. The feature axis is
// walked in slices of 16: both operand slices are staged in shared
// memory (k-major, rows padded to 68 floats so the transposing stores do
// not pile onto one bank), and for 'dist' threads 0-63 / 64-127
// accumulate the squared norms of the tile's ground rows / candidate
// rows from the same staged slices. The norms accumulate in float64
// (each product exact, the sum as good as exact), so a norm is off by
// one f32 rounding; a sequential f32 sum over D = 12,288 features left
// the 'dist' entries ~4x less accurate (RMS, against a float64 build)
// than the plain torch build's on the H100. The norms cost D double FMAs
// per tile row against the tile's 64*D f32 FMAs per row. Rows, columns
// and features past N, C, D are masked.
//
// 'dot'  : <g, c>
// 'dist' : sqrt(max(|g|^2 + |c|^2 - 2<g, c>, 0))   (rules.pairwise_block)
//
// FOLD > 0 sums each dot product in two levels: the products of FOLD
// feature slices (16 features each) accumulate in f32 as above, and each
// such partial is then added into an outer f32 sum, so no sequential
// chain is longer than 16·FOLD (+ D / (16·FOLD)) terms. The stream filter
// builds its (N, B) slab so (here FOLD = 16, its yardstick; tile128.cuh's
// FOLD = 32 slices of 8 gives the same sums): against a plain torch.matmul
// that cuBLAS splits along D for its tall-skinny shape (16,384 x 12,288
// x 256), one f32 chain over D = 12,288 erred 2.4x more (RMS, from a
// float64 build) than the plain version on the H100. FOLD = 0 (the
// other kernels) keeps the single chain.
//
// The ground rows may be stored int8 with one f32 scale a row (the
// yardsticks of the per-step gains and the stream filter under an int8
// rung: rules.quantize_rows of the ground features). The tile stages its
// 64 rows' scales in shared memory and widens each entry as it is
// staged, by rt_entry's __fmul_rn(q, scale): the staged slice, and so
// every product and norm after it, is what the f32 tile reads from the
// dequantized ground (rules.dequant), bit for bit.
#pragma once

#include "rules.cuh"

#define RT_TILE 64
#define RT_TK 16
#define RT_TILE_LD (RT_TILE + 4)

struct RtTileSmem {
  float a[RT_TK][RT_TILE_LD];  // ground slice, feature-major
  float b[RT_TK][RT_TILE_LD];  // candidate slice, feature-major
  float gn[RT_TILE];
  float cn[RT_TILE];
  float gs[RT_TILE];           // int8 ground: the tile rows' scales
};

// A matrix entry from its accumulated dot product v and, for 'dist', the
// f32 squared norms of its ground row (gn) and candidate row (cn). 2*v is
// exact, so whether nvcc contracts the subtraction into an FMA does not
// change the result.
__device__ __forceinline__ float rt_entry_value(float gn, float cn, float v,
                                                int mode) {
  return mode == RT_MODE_DIST ? sqrtf(fmaxf(gn + cn - 2.f * v, 0.f)) : v;
}

// The entry of tile row i, tile column j from its accumulated dot product
// v (after rt_tile has filled s.gn / s.cn for 'dist').
__device__ __forceinline__ float rt_tile_entry(const RtTileSmem& s, float v,
                                              int i, int j, int mode) {
  return rt_entry_value(s.gn[i], s.cn[j], v, mode);
}

// G: (N, D) ground rows (f32, or int8 with `gscale` (N,) row scales),
// Cd: (C, D) candidate rows, row-major, of ONE greedy. (n0, c0): the
// tile's corner. Thread t owns tile rows 4*(t/16) + i and columns
// 4*(t%16) + j, i, j < 4, in acc[i][j]; after the accumulation `epi(acc)`
// runs on every thread (s.gn / s.cn hold the norms for 'dist'). Must be
// called by all 256 threads of the block.
template <int FOLD = 0, class TG, class Epilogue>
__device__ __forceinline__ void rt_tile(const TG* __restrict__ G,
                                        const float* __restrict__ gscale,
                                        const float* __restrict__ Cd, int N,
                                        int C, int D, int n0, int c0,
                                        int mode, RtTileSmem& s,
                                        Epilogue&& epi) {
  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  if constexpr (rt_scaled<TG>()) {
    if (t < RT_TILE) s.gs[t] = n0 + t < N ? gscale[n0 + t] : 0.f;
    __syncthreads();
  }
  float acc[4][4];
  float outer[4][4];  // FOLD > 0: the sum of the folded partials
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = outer[i][j] = 0.f;
  double nrm = 0.0;
  int slices = 0;

  for (int k0 = 0; k0 < D; k0 += RT_TK) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int idx = t + l * RT_THREADS;  // 0 .. 1023
      const int r = idx / RT_TK;
      const int kk = idx % RT_TK;
      const int gk = k0 + kk;
      const int gr = n0 + r;
      const int gc = c0 + r;
      s.a[kk][r] =
          (gr < N && gk < D) ? rt_entry(G, (size_t)gr * D + gk, s.gs[r]) : 0.f;
      s.b[kk][r] = (gc < C && gk < D) ? Cd[(size_t)gc * D + gk] : 0.f;
    }
    __syncthreads();
    if (mode == RT_MODE_DIST) {
      if (t < RT_TILE) {
#pragma unroll
        for (int kk = 0; kk < RT_TK; ++kk) {
          const double v = s.a[kk][t];
          nrm = fma(v, v, nrm);
        }
      } else if (t < 2 * RT_TILE) {
        const int u = t - RT_TILE;
#pragma unroll
        for (int kk = 0; kk < RT_TK; ++kk) {
          const double v = s.b[kk][u];
          nrm = fma(v, v, nrm);
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < RT_TK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&s.a[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&s.b[kk][tx * 4]);
      const float a[4] = {av.x, av.y, av.z, av.w};
      const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if constexpr (FOLD > 0) {
      if (++slices == FOLD) {
        slices = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            outer[i][j] += acc[i][j];
            acc[i][j] = 0.f;
          }
      }
    }
  }
  if constexpr (FOLD > 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += outer[i][j];
  }

  if (mode == RT_MODE_DIST) {
    if (t < RT_TILE)
      s.gn[t] = (float)nrm;
    else if (t < 2 * RT_TILE)
      s.cn[t - RT_TILE] = (float)nrm;
    __syncthreads();
  }
  epi(acc);
  __syncthreads();  // the block may reuse `s` for its next tile
}

// The f32 ground's tile (pairwise, the resident build, the f32 gains).
template <class Epilogue>
__device__ __forceinline__ void rt_tile(const float* __restrict__ G,
                                        const float* __restrict__ Cd, int N,
                                        int C, int D, int n0, int c0,
                                        int mode, RtTileSmem& s,
                                        Epilogue&& epi) {
  rt_tile<0>(G, (const float*)nullptr, Cd, N, C, D, n0, c0, mode, s, epi);
}

// An entry as stored: f32 as computed, bf16 rounded to nearest even
// (as torch.Tensor.to(torch.bfloat16) and XLA's convert round).
__device__ __forceinline__ void rt_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void rt_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The stored tile: out is the (N, C) row-major matrix of ONE greedy, f32
// or bf16 (the same entries, another store).
template <class T>
__device__ __noinline__ void rt_pairwise_tile(const float* __restrict__ G,
                                              const float* __restrict__ Cd,
                                              T* __restrict__ out, int N,
                                              int C, int D, int n0, int c0,
                                              int mode, RtTileSmem& s) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  rt_tile(G, Cd, N, C, D, n0, c0, mode, s, [&](float (&acc)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = n0 + ty * 4 + i;
      if (r >= N) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx * 4 + j;
        if (c >= C) continue;
        rt_store(out + (size_t)r * C + c,
                 rt_tile_entry(s, acc[i][j], ty * 4 + i, tx * 4 + j, mode));
      }
    }
  });
}
