// The 128x128 fp32 tile (no TF32, no tensor cores) and the float64 row
// norms that go with it, shared by the pairwise kernel (pairwise.cu) and
// the stream filter's slab (stream_filter.cu).
//
// The tile. Each 256-thread block owns a 128x128 output tile; each thread
// an 8x8 micro-tile (rows ty*4 + {0..3, 64..67}, columns tx*4 + {0..3,
// 64..67}), so one feature step reads four 16-byte shared-memory vectors
// (two of them broadcast in the warp) for 64 FMAs. The feature axis is
// walked in slices of 8, staged k-major in a ring of two shared-memory
// stages (rows padded to 132 floats, so the transposing stores of the two
// loader halves fall on distinct banks) with ONE barrier a slice: while
// the block multiplies one stage, each thread's 16-byte global loads of
// the next slice are in flight in registers and land in the other stage
// after the multiply. A D that is not a multiple of 4 (or an operand not
// 16-byte aligned) takes scalar loads (template flag VEC); features, rows
// and columns past D, N and C are zeros or masked. 128 registers a
// thread, 2 blocks an SM.
//
// Every entry is one f32 fmaf chain over ascending features from 0, as
// the 64x64 tile (pairwise_tile.cuh) computes it, so the two tiles give
// the same bits. FOLD > 0 sums each dot product in two levels as the 64x64
// tile's FOLD does: the products of FOLD feature slices (8 features each
// here) accumulate in f32, and each such partial is added into an outer
// f32 sum, kept in shared memory (64 floats a thread would not fit the
// registers beside the accumulators; one read-modify-write an entry per
// partial against 8 * FOLD FMAs). The stream filter's slab folds every
// 256 features (FOLD = 32 here, 16 slices of 16 there), so its entries
// equal the 64x64 tile's with FOLD = 16 bit for bit.
//
// int8 ground rows (one f32 scale a row) are widened as they are staged,
// by rt_entry's __fmul_rn(q, scale): the staged slice, and so every
// product after it, is what the f32 tile reads from the dequantized
// ground (rules.dequant), bit for bit.
//
// The norms ('dist' only) are not computed by the tile: a pass before it
// (rt_row_norms_kernel) gives each row's float64 fma(v, v, nrm) chain in
// ascending feature order, cast once to f32 (for int8, of the widened
// entries): the chain the 64x64 tile runs inline, so its norms too.
#pragma once

#include "pairwise_tile.cuh"

#define RT_T128 128
#define RT_T128_TK 8
#define RT_T128_LD (RT_T128 + 4)
#define RT_NORM_ROWS RT_THREADS
#define RT_NORM_TK 32

struct RtTile128Smem {
  float a[2][RT_T128_TK][RT_T128_LD];  // ground slices
  float b[2][RT_T128_TK][RT_T128_LD];  // candidate slices
};

// Shared memory of the outer sums of a FOLD > 0 tile: 64 floats a thread.
#define RT_T128_OUTER_FLOATS (64 * RT_THREADS)

// Four consecutive features of one row, as f32: a 16-byte load of f32, a
// 4-byte load of int8 widened by the row's scale `sc`.
__device__ __forceinline__ void rt_load4(const float* p, float,
                                         float (&r)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
}
__device__ __forceinline__ void rt_load4(const int8_t* p, float sc,
                                         float (&r)[4]) {
  const char4 v = __ldg(reinterpret_cast<const char4*>(p));
  r[0] = __fmul_rn((float)v.x, sc), r[1] = __fmul_rn((float)v.y, sc);
  r[2] = __fmul_rn((float)v.z, sc), r[3] = __fmul_rn((float)v.w, sc);
}

// The float64 squared norm of each row of x (R, D), cast once to f32; an
// int8 x is widened by its row's scale (xscale, (R,)) first. Block: 256
// rows; each (256 x 32)-feature chunk is read coalesced (a warp reads one
// row's 32 features) into shared memory, then every thread extends its
// row's fma chain in ascending feature order.
template <class TG>
__global__ void __launch_bounds__(RT_THREADS)
    rt_row_norms_kernel(const TG* __restrict__ x,
                        const float* __restrict__ xscale,
                        float* __restrict__ nrm, long long R, int D) {
  __shared__ float s[RT_NORM_ROWS][RT_NORM_TK + 1];
  const int t = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * RT_NORM_ROWS;
  double acc = 0.0;
  for (int k0 = 0; k0 < D; k0 += RT_NORM_TK) {
#pragma unroll 8
    for (int i = 0; i < RT_NORM_TK; ++i) {
      const int e = t + RT_THREADS * i;
      const int rr = e / RT_NORM_TK, f = e % RT_NORM_TK;
      const long long r = r0 + rr;
      float sc = 0.f;
      if constexpr (rt_scaled<TG>()) sc = r < R ? xscale[r] : 0.f;
      s[rr][f] = (r < R && k0 + f < D) ? rt_entry(x, r * D + k0 + f, sc)
                                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int f = 0; f < RT_NORM_TK; ++f) {
      const double v = s[t][f];
      acc = fma(v, v, acc);
    }
    __syncthreads();
  }
  if (r0 + t < R) nrm[r0 + t] = (float)acc;
}

// The same norms for a few rows (fewer than a block for every SM in the
// staged kernel: a batch's arrivals). A row's chain is 12,288 dependent
// float64 FMAs at the streams' D, so a warp takes a row: its 32 lanes
// load the next 512 features coalesced (16-byte loads) while lane 0 runs
// the chain over the current 512 from shared memory (the same chain, so
// the same bits). 8 warps, 8 rows, a block.
#define RT_NORM_FEW_TK 512
template <class TG, bool VEC>
__global__ void __launch_bounds__(RT_THREADS)
    rt_row_norms_few_kernel(const TG* __restrict__ x,
                            const float* __restrict__ xscale,
                            float* __restrict__ nrm, long long R, int D) {
  __shared__ __align__(16) float s[RT_THREADS / 32][2][RT_NORM_FEW_TK];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long r = (long long)blockIdx.x * (RT_THREADS / 32) + warp;
  if (r >= R) return;  // whole warps leave together
  const TG* row = x + r * D;
  float sc = 0.f;
  if constexpr (rt_scaled<TG>()) sc = xscale[r];
  constexpr int PER = RT_NORM_FEW_TK / 32;  // features a lane a chunk
  float v[PER];
  // lane l holds features k0 + 4 (l + 32 q) + e of a chunk
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < PER / 4; ++q) {
      const int f = k0 + 4 * (lane + 32 * q);
      if (VEC && f + 3 < D) {
        float w[4];
        rt_load4(row + f, sc, w);
        v[4 * q] = w[0], v[4 * q + 1] = w[1], v[4 * q + 2] = w[2],
                  v[4 * q + 3] = w[3];
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[4 * q + e] = f + e < D ? rt_entry(row, (size_t)(f + e), sc) : 0.f;
      }
    }
  };
  auto stage = [&](int st) {
#pragma unroll
    for (int q = 0; q < PER / 4; ++q)
      *reinterpret_cast<float4*>(&s[warp][st][4 * (lane + 32 * q)]) =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  };
  double acc = 0.0;
  load(0);
  stage(0);
  __syncwarp();
  int st = 0;
  for (int k0 = 0; k0 < D; k0 += RT_NORM_FEW_TK) {
    const bool more = k0 + RT_NORM_FEW_TK < D;
    if (more) load(k0 + RT_NORM_FEW_TK);  // in flight during the chain
    if (lane == 0) {
      const int n = min(RT_NORM_FEW_TK, D - k0);
      const float* c = s[warp][st];
#pragma unroll 8
      for (int f = 0; f < n; ++f) {
        const double d = c[f];
        acc = fma(d, d, acc);
      }
    }
    __syncwarp();
    if (more) stage(st ^ 1);
    __syncwarp();
    st ^= 1;
  }
  if (lane == 0) nrm[r] = (float)acc;
}

// The norm pass over R rows of x on stream st; returns the launch error.
template <class TG>
static cudaError_t rt_norms(const TG* x, const float* xscale, float* nrm,
                            long long R, int D, cudaStream_t st) {
  if (R == 0) return cudaSuccess;
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (R < (long long)sms * RT_NORM_ROWS) {
    const unsigned blocks = (unsigned)((R + 7) / 8);
    const size_t align = rt_scaled<TG>() ? 4 : 16;
    if (D % 4 == 0 && (uintptr_t)x % align == 0)
      rt_row_norms_few_kernel<TG, true>
          <<<blocks, RT_THREADS, 0, st>>>(x, xscale, nrm, R, D);
    else
      rt_row_norms_few_kernel<TG, false>
          <<<blocks, RT_THREADS, 0, st>>>(x, xscale, nrm, R, D);
    return cudaGetLastError();
  }
  const long long blocks = (R + RT_NORM_ROWS - 1) / RT_NORM_ROWS;
  rt_row_norms_kernel<TG>
      <<<(unsigned)blocks, RT_THREADS, 0, st>>>(x, xscale, nrm, R, D);
  return cudaGetLastError();
}

// G: (N, D) ground rows (f32, or int8 with `gscale` (N,) row scales), Cd:
// (C, D) candidate rows, row-major, of ONE product. (n0, c0): the tile's
// corner. Thread t = 16 ty + tx owns rows (i >> 2) * 64 + ty * 4 + (i & 3)
// and columns (j >> 2) * 64 + tx * 4 + (j & 3) in acc[i][j]; after the
// accumulation `epi(acc)` runs on every thread. `outer`: FOLD > 0's
// RT_T128_OUTER_FLOATS of shared memory (null otherwise), free for the
// epilogue's own use. VEC: D % 4 == 0 and 16-byte (int8: 4-byte) aligned
// operands. Must be called by all 256 threads of the block.
template <class TG, bool VEC, int FOLD, class Epilogue>
__device__ __forceinline__ void rt_tile128(
    const TG* __restrict__ G, const float* __restrict__ gscale,
    const float* __restrict__ Cd, int N, int C, int D, int n0, int c0,
    RtTile128Smem& s, float* outer, Epilogue&& epi) {
  const int t = threadIdx.x;

  // loader: thread t stages features lk .. lk + 3 of tile row lr of both
  // operands (a warp reads 16 rows x 32 bytes of each)
  const int lr = t >> 1;
  const int lk = (t & 1) * 4;
  const bool gin = n0 + lr < N;
  const bool cin = c0 + lr < C;
  const TG* gp = G + (size_t)(gin ? n0 + lr : 0) * D + lk;
  const float* cp = Cd + (size_t)(cin ? c0 + lr : 0) * D + lk;
  float gsc = 0.f;
  if constexpr (rt_scaled<TG>()) gsc = gin ? gscale[n0 + lr] : 0.f;
  float ra[4], rb[4];
  auto load = [&](int k0) {
    if constexpr (VEC) {
      // D % 4 == 0: the 4 features are all in or all out
      const bool kin = k0 + lk < D;
      if (gin && kin) {
        rt_load4(gp + k0, gsc, ra);
      } else {
        ra[0] = ra[1] = ra[2] = ra[3] = 0.f;
      }
      if (cin && kin) {
        rt_load4(cp + k0, 0.f, rb);
      } else {
        rb[0] = rb[1] = rb[2] = rb[3] = 0.f;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool kin = k0 + lk + q < D;
        ra[q] = gin && kin ? rt_entry(gp, (size_t)(k0 + q), gsc) : 0.f;
        rb[q] = cin && kin ? __ldg(cp + k0 + q) : 0.f;
      }
    }
  };
  auto stage = [&](int st) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s.a[st][lk + q][lr] = ra[q];
      s.b[st][lk + q][lr] = rb[q];
    }
  };

  const int tx = t & 15;
  const int ty = t >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if constexpr (FOLD > 0) {
#pragma unroll
    for (int e = 0; e < 64; ++e) outer[e * RT_THREADS + t] = 0.f;
  }
  int slices = 0;

  load(0);
  stage(0);
  __syncthreads();
  int st = 0;
  for (int k0 = 0; k0 < D; k0 += RT_T128_TK) {
    const bool more = k0 + RT_T128_TK < D;
    if (more) load(k0 + RT_T128_TK);  // in flight during the multiply
#pragma unroll
    for (int kk = 0; kk < RT_T128_TK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s.a[st][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&s.a[st][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&s.b[st][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&s.b[st][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    if (more) stage(st ^ 1);
    if constexpr (FOLD > 0) {
      if (++slices == FOLD) {
        slices = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float& o = outer[(i * 8 + j) * RT_THREADS + t];
            o += acc[i][j];
            acc[i][j] = 0.f;
          }
      }
    }
    // one barrier a slice: the other stage is written, and every thread
    // is done reading this one before the next slice overwrites it
    __syncthreads();
    st ^= 1;
  }
  if constexpr (FOLD > 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i][j] += outer[(i * 8 + j) * RT_THREADS + t];
    __syncthreads();  // the epilogue may reuse `outer`
  }
  epi(acc);
}
