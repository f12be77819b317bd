// The span pass of the per-step fused kernel (fused_step.cu): one block's
// chunk partials over one 128-column span of a cached (N, C) matrix, read
// in 16-byte loads. The whole-greedy loops (greedy_loop.cu,
// greedy_loop_resident.cu) sum the same parts in the same order with
// their own loads, and share its int8 widening (rt_widen_bytes).
//
// A block holds the state rows of nq consecutive chunks of CH ground rows
// in shared memory. Its lanes take the span in 16-byte vectors, a lane a
// vector a row: 4 f32, 8 bf16 or 16 int8 entries, so LR = 32, 16 or 8
// lanes cover a row's 512, 256 or 128 contiguous bytes. Each group of LR
// lanes takes one chunk at a time, RT_FUSED_U = 4 rows' loads at once; a
// lane sums its entries' gain parts over the chunk's rows in f32, in row
// order, and hands the chunk's partials to the caller's sink. The loads
// in flight come from occupancy: 64 registers a thread leave room for 4
// blocks (32 warps) an SM, which beat 2 or 3 blocks with 8 or 16 rows at
// once, or with the next rows' loads issued ahead, at the knapsack leaf
// (PERF.md §6). When C is not a multiple of the vector the rows start
// off the 16-byte grid: a lane then loads the aligned vector under its
// columns and takes the entries it lacks from its neighbour's by warp
// shuffles (RT_ROWS_SHIFT; the knapsack leaves' C = 3,125 is such). A
// matrix whose base is off the grid takes scalar loads
// (RT_ROWS_SCALAR).
//
// bf16 and int8 storage: each vector is widened to the f32 values
// rules.dequant gives (bf16 exactly; int8 by one __fmul_rn of the byte's
// exact integer value - a byte permute and one f32 subtraction, not a
// conversion instruction a byte - by its row's scale), then the f32
// algebra, so a variant equals the f32 pass on the dequantized cache bit
// for bit.
#pragma once

#include "rules.cuh"

#define RT_FUSED_SPAN 128  // columns a span: LR lanes x one 16-byte vector
// rows a lane group loads at once, and the blocks an SM the registers
// leave room for (64 registers a thread): chosen at the knapsack leaf
// over 2-8 rows and 2-4 blocks (PERF.md §6)
#define RT_FUSED_U 4
#define RT_FUSED_MINB 4

// how a block reads its rows
#define RT_ROWS_SCALAR 0   // the matrix base off the 16-byte grid
#define RT_ROWS_SHIFT 1    // C % VW != 0: aligned vectors shuffled into place
#define RT_ROWS_ALIGNED 2  // every row on the 16-byte grid

template <class S>
struct RtFusedVec {
  static constexpr int VW = 16 / (int)sizeof(S);  // entries a vector
  static constexpr int LR = RT_FUSED_SPAN / VW;   // lanes a row
};

// A vector's VW entries as f32, rules.dequant's values. int8: the byte's
// integer value exactly (the f32 2^23 + (q + 128), less 2^23 + 128),
// times the row's scale once (__fmul_rn, as rt_entry).
__device__ __forceinline__ void rt_widen(const uint4& w, float,
                                         float (&e)[4]) {
  e[0] = __uint_as_float(w.x), e[1] = __uint_as_float(w.y);
  e[2] = __uint_as_float(w.z), e[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void rt_widen(const uint4& w, float,
                                         float (&e)[8]) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    e[2 * k] = __uint_as_float(u[k] << 16);
    e[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
  }
}
// The four bytes of u (already XOR 0x80808080) as rules.dequant's f32
// values at scale s.
__device__ __forceinline__ void rt_widen_bytes(unsigned u, float s,
                                               float* e) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float q = __fsub_rn(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | (unsigned)k)),
        8388736.0f);
    e[k] = __fmul_rn(q, s);
  }
}
__device__ __forceinline__ void rt_widen(const uint4& w, float s,
                                         float (&e)[16]) {
  rt_widen_bytes(w.x ^ 0x80808080u, s, e);
  rt_widen_bytes(w.y ^ 0x80808080u, s, e + 4);
  rt_widen_bytes(w.z ^ 0x80808080u, s, e + 8);
  rt_widen_bytes(w.w ^ 0x80808080u, s, e + 12);
}

// Four consecutive entries as one load: 16, 8 or 4 bytes (f32, bf16,
// int8; the whole-greedy loops' vectors), and as f32 (rules.dequant's
// values, an int8 vector at its row's scale s).
template <class S>
struct RtRaw4;
template <>
struct RtRaw4<float> {
  using T = float4;
};
template <>
struct RtRaw4<__nv_bfloat16> {
  using T = uint2;
};
template <>
struct RtRaw4<int8_t> {
  using T = unsigned;
};
__device__ __forceinline__ void rt_widen4(const float4& v, float,
                                          float (&e)[4]) {
  e[0] = v.x, e[1] = v.y, e[2] = v.z, e[3] = v.w;
}
__device__ __forceinline__ void rt_widen4(const uint2& v, float,
                                          float (&e)[4]) {
  e[0] = __uint_as_float(v.x << 16), e[1] = __uint_as_float(v.x & 0xffff0000u);
  e[2] = __uint_as_float(v.y << 16), e[3] = __uint_as_float(v.y & 0xffff0000u);
}
__device__ __forceinline__ void rt_widen4(unsigned v, float s,
                                          float (&e)[4]) {
  rt_widen_bytes(v ^ 0x80808080u, s, e);
}

// The 16 bytes at byte offset ob (0..15) of the 32 bytes a:b (BYTES:
// offsets that are not whole 32-bit words occur).
template <bool BYTES>
__device__ __forceinline__ uint4 rt_realign(const uint4& a, const uint4& b,
                                            int ob) {
  unsigned u[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int qw = ob >> 2;
  if (qw & 2) {
#pragma unroll
    for (int k = 0; k < 6; ++k) u[k] = u[k + 2];
  }
  if (qw & 1) {
#pragma unroll
    for (int k = 0; k < 5; ++k) u[k] = u[k + 1];
  }
  if constexpr (!BYTES) {
    return make_uint4(u[0], u[1], u[2], u[3]);
  } else {
    const unsigned sh = (unsigned)(ob & 3) * 8u;
    return make_uint4(__funnelshift_r(u[0], u[1], sh),
                      __funnelshift_r(u[1], u[2], sh),
                      __funnelshift_r(u[2], u[3], sh),
                      __funnelshift_r(u[3], u[4], sh));
  }
}

// Lane l + 1's vector, within groups of `width` lanes.
__device__ __forceinline__ uint4 rt_shfl_down(const uint4& v, int width) {
  return make_uint4(__shfl_down_sync(0xffffffffu, v.x, 1, width),
                    __shfl_down_sync(0xffffffffu, v.y, 1, width),
                    __shfl_down_sync(0xffffffffu, v.z, 1, width),
                    __shfl_down_sync(0xffffffffu, v.w, 1, width));
}

// The pass over span columns cs .. cs + 127 of one greedy's matrix (its
// first entry at e_greedy; the row stride C), for the block's nq chunks
// of CH rows from ground row r0 (nr rows in all; their states `rows` and
// int8 scales `scl` in shared memory, block-local indices). For each
// chunk j < nq, every lane of the chunk's lane group calls
// sink(j, lane, acc) once with acc[v] the chunk's partial gain of column
// cs + lane * VW + v (columns past C hold no meaning). Must be called by
// all RT_THREADS threads of the block: every lane of a warp runs the same
// trip counts (the shuffles).
template <class S, int PATH, class Sink>
__device__ __forceinline__ void rt_span_pass(
    const S* __restrict__ mat, size_t e_greedy, int C, int cs, int r0,
    int nr, int nq, int CH, const float* rows, const float* scl,
    RtRule rule, Sink&& sink) {
  constexpr int VW = RtFusedVec<S>::VW;
  constexpr int LR = RtFusedVec<S>::LR;
  constexpr int U = RT_FUSED_U;
  const int tid = threadIdx.x;
  const int lane = tid % LR;
  const int grp = tid / LR;
  const int G = blockDim.x / LR;
  const int rounds = (nq + G - 1) / G;
  for (int t = 0; t < rounds; ++t) {
    const int j = grp + t * G;
    const bool live = j < nq;
    const int i0 = j * CH;
    const int ni = live ? min(CH, nr - i0) : 0;
    // the chunk's first entry: row i0 of the block, the span's column 0
    const size_t e0 = e_greedy + (size_t)(r0 + (live ? i0 : 0)) * C + cs;
    float acc[VW];
#pragma unroll
    for (int v = 0; v < VW; ++v) acc[v] = 0.f;
    for (int u0 = 0; u0 < CH; u0 += U) {
      uint4 raw[U];
      int ob[U];  // the row's byte offset from the 16-byte grid (SHIFT)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
        ob[u] = 0;
        const int i = u0 + u;
        if (i >= ni) continue;
        const size_t e_row = e0 + (size_t)i * C;  // row i, column cs
        const size_t e_end = e_row - cs + C;      // the row's end
        if constexpr (PATH == RT_ROWS_ALIGNED) {
          const size_t a = e_row + lane * VW;
          if (a < e_end)
            raw[u] = __ldg(reinterpret_cast<const uint4*>(mat + a));
        } else if constexpr (PATH == RT_ROWS_SHIFT) {
          const int off = (int)(e_row % VW);
          ob[u] = off * (int)sizeof(S);
          // the vector on the 16-byte grid under the lane's columns
          const size_t a = e_row + lane * VW - off;
          if (a < e_end)
            raw[u] = __ldg(reinterpret_cast<const uint4*>(mat + a));
        }
      }
      if constexpr (PATH == RT_ROWS_SHIFT) {
        // the entries past a lane's vector: its neighbour's, or for the
        // last lane of a row the vector past the span
#pragma unroll
        for (int u = 0; u < U; ++u) {
          uint4 nx = rt_shfl_down(raw[u], LR);
          const int i = u0 + u;
          if (lane == LR - 1 && i < ni && ob[u] != 0) {
            const size_t e_row = e0 + (size_t)i * C;
            const size_t a = e_row + LR * VW - ob[u] / (int)sizeof(S);
            nx = a < e_row - cs + C
                     ? __ldg(reinterpret_cast<const uint4*>(mat + a))
                     : make_uint4(0u, 0u, 0u, 0u);
          }
          raw[u] = rt_realign<(sizeof(S) < 4)>(raw[u], nx, ob[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = u0 + u;
        if (i >= ni) continue;
        const int li = i0 + i;
        const float sc = rt_scaled<S>() ? scl[li] : 1.f;
        float e[VW];
        if constexpr (PATH == RT_ROWS_SCALAR) {
          const size_t e_row = e0 + (size_t)i * C;
#pragma unroll
          for (int v = 0; v < VW; ++v)
            e[v] = cs + lane * VW + v < C
                       ? rt_entry(mat, e_row + lane * VW + v, sc)
                       : 0.f;
        } else {
          rt_widen(raw[u], sc, e);
        }
        const float r = rows[li];
#pragma unroll
        for (int v = 0; v < VW; ++v) acc[v] += rt_gain_part(r, e[v], rule);
      }
    }
    if (live) sink(j, lane, acc);
  }
}
