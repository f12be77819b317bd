// Selection algebra of the kernels: the device twin of
// repro_torch/kernels/rules.py (gain_part, fold_cols, masked_argmax).
//
// Feature rules, on one f32 entry at a time: the folds 'min' (kmedoid),
// 'max' (facility), 'satsum' (satcover) and 'sum' (graphcut, mmr).
// The bitmap rule (coverage), on 32-bit words: fold r | m, part
// popc(m & ~r). Its matrix is the transpose of the candidates' words, so
// its kernels read candidate-major (C, W) words and give each candidate
// to one warp (rt_warp_bits_gain); gains are exact integer sums.
//
// A feature rule's cached matrix is stored as f32, bf16 or int8 with a
// per-row f32 scale (kernels/rules.py:quantize_rows); rt_entry reads one
// entry of any of them as the f32 value rules.dequant gives, so one
// kernel template serves the three storages with the same arithmetic.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#define RT_FOLD_MIN 0
#define RT_FOLD_MAX 1
#define RT_FOLD_SATSUM 2
#define RT_FOLD_SUM 3

#define RT_MODE_DOT 0
#define RT_MODE_DIST 1

#define RT_THREADS 256
#define RT_NO_INDEX (1 << 30)

// pad sentinel of the facility/sum rows (rules.BIG)
#define RT_BIG 3.0e38f

// every library of the port exports its CUDA error strings for the wrappers
extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// lam1 = 1 - lam, rounded to f32 on the host from the double difference,
// as PyTorch rounds the scalar of `(1.0 - lam) * sat` in the plain version
struct RtRule {
  int fold;
  float cap;
  float lam;
  float lam1;
};

// part(r, m): one ground row's contribution to a candidate's gain
__device__ __forceinline__ float rt_gain_part(float r, float m, RtRule rule) {
  switch (rule.fold) {
    case RT_FOLD_MIN:
      return fmaxf(r - m, 0.f);
    case RT_FOLD_MAX:
      return fmaxf(m - r, 0.f);
    case RT_FOLD_SATSUM:
      return fminf(fmaxf(m, 0.f), rule.cap - r);
    default: {  // RT_FOLD_SUM: increment of lam*(r ^ BIG) + (1-lam)*h(r ^ cap)
      // every product rounds on its own (__fmul_rn is never fused into an
      // FMA): t1^2 - t0^2 cancels, and a fused product would round it
      // differently from the plain version's separate operations
      float inc = fmaxf(m, 0.f);
      float mod = fminf(r + inc, RT_BIG) - fminf(r, RT_BIG);
      float t0 = fminf(r, rule.cap);
      float t1 = fminf(r + inc, rule.cap);
      float sq = __fsub_rn(__fmul_rn(t1, t1), __fmul_rn(t0, t0));
      float sat = (t1 - t0) - sq / (2.f * rule.cap);
      return __fadd_rn(__fmul_rn(rule.lam, mod), __fmul_rn(rule.lam1, sat));
    }
  }
}

// Entry i of a cached matrix in its storage, as f32; `s` is the entry's
// row scale (read for int8 only). bf16 -> f32 is exact. The int8 product
// is __fmul_rn: nvcc would otherwise contract q*s into an FMA with the
// sum or difference it feeds (-fmad=true), which rounds otherwise than
// rules.dequant's one f32 multiply.
__device__ __forceinline__ float rt_entry(const float* m, size_t i, float) {
  return m[i];
}
__device__ __forceinline__ float rt_entry(const __nv_bfloat16* m, size_t i,
                                          float) {
  return __bfloat162float(m[i]);
}
__device__ __forceinline__ float rt_entry(const int8_t* m, size_t i,
                                          float s) {
  return __fmul_rn((float)m[i], s);
}

// whether storage T carries a per-row scale
template <class T>
__host__ __device__ constexpr bool rt_scaled() {
  return std::is_same<T, int8_t>::value;
}

// storage codes of the C entry points (kernels/pairwise.py:STORAGES)
#define RT_STORE_F32 0
#define RT_STORE_BF16 1
#define RT_STORE_INT8 2

// the state-row fold: absorb an accepted element's matrix entry
__device__ __forceinline__ float rt_fold(float r, float m, RtRule rule) {
  switch (rule.fold) {
    case RT_FOLD_MIN:
      return fminf(r, m);
    case RT_FOLD_MAX:
      return fmaxf(r, m);
    case RT_FOLD_SATSUM:
      return fminf(r + fmaxf(m, 0.f), rule.cap);
    default:
      return r + fmaxf(m, 0.f);
  }
}

__device__ __forceinline__ bool rt_finite(float v) {
  return v > -INFINITY && v < INFINITY;
}

// first-max order: the larger gain wins; on equal gains the smaller column
__device__ __forceinline__ void rt_argmax_pair(float& v, int& i, float v2,
                                               int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// Bitmap rule: the state row's fold and one word's gain part
__device__ __forceinline__ unsigned rt_bits_fold(unsigned r, unsigned m) {
  return r | m;
}

__device__ __forceinline__ int rt_bits_part(unsigned r, unsigned m) {
  return __popc(m & ~r);
}

// One warp: candidate `cand`'s gain against the covered words `row`
// (W words each), the exact integer sum of popc(cand & ~row), returned
// to every lane. Lanes read consecutive words (coalesced), four loads in
// flight per lane.
__device__ __forceinline__ int rt_warp_bits_gain(
    const unsigned* __restrict__ cand, const unsigned* row, int W) {
  const int lane = threadIdx.x & 31;
  int s = 0;
  int w = lane;
  for (; w + 96 < W; w += 128) {
    const unsigned m0 = cand[w], m1 = cand[w + 32], m2 = cand[w + 64],
                   m3 = cand[w + 96];
    s += rt_bits_part(row[w], m0) + rt_bits_part(row[w + 32], m1) +
         rt_bits_part(row[w + 64], m2) + rt_bits_part(row[w + 96], m3);
  }
  for (; w < W; w += 32) s += rt_bits_part(row[w], cand[w]);
  return __reduce_add_sync(0xffffffffu, s);
}

// Block-wide first-max reduction of (v, i); every thread gets the result.
// sv/si hold one entry per warp (32 is enough for any block size).
__device__ __forceinline__ void rt_block_argmax(float& v, int& i, float* sv,
                                                int* si) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    float v2 = __shfl_down_sync(0xffffffffu, v, off);
    int i2 = __shfl_down_sync(0xffffffffu, i, off);
    rt_argmax_pair(v, i, v2, i2);
  }
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    v = lane < nw ? sv[lane] : -INFINITY;
    i = lane < nw ? si[lane] : RT_NO_INDEX;
    for (int off = 16; off > 0; off >>= 1) {
      float v2 = __shfl_down_sync(0xffffffffu, v, off);
      int i2 = __shfl_down_sync(0xffffffffu, i, off);
      rt_argmax_pair(v, i, v2, i2);
    }
    if (lane == 0) {
      sv[0] = v;
      si[0] = i;
    }
  }
  __syncthreads();
  v = sv[0];
  i = si[0];
  __syncthreads();
}
