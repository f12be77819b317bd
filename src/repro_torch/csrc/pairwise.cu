// Batched pairwise matrix: (B, N, D) x (B, C, D) -> (B, N, C), fp32 compute,
// stored as f32 or bf16.
//
// Replaces the Pallas kernel src/repro/kernels/pairwise.py:pairwise_pallas
// (_kernel): the cached ground x candidate matrix of a streaming-tier
// greedy ('dist' for kmedoid, 'dot' for the similarity rules), and the
// batched replay of S_prev at every accumulation level.
//
// What bounds it on the H100: operations. At the leaf shape of the
// Tiny-ImageNet configuration (32 leaves, N = C ~ 3,300, D = 12,288) it
// does 2*B*N*C*D ~ 8.5e12 flops against ~12 GB of compulsory traffic;
// the kernel must stay in fp32 (TF32 keeps ~3 digits, and the 'dist'
// expansion cancels heavily at D = 12,288), so the ceiling is the 67
// TFLOP/s of the non-tensor fp32 pipes, not the tensor cores.
//
// What the design does about it: a register-blocked fp32 GEMM tile that
// keeps the FMA pipes fed, tile128.cuh's 128x128 tile (8x8 a thread,
// 8-feature slices in a two-stage shared-memory ring, 16-byte global
// loads prefetched in registers, scalar loads when D % 4 != 0); this
// file adds its epilogue, which stores 4 columns a store. Grid (C/128,
// N/128, B): one launch for all greedies of a level.
//
// The 'dist' norms are computed once, before the product, by the tile's
// norm pass (tile128.cuh: rt_row_norms_kernel): one float64 fma(v, v,
// nrm) chain a row in ascending feature order, cast once to f32, over the
// B*(N + C) rows (B*N when ground and candidates are one tensor). The
// product's epilogue reads them; no tile recomputes them.
//
// Every entry is computed as the 64x64 tile computes it (pairwise_tile.cuh:
// rt_tile): one f32 fmaf chain over ascending features from 0 (no split
// of D), the same float64 norms, and rt_entry_value, stored f32 or
// rounded to nearest even for bf16. So this kernel equals the entries of
// the 64x64-tile kernel it replaced, and the resident kernel's build
// (greedy_loop_resident.cu), bit for bit.
//
// No torch matmul, cdist, cuBLAS or tensor-core path is used.
//
// The bf16 output (pairwise_pallas with out_dtype bfloat16, the cache of
// the bf16 rung of the planner's storage ladder) is the same tile with a
// round-to-nearest-even store: half the bytes written, the same
// operations, so the bound barely moves.
#include <stdint.h>

#include "tile128.cuh"

#define PW_TILE RT_T128

// Four entries of one output row, columns c .. c + 3, as stored.
__device__ __forceinline__ void rt_store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void rt_store4(__nv_bfloat16* p,
                                          const float (&v)[4]) {
  __nv_bfloat162 lo, hi;
  lo.x = __float2bfloat16_rn(v[0]);
  lo.y = __float2bfloat16_rn(v[1]);
  hi.x = __float2bfloat16_rn(v[2]);
  hi.y = __float2bfloat16_rn(v[3]);
  uint2 w;
  w.x = *reinterpret_cast<unsigned*>(&lo);
  w.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = w;
}

// gnorm (B, N) / cnorm (B, C): the f32 squared norms ('dist' only).
template <class T, bool VEC>
__global__ void __launch_bounds__(RT_THREADS, 2)
    rt_pairwise_kernel(const float* __restrict__ ground,
                       const float* __restrict__ cands,
                       const float* __restrict__ gnorm,
                       const float* __restrict__ cnorm, T* __restrict__ out,
                       int N, int C, int D, int mode) {
  __shared__ __align__(16) RtTile128Smem ts;
  const int t = threadIdx.x;
  const int tx = t & 15;
  const int ty = t >> 4;
  const size_t b = blockIdx.z;
  const int n0 = blockIdx.y * PW_TILE;
  const int c0 = blockIdx.x * PW_TILE;
  rt_tile128<float, VEC, 0>(
      ground + b * N * (size_t)D, (const float*)nullptr,
      cands + b * C * (size_t)D, N, C, D, n0, c0, ts, nullptr,
      [&](float (&acc)[8][8]) {
        // entries as rt_tile_entry gives them, 4 columns a store
        const bool dist = mode == RT_MODE_DIST;
        const bool vout = (C & 3) == 0;
        float cn[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = c0 + (j >> 2) * 64 + tx * 4 + (j & 3);
          cn[j] = dist && c < C ? cnorm[b * C + c] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = n0 + (i >> 2) * 64 + ty * 4 + (i & 3);
          if (r >= N) continue;
          const float gn = dist ? gnorm[b * N + r] : 0.f;
          T* orow = out + (b * N + r) * (size_t)C;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = c0 + h * 64 + tx * 4;
            float v[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              v[q] = rt_entry_value(gn, cn[h * 4 + q], acc[i][h * 4 + q],
                                    mode);
            if (vout && c + 3 < C) {
              rt_store4(orow + c, v);
            } else {
#pragma unroll
              for (int q = 0; q < 4; ++q)
                if (c + q < C) rt_store(orow + c + q, v[q]);
            }
          }
        }
      });
}

template <class T>
static void rt_pairwise_launch(const float* ground, const float* cands,
                               const float* gnorm, const float* cnorm, T* out,
                               int B, int N, int C, int D, int mode, bool vec,
                               cudaStream_t st) {
  dim3 grid((C + PW_TILE - 1) / PW_TILE, (N + PW_TILE - 1) / PW_TILE, B);
  if (vec)
    rt_pairwise_kernel<T, true>
        <<<grid, RT_THREADS, 0, st>>>(ground, cands, gnorm, cnorm, out, N, C,
                                      D, mode);
  else
    rt_pairwise_kernel<T, false>
        <<<grid, RT_THREADS, 0, st>>>(ground, cands, gnorm, cnorm, out, N, C,
                                      D, mode);
}

// out: (B, N, C) f32 (storage RT_STORE_F32) or bf16 (RT_STORE_BF16).
// norms: (B*N + B*C) f32 scratch for 'dist' (null for 'dot'); when ground
// and cands are the same tensor (N == C) only its first B*N are written.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int rt_pairwise(const float* ground, const float* cands, void* out,
                           float* norms, int B, int N, int C, int D, int mode,
                           int storage, void* stream) {
  if (B == 0 || N == 0 || C == 0) return 0;
  if (storage != RT_STORE_F32 && storage != RT_STORE_BF16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* gnorm = nullptr;
  const float* cnorm = nullptr;
  if (mode == RT_MODE_DIST) {
    if (norms == nullptr) return (int)cudaErrorInvalidValue;
    cudaError_t e = rt_norms(ground, (const float*)nullptr, norms,
                             (long long)B * N, D, st);
    if (e != cudaSuccess) return (int)e;
    gnorm = norms;
    if (cands == ground && C == N) {
      cnorm = norms;
    } else {
      e = rt_norms(cands, (const float*)nullptr, norms + (size_t)B * N,
                   (long long)B * C, D, st);
      if (e != cudaSuccess) return (int)e;
      cnorm = norms + (size_t)B * N;
    }
  }
  const bool vec = D % 4 == 0 && (uintptr_t)ground % 16 == 0 &&
                   (uintptr_t)cands % 16 == 0;
  if (storage == RT_STORE_F32)
    rt_pairwise_launch(ground, cands, gnorm, cnorm, (float*)out, B, N, C, D,
                       mode, vec, st);
  else
    rt_pairwise_launch(ground, cands, gnorm, cnorm, (__nv_bfloat16*)out, B,
                       N, C, D, mode, vec, st);
  return (int)cudaGetLastError();
}
