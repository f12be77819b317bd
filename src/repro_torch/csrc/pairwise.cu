// Batched pairwise matrix: (B, N, D) x (B, C, D) -> (B, N, C), fp32 compute,
// stored as f32 or bf16.
//
// Replaces the Pallas kernel src/repro/kernels/pairwise.py:pairwise_pallas
// (_kernel): the cached ground x candidate matrix of a streaming-tier
// greedy ('dist' for kmedoid, 'dot' for the similarity rules), and the
// batched replay of S_prev at every accumulation level.
//
// What bounds it on the H100: operations. At the leaf shape of the
// Tiny-ImageNet configuration (32 leaves, N = C ~ 3,200, D = 12,288) it
// does 2*B*N*C*D ~ 8.6e12 flops against ~12 GB of compulsory traffic;
// the kernel must stay in fp32 (TF32 keeps ~3 digits, and the 'dist'
// expansion cancels heavily at D = 12,288), so the ceiling is the 67
// TFLOP/s of the non-tensor fp32 pipes, not the tensor cores.
//
// What the design does about it: a classic shared-memory GEMM tile
// (pairwise_tile.cuh). Each 256-thread block computes one 64x64 output
// tile with 4x4 register micro-tiles, so every staged operand value
// feeds 4 FMAs from registers and every shared-memory read is a 16-byte
// vector load. The norms for 'dist' are accumulated, in float64, from
// the same staged slices, so the expansion costs no extra pass over the
// features. Grid:
// (C/64, N/64, B) - one launch for all greedies of a level. No torch
// matmul, cdist, cuBLAS or tensor-core path is used.
//
// The bf16 output (pairwise_pallas with out_dtype bfloat16, the cache of
// the bf16 rung of the planner's storage ladder) is the same tile with a
// round-to-nearest-even store: half the bytes written, the same
// operations, so the bound barely moves.
#include "pairwise_tile.cuh"

template <class T>
__global__ void __launch_bounds__(RT_THREADS)
    rt_pairwise_kernel(const float* __restrict__ ground,
                       const float* __restrict__ cands, T* __restrict__ out,
                       int N, int C, int D, int mode) {
  __shared__ __align__(16) RtTileSmem s;
  const size_t b = blockIdx.z;
  rt_pairwise_tile(ground + b * N * D, cands + b * C * D, out + b * N * C, N,
                   C, D, blockIdx.y * RT_TILE, blockIdx.x * RT_TILE, mode, s);
}

// out: (B, N, C) f32 (storage RT_STORE_F32) or bf16 (RT_STORE_BF16).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int rt_pairwise(const float* ground, const float* cands, void* out,
                           int B, int N, int C, int D, int mode, int storage,
                           void* stream) {
  if (B == 0 || N == 0 || C == 0) return 0;
  dim3 grid((C + RT_TILE - 1) / RT_TILE, (N + RT_TILE - 1) / RT_TILE, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (storage == RT_STORE_F32)
    rt_pairwise_kernel<float><<<grid, RT_THREADS, 0, st>>>(
        ground, cands, (float*)out, N, C, D, mode);
  else if (storage == RT_STORE_BF16)
    rt_pairwise_kernel<__nv_bfloat16><<<grid, RT_THREADS, 0, st>>>(
        ground, cands, (__nv_bfloat16*)out, N, C, D, mode);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
