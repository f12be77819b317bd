// Resident whole-greedy loop: build every node's matrix and run all k
// steps of every node of a level in ONE launch.
//
// Replaces the Pallas kernel
// src/repro/kernels/greedy_loop.py:greedy_loop_resident_pallas
// (_resident_kernel), the accumulation-node greedy of the main path.
// Inputs: ground (B, N, D) and candidate (B, C, D) features, state rows
// (B, N), masks (B, C) and ctl (B, 3) int32 = [kq, logical_n, logical_c].
// Steps s >= kq freeze (bests -1, gains 0), as in the reference; the
// logical extents bound the sub-f32 rounding (below).
//
// What bounds it on the H100: operations, in the build. At a level-1
// node of the Tiny-ImageNet configuration (16 nodes, N = C = 400,
// D = 12,288) the build is 2*B*N*C*D ~ 6.3e10 fp32 flops while the k
// steps add ~3*k*B*N*C ~ 1.5e9 flops over matrices that sit in L2.
//
// What the design does about it: a TPU core held the whole node in VMEM;
// a 400x400 f32 matrix (640 KB) does not fit one block's 227 KB of
// shared memory. So the launch is cooperative and has two phases. Phase
// 1 spreads the B*(N/64)*(C/64) matrix tiles over every block on the
// card (pairwise_tile.cuh's fp32 tile; the pairwise kernel computes
// every entry with the same arithmetic, so the entries are the pairwise
// kernel's bit for bit) and writes them to a wrapper-allocated
// scratch of B*N*C floats, which the planner admits only when it fits
// the L2 share (10 MB at level 1). One grid barrier later, phase 2 gives
// each node one block that keeps the node's whole state row and mask in
// shared memory and runs the k steps over its L2-resident matrix: fold
// the previous winner, one thread per column sums the gain parts over
// all N rows in row order, block-wide masked first-argmax, accept if the
// gain is finite and > 0. A final fold flushes the last winner.
//
// Under a bf16 or int8 cache plan (the rounding branch of
// _resident_kernel) a rounding phase runs between the two, behind one
// more grid barrier: each warp takes whole matrix rows, zeroes entries
// outside the node's logical extents ctl[1], ctl[2], and rounds the rest
// in place as the HBM-cached tiers store them - bf16 to nearest even and
// back, int8 by rules.quantize_rows: the row's absmax over its logical
// columns, scale = absmax / 127 (IEEE division; 1 for a zero row),
// q = clamp(rint(m / scale), +-127) (rint is half to even, as
// torch.round), written back as __fmul_rn(q, scale). The scratch stays
// f32, so phase 2 is unchanged (and the planner counts 4 B an entry).
//
// The bitmap rule (coverage) has nothing to build: its branch of
// _resident_kernel runs csrc/greedy_loop.cu:rt_greedy_loop_bits with ctl.
#include <cooperative_groups.h>

#include "pairwise_tile.cuh"

namespace cg = cooperative_groups;

// The rounding phase: every warp of the grid takes whole rows of the
// (B, N, C) scratch and rounds them in place to `storage`'s values.
__device__ void rt_round_rows(float* __restrict__ mat,
                              const int* __restrict__ ctl, int B, int N,
                              int C, int storage) {
  const int lane = threadIdx.x & 31;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long rr = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       rr < (long long)B * N; rr += warps) {
    const int b = (int)(rr / N);
    const int i = (int)(rr % N);
    const int lc =
        i < ctl[(size_t)b * 3 + 1] ? min(C, ctl[(size_t)b * 3 + 2]) : 0;
    float* row = mat + rr * C;
    if (storage == RT_STORE_BF16) {
      for (int c = lane; c < C; c += 32)
        row[c] = c < lc ? __bfloat162float(__float2bfloat16_rn(row[c])) : 0.f;
      continue;
    }
    float amax = 0.f;
    for (int c = lane; c < lc; c += 32) amax = fmaxf(amax, fabsf(row[c]));
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float scale = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
    for (int c = lane; c < C; c += 32) {
      const float q =
          c < lc ? fminf(fmaxf(rintf(__fdiv_rn(row[c], scale)), -127.f), 127.f)
                 : 0.f;
      // through int: q = -0 (a small negative entry) stores +0, as int8 does
      row[c] = __fmul_rn((float)(int)q, scale);
    }
  }
}

__global__ void __launch_bounds__(RT_THREADS) rt_greedy_loop_resident_kernel(
    const float* __restrict__ ground, const float* __restrict__ cands,
    const float* __restrict__ row_in, const float* __restrict__ mask_in,
    const int* __restrict__ ctl, float* __restrict__ mat,
    float* __restrict__ row_out, int* __restrict__ bests,
    float* __restrict__ gains, int B, int N, int C, int D, int k, int mode,
    int storage, RtRule rule) {
  cg::grid_group grid = cg::this_grid();
  __shared__ __align__(16) RtTileSmem ts;
  __shared__ float sv[32];
  __shared__ int si[32];
  extern __shared__ float smem[];
  float* rows = smem;      // (N,) the node's state row
  float* mask = smem + N;  // (C,) the node's candidate mask

  // phase 1: every block builds matrix tiles of every node
  const long long tn = (N + RT_TILE - 1) / RT_TILE;
  const long long tc = (C + RT_TILE - 1) / RT_TILE;
  const long long tiles = (long long)B * tn * tc;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long b = t / (tn * tc);
    const long long rem = t % (tn * tc);
    rt_pairwise_tile<float>(ground + b * N * D, cands + b * C * D,
                            mat + b * N * C,
                     N, C, D, (int)(rem / tc) * RT_TILE,
                     (int)(rem % tc) * RT_TILE, mode, ts);
  }
  grid.sync();

  if (storage != RT_STORE_F32) {
    rt_round_rows(mat, ctl, B, N, C, storage);
    grid.sync();
  }

  // phase 2: one block per node runs the k steps
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const float* M = mat + (size_t)b * N * C;
    const int kq = ctl[(size_t)b * 3];
    for (int i = tid; i < N; i += T) rows[i] = row_in[(size_t)b * N + i];
    for (int c = tid; c < C; c += T) mask[c] = mask_in[(size_t)b * C + c];
    __syncthreads();
    int prev = -1;
    for (int s = 0; s < k; ++s) {
      if (prev >= 0)
        for (int i = tid; i < N; i += T)
          rows[i] = rt_fold(rows[i], M[(size_t)i * C + prev], rule);
      __syncthreads();
      float bv = -INFINITY;
      int bi = RT_NO_INDEX;
      for (int c = tid; c < C; c += T) {
        float acc = 0.f;
#pragma unroll 8
        for (int i = 0; i < N; ++i)
          acc += rt_gain_part(rows[i], M[(size_t)i * C + c], rule);
        rt_argmax_pair(bv, bi, mask[c] > 0.f ? acc : -INFINITY, c);
      }
      rt_block_argmax(bv, bi, sv, si);
      const bool live = s < kq;
      const bool accept = live && rt_finite(bv) && bv > 0.f;
      const int best = accept ? bi : -1;
      if (accept && tid == 0) mask[bi] = 0.f;
      if (tid == 0) {
        bests[(size_t)b * k + s] = best;
        gains[(size_t)b * k + s] = live ? bv : 0.f;
      }
      prev = best;
      __syncthreads();
    }
    for (int i = tid; i < N; i += T) {
      float r = rows[i];
      if (prev >= 0) r = rt_fold(r, M[(size_t)i * C + prev], rule);
      row_out[(size_t)b * N + i] = r;
    }
    __syncthreads();
  }
}

extern "C" int rt_resident_occupancy(int smem_bytes, int* blocks_per_sm,
                                     int* sms) {
  cudaError_t e = cudaFuncSetAttribute(
      rt_greedy_loop_resident_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, rt_greedy_loop_resident_kernel, RT_THREADS, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// mat: (B, N, C) f32 scratch; storage: the cache plan's dtype, whose
// rounding the scratch gets (RT_STORE_F32: none); grid: blocks to launch
// (all co-resident). Returns the cudaError_t.
extern "C" int rt_greedy_loop_resident(
    const float* ground, const float* cands, const float* row_in,
    const float* mask_in, const int* ctl, float* mat, float* row_out,
    int* bests, float* gains, int B, int N, int C, int D, int k, int mode,
    int storage, int fold, float cap, float lam, float lam1, int grid,
    void* stream) {
  if (B == 0) return 0;
  RtRule rule{fold, cap, lam, lam1};
  const int smem = (N + C) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      rt_greedy_loop_resident_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&ground, (void*)&cands,  (void*)&row_in,
                  (void*)&mask_in, (void*)&ctl,   (void*)&mat,
                  (void*)&row_out, (void*)&bests, (void*)&gains,
                  (void*)&B,      (void*)&N,      (void*)&C,
                  (void*)&D,      (void*)&k,      (void*)&mode,
                  (void*)&storage, (void*)&rule};
  e = cudaLaunchCooperativeKernel((void*)rt_greedy_loop_resident_kernel,
                                  dim3(grid), dim3(RT_THREADS), args,
                                  (size_t)smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
