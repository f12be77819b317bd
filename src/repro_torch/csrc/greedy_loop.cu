// Streaming whole-greedy loop: all k steps of B greedies in ONE launch.
//
// Replaces the Pallas kernel
// src/repro/kernels/greedy_loop.py:greedy_loop_pallas (_stream_kernel),
// the leaf greedy of the main path. Inputs: the cached (B, N, C) f32
// matrices, the (B, N) state rows and (B, C) candidate masks. Outputs:
// final rows (B, N), bests (B, k) int32 (-1 = rejected step) and raw
// gains (B, k) f32 - the semantics of kernels/ref.py:greedy_loop.
//
// What bounds it on the H100: device-memory bytes. Each step re-reads
// every greedy's whole cache (32 leaves x ~3,200^2 x 4 B ~ 1.3 GB at the
// Tiny-ImageNet shape, far over the 50 MB L2) for ~3 flops per entry, so
// a step costs at least ~0.4 ms of HBM time at 3.35 TB/s.
//
// What the design does about it: the TPU ran its (step, row-block) grid
// in order on one core; here each greedy spans P blocks that hold a
// contiguous slice of ground rows, so a step streams the cache through
// all SMs at once (one block per greedy would leave the card idle and
// read 40 MB per step through one SM). Blocks do not run in order on a
// GPU, so the kernel is launched cooperatively (all B*P blocks
// co-resident, sized by the wrapper from the occupancy calculator) and
// one grid barrier per step separates "write per-block gain partials"
// from "reduce them". Every block of a greedy then reduces the P
// partials of every column itself, in a fixed block order (no float
// atomics: runs repeat bit for bit), takes the masked first-argmax and
// updates its own shared-memory copy of the mask - so the winner is
// known everywhere without a second barrier. Partials alternate between
// two buffers by step parity, so a fast block never overwrites a step's
// partials while a slow block still reads them. The state rows of a
// block's slice stay in shared memory for all k steps, and the previous
// winner's column is folded in at the start of the next step (the
// deferred update) and once more after step k (the flush).
//
// bf16 and int8 caches (_stream_kernel_quant) run the same template over
// rt_entry (rules.cuh): every entry is widened to rules.dequant's f32
// value (int8: one __fmul_rn by its row's scale, staged in shared memory
// beside the rows) before the identical f32 algebra, so each variant
// equals the f32 kernel on the dequantized cache bit for bit. Every step
// re-reads 0.69 GB (bf16) or 0.345 GB (int8) at the Tiny-ImageNet
// leaves instead of 1.38 GB.
//
// The bitmap rule (coverage) runs rt_greedy_loop_bits, the uint32 branch
// of _stream_body, over the candidates' words held candidate-major,
// (B, C, W): the reference's matrix is their transpose, which is never
// materialized. The cooperative design stays - P blocks per greedy, one
// grid barrier per step, accept only when the gain is > 0 - but the
// blocks split a greedy's CANDIDATES, not its ground rows: each block
// keeps the whole (W,) covered-word row and the mask of its CB
// candidates in shared memory, gives each candidate to one warp (exact
// integer popcount sums) and writes its masked first-argmax; after the
// barrier every block reduces the P pairs (first-max order: exact in any
// order) and folds the winner's words into its row at once. Bound by
// bytes: every step re-reads the whole cache, 32 x 30,938 x 1,290 words
// x 4 B = 5.1 GB at the kcover leaf, so 64 steps are at least ~98 ms at
// 3.35 TB/s.
//
// The same kernel is the bitmap branch of _resident_kernel
// (greedy_loop_resident_pallas), the accumulation nodes' loop: there the
// on-chip matrix is the transpose of the node's (C, W) candidate words
// (R.matrix_block is c.T), so there is nothing to build, and a copy into
// a scratch would only duplicate words the node's union already holds
// contiguously. The nodes' words are read in place and sit in L2 after
// the first step (16 nodes x 128 x 1,290 words x 4 B = 10.6 MB at
// kcover's level 1, under the 25 MB share the planner admits). ctl
// (B, 3) int32 = [kq, logical_n, logical_c] is then given, and steps
// s >= kq freeze (bests -1, gains 0, nothing folded); a frozen greedy's
// blocks still meet every grid barrier. The streaming tier passes no
// ctl (kq = k).
#include <cooperative_groups.h>

#include "rules.cuh"

namespace cg = cooperative_groups;

template <class S>
__global__ void __launch_bounds__(RT_THREADS)
    rt_greedy_loop_kernel(const S* __restrict__ mat,
                          const float* __restrict__ scale,
                          const float* __restrict__ row_in,
                          const float* __restrict__ mask_in,
                          float* __restrict__ row_out, int* __restrict__ bests,
                          float* __restrict__ gains,
                          float* __restrict__ partials, int B, int N, int C,
                          int k, int P, int R, RtRule rule) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  float* mask = smem;          // (C,) this block's copy of the candidate mask
  float* rows = smem + C;      // (R,) state of this block's ground rows
  float* scl = smem + C + R;   // (R,) their int8 scales (int8 only)
  __shared__ float sv[32];
  __shared__ int si[32];

  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int b = blockIdx.x / P;
  const int p = blockIdx.x % P;
  const int r0 = p * R;
  const int nr = max(0, min(N - r0, R));
  const S* M = mat + (size_t)b * N * C;

  for (int c = tid; c < C; c += T) mask[c] = mask_in[(size_t)b * C + c];
  for (int i = tid; i < nr; i += T) {
    rows[i] = row_in[(size_t)b * N + r0 + i];
    if (rt_scaled<S>()) scl[i] = scale[(size_t)b * N + r0 + i];
  }
  __syncthreads();

  int prev = -1;
  for (int s = 0; s < k; ++s) {
    // deferred update: fold the previous winner's column into the rows
    if (prev >= 0)
      for (int i = tid; i < nr; i += T)
        rows[i] = rt_fold(rows[i],
                          rt_entry(M, (size_t)(r0 + i) * C + prev,
                                   rt_scaled<S>() ? scl[i] : 1.f),
                          rule);
    __syncthreads();

    // per-block gain partials over this block's rows, every column
    const size_t buf = (size_t)(s & 1) * B * P;
    float* part = partials + (buf + (size_t)b * P + p) * C;
    for (int c = tid; c < C; c += T) {
      const S* col = M + (size_t)r0 * C + c;
      float acc = 0.f;
#pragma unroll 8
      for (int i = 0; i < nr; ++i)
        acc += rt_gain_part(
            rows[i],
            rt_entry(col, (size_t)i * C, rt_scaled<S>() ? scl[i] : 1.f),
            rule);
      part[c] = acc;
    }
    grid.sync();

    // reduce the P partials in block order, masked first-argmax
    const float* base = partials + (buf + (size_t)b * P) * C;
    float bv = -INFINITY;
    int bi = RT_NO_INDEX;
    for (int c = tid; c < C; c += T) {
      float g = 0.f;
      for (int q = 0; q < P; ++q) g += base[(size_t)q * C + c];
      rt_argmax_pair(bv, bi, mask[c] > 0.f ? g : -INFINITY, c);
    }
    rt_block_argmax(bv, bi, sv, si);
    const bool accept = rt_finite(bv) && bv > 0.f;
    const int best = accept ? bi : -1;
    if (accept && tid == 0) mask[bi] = 0.f;
    if (p == 0 && tid == 0) {
      bests[(size_t)b * k + s] = best;
      gains[(size_t)b * k + s] = bv;
    }
    prev = best;
    __syncthreads();
  }
  // flush: fold the final accepted winner
  for (int i = tid; i < nr; i += T) {
    float r = rows[i];
    if (prev >= 0)
      r = rt_fold(r,
                  rt_entry(M, (size_t)(r0 + i) * C + prev,
                           rt_scaled<S>() ? scl[i] : 1.f),
                  rule);
    row_out[(size_t)b * N + r0 + i] = r;
  }
}

// the kernel of a storage code (null for an unknown code)
static const void* rt_greedy_loop_fn(int storage) {
  switch (storage) {
    case RT_STORE_F32:
      return (const void*)rt_greedy_loop_kernel<float>;
    case RT_STORE_BF16:
      return (const void*)rt_greedy_loop_kernel<__nv_bfloat16>;
    case RT_STORE_INT8:
      return (const void*)rt_greedy_loop_kernel<int8_t>;
  }
  return nullptr;
}

// Blocks of the `storage` kernel one SM holds at `smem_bytes` of dynamic
// shared memory, and the SM count; returns the cudaError_t.
extern "C" int rt_greedy_loop_occupancy(int storage, int smem_bytes,
                                        int* blocks_per_sm, int* sms) {
  const void* fn = rt_greedy_loop_fn(storage);
  if (!fn) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                    RT_THREADS, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// mat: (B, N, C) in `storage` (RT_STORE_F32 | BF16 | INT8); scale: (B, N)
// f32 row scales for int8, else null; partials: (2, B, P, C) f32
// scratch. Dynamic shared memory: C + R floats, + R for int8's scales.
// Returns the cudaError_t.
extern "C" int rt_greedy_loop(const void* mat, const float* scale,
                              const float* row_in, const float* mask_in,
                              float* row_out, int* bests, float* gains,
                              float* partials, int B, int N, int C, int k,
                              int P, int R, int storage, int fold, float cap,
                              float lam, float lam1, void* stream) {
  if (B == 0) return 0;
  const void* fn = rt_greedy_loop_fn(storage);
  if (!fn) return (int)cudaErrorInvalidValue;
  RtRule rule{fold, cap, lam, lam1};
  const int smem =
      (C + R * (storage == RT_STORE_INT8 ? 2 : 1)) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&mat,     (void*)&scale,  (void*)&row_in,
                  (void*)&mask_in, (void*)&row_out, (void*)&bests,
                  (void*)&gains,   (void*)&partials, (void*)&B,
                  (void*)&N,       (void*)&C,      (void*)&k,
                  (void*)&P,       (void*)&R,      (void*)&rule};
  e = cudaLaunchCooperativeKernel(fn, dim3(B * P), dim3(RT_THREADS), args,
                                  (size_t)smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(RT_THREADS)
    rt_greedy_loop_bits_kernel(const unsigned* __restrict__ cands,
                               const unsigned* __restrict__ row_in,
                               const float* __restrict__ mask_in,
                               const int* __restrict__ ctl,
                               unsigned* __restrict__ row_out,
                               int* __restrict__ bests,
                               float* __restrict__ gains,
                               float* __restrict__ pval,
                               int* __restrict__ pidx, int B, int C, int W,
                               int k, int P, int CB) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ unsigned smem_words[];
  unsigned* covered = smem_words;  // (W,) the greedy's covered words
  float* mask = reinterpret_cast<float*>(smem_words + W);  // (CB,) own
  __shared__ float sv[32];
  __shared__ int si[32];

  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int warps = T >> 5;
  const int b = blockIdx.x / P;
  const int p = blockIdx.x % P;
  const int c0 = p * CB;
  const int nc = max(0, min(C - c0, CB));
  const unsigned* base = cands + (size_t)b * C * W;
  const int kq = ctl ? ctl[(size_t)b * 3] : k;

  for (int w = tid; w < W; w += T) covered[w] = row_in[(size_t)b * W + w];
  for (int i = tid; i < nc; i += T) mask[i] = mask_in[(size_t)b * C + c0 + i];
  __syncthreads();

  for (int s = 0; s < k; ++s) {
    if (s >= kq) {  // frozen: nothing more is taken
      if (p == 0 && tid == 0) {
        bests[(size_t)b * k + s] = -1;
        gains[(size_t)b * k + s] = 0.f;
      }
      grid.sync();
      continue;
    }
    // this block's candidates, one warp each: masked first-argmax
    float bv = -INFINITY;
    int bi = RT_NO_INDEX;
    for (int i = tid >> 5; i < nc; i += warps) {
      const int g = rt_warp_bits_gain(base + (size_t)(c0 + i) * W, covered, W);
      rt_argmax_pair(bv, bi, mask[i] > 0.f ? (float)g : -INFINITY, c0 + i);
    }
    rt_block_argmax(bv, bi, sv, si);
    const size_t slot = ((size_t)(s & 1) * B + b) * P;
    if (tid == 0) {
      pval[slot + p] = bv;
      pidx[slot + p] = bi;
    }
    grid.sync();

    // every block: the greedy's winner from the P block winners
    bv = -INFINITY;
    bi = RT_NO_INDEX;
    for (int q = tid; q < P; q += T)
      rt_argmax_pair(bv, bi, pval[slot + q], pidx[slot + q]);
    rt_block_argmax(bv, bi, sv, si);
    const bool accept = rt_finite(bv) && bv > 0.f;
    if (p == 0 && tid == 0) {
      bests[(size_t)b * k + s] = accept ? bi : -1;
      gains[(size_t)b * k + s] = bv;
    }
    if (accept) {
      if (tid == 0 && bi >= c0 && bi < c0 + nc) mask[bi - c0] = 0.f;
      const unsigned* win = base + (size_t)bi * W;
      for (int w = tid; w < W; w += T)
        covered[w] = rt_bits_fold(covered[w], win[w]);
    }
    __syncthreads();
  }
  if (p == 0)
    for (int w = tid; w < W; w += T) row_out[(size_t)b * W + w] = covered[w];
}

extern "C" int rt_greedy_loop_bits_occupancy(int smem_bytes,
                                             int* blocks_per_sm, int* sms) {
  cudaError_t e = cudaFuncSetAttribute(
      rt_greedy_loop_bits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, rt_greedy_loop_bits_kernel, RT_THREADS, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// cands (B, C, W) and rows (B, W) 32-bit words; ctl (B, 3) int32 or
// null (only kq is read); pval/pidx: (2, B, P) scratch; CB candidates
// per block, P = ceil(C / CB), all B * P blocks co-resident. Returns the
// cudaError_t.
extern "C" int rt_greedy_loop_bits(const unsigned* cands, const unsigned* row_in,
                                   const float* mask_in, const int* ctl,
                                   unsigned* row_out,
                                   int* bests, float* gains, float* pval,
                                   int* pidx, int B, int C, int W, int k, int P,
                                   int CB, void* stream) {
  if (B == 0) return 0;
  const int smem = (W + CB) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      rt_greedy_loop_bits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&cands,  (void*)&row_in, (void*)&mask_in,
                  (void*)&ctl,    (void*)&row_out, (void*)&bests,
                  (void*)&gains,  (void*)&pval,   (void*)&pidx,
                  (void*)&B,      (void*)&C,      (void*)&W,
                  (void*)&k,      (void*)&P,      (void*)&CB};
  e = cudaLaunchCooperativeKernel((void*)rt_greedy_loop_bits_kernel,
                                  dim3(B * P), dim3(RT_THREADS), args,
                                  (size_t)smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
