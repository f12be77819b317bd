// One fused greedy step over cached matrices, for B greedies in ONE launch.
//
// Replaces the Pallas kernel src/repro/kernels/fused_step.py:
// fused_step_pallas (_kernel, _step_body), the per-step engine over a
// cache that the constrained and sampled greedies run (the loop kernels
// evaluate no per-step feasibility mask). Inputs: cached (B, N, C)
// matrices stored as f32, bf16 or int8 with (B, N) row scales (the
// _kernel_quant entry point), (B, N) state rows, (B, C) 0/1 f32 masks
// and (B,) int64 previous winners (-1 = none). Outputs: the new rows
// (B, N), and per
// greedy the masked first-argmax column (int32) and its raw gain sum
// (f32) - the semantics of kernels/ref.py:fused_step.
//
// What bounds it on the H100: device-memory bytes. A step reads every
// greedy's whole cache once for ~3 flops per entry: at the knapsack leaf
// shape of the Tiny-ImageNet configuration (32 leaves x 3,125^2 x 4 B =
// 1.25 GB, far over the 50 MB L2) that is ~0.37 ms at 3.35 TB/s.
//
// What the design does about it: the TPU walked the (N/BN,) row blocks
// of one greedy in order on one core, carrying the gains in VMEM. Here
// each greedy spans P = N/R blocks, each holding R ground rows, so one
// step streams every cache through all SMs at once. A block folds the
// previous winner's column into its rows (the deferred update) and
// writes them out, then streams its (R, C) slab with consecutive threads
// on consecutive columns (coalesced) and writes a (C,) partial to
// device memory. Blocks run in no order on a GPU, so the last block of a
// greedy to finish - counted with an atomic int after a __threadfence -
// sums the P partials of every column in block order (no float atomics:
// runs repeat bit for bit) and takes the masked first-argmax, keeping
// the reference's one launch per step without a grid barrier.
//
// bf16 and int8 storage run the same template over rt_entry (rules.cuh):
// each entry is widened to the f32 value rules.dequant gives (int8: one
// __fmul_rn by its row's scale, which a block stages beside its rows in
// shared memory), then the identical f32 algebra, so a variant equals
// the f32 kernel run on the dequantized cache bit for bit. A step then
// reads 2 or 1 bytes an entry: 0.63 or 0.31 GB at the knapsack leaf.
//
// The bitmap rule (coverage) runs rt_fused_step_bits, the uint32 branch
// of _step_body: its matrix is the transpose of the candidates' words,
// so the kernel takes them candidate-major, (B, C, W), as the greedy
// holds them (no transposed copy of a cache that reaches 5.1 GB at the
// kcover leaf). Each greedy spans P blocks of CB candidates; every block
// folds the previous winner's words into its shared-memory copy of the
// (W,) covered words (block 0 writes the new row), gives each candidate
// to one warp (exact integer popcount sums), takes its block's masked
// first-argmax, and the greedy's last block to arrive reduces the P
// (gain, index) pairs in block order - the same last-block-done scheme,
// exact in any order since the gains are integers. Bound by bytes: a
// step reads the cache once, 32 x 30,938 x 1,290 words x 4 B = 5.1 GB at
// the kcover knapsack leaf, 1.5 ms at 3.35 TB/s.
#include "rules.cuh"

template <class S>
__global__ void __launch_bounds__(RT_THREADS)
    rt_fused_step_kernel(const S* __restrict__ mat,
                         const float* __restrict__ scale,
                         const float* __restrict__ row_in,
                         const float* __restrict__ mask,
                         const long long* __restrict__ prev_in,
                         float* __restrict__ row_out, int* __restrict__ best,
                         float* __restrict__ gain,
                         float* __restrict__ partials,
                         int* __restrict__ arrivals, int N, int C, int P,
                         int R, RtRule rule) {
  extern __shared__ float rows[];  // (R,) this block's new state rows
  float* scl = rows + R;           // (R,) their int8 scales (int8 only)
  __shared__ float sv[32];
  __shared__ int si[32];
  __shared__ int is_last;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const size_t b = blockIdx.x / P;
  const int p = blockIdx.x % P;
  const int r0 = p * R;
  const int nr = max(0, min(N - r0, R));
  const S* M = mat + b * N * C + (size_t)r0 * C;
  const long long prev = prev_in[b];

  // 1. deferred update: fold the previous winner's column into the rows
  for (int i = tid; i < nr; i += T) {
    const float s = rt_scaled<S>() ? scale[b * N + r0 + i] : 1.f;
    if (rt_scaled<S>()) scl[i] = s;
    float r = row_in[b * N + r0 + i];
    if (prev >= 0) r = rt_fold(r, rt_entry(M, (size_t)i * C + prev, s), rule);
    rows[i] = r;
    row_out[b * N + r0 + i] = r;
  }
  __syncthreads();

  // 2. this block's gain partials over its rows, every column
  float* part = partials + (b * P + p) * C;
  for (int c = tid; c < C; c += T) {
    const S* col = M + c;
    float acc = 0.f;
#pragma unroll 8
    for (int i = 0; i < nr; ++i)
      acc += rt_gain_part(
          rows[i],
          rt_entry(col, (size_t)i * C, rt_scaled<S>() ? scl[i] : 1.f), rule);
    part[c] = acc;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(arrivals + b, 1) == P - 1;
  __syncthreads();
  if (!is_last) return;

  // 3. the greedy's last block: reduce the P partials in block order,
  //    masked first-argmax
  const float* base = partials + b * P * C;
  float bv = -INFINITY;
  int bi = RT_NO_INDEX;
  for (int c = tid; c < C; c += T) {
    float g = 0.f;
    for (int q = 0; q < P; ++q) g += __ldcg(&base[(size_t)q * C + c]);
    rt_argmax_pair(bv, bi, mask[b * C + c] > 0.f ? g : -INFINITY, c);
  }
  rt_block_argmax(bv, bi, sv, si);
  if (tid == 0) {
    best[b] = bi;
    gain[b] = bv;
    arrivals[b] = 0;  // ready for the next launch
  }
}

template <class S>
static cudaError_t rt_fused_step_launch(const void* mat, const float* scale,
                                        const float* row_in,
                                        const float* mask,
                                        const long long* prev, float* row_out,
                                        int* best, float* gain,
                                        float* partials, int* arrivals, int B,
                                        int N, int C, int P, int R,
                                        RtRule rule, cudaStream_t stream) {
  const size_t smem = (size_t)R * (rt_scaled<S>() ? 2 : 1) * sizeof(float);
  rt_fused_step_kernel<S><<<B * P, RT_THREADS, smem, stream>>>(
      (const S*)mat, scale, row_in, mask, prev, row_out, best, gain, partials,
      arrivals, N, C, P, R, rule);
  return cudaGetLastError();
}

// mat: (B, N, C) in `storage` (RT_STORE_F32 | BF16 | INT8); scale: (B, N)
// f32 row scales for int8, else null. partials: (B, P, C) f32 scratch;
// arrivals: (B,) int32, zero on entry and left zero; R ground rows per
// block, P = ceil(N / R). Returns the cudaError_t.
extern "C" int rt_fused_step(const void* mat, const float* scale,
                             const float* row_in, const float* mask,
                             const long long* prev, float* row_out, int* best,
                             float* gain, float* partials, int* arrivals,
                             int B, int N, int C, int P, int R, int storage,
                             int fold, float cap, float lam, float lam1,
                             void* stream) {
  if (B == 0) return 0;
  RtRule rule{fold, cap, lam, lam1};
  cudaStream_t st = (cudaStream_t)stream;
  switch (storage) {
    case RT_STORE_F32:
      return (int)rt_fused_step_launch<float>(
          mat, scale, row_in, mask, prev, row_out, best, gain, partials,
          arrivals, B, N, C, P, R, rule, st);
    case RT_STORE_BF16:
      return (int)rt_fused_step_launch<__nv_bfloat16>(
          mat, scale, row_in, mask, prev, row_out, best, gain, partials,
          arrivals, B, N, C, P, R, rule, st);
    case RT_STORE_INT8:
      return (int)rt_fused_step_launch<int8_t>(
          mat, scale, row_in, mask, prev, row_out, best, gain, partials,
          arrivals, B, N, C, P, R, rule, st);
  }
  return (int)cudaErrorInvalidValue;
}

__global__ void __launch_bounds__(RT_THREADS)
    rt_fused_step_bits_kernel(const unsigned* __restrict__ cands,
                              const unsigned* __restrict__ row_in,
                              const float* __restrict__ mask,
                              const long long* __restrict__ prev_in,
                              unsigned* __restrict__ row_out,
                              int* __restrict__ best, float* __restrict__ gain,
                              float* __restrict__ pval, int* __restrict__ pidx,
                              int* __restrict__ arrivals, int C, int W, int P,
                              int CB) {
  extern __shared__ unsigned covered[];  // (W,) the greedy's new row
  __shared__ float sv[32];
  __shared__ int si[32];
  __shared__ int is_last;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const size_t b = blockIdx.x / P;
  const int p = blockIdx.x % P;
  const unsigned* base = cands + b * C * W;
  const long long prev = prev_in[b];

  // 1. deferred update: fold the previous winner's words into the row
  for (int w = tid; w < W; w += T) {
    unsigned r = row_in[b * W + w];
    if (prev >= 0) r = rt_bits_fold(r, base[(size_t)prev * W + w]);
    covered[w] = r;
    if (p == 0) row_out[b * W + w] = r;
  }
  __syncthreads();

  // 2. this block's candidates, one warp each: masked first-argmax
  const int c0 = p * CB;
  const int c1 = min(C, c0 + CB);
  float bv = -INFINITY;
  int bi = RT_NO_INDEX;
  for (int c = c0 + (tid >> 5); c < c1; c += T >> 5) {
    const int g = rt_warp_bits_gain(base + (size_t)c * W, covered, W);
    rt_argmax_pair(bv, bi, mask[b * C + c] > 0.f ? (float)g : -INFINITY, c);
  }
  rt_block_argmax(bv, bi, sv, si);
  if (tid == 0) {
    pval[b * P + p] = bv;
    pidx[b * P + p] = bi;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(arrivals + b, 1) == P - 1;
  __syncthreads();
  if (!is_last) return;

  // 3. the greedy's last block: the P block winners, first-max order
  bv = -INFINITY;
  bi = RT_NO_INDEX;
  for (int q = tid; q < P; q += T)
    rt_argmax_pair(bv, bi, __ldcg(&pval[b * P + q]), __ldcg(&pidx[b * P + q]));
  rt_block_argmax(bv, bi, sv, si);
  if (tid == 0) {
    best[b] = bi;
    gain[b] = bv;
    arrivals[b] = 0;  // ready for the next launch
  }
}

// cands (B, C, W) and rows (B, W) 32-bit words; pval/pidx: (B, P)
// scratch; arrivals: (B,) int32, zero on entry and left zero; CB
// candidates per block, P = ceil(C / CB). Returns the cudaError_t.
extern "C" int rt_fused_step_bits(const unsigned* cands, const unsigned* row_in,
                                  const float* mask, const long long* prev,
                                  unsigned* row_out, int* best, float* gain,
                                  float* pval, int* pidx, int* arrivals, int B,
                                  int C, int W, int P, int CB, void* stream) {
  if (B == 0) return 0;
  const int smem = W * (int)sizeof(unsigned);
  cudaError_t e = cudaFuncSetAttribute(
      rt_fused_step_bits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  rt_fused_step_bits_kernel<<<B * P, RT_THREADS, (size_t)smem,
                              (cudaStream_t)stream>>>(
      cands, row_in, mask, prev, row_out, best, gain, pval, pidx, arrivals, C,
      W, P, CB);
  return (int)cudaGetLastError();
}
