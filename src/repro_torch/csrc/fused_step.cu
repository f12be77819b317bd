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
// greedy the masked first-argmax column (int64) and its raw gain sum
// (f32) - the semantics of kernels/ref.py:fused_step.
//
// What bounds it on the H100: device-memory bytes. A step reads every
// greedy's whole cache once for ~3 flops per entry: at the knapsack leaf
// shape of the Tiny-ImageNet configuration (32 leaves x 3,125^2 x 4 B =
// 1.25 GB, far over the 50 MB L2) that is ~0.37 ms at 3.35 TB/s, 0.19 ms
// for bf16 and 0.09 ms for int8.
//
// What the design does about it. The TPU walked the (N/BN,) row blocks
// of one greedy in order on one core, carrying the gains in VMEM. Here a
// greedy's cache is cut into spans of RT_FUSED_SPAN = 128 columns and
// chunks of CH ground rows (the caller's block_n, 32 by default), and a
// block takes CPB consecutive chunks of one span:
//  1. it folds the previous winner's column into its rows (the deferred
//     update; the span-0 blocks write the new rows out);
//  2. it streams its (CPB * CH, 128) slab in 16-byte loads and leaves
//     each chunk's partials (f32 over the chunk's rows, in row order) in
//     shared memory: the span pass of span_pass.cuh, which the streaming
//     whole-greedy loop (greedy_loop.cu) runs too;
//  3. a span's CL blocks are a thread-block cluster (CPB = ceil(P / CL),
//     P = ceil(N / CH)): after one cluster barrier each block adds, for
//     its share of the span's columns, the P chunk partials in chunk
//     order (the other blocks' through distributed shared memory, the
//     loads issued ahead of the chain of adds) and takes their masked
//     first-argmax;
//  4. every block writes its (gain, column) pair, and the greedy's last
//     block to finish - counted with an atomic int after a __threadfence
//     - picks the first maximum of the greedy's few pairs (no float
//     atomics: runs repeat bit for bit), so the step stays one launch
//     without a grid barrier, and no block sums a whole greedy's
//     partials alone.
// The sum's order is the earlier design's (f32 over each chunk's rows in
// row order, then the chunk partials in chunk order), so the kernel
// gives its bits. CL is the smallest of 1..8 that gives about 8 blocks
// an SM or leaves each lane group one chunk, with the partials in shared
// memory (rt_fused_cluster): at the leaf 25 spans x 2 x 32 greedies =
// 1,600 blocks of 49 chunks; at a 400-row node 4 spans x 2 (f32) a
// greedy.
//
// Past 16 chunks a block of a cluster of 8 (the caller's gate,
// plans.fused_tier: 4,096 rows in chunks of 32), where a span's partials
// crowd the SM's shared memory to one or two blocks or fit no cluster at
// all (more than ~92,000 f32 or bf16 rows, ~77,000 int8 rows), the step
// runs the global tier, rt_fused_step_spans_kernel: the same span pass,
// its chunk partials in a (B, P, CP) f32 scratch in device memory, each
// span's last block to arrive summing its columns in chunk order and the
// greedy's last span picking the first maximum of the spans' pairs - the
// same sums in the same order, so the same bits; at the sequential
// Greedy's 1 x 100,000^2 f32 its 782 spans sum their chains in parallel
// (the earlier design, rt_fused_step_global_kernel, kept as the tests'
// yardstick, left that sum of 1.25 GB of partials to one block).
//
// bf16 and int8 storage run the same template: the span pass widens
// each entry to the f32 value rules.dequant gives (an int8 row's scale
// staged beside its rows in shared memory), then the identical f32
// algebra, so a variant equals the f32 kernel run on the dequantized
// cache bit for bit.
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
#include <cooperative_groups.h>

#include "span_pass.cuh"

namespace cg = cooperative_groups;

#define RT_FUSED_CLUSTER_MAX 8

// Grid (spans * CL, B), clusters of CL blocks along x: a span's ranks.
// Dynamic shared memory: part (CPB, SPAN) chunk partials, rows (CPB * CH)
// the block's new state rows, scl (CPB * CH) their int8 scales. pval /
// pidx (B, gridDim.x): the blocks' (gain, column) pairs; arrivals (B,)
// zero on entry and left zero.
template <class S, int PATH>
__global__ void __launch_bounds__(RT_THREADS, RT_FUSED_MINB)
    rt_fused_step_kernel(const S* __restrict__ mat,
                         const float* __restrict__ scale,
                         const float* __restrict__ row_in,
                         const float* __restrict__ mask,
                         const long long* __restrict__ prev_in,
                         float* __restrict__ row_out,
                         long long* __restrict__ best,
                         float* __restrict__ gain, float* __restrict__ pval,
                         int* __restrict__ pidx, int* __restrict__ arrivals,
                         int N, int C, int CH, int CL, int CPB,
                         RtRule rule) {
  constexpr int SPAN = RT_FUSED_SPAN;
  extern __shared__ __align__(16) float smem[];
  float* part = smem;               // (CPB, SPAN)
  float* rows = part + CPB * SPAN;  // (CPB * CH,)
  float* scl = rows + CPB * CH;     // (CPB * CH,), int8 only
  __shared__ float sv[32];
  __shared__ int si[32];
  __shared__ int is_last;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const size_t b = blockIdx.y;
  const int span = blockIdx.x / CL;
  const int rank = blockIdx.x % CL;
  const int P = (N + CH - 1) / CH;
  const int q0 = rank * CPB;
  const int nq = max(0, min(P - q0, CPB));  // this block's chunks
  const int r0 = q0 * CH;
  const int nr = max(0, min(N - r0, nq * CH));
  const int cs = span * SPAN;
  const size_t e_greedy = b * N * C;  // the greedy's first entry
  const long long prev = prev_in[b];

  // 1. deferred update: fold the previous winner's column into the rows
  for (int i = tid; i < nr; i += T) {
    const size_t r = (size_t)(r0 + i);
    const float s = rt_scaled<S>() ? scale[b * N + r] : 1.f;
    if (rt_scaled<S>()) scl[i] = s;
    float v = row_in[b * N + r];
    if (prev >= 0) v = rt_fold(v, rt_entry(mat, e_greedy + r * C + prev, s),
                               rule);
    rows[i] = v;
    if (span == 0) row_out[b * N + r] = v;
  }
  __syncthreads();

  // 2. the chunk partials (span_pass.cuh), into shared memory
  rt_span_pass<S, PATH>(
      mat, e_greedy, C, cs, r0, nr, nq, CH, rows, scl, rule,
      [&](int j, int lane, const float (&acc)[RtFusedVec<S>::VW]) {
        float4* dst = reinterpret_cast<float4*>(
            &part[j * SPAN + lane * RtFusedVec<S>::VW]);
#pragma unroll
        for (int v = 0; v < RtFusedVec<S>::VW; v += 4)
          dst[v / 4] = make_float4(acc[v], acc[v + 1], acc[v + 2],
                                   acc[v + 3]);
      });

  // 3. the chains: this rank's share of the span's columns, each the sum
  //    of all P chunk partials in chunk order, then masked first-argmax
  if (CL > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
  const int per = (SPAN + CL - 1) / CL;
  float bv = -INFINITY;
  int bi = RT_NO_INDEX;
  for (int lc = rank * per + tid; lc < min(SPAN, (rank + 1) * per);
       lc += T) {
    const int c = cs + lc;
    if (c >= C) break;
    float g = 0.f;
    for (int o = 0; o < CL; ++o) {
      const int cnt = max(0, min(P - o * CPB, CPB));
      const float* src =
          CL > 1 ? cg::this_cluster().map_shared_rank(part, o) : part;
#pragma unroll 8
      for (int k = 0; k < cnt; ++k) g += src[k * SPAN + lc];
    }
    rt_argmax_pair(bv, bi, mask[b * C + c] > 0.f ? g : -INFINITY, c);
  }
  // no block leaves while another may still read its partials
  if (CL > 1) cg::this_cluster().sync();
  rt_block_argmax(bv, bi, sv, si);
  const int SC = gridDim.x;
  if (tid == 0) {
    pval[b * SC + blockIdx.x] = bv;
    pidx[b * SC + blockIdx.x] = bi;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(arrivals + b, 1) == SC - 1;
  __syncthreads();
  if (!is_last) return;

  // 4. the greedy's last block: the first maximum of its blocks' pairs
  bv = -INFINITY;
  bi = RT_NO_INDEX;
  for (int q = tid; q < SC; q += T)
    rt_argmax_pair(bv, bi, __ldcg(&pval[b * SC + q]),
                   __ldcg(&pidx[b * SC + q]));
  rt_block_argmax(bv, bi, sv, si);
  if (tid == 0) {
    best[b] = bi;
    gain[b] = bv;
    arrivals[b] = 0;  // ready for the next launch
  }
}

// Shared-memory bytes of a block holding cpb chunks of ch rows.
template <class S>
static size_t rt_fused_smem(int cpb, int ch) {
  return (size_t)cpb *
         (RT_FUSED_SPAN + (size_t)ch * (rt_scaled<S>() ? 2 : 1)) *
         sizeof(float);
}

// The cluster size: the smallest CL of 1..8 whose blocks' partials fit
// shared memory and that gives the launch about 8 blocks an SM or leaves
// every lane group at most one chunk; 0 when none fits.
template <class S>
static int rt_fused_cluster(int B, int N, int C, int CH, int smem_max) {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long spans = (C + RT_FUSED_SPAN - 1) / RT_FUSED_SPAN;
  const int P = (N + CH - 1) / CH;
  const int groups = RT_THREADS / RtFusedVec<S>::LR;
  for (int cl = 1; cl <= RT_FUSED_CLUSTER_MAX; ++cl) {
    const int cpb = (P + cl - 1) / cl;
    if (rt_fused_smem<S>(cpb, CH) > (size_t)smem_max) continue;
    if ((long long)B * spans * cl >= 8LL * sms || cpb <= groups ||
        cl == RT_FUSED_CLUSTER_MAX)
      return cl;
  }
  return 0;
}

template <class S, int PATH>
static cudaError_t rt_fused_step_path(const S* mat, const float* scale,
                                      const float* row_in, const float* mask,
                                      const long long* prev, float* row_out,
                                      long long* best, float* gain, float* pval,
                                      int* pidx, int* arrivals, int B, int N,
                                      int C, int CH, int CL, RtRule rule,
                                      cudaStream_t st) {
  const int P = (N + CH - 1) / CH;
  const int cpb = (P + CL - 1) / CL;
  const int spans = (C + RT_FUSED_SPAN - 1) / RT_FUSED_SPAN;
  const size_t smem = rt_fused_smem<S>(cpb, CH);
  void* fn = (void*)rt_fused_step_kernel<S, PATH>;
  cudaError_t e;
  if (smem > 48 * 1024) {  // beyond the default: opt in (a host call)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(spans * CL), (unsigned)B);
  cfg.blockDim = dim3(RT_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  void* args[] = {(void*)&mat,  (void*)&scale,    (void*)&row_in,
                  (void*)&mask, (void*)&prev,     (void*)&row_out,
                  (void*)&best, (void*)&gain,     (void*)&pval,
                  (void*)&pidx, (void*)&arrivals, (void*)&N,
                  (void*)&C,    (void*)&CH,       (void*)&CL,
                  (void*)&cpb,  (void*)&rule};
  e = cudaLaunchKernelExC(&cfg, fn, args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <class S>
static cudaError_t rt_fused_step_launch(const void* mat, const float* scale,
                                        const float* row_in,
                                        const float* mask,
                                        const long long* prev, float* row_out,
                                        long long* best, float* gain,
                                        float* pval, int* pidx, int* arrivals,
                                        int B, int N, int C, int CH,
                                        RtRule rule, cudaStream_t st) {
  int dev = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  smem_max -= 1024;  // the static argmax scratch
  const int CL = rt_fused_cluster<S>(B, N, C, CH, smem_max);
  if (CL <= 0) return cudaErrorInvalidValue;  // no cluster fits: global tier
  const S* m = (const S*)mat;
  constexpr int VW = RtFusedVec<S>::VW;
  if ((uintptr_t)m % 16 != 0)
    return rt_fused_step_path<S, RT_ROWS_SCALAR>(
        m, scale, row_in, mask, prev, row_out, best, gain, pval, pidx,
        arrivals, B, N, C, CH, CL, rule, st);
  if (C % VW != 0)
    return rt_fused_step_path<S, RT_ROWS_SHIFT>(
        m, scale, row_in, mask, prev, row_out, best, gain, pval, pidx,
        arrivals, B, N, C, CH, CL, rule, st);
  return rt_fused_step_path<S, RT_ROWS_ALIGNED>(
      m, scale, row_in, mask, prev, row_out, best, gain, pval, pidx,
      arrivals, B, N, C, CH, CL, rule, st);
}

// The global tier: the cluster design's span pass with its chunk
// partials in device memory. A span's NB blocks of CPB chunks each write
// (CPB, SPAN) partials into the (B, P, CP) f32 scratch (CP = spans * SPAN,
// so every vector store lies on the 16-byte grid) and count their arrival
// on the (greedy, span) counter; the span's last block sums the span's
// columns over all P partials in chunk order (the loads issued
// RT_CHAIN_AHEAD chunks ahead of the chain), takes their masked
// first-argmax and writes the span's (gain, column) pair; the greedy's
// last span to arrive picks the first maximum of the pairs. The blocks
// run span by span (blockIdx.x = span * NB + rank), so a span's sum runs
// while later spans stream, and a span's partials are read back from L2.
// arrivals: (B * spans) span counters, then (B,) greedy counters.
#define RT_CHAIN_AHEAD 16

template <class S, int PATH>
__global__ void __launch_bounds__(RT_THREADS, RT_FUSED_MINB)
    rt_fused_step_spans_kernel(const S* __restrict__ mat,
                               const float* __restrict__ scale,
                               const float* __restrict__ row_in,
                               const float* __restrict__ mask,
                               const long long* __restrict__ prev_in,
                               float* __restrict__ row_out,
                               long long* __restrict__ best,
                               float* __restrict__ gain,
                               float* __restrict__ partials,
                               float* __restrict__ pval,
                               int* __restrict__ pidx,
                               int* __restrict__ arrivals, int N, int C,
                               int CH, int NB, int CPB, RtRule rule) {
  constexpr int SPAN = RT_FUSED_SPAN;
  extern __shared__ __align__(16) float smem[];
  float* rows = smem;            // (CPB * CH,) the block's new state rows
  float* scl = rows + CPB * CH;  // (CPB * CH,) their int8 scales
  __shared__ float sv[32];
  __shared__ int si[32];
  __shared__ int is_last;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const size_t b = blockIdx.y;
  const int B = gridDim.y;
  const int span = blockIdx.x / NB;
  const int rank = blockIdx.x % NB;
  const int spans = gridDim.x / NB;
  const size_t CP = (size_t)spans * SPAN;
  const int P = (N + CH - 1) / CH;
  const int q0 = rank * CPB;
  const int nq = max(0, min(P - q0, CPB));  // this block's chunks
  const int r0 = q0 * CH;
  const int nr = max(0, min(N - r0, nq * CH));
  const int cs = span * SPAN;
  const size_t e_greedy = b * N * C;  // the greedy's first entry
  const long long prev = prev_in[b];
  float* part = partials + b * P * CP;  // the greedy's (P, CP) partials

  // 1. deferred update: fold the previous winner's column into the rows
  for (int i = tid; i < nr; i += T) {
    const size_t r = (size_t)(r0 + i);
    const float s = rt_scaled<S>() ? scale[b * N + r] : 1.f;
    if (rt_scaled<S>()) scl[i] = s;
    float v = row_in[b * N + r];
    if (prev >= 0) v = rt_fold(v, rt_entry(mat, e_greedy + r * C + prev, s),
                               rule);
    rows[i] = v;
    if (span == 0) row_out[b * N + r] = v;
  }
  __syncthreads();

  // 2. the chunk partials (span_pass.cuh), into device memory
  rt_span_pass<S, PATH>(
      mat, e_greedy, C, cs, r0, nr, nq, CH, rows, scl, rule,
      [&](int j, int lane, const float (&acc)[RtFusedVec<S>::VW]) {
        float4* dst = reinterpret_cast<float4*>(
            &part[(size_t)(q0 + j) * CP + cs + lane * RtFusedVec<S>::VW]);
#pragma unroll
        for (int v = 0; v < RtFusedVec<S>::VW; v += 4)
          dst[v / 4] = make_float4(acc[v], acc[v + 1], acc[v + 2],
                                   acc[v + 3]);
      });
  __threadfence();
  __syncthreads();
  int* span_count = arrivals + b * spans + span;
  if (tid == 0) is_last = atomicAdd(span_count, 1) == NB - 1;
  __syncthreads();
  if (!is_last) return;

  // 3. the span's last block: each column the sum of all P chunk
  //    partials in chunk order, then masked first-argmax
  float bv = -INFINITY;
  int bi = RT_NO_INDEX;
  if (tid < SPAN && cs + tid < C) {
    const int c = cs + tid;
    const float* src = part + c;
    float g = 0.f;
    int q = 0;
    for (; q + RT_CHAIN_AHEAD <= P; q += RT_CHAIN_AHEAD) {
      float v[RT_CHAIN_AHEAD];
#pragma unroll
      for (int u = 0; u < RT_CHAIN_AHEAD; ++u)
        v[u] = __ldcg(&src[(size_t)(q + u) * CP]);
#pragma unroll
      for (int u = 0; u < RT_CHAIN_AHEAD; ++u) g += v[u];
    }
    for (; q < P; ++q) g += __ldcg(&src[(size_t)q * CP]);
    rt_argmax_pair(bv, bi, mask[b * C + c] > 0.f ? g : -INFINITY, c);
  }
  rt_block_argmax(bv, bi, sv, si);
  int* greedy_count = arrivals + (size_t)B * spans + b;
  if (tid == 0) {
    pval[b * spans + span] = bv;
    pidx[b * spans + span] = bi;
    *span_count = 0;  // ready for the next launch
    __threadfence();
    is_last = atomicAdd(greedy_count, 1) == spans - 1;
  }
  __syncthreads();
  if (!is_last) return;

  // 4. the greedy's last span: the first maximum of its spans' pairs
  bv = -INFINITY;
  bi = RT_NO_INDEX;
  for (int q = tid; q < spans; q += T)
    rt_argmax_pair(bv, bi, __ldcg(&pval[b * spans + q]),
                   __ldcg(&pidx[b * spans + q]));
  rt_block_argmax(bv, bi, sv, si);
  if (tid == 0) {
    best[b] = bi;
    gain[b] = bv;
    *greedy_count = 0;  // ready for the next launch
  }
}

template <class S, int PATH>
static cudaError_t rt_fused_step_spans_path(
    const S* mat, const float* scale, const float* row_in, const float* mask,
    const long long* prev, float* row_out, long long* best, float* gain,
    float* partials, float* pval, int* pidx, int* arrivals, int B, int N,
    int C, int CH, int CPB, RtRule rule, cudaStream_t st) {
  const int P = (N + CH - 1) / CH;
  const int NB = max(1, (P + CPB - 1) / CPB);
  const int spans = (C + RT_FUSED_SPAN - 1) / RT_FUSED_SPAN;
  const size_t smem =
      (size_t)CPB * CH * (rt_scaled<S>() ? 2 : 1) * sizeof(float);
  void* fn = (void*)rt_fused_step_spans_kernel<S, PATH>;
  if (smem > 48 * 1024) {  // beyond the default: opt in (a host call)
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  rt_fused_step_spans_kernel<S, PATH>
      <<<dim3((unsigned)(spans * NB), (unsigned)B), RT_THREADS, smem, st>>>(
          mat, scale, row_in, mask, prev, row_out, best, gain, partials, pval,
          pidx, arrivals, N, C, CH, NB, CPB, rule);
  return cudaGetLastError();
}

template <class S>
static cudaError_t rt_fused_step_spans(const void* mat, const float* scale,
                                       const float* row_in, const float* mask,
                                       const long long* prev, float* row_out,
                                       long long* best, float* gain,
                                       float* partials, float* pval,
                                       int* pidx, int* arrivals, int B, int N,
                                       int C, int CH, int CPB, RtRule rule,
                                       cudaStream_t st) {
  if (CPB <= 0) return cudaErrorInvalidValue;
  const S* m = (const S*)mat;
  constexpr int VW = RtFusedVec<S>::VW;
  if ((uintptr_t)m % 16 != 0)
    return rt_fused_step_spans_path<S, RT_ROWS_SCALAR>(
        m, scale, row_in, mask, prev, row_out, best, gain, partials, pval,
        pidx, arrivals, B, N, C, CH, CPB, rule, st);
  if (C % VW != 0)
    return rt_fused_step_spans_path<S, RT_ROWS_SHIFT>(
        m, scale, row_in, mask, prev, row_out, best, gain, partials, pval,
        pidx, arrivals, B, N, C, CH, CPB, rule, st);
  return rt_fused_step_spans_path<S, RT_ROWS_ALIGNED>(
      m, scale, row_in, mask, prev, row_out, best, gain, partials, pval,
      pidx, arrivals, B, N, C, CH, CPB, rule, st);
}

// The earlier design, kept as the tests' yardstick (reference=True): P =
// N/R blocks of R rows a greedy read every column in scalar loads, write
// (B, P, C) f32 partials to device memory, and the greedy's last block
// sums them alone - the same sums in the same order as the other tiers.
// stamps (B, 3), when not null: the card's clock (ns) as the greedy's
// first block starts (the host sets it to ~0 first), as its last block
// starts the sum, and as that block ends - the two phases' split.
__device__ __forceinline__ unsigned long long rt_globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <class S>
__global__ void __launch_bounds__(RT_THREADS)
    rt_fused_step_global_kernel(const S* __restrict__ mat,
                                const float* __restrict__ scale,
                                const float* __restrict__ row_in,
                                const float* __restrict__ mask,
                                const long long* __restrict__ prev_in,
                                float* __restrict__ row_out,
                                long long* __restrict__ best,
                                float* __restrict__ gain,
                                float* __restrict__ partials,
                                int* __restrict__ arrivals,
                                unsigned long long* __restrict__ stamps,
                                int N, int C, int P, int R, RtRule rule) {
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
  if (stamps != nullptr && tid == 0) atomicMin(&stamps[b * 3], rt_globaltimer());

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
  if (stamps != nullptr && tid == 0) stamps[b * 3 + 1] = rt_globaltimer();

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
    if (stamps != nullptr) stamps[b * 3 + 2] = rt_globaltimer();
  }
}

template <class S>
static cudaError_t rt_fused_step_global(const S* mat, const float* scale,
                                        const float* row_in,
                                        const float* mask,
                                        const long long* prev, float* row_out,
                                        long long* best, float* gain,
                                        float* partials, int* arrivals,
                                        unsigned long long* stamps, int B,
                                        int N, int C, int R, RtRule rule,
                                        cudaStream_t st) {
  const int P = max(1, (N + R - 1) / R);
  const size_t smem = (size_t)R * (rt_scaled<S>() ? 2 : 1) * sizeof(float);
  rt_fused_step_global_kernel<S><<<B * P, RT_THREADS, smem, st>>>(
      mat, scale, row_in, mask, prev, row_out, best, gain, partials,
      arrivals, stamps, N, C, P, R, rule);
  return cudaGetLastError();
}

// the tiers of rt_fused_step (kernels/fused_step.py:TIERS)
#define RT_TIER_CLUSTER 0
#define RT_TIER_GLOBAL 1
#define RT_TIER_EARLIER 2

template <class S>
static cudaError_t rt_fused_step_any(const void* mat, const float* scale,
                                     const float* row_in, const float* mask,
                                     const long long* prev, float* row_out,
                                     long long* best, float* gain,
                                     float* partials, int* pairs,
                                     int* arrivals, void* stamps, int B,
                                     int N, int C, int CH, int tier, int CPB,
                                     RtRule rule, cudaStream_t st) {
  const int spans = (C + RT_FUSED_SPAN - 1) / RT_FUSED_SPAN;
  switch (tier) {
    case RT_TIER_CLUSTER: {
      float* pval = (float*)pairs;
      int* pidx = pairs + (size_t)B * spans * RT_FUSED_CLUSTER_MAX;
      return rt_fused_step_launch<S>(mat, scale, row_in, mask, prev, row_out,
                                     best, gain, pval, pidx, arrivals, B, N,
                                     C, CH, rule, st);
    }
    case RT_TIER_GLOBAL:
      return rt_fused_step_spans<S>(mat, scale, row_in, mask, prev, row_out,
                                    best, gain, partials, (float*)pairs,
                                    pairs + (size_t)B * spans, arrivals, B, N,
                                    C, CH, CPB, rule, st);
    case RT_TIER_EARLIER:
      return rt_fused_step_global<S>((const S*)mat, scale, row_in, mask,
                                     prev, row_out, best, gain, partials,
                                     arrivals, (unsigned long long*)stamps,
                                     B, N, C, CH, rule, st);
  }
  return cudaErrorInvalidValue;
}

// mat: (B, N, C) in `storage` (RT_STORE_F32 | BF16 | INT8); scale: (B, N)
// f32 row scales for int8, else null; CH ground rows a chunk of the sum.
// tier RT_TIER_CLUSTER: pairs 2 * B * ceil(C / 128) * 8 int32 scratch
// (the blocks' gains and columns), arrivals (B,). RT_TIER_GLOBAL:
// partials (B, ceil(N / CH), ceil(C / 128) * 128) f32 scratch, pairs
// 2 * B * ceil(C / 128) int32 (the spans' gains and columns), arrivals
// B * ceil(C / 128) + B, CPB chunks a block. RT_TIER_EARLIER: partials
// (B, ceil(N / CH), C) f32, arrivals (B,), stamps (B, 3) u64 or null.
// The arrivals are zero on entry and left zero. Returns the cudaError_t.
extern "C" int rt_fused_step(const void* mat, const float* scale,
                             const float* row_in, const float* mask,
                             const long long* prev, float* row_out,
                             long long* best, float* gain, float* partials,
                             int* pairs, int* arrivals, void* stamps, int B,
                             int N, int C, int CH, int tier, int CPB,
                             int storage, int fold, float cap, float lam,
                             float lam1, void* stream) {
  if (B == 0) return 0;
  if (N < 0 || C <= 0 || CH <= 0) return (int)cudaErrorInvalidValue;
  const RtRule rule{fold, cap, lam, lam1};
  cudaStream_t st = (cudaStream_t)stream;
  switch (storage) {
    case RT_STORE_F32:
      return (int)rt_fused_step_any<float>(
          mat, scale, row_in, mask, prev, row_out, best, gain, partials,
          pairs, arrivals, stamps, B, N, C, CH, tier, CPB, rule, st);
    case RT_STORE_BF16:
      return (int)rt_fused_step_any<__nv_bfloat16>(
          mat, scale, row_in, mask, prev, row_out, best, gain, partials,
          pairs, arrivals, stamps, B, N, C, CH, tier, CPB, rule, st);
    case RT_STORE_INT8:
      return (int)rt_fused_step_any<int8_t>(
          mat, scale, row_in, mask, prev, row_out, best, gain, partials,
          pairs, arrivals, stamps, B, N, C, CH, tier, CPB, rule, st);
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
