// Streaming whole-greedy loop: all k steps of B greedies in ONE launch.
//
// Replaces the Pallas kernel
// src/repro/kernels/greedy_loop.py:greedy_loop_pallas (_stream_kernel,
// _stream_kernel_quant), the leaf greedy of the main path. Inputs: the
// cached (B, N, C) matrices stored as f32, bf16 or int8 with (B, N) row
// scales, the (B, N) state rows and (B, C) candidate masks. Outputs:
// final rows (B, N), bests (B, k) int32 (-1 = rejected step) and raw
// gains (B, k) f32 - the semantics of kernels/ref.py:greedy_loop.
//
// What bounds it on the H100: device-memory bytes. Each step re-reads
// every greedy's whole cache (32 leaves x 3,284^2 x 4 B = 1.38 GB at the
// Tiny-ImageNet shape, 0.69 GB bf16, 0.345 GB int8, far over the 50 MB
// L2) for ~3 flops per entry: 0.41 / 0.21 / 0.10 ms a step at 3.35 TB/s.
//
// What the design does about it. The TPU ran its (step, row-block) grid
// in order on one core. Here each greedy gets G blocks (the card's
// resident blocks over B: 16 at the leaves), a cooperative launch, and
// only a greedy's own blocks wait for each other - two barriers a step on
// an atomic counter per greedy, none across the grid - so no greedy waits
// for a slower one. A greedy's cache is cut into items: a chunk of CH
// ground rows (P = ceil(N / CH) chunks, CH the plan's block_n) by a span
// of SPAN = 128 f32 or 256 bf16 and int8 columns. Block
// rho takes the items [I rho / G, I (rho + 1) / G) in chunk-major order
// (I = P x spans; at most one item more than another block) and keeps the
// state rows (and int8 scales) of the chunks they touch in shared memory
// for all k steps. A step:
//  1. folds the previous winner's column into those rows (the deferred
//     update; once more after step k, the flush);
//  2. streams its items, a warp an item: a lane takes 4 columns a load,
//     one 16-, 8- or 4-byte load (f32, bf16, int8) when the rows sit on
//     that grid (C % 4 == 0: the leaves' 3,284), W = 1 or 2 such loads a
//     row, 4 rows' loads in flight; an int8 load is widened by a byte
//     permute and one f32 subtraction, times the row's scale (__fmul_rn,
//     rules.dequant's value). Each lane sums its columns' gain parts over
//     the chunk's rows in f32, in row order, and stores the chunk
//     partials to device memory (B, P, spans x SPAN), which stay in L2;
//  3. after the first barrier, block rho sums the P chunk partials of
//     its columns [C rho / G, C (rho + 1) / G) in chunk order (16 loads
//     ahead of the adds) and writes its masked first-argmax pair;
//  4. after the second, every block takes the first maximum of the G
//     pairs (any order gives the same winner) and accepts it if > 0.
// That is the per-step fused kernel's sum in its order (f32 over each
// chunk's rows, then the chunk partials in chunk order), so with the same
// CH the loop gives the bits of k fused_step launches over the same
// cache (the reference says so of its own engines:
// src/repro/kernels/greedy_loop.py:30-34).
//
// Measured at the leaves (PERF.md §6): the per-step kernel's
// 16-byte span pass (span_pass.cuh) run by the loop, with per-span
// cluster barriers and the partials in distributed shared memory, was
// slower (clusters of 16 blocks were not all resident at once, 12 or
// fewer a greedy ran), and over items it still lost to 4-entry loads for
// bf16 and int8 (the shuffles that realign rows off the 16-byte grid);
// int8 with W = 4 or 8 rows in flight spilled registers and was slower.
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
// The accumulation nodes' bitmap loop (the bits branch of
// _resident_kernel) is csrc/greedy_loop_resident.cu's
// rt_resident_bits_kernel: a cluster a node, no grid barrier.
#include <cooperative_groups.h>

#include <algorithm>

#include "span_pass.cuh"

namespace cg = cooperative_groups;

// A span of the loop: a warp's W loads of 4 entries a lane a row (W = 1
// f32, 2 bf16 and int8: 512, 512 and 256 bytes), 128 W columns; U rows'
// loads in flight
template <class S>
struct RtLoopSpan {
  static constexpr int W = sizeof(S) == 4 ? 1 : 2;
  static constexpr int VALUE = 128 * W;
  static constexpr int U = 4;
};

// plan[]: what rt_greedy_loop_plan decides and rt_greedy_loop launches
#define RT_LOOP_PLAN_G 0      // blocks a greedy
#define RT_LOOP_PLAN_WIDTH 1  // a chunk's partials: ceil(C / SPAN) SPAN
#define RT_LOOP_PLAN_LEN 2

struct RtLoopArgs {
  const void* mat;
  const float* scale;
  const float* row_in;
  const float* mask_in;
  float* row_out;
  int* bests;
  float* gains;
  float* partials;  // (B, P, S * SPAN) chunk partials
  float* pval;      // (B, G) the blocks' pairs
  int* pidx;
  int* bar;         // (B,) barrier counters, zero on entry
  int N, C, k, CH, P, S, G;
  int rcap;  // rows a block keeps at most
  int ccap;  // chain columns a block owns at most
  RtRule rule;
};

__host__ __device__ __forceinline__ int rt_up4(int n) { return (n + 3) & ~3; }

// Block rho of G's share of n things: [n rho / G, n (rho + 1) / G).
__host__ __device__ __forceinline__ int rt_share(long long n, int rho,
                                                 int G) {
  return (int)(n * rho / G);
}

// The chunks [j0, j1] whose (chunk, span) items block rho of G takes:
// items i = j * S + span, [I rho / G, I (rho + 1) / G), I = P * S (with
// no span, block 0 keeps every chunk: its rows still pass through).
__host__ __device__ __forceinline__ void rt_loop_chunks(int P, int S, int G,
                                                        int rho, int& j0,
                                                        int& j1) {
  const long long I = (long long)P * S;
  if (I == 0) {
    j0 = 0;
    j1 = rho == 0 ? P - 1 : -1;
    return;
  }
  const int i0 = rt_share(I, rho, G), i1 = rt_share(I, rho + 1, G);
  j0 = i0 / S;
  j1 = i1 > i0 ? (i1 - 1) / S : j0 - 1;
}

// Four consecutive entries of a row as loaded (RtRaw4, span_pass.cuh):
// one load of 16 (f32), 8 (bf16) or 4 (int8) bytes when the row sits on
// that grid (VEC), else one entry at a time packed alike, zeros past the
// row's end (`left` entries remain).
template <bool VEC>
__device__ __forceinline__ float4 rt_load4(const float* m, int left) {
  if (VEC) return __ldg(reinterpret_cast<const float4*>(m));
  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = q < left ? __ldg(m + q) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}
template <bool VEC>
__device__ __forceinline__ uint2 rt_load4(const __nv_bfloat16* m, int left) {
  if (VEC) return __ldg(reinterpret_cast<const uint2*>(m));
  const unsigned short* h = reinterpret_cast<const unsigned short*>(m);
  unsigned v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = q < left ? __ldg(h + q) : 0u;
  return make_uint2(v[0] | (v[1] << 16), v[2] | (v[3] << 16));
}
template <bool VEC>
__device__ __forceinline__ unsigned rt_load4(const int8_t* m, int left) {
  if (VEC) return __ldg(reinterpret_cast<const unsigned*>(m));
  const unsigned char* q8 = reinterpret_cast<const unsigned char*>(m);
  unsigned u = 0u;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (q < left) u |= (unsigned)__ldg(q8 + q) << (8 * q);
  return u;
}

// The barrier among one greedy's G blocks: `bar` counts arrivals,
// `target` the arrivals this block waits for (G more a call).
__device__ __forceinline__ void rt_greedy_sync(int* bar, int G, int& target) {
  __syncthreads();
  target += G;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1);
    while (*(volatile int*)bar < target) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// Grid (G, B), a cooperative launch: block x of greedy y. See the
// module comment.
template <class S, bool VEC>
__global__ void __launch_bounds__(RT_THREADS, RT_FUSED_MINB)
    rt_greedy_loop_kernel(const RtLoopArgs a) {
  constexpr int SPAN = RtLoopSpan<S>::VALUE;
  constexpr int W = RtLoopSpan<S>::W;
  constexpr int U = RtLoopSpan<S>::U;
  extern __shared__ __align__(16) float smem[];
  __shared__ float sv[32];
  __shared__ int si[32];
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = T >> 5;
  const int rho = blockIdx.x;
  const size_t b = blockIdx.y;
  const int N = a.N, C = a.C, CH = a.CH, P = a.P, NS = a.S, G = a.G;
  // this block's items, the chunks they touch and its chain columns
  const long long I = (long long)P * NS;
  const int i0 = rt_share(I, rho, G), i1 = rt_share(I, rho + 1, G);
  int j0, j1;
  rt_loop_chunks(P, NS, G, rho, j0, j1);
  const int r0 = j0 * CH;
  const int nr = max(0, min(N, (j1 + 1) * CH) - r0);
  const int c0 = rt_share(C, rho, G), c1 = rt_share(C, rho + 1, G);
  float* rows = smem;              // (rcap,) the states of rows r0 ..
  float* scl = rows + rt_up4(a.rcap);  // (rcap,) their int8 scales
  float* mk = scl + (rt_scaled<S>() ? rt_up4(a.rcap) : 0);  // (c1 - c0,)
  const S* M = static_cast<const S*>(a.mat);
  const size_t eg = b * (size_t)N * C;  // the greedy's first entry
  const size_t stride = (size_t)NS * SPAN;  // a chunk's partials
  float* part = a.partials + b * P * stride;
  const RtRule rule = a.rule;

  for (int i = tid; i < nr; i += T) {
    rows[i] = a.row_in[b * N + r0 + i];
    if (rt_scaled<S>()) scl[i] = a.scale[b * N + r0 + i];
  }
  for (int c = c0 + tid; c < c1; c += T) mk[c - c0] = a.mask_in[b * C + c];
  __syncthreads();

  int prev = -1;
  int target = 0;
  for (int s = 0; s < a.k; ++s) {
    // deferred update: fold the previous winner's column into the rows
    if (prev >= 0)
      for (int i = tid; i < nr; i += T)
        rows[i] = rt_fold(
            rows[i],
            rt_entry(M, eg + (size_t)(r0 + i) * C + prev,
                     rt_scaled<S>() ? scl[i] : 1.f),
            rule);
    __syncthreads();
    // the chunk partials: a warp an item (chunk, span) at a time, its
    // load x of a row the columns 128 x + 4 lane .. + 3 of the span, U
    // rows' loads in flight; f32 over the chunk's rows in order
    for (int i = i0 + warp; i < i1; i += warps) {
      const int j = i / NS;
      const int cs = (i % NS) * SPAN + lane * 4;
      const int l0 = j * CH - r0;  // the chunk's first row in `rows`
      const int ni = min(CH, N - j * CH);
      const S* m0 = M + eg + (size_t)j * CH * C + cs;
      float acc[W][4];
#pragma unroll
      for (int x = 0; x < W; ++x)
        acc[x][0] = acc[x][1] = acc[x][2] = acc[x][3] = 0.f;
      for (int u0 = 0; u0 < ni; u0 += U) {
        typename RtRaw4<S>::T raw[U][W];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int x = 0; x < W; ++x) {
            const int left = C - cs - 128 * x;
            raw[u][x] = {};
            if (u0 + u < ni && left > 0)
              raw[u][x] =
                  rt_load4<VEC>(m0 + (size_t)(u0 + u) * C + 128 * x, left);
          }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (u0 + u >= ni) break;
          const int li = l0 + u0 + u;
          const float sc = rt_scaled<S>() ? scl[li] : 1.f;
          const float rv = rows[li];
#pragma unroll
          for (int x = 0; x < W; ++x) {
            float e[4];
            rt_widen4(raw[u][x], sc, e);
#pragma unroll
            for (int v = 0; v < 4; ++v)
              acc[x][v] += rt_gain_part(rv, e[v], rule);
          }
        }
      }
#pragma unroll
      for (int x = 0; x < W; ++x)
        *reinterpret_cast<float4*>(part + (size_t)j * stride + cs + 128 * x) =
            make_float4(acc[x][0], acc[x][1], acc[x][2], acc[x][3]);
    }
    rt_greedy_sync(a.bar + b, G, target);
    // the chains of this block's columns: the P chunk partials in chunk
    // order (16 loads ahead of the adds), masked first-argmax
    float bv = -INFINITY;
    int bi = RT_NO_INDEX;
    for (int c = c0 + tid; c < c1; c += T) {
      const float* src = part + c;
      float g = 0.f;
      int j = 0;
      for (; j + 16 <= P; j += 16) {
        float v[16];
#pragma unroll
        for (int u = 0; u < 16; ++u)
          v[u] = __ldcg(src + (size_t)(j + u) * stride);
#pragma unroll
        for (int u = 0; u < 16; ++u) g += v[u];
      }
      for (; j < P; ++j) g += __ldcg(src + (size_t)j * stride);
      rt_argmax_pair(bv, bi, mk[c - c0] > 0.f ? g : -INFINITY, c);
    }
    rt_block_argmax(bv, bi, sv, si);
    if (tid == 0) {
      a.pval[b * G + rho] = bv;
      a.pidx[b * G + rho] = bi;
    }
    rt_greedy_sync(a.bar + b, G, target);
    // the greedy's winner, in every block
    bv = -INFINITY;
    bi = RT_NO_INDEX;
    for (int q = tid; q < G; q += T)
      rt_argmax_pair(bv, bi, __ldcg(&a.pval[b * G + q]),
                     __ldcg(&a.pidx[b * G + q]));
    rt_block_argmax(bv, bi, sv, si);
    const bool accept = rt_finite(bv) && bv > 0.f;
    if (accept && tid == 0 && bi >= c0 && bi < c1) mk[bi - c0] = 0.f;
    if (rho == 0 && tid == 0) {
      a.bests[b * a.k + s] = accept ? bi : -1;
      a.gains[b * a.k + s] = bv;
    }
    prev = accept ? bi : -1;
  }
  // flush: fold the final accepted winner; a chunk's rows are written by
  // the block that holds its first item
  const int w0 = NS > 0 ? (i0 + NS - 1) / NS : j0;  // first chunk starting here
  for (int i = tid; i < nr; i += T) {
    if ((r0 + i) / CH < w0) continue;
    float v = rows[i];
    if (prev >= 0)
      v = rt_fold(v,
                  rt_entry(M, eg + (size_t)(r0 + i) * C + prev,
                           rt_scaled<S>() ? scl[i] : 1.f),
                  rule);
    a.row_out[b * N + r0 + i] = v;
  }
}

// Whether every row of the (N, C) `S` matrices at mat starts on the grid
// of its 4-entry loads.
template <class S>
static bool rt_loop_vec(const void* mat, int C) {
  return C % 4 == 0 && (uintptr_t)mat % (4 * sizeof(S)) == 0;
}

template <class S>
static const void* rt_loop_fn(bool vec) {
  return vec ? (const void*)rt_greedy_loop_kernel<S, true>
             : (const void*)rt_greedy_loop_kernel<S, false>;
}

// The rows and chain columns the busiest of G blocks a greedy keeps.
static void rt_loop_caps(int N, int C, int CH, int S, int G, int& rcap,
                         int& ccap) {
  const int P = (N + CH - 1) / CH;
  rcap = ccap = 0;
  for (int rho = 0; rho < G; ++rho) {
    int j0, j1;
    rt_loop_chunks(P, S, G, rho, j0, j1);
    rcap = std::max(rcap, std::min(N, (j1 + 1) * CH) - j0 * CH);
    ccap = std::max(ccap, rt_share(C, rho + 1, G) - rt_share(C, rho, G));
  }
}

// Dynamic shared memory of a block: rows' states, int8 scales, mask.
template <class S>
static int rt_loop_smem(int rcap, int ccap) {
  return (rt_up4(rcap) * (rt_scaled<S>() ? 2 : 1) + ccap) * (int)sizeof(float);
}

// Fill plan[RT_LOOP_PLAN_LEN]: every block the card holds at once, split
// over the B greedies (no more blocks a greedy than items).
template <class S>
static cudaError_t rt_loop_plan(const void* mat, int B, int N, int C, int CH,
                                int* plan) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&smem_max,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  smem_max -= 1024;  // the static argmax scratch
  constexpr int SPAN = RtLoopSpan<S>::VALUE;
  const int spans = (C + SPAN - 1) / SPAN;
  const long long items = (long long)((N + CH - 1) / CH) * spans;
  const void* fn = rt_loop_fn<S>(rt_loop_vec<S>(mat, C));
  plan[RT_LOOP_PLAN_WIDTH] = spans * SPAN;
  for (int G = (int)std::max(1LL, std::min<long long>(
                                      RT_FUSED_MINB * sms / std::max(1, B),
                                      items));
       G >= 1;) {
    int rcap, ccap;
    rt_loop_caps(N, C, CH, spans, G, rcap, ccap);
    const int smem = rt_loop_smem<S>(rcap, ccap);
    int bps = 0;
    if (smem <= smem_max) {
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      if (e != cudaSuccess) return e;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, fn, RT_THREADS,
                                                        (size_t)smem);
      if (e != cudaSuccess) return e;
    }
    const long long cap = (long long)bps * sms;
    if (smem <= smem_max && (long long)B * G <= cap) {
      plan[RT_LOOP_PLAN_G] = G;
      return cudaSuccess;
    }
    // fewer blocks a greedy: those the card holds, or one less
    G = (int)std::min<long long>(G - 1, cap / std::max(1, B));
  }
  return cudaErrorCooperativeLaunchTooLarge;
}

template <class S>
static cudaError_t rt_loop_launch(RtLoopArgs a, int B, const int* plan,
                                  cudaStream_t st) {
  constexpr int SPAN = RtLoopSpan<S>::VALUE;
  a.G = plan[RT_LOOP_PLAN_G];
  a.S = (a.C + SPAN - 1) / SPAN;
  a.P = (a.N + a.CH - 1) / a.CH;
  if (a.G < 1) return cudaErrorInvalidValue;
  rt_loop_caps(a.N, a.C, a.CH, a.S, a.G, a.rcap, a.ccap);
  const int smem = rt_loop_smem<S>(a.rcap, a.ccap);
  const void* fn = rt_loop_fn<S>(rt_loop_vec<S>(a.mat, a.C));
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  void* args[] = {(void*)&a};
  return cudaLaunchCooperativeKernel(fn, dim3((unsigned)a.G, (unsigned)B),
                                     dim3(RT_THREADS), args, (size_t)smem,
                                     st);
}

// The launch plan of the streaming loop over a (B, N, C) `storage` cache
// at mat, chunks of CH rows: plan[0] blocks a greedy, plan[1] the spans'
// columns. Its scratch: partials (B, ceil(N / CH), plan[1]) f32, pairs
// (B, plan[0]) f32 and int32, counters (B,) int32 zeroed. Returns the
// cudaError_t.
extern "C" int rt_greedy_loop_plan(int storage, const void* mat, int B,
                                   int N, int C, int CH, int* plan) {
  if (B <= 0 || N < 0 || C < 0 || CH <= 0) return (int)cudaErrorInvalidValue;
  switch (storage) {
    case RT_STORE_F32:
      return (int)rt_loop_plan<float>(mat, B, N, C, CH, plan);
    case RT_STORE_BF16:
      return (int)rt_loop_plan<__nv_bfloat16>(mat, B, N, C, CH, plan);
    case RT_STORE_INT8:
      return (int)rt_loop_plan<int8_t>(mat, B, N, C, CH, plan);
  }
  return (int)cudaErrorInvalidValue;
}

// mat: (B, N, C) in `storage` (RT_STORE_F32 | BF16 | INT8); scale: (B, N)
// f32 row scales for int8, else null; CH ground rows a chunk of the sum;
// plan and scratch from rt_greedy_loop_plan. Returns the cudaError_t.
extern "C" int rt_greedy_loop(const void* mat, const float* scale,
                              const float* row_in, const float* mask_in,
                              float* row_out, int* bests, float* gains,
                              float* partials, float* pval, int* pidx,
                              int* bar, int B, int N, int C, int k, int CH,
                              const int* plan, int storage, int fold,
                              float cap, float lam, float lam1,
                              void* stream) {
  if (B == 0) return 0;
  if (N < 0 || C < 0 || CH <= 0) return (int)cudaErrorInvalidValue;
  RtLoopArgs a = {};
  a.mat = mat;
  a.scale = scale;
  a.row_in = row_in;
  a.mask_in = mask_in;
  a.row_out = row_out;
  a.bests = bests;
  a.gains = gains;
  a.partials = partials;
  a.pval = pval;
  a.pidx = pidx;
  a.bar = bar;
  a.N = N;
  a.C = C;
  a.k = k;
  a.CH = CH;
  a.rule = RtRule{fold, cap, lam, lam1};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaErrorInvalidValue;
  switch (storage) {
    case RT_STORE_F32:
      e = rt_loop_launch<float>(a, B, plan, st);
      break;
    case RT_STORE_BF16:
      e = rt_loop_launch<__nv_bfloat16>(a, B, plan, st);
      break;
    case RT_STORE_INT8:
      e = rt_loop_launch<int8_t>(a, B, plan, st);
      break;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(RT_THREADS)
    rt_greedy_loop_bits_kernel(const unsigned* __restrict__ cands,
                               const unsigned* __restrict__ row_in,
                               const float* __restrict__ mask_in,
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

  for (int w = tid; w < W; w += T) covered[w] = row_in[(size_t)b * W + w];
  for (int i = tid; i < nc; i += T) mask[i] = mask_in[(size_t)b * C + c0 + i];
  __syncthreads();

  for (int s = 0; s < k; ++s) {
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

// cands (B, C, W) and rows (B, W) 32-bit words; pval/pidx: (2, B, P)
// scratch; CB candidates per block, P = ceil(C / CB), all B * P blocks
// co-resident. Returns the cudaError_t.
extern "C" int rt_greedy_loop_bits(const unsigned* cands, const unsigned* row_in,
                                   const float* mask_in, unsigned* row_out,
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
                  (void*)&row_out, (void*)&bests,
                  (void*)&gains,  (void*)&pval,   (void*)&pidx,
                  (void*)&B,      (void*)&C,      (void*)&W,
                  (void*)&k,      (void*)&P,      (void*)&CB};
  e = cudaLaunchCooperativeKernel((void*)rt_greedy_loop_bits_kernel,
                                  dim3(B * P), dim3(RT_THREADS), args,
                                  (size_t)smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
