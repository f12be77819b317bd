// Resident whole-greedy loop: build every node's matrix and run all k
// steps of every node of a level in ONE dispatch.
//
// Replaces the Pallas kernel
// src/repro/kernels/greedy_loop.py:greedy_loop_resident_pallas
// (_resident_kernel), the accumulation-node greedy of the main path.
// Inputs: ground (B, N, D) and candidate (B, C, D) features, state rows
// (B, N), masks (B, C) and ctl (B, 3) int32 = [kq, logical_n, logical_c].
// Steps s >= kq freeze (bests -1, gains 0), as in the reference; the
// logical extents bound the sub-f32 rounding (below). Outputs as
// kernels/ref.py:greedy_loop over the matrix it builds.
//
// What bounds it on the H100: operations, in the build. At a level-1
// node of the Tiny-ImageNet configuration (16 nodes, N = C = 400,
// D = 12,288) the build is 2*B*N*C*D ~ 6.3e10 fp32 flops while the k
// steps add ~3*k*B*N*C ~ 1.5e9 flops over matrices that fit on chip.
//
// What the design does about it. A TPU core held the whole node in VMEM;
// a 400x400 f32 matrix (640 KB) does not fit one block's 227 KB of shared
// memory, but it fits a cluster of 8 blocks. A dispatch is two launches,
// counted as one:
//  1. the build, over the whole card: every (node, tile) is a block of
//     rt_resident_build_kernel, a register-tiled fp32 product with the
//     features walked in slices of 8 through a two-stage shared-memory
//     ring (tile128.cuh's loop, generalized), each 'dist' row's float64
//     norm chain run by one thread over the staged slices. The tile is
//     128x128 (8x8 a thread) while a level's tiles cover half the SMs,
//     else 40x40 (4x4 a thread): at levels of 4 or fewer 400-row nodes
//     one tile's latency sets the time. Each entry is one f32 fmaf chain
//     over ascending features from 0 and its norms the float64 chains of
//     the 64x64 tile, so every entry equals that tile's and the pairwise
//     kernel's bit for bit. The f32 build lands in a (B, N, C) device
//     scratch (written once, read once);
//  2. the steps, a cluster of RT_RES_CLUSTER = 8 blocks a node: rank r
//     holds ground-row chunks [r P / 8, (r + 1) P / 8) of CH rows (P =
//     ceil(N / CH), CH the plan's block_n). It reads its rows of the f32
//     build and rounds them as whole rows into the plan's storage - bf16
//     to nearest even; int8 by rules.quantize_rows: entries outside the
//     node's logical extents ctl[1], ctl[2] zeroed first, then the row's
//     absmax, scale = absmax / 127 (IEEE division; 1 for a zero row),
//     q = clamp(rint(m / scale), +-127) (half to even, as torch.round) -
//     what round_resident gives, bit for bit, and writes the rounded f32
//     values back to the scratch (the matrix the loop ran over, for
//     checks). The rows stay in the block's shared memory in the storage
//     dtype (640 / 320 / 160 KB a 400x400 node over the cluster's 8 x 227
//     KB). A step folds the previous winner into the rows, sums each
//     chunk's gain parts in f32 over its rows in row order (4 columns a
//     thread), leaves the chunk partials in shared memory, meets the
//     cluster's other blocks at ONE cluster barrier, and every block adds
//     every column's P chunk partials in chunk order through distributed
//     shared memory and takes the masked first-argmax itself (partials
//     alternate between two buffers by step parity, so no second barrier
//     is needed before the next step writes). That is the streaming
//     loop's sum in its order (greedy_loop.cu with the same CH), so the
//     resident loop gives the bits of greedy_loop over its own matrix.
//     Steps s >= kq stop the node (bests -1, gains 0); the last winner is
//     folded in once more (the flush).
// Where a node's rows do not fit its cluster's shared memory (the
// storage, the partials and the state), the same steps read the rounded
// matrix from a (B, N, Cp) device copy in the storage dtype and keep the
// partials in device memory (rt_greedy_loop_resident_plan says which).
//
// The bitmap rule (coverage) has nothing to build: its branch of
// _resident_kernel is rt_resident_bits_kernel, at the end of this file.
#include <cooperative_groups.h>

#include <climits>

#include "pairwise_tile.cuh"
#include "span_pass.cuh"

namespace cg = cooperative_groups;

#define RT_RES_CLUSTER 8  // blocks a node's cluster

// The build tile: TY x TX threads, each an MT x MT register micro-tile of
// rows h * 4 TY + 4 ty + i and columns h * 4 TX + 4 tx + j (h < MT / 4,
// i, j < 4), so a feature step reads MT / 2 16-byte shared-memory
// vectors for MT^2 FMAs; features in slices of KS.
template <int MT, int TY, int TX, int KS>
struct RtBuildTile {
  static constexpr int BM = MT * TY;
  static constexpr int BN = MT * TX;
  static constexpr int NT = TY * TX;
  static constexpr int LDA = BM + 4;
  static constexpr int LDB = BN + 4;
  // 16-byte loader slots a slice (a row's KS features are KS / 4)
  static constexpr int SLOTS = (BM + BN) * (KS / 4);
  static constexpr int NS = (SLOTS + NT - 1) / NT;  // a thread's
};

// Grid (tiles of a node, B): the (BM x BN) tile of node y's f32 matrix.
// For 'dist' the first BM + BN threads also run their tile row's float64
// norm chain over the staged slices (fma(v, v, .) in ascending feature
// order, cast once to f32: the 64x64 tile's and rt_norms' chain). VEC:
// D % 4 == 0 and 16-byte aligned operands (else scalar loads).
template <int MT, int TY, int TX, int MINB, bool VEC>
__global__ void __launch_bounds__(TY * TX, MINB)
    rt_resident_build_kernel(const float* __restrict__ ground,
                             const float* __restrict__ cands,
                             float* __restrict__ mat, int N, int C, int D,
                             int mode) {
  constexpr int KS = 8;
  using T = RtBuildTile<MT, TY, TX, KS>;
  static_assert(T::BM + T::BN <= T::NT, "a norm chain a thread");
  __shared__ __align__(16) float sa[2][KS][T::LDA];
  __shared__ __align__(16) float sb[2][KS][T::LDB];
  __shared__ float nrm[T::BM + T::BN];  // the rows' f32 squared norms
  const int t = threadIdx.x;
  const int tc = (C + T::BN - 1) / T::BN;
  const int n0 = (int)(blockIdx.x / tc) * T::BM;
  const int c0 = (int)(blockIdx.x % tc) * T::BN;
  const size_t b = blockIdx.y;
  const float* G = ground + b * N * D;
  const float* Cd = cands + b * C * D;

  // loader: slot s takes features (s & 1) * 4 .. + 3 of operand row s / 2
  // (the tile's ground rows, then its candidate rows)
  float reg[T::NS][4];
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < T::NS; ++u) {
      const int s = t + u * T::NT;
      const int row = s >> 1;
      const int kk = k0 + (s & 1) * 4;
      const bool isa = row < T::BM;
      const int rr = isa ? n0 + row : c0 + row - T::BM;
      const bool in = s < T::SLOTS && rr < (isa ? N : C);
      const float* p = (isa ? G : Cd) + (size_t)(in ? rr : 0) * D + kk;
      if constexpr (VEC) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (in && kk < D) v = __ldg(reinterpret_cast<const float4*>(p));
        reg[u][0] = v.x, reg[u][1] = v.y, reg[u][2] = v.z, reg[u][3] = v.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          reg[u][q] = in && kk + q < D ? __ldg(p + q) : 0.f;
      }
    }
  };
  auto stage = [&](int st) {
#pragma unroll
    for (int u = 0; u < T::NS; ++u) {
      const int s = t + u * T::NT;
      if (s >= T::SLOTS) continue;
      const int row = s >> 1;
      const int kk = (s & 1) * 4;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (row < T::BM)
          sa[st][kk + q][row] = reg[u][q];
        else
          sb[st][kk + q][row - T::BM] = reg[u][q];
      }
    }
  };

  const int tx = t % TX;
  const int ty = t / TX;
  const bool norms = mode == RT_MODE_DIST && t < T::BM + T::BN;
  double nacc = 0.0;
  float acc[MT][MT];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j) acc[i][j] = 0.f;
  load(0);
  stage(0);
  __syncthreads();
  int st = 0;
  for (int k0 = 0; k0 < D; k0 += KS) {
    const bool more = k0 + KS < D;
    if (more) load(k0 + KS);  // in flight during the multiply
    if (norms) {
      const float* col = t < T::BM ? &sa[st][0][t] : &sb[st][0][t - T::BM];
      const int ld = t < T::BM ? T::LDA : T::LDB;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const double v = col[kk * ld];
        nacc = fma(v, v, nacc);
      }
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      float a[MT], bv[MT];
#pragma unroll
      for (int h = 0; h < MT / 4; ++h) {
        const float4 x =
            *reinterpret_cast<const float4*>(&sa[st][kk][h * 4 * TY + ty * 4]);
        const float4 y =
            *reinterpret_cast<const float4*>(&sb[st][kk][h * 4 * TX + tx * 4]);
        a[4 * h] = x.x, a[4 * h + 1] = x.y, a[4 * h + 2] = x.z,
                  a[4 * h + 3] = x.w;
        bv[4 * h] = y.x, bv[4 * h + 1] = y.y, bv[4 * h + 2] = y.z,
                   bv[4 * h + 3] = y.w;
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < MT; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    if (more) stage(st ^ 1);
    // one barrier a slice: the other stage is written, and every thread
    // is done reading this one before the next slice overwrites it
    __syncthreads();
    st ^= 1;
  }
  if (norms) nrm[t] = (float)nacc;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int ri = (i >> 2) * 4 * TY + ty * 4 + (i & 3);
    const int r = n0 + ri;
    if (r >= N) continue;
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int cj = (j >> 2) * 4 * TX + tx * 4 + (j & 3);
      const int c = c0 + cj;
      if (c >= C) continue;
      mat[(b * N + r) * C + c] =
          rt_entry_value(nrm[ri], nrm[T::BM + cj], acc[i][j], mode);
    }
  }
}

// The build tiles: 128x128 (8x8 a thread, 2 blocks an SM) while a
// level's 128-row tiles cover half the SMs, else 40x40 (4x4 a thread, 100
// threads): at levels of 4 or fewer 400-row nodes one tile's latency
// sets the time, and the 40x40 tiles spread a node over more SMs.
template <bool VEC>
static const void* rt_build_fn(bool big) {
  return big ? (const void*)rt_resident_build_kernel<8, 16, 16, 2, VEC>
             : (const void*)rt_resident_build_kernel<4, 10, 10, 8, VEC>;
}

static bool rt_build_big(int B, int N, int C, int sms) {
  return 2LL * B * ((N + 127) / 128) * ((C + 127) / 128) >= sms;
}

struct RtResArgs {
  float* mat;          // (B, N, C) f32 build; sub-f32: rounded in place
  void* typed;         // device tier: (B, N, Cp) in storage, else null
  float* partials;     // device tier: (B, 2, P, Cp) f32
  const float* row_in;
  const float* mask_in;
  const int* ctl;
  float* row_out;
  int* bests;
  float* gains;
  int N, C, Cp, k, CH, P, cpb;
  RtRule rule;
};

// Four entries of a stored row (shared or device memory) from column c,
// a multiple of 4, as f32.
template <class S>
__device__ __forceinline__ void rt_load_cols4(const S* row, int c, float s,
                                              float (&e)[4]) {
  rt_widen4(*reinterpret_cast<const typename RtRaw4<S>::T*>(row + c), s, e);
}

// Round one f32 row (C entries; the logical ones lc) into the storage:
// f32 as built; bf16 to nearest even; int8 by rules.quantize_rows. Writes
// the stored row (Cp entries, zeros past C) and, for sub-f32 storage, the
// rounded f32 values back over src; returns the int8 row's scale (1
// otherwise). One warp a row.
__device__ __forceinline__ float rt_round_row(float* src, float* dst,
                                              int C, int Cp, int) {
  const int lane = threadIdx.x & 31;
  for (int c = lane; c < Cp; c += 32) dst[c] = c < C ? src[c] : 0.f;
  return 1.f;
}
__device__ __forceinline__ float rt_round_row(float* src, __nv_bfloat16* dst,
                                              int C, int Cp, int lc) {
  const int lane = threadIdx.x & 31;
  for (int c = lane; c < Cp; c += 32) {
    const __nv_bfloat16 v = __float2bfloat16_rn(c < lc ? src[c] : 0.f);
    dst[c] = v;
    if (c < C) src[c] = __bfloat162float(v);
  }
  return 1.f;
}
__device__ __forceinline__ float rt_round_row(float* src, int8_t* dst, int C,
                                              int Cp, int lc) {
  const int lane = threadIdx.x & 31;
  float amax = 0.f;
  for (int c = lane; c < lc; c += 32) amax = fmaxf(amax, fabsf(src[c]));
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
  for (int c = lane; c < Cp; c += 32) {
    const float q =
        c < lc ? fminf(fmaxf(rintf(__fdiv_rn(src[c], scale)), -127.f), 127.f)
               : 0.f;
    // through int: q = -0 (a small negative entry) stores +0, as int8 does
    const int qi = (int)q;
    dst[c] = (int8_t)qi;
    if (c < C) src[c] = __fmul_rn((float)qi, scale);
  }
  return scale;
}

// Bytes of the stored rows of cpb chunks of CH rows, 16-byte aligned.
template <class S>
__host__ __device__ __forceinline__ size_t rt_res_rows_bytes(int cpb, int CH,
                                                             int Cp) {
  return ((size_t)cpb * CH * Cp * sizeof(S) + 15) & ~(size_t)15;
}

// Dynamic shared memory of a step block: ONCHIP, its stored rows and the
// (2, cpb, Cp) chunk partials; always the P chunks' partial addresses,
// the rows' states and int8 scales and the node's mask as bits.
template <class S>
__host__ __device__ __forceinline__ size_t rt_res_smem(int cpb, int CH,
                                                       int C, int Cp, int P,
                                                       bool onchip) {
  size_t bytes = (size_t)P * sizeof(float*) +
                 (size_t)2 * cpb * CH * sizeof(float) +
                 (size_t)((C + 31) / 32) * sizeof(unsigned);
  if (onchip)
    bytes += rt_res_rows_bytes<S>(cpb, CH, Cp) +
             (size_t)2 * cpb * Cp * sizeof(float);
  return bytes;
}

// Grid (8, B), clusters of 8 along x: rank x of node y. See the module
// comment (step 2).
template <class S, bool ONCHIP>
__global__ void __launch_bounds__(RT_THREADS)
    rt_resident_steps_kernel(const RtResArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float sv[32];
  __shared__ int si[32];
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int r = blockIdx.x;
  const size_t b = blockIdx.y;
  const int N = a.N, C = a.C, Cp = a.Cp, CH = a.CH, P = a.P, cpb = a.cpb;
  const int q0 = r * P / RT_RES_CLUSTER;
  const int nq = (r + 1) * P / RT_RES_CLUSTER - q0;
  const int r0 = q0 * CH;
  const int nr = max(0, min(N - r0, nq * CH));
  // shared memory: [stored rows, partials (ONCHIP)], the chunks' partial
  // addresses, states, scales, mask
  unsigned char* p = smem_raw;
  S* mrows = nullptr;
  float* part = nullptr;
  if constexpr (ONCHIP) {
    mrows = reinterpret_cast<S*>(p);
    p += rt_res_rows_bytes<S>(cpb, CH, Cp);
    part = reinterpret_cast<float*>(p);
    p += (size_t)2 * cpb * Cp * sizeof(float);
  } else {
    mrows = static_cast<S*>(a.typed) + (b * N + r0) * Cp;
  }
  const float** csrc = reinterpret_cast<const float**>(p);
  p += (size_t)P * sizeof(float*);
  float* rows = reinterpret_cast<float*>(p);
  float* scl = rows + cpb * CH;
  unsigned* mbits = reinterpret_cast<unsigned*>(scl + cpb * CH);
  const RtRule rule = a.rule;
  const int warp = tid >> 5;
  const int warps = T >> 5;

  // round this rank's rows of the build into the storage
  const int ln = a.ctl[b * 3 + 1];
  const int lcx = min(C, a.ctl[b * 3 + 2]);
  for (int i = warp; i < nr; i += warps) {
    const int gr = r0 + i;
    const float s = rt_round_row(a.mat + (b * N + gr) * C,
                                 mrows + (size_t)i * Cp, C, Cp,
                                 gr < ln ? lcx : 0);
    if ((tid & 31) == 0) scl[i] = s;
  }
  for (int i = tid; i < nr; i += T) rows[i] = a.row_in[b * N + r0 + i];
  // chunk j's partials (buffer 0): rank o's shared memory, or device
  for (int j = tid; j < P; j += T) {
    int o = 0;
    while ((o + 1) * P / RT_RES_CLUSTER <= j) ++o;
    const int jl = j - o * P / RT_RES_CLUSTER;
    if constexpr (ONCHIP)
      csrc[j] = cl.map_shared_rank(part, o) + (size_t)jl * Cp;
    else
      csrc[j] = a.partials + (b * 2 * P + j) * Cp;
  }
  for (int w = tid; w < (C + 31) / 32; w += T) {
    unsigned bits = 0u;
    for (int q = 0; q < 32 && w * 32 + q < C; ++q)
      if (a.mask_in[b * C + w * 32 + q] > 0.f) bits |= 1u << q;
    mbits[w] = bits;
  }
  __syncthreads();

  const int kq = min(a.k, a.ctl[b * 3]);
  const int groups = Cp / 4;  // 4 columns a thread
  int prev = -1;
  for (int s = 0; s < kq; ++s) {
    // deferred update: fold the previous winner's column into the rows
    if (prev >= 0)
      for (int i = tid; i < nr; i += T)
        rows[i] = rt_fold(rows[i], rt_entry(mrows, (size_t)i * Cp + prev,
                                            rt_scaled<S>() ? scl[i] : 1.f),
                          rule);
    __syncthreads();
    // the chunk partials: f32 over each chunk's rows in row order
    for (int w = tid; w < nq * groups; w += T) {
      const int j = w / groups;
      const int c = (w % groups) * 4;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const int i1 = min(nr, (j + 1) * CH);
      for (int i = j * CH; i < i1; ++i) {
        float e[4];
        rt_load_cols4(mrows + (size_t)i * Cp, c,
                      rt_scaled<S>() ? scl[i] : 1.f, e);
        const float rv = rows[i];
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[v] += rt_gain_part(rv, e[v], rule);
      }
      float* dst = ONCHIP ? part + ((size_t)(s & 1) * cpb + j) * Cp + c
                          : a.partials +
                                ((b * 2 + (s & 1)) * P + q0 + j) * Cp + c;
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    cl.sync();
    // every block: each column's P partials in chunk order (16 loads
    // ahead of the adds), masked first-argmax
    const size_t boff = (size_t)(s & 1) * (ONCHIP ? cpb : P) * Cp;
    float bv = -INFINITY;
    int bi = RT_NO_INDEX;
    for (int c = tid; c < C; c += T) {
      float g = 0.f;
      for (int j0 = 0; j0 < P; j0 += 16) {
        float v[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const float* q = csrc[min(j0 + u, P - 1)] + boff + c;
          v[u] = ONCHIP ? *q : __ldcg(q);
        }
#pragma unroll
        for (int u = 0; u < 16; ++u)
          if (j0 + u < P) g += v[u];
      }
      const bool live = (mbits[c >> 5] >> (c & 31)) & 1u;
      rt_argmax_pair(bv, bi, live ? g : -INFINITY, c);
    }
    rt_block_argmax(bv, bi, sv, si);
    const bool accept = rt_finite(bv) && bv > 0.f;
    if (accept && tid == 0) mbits[bi >> 5] &= ~(1u << (bi & 31));
    if (r == 0 && tid == 0) {
      a.bests[b * a.k + s] = accept ? bi : -1;
      a.gains[b * a.k + s] = bv;
    }
    prev = accept ? bi : -1;
  }
  if (r == 0)  // frozen steps
    for (int s = kq + tid; s < a.k; s += T) {
      a.bests[b * a.k + s] = -1;
      a.gains[b * a.k + s] = 0.f;
    }
  // flush: fold the final accepted winner
  __syncthreads();
  for (int i = tid; i < nr; i += T) {
    float v = rows[i];
    if (prev >= 0)
      v = rt_fold(v, rt_entry(mrows, (size_t)i * Cp + prev,
                              rt_scaled<S>() ? scl[i] : 1.f),
                  rule);
    a.row_out[b * N + r0 + i] = v;
  }
  // no block leaves while another may still read its partials
  cl.sync();
}

template <class S>
static const void* rt_steps_fn(bool onchip) {
  return onchip ? (const void*)rt_resident_steps_kernel<S, true>
                : (const void*)rt_resident_steps_kernel<S, false>;
}

static int rt_res_cp(int C) { return (C + 15) & ~15; }

template <class S>
static size_t rt_res_need(int N, int C, int CH, bool onchip) {
  const int P = (N + CH - 1) / CH;
  const int cpb = (P + RT_RES_CLUSTER - 1) / RT_RES_CLUSTER;
  return rt_res_smem<S>(cpb, CH, C, rt_res_cp(C), P, onchip);
}

static int rt_smem_max() {
  int dev = 0, smem = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return smem - 1024;  // the static argmax scratch
}

template <class S>
static cudaError_t rt_res_launch(const float* ground, const float* cands,
                                 RtResArgs a, int B, int D, int mode,
                                 cudaStream_t st) {
  cudaError_t e;
  const int N = a.N, C = a.C;
  // 1. the build
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const bool big = rt_build_big(B, N, C, sms);
  const int bm = big ? 128 : 40;
  const bool vec = D % 4 == 0 && (uintptr_t)ground % 16 == 0 &&
                   (uintptr_t)cands % 16 == 0;
  if (N > 0 && C > 0) {
    float* mat = a.mat;
    void* bargs[] = {(void*)&ground, (void*)&cands, (void*)&mat,
                     (void*)&a.N,    (void*)&a.C,   (void*)&D,
                     (void*)&mode};
    const dim3 grid((unsigned)(((N + bm - 1) / bm) * ((C + bm - 1) / bm)),
                    (unsigned)B);
    e = cudaLaunchKernel(vec ? rt_build_fn<true>(big) : rt_build_fn<false>(big),
                         grid, dim3(big ? 256 : 100), bargs, 0, st);
    if (e != cudaSuccess) return e;
  }
  // 2. the steps, a cluster a node
  const bool onchip = a.typed == nullptr;
  const size_t smem = rt_res_need<S>(N, C, a.CH, onchip);
  if (smem > (size_t)rt_smem_max()) return cudaErrorInvalidValue;
  const void* fn = rt_steps_fn<S>(onchip);
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(RT_RES_CLUSTER, (unsigned)B);
  cfg.blockDim = dim3(RT_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = RT_RES_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {(void*)&a};
  return cudaLaunchKernelExC(&cfg, fn, args);
}

// Whether a node's steps run on chip (1) or over a device copy (0) at
// (N, C) in `storage` with chunks of CH rows; plan[1] the stored rows'
// padded width Cp. The device tier's scratch: typed (B, N, Cp) in the
// storage, partials (B, 2, ceil(N / CH), Cp) f32. Returns the
// cudaError_t.
extern "C" int rt_greedy_loop_resident_plan(int storage, int N, int C,
                                            int CH, int* plan) {
  if (N < 0 || C < 0 || CH <= 0) return (int)cudaErrorInvalidValue;
  const size_t max = (size_t)rt_smem_max();
  size_t need;
  switch (storage) {
    case RT_STORE_F32:
      need = rt_res_need<float>(N, C, CH, true);
      break;
    case RT_STORE_BF16:
      need = rt_res_need<__nv_bfloat16>(N, C, CH, true);
      break;
    case RT_STORE_INT8:
      need = rt_res_need<int8_t>(N, C, CH, true);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  plan[0] = need <= max ? 1 : 0;
  plan[1] = rt_res_cp(C);
  return 0;
}

// ground (B, N, D), cands (B, C, D) f32; mat (B, N, C) f32 scratch (the
// build; sub-f32 storage: rounded in place); typed / partials: the
// device tier's scratch (rt_greedy_loop_resident_plan), null on chip; CH ground
// rows a chunk of the gain sum. Returns the cudaError_t.
extern "C" int rt_greedy_loop_resident(
    const float* ground, const float* cands, const float* row_in,
    const float* mask_in, const int* ctl, float* mat, void* typed,
    float* partials, float* row_out, int* bests,
    float* gains, int B, int N, int C, int D, int k, int CH, int mode,
    int storage, int fold, float cap, float lam, float lam1, void* stream) {
  if (B == 0) return 0;
  if (N < 0 || C < 0 || D < 0 || CH <= 0) return (int)cudaErrorInvalidValue;
  RtResArgs a = {};
  a.mat = mat;
  a.typed = typed;
  a.partials = partials;
  a.row_in = row_in;
  a.mask_in = mask_in;
  a.ctl = ctl;
  a.row_out = row_out;
  a.bests = bests;
  a.gains = gains;
  a.N = N;
  a.C = C;
  a.Cp = rt_res_cp(C);
  a.k = k;
  a.CH = CH;
  a.P = (N + CH - 1) / CH;
  a.cpb = (a.P + RT_RES_CLUSTER - 1) / RT_RES_CLUSTER;
  a.rule = RtRule{fold, cap, lam, lam1};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaErrorInvalidValue;
  switch (storage) {
    case RT_STORE_F32:
      e = rt_res_launch<float>(ground, cands, a, B, D, mode, st);
      break;
    case RT_STORE_BF16:
      e = rt_res_launch<__nv_bfloat16>(ground, cands, a, B, D, mode, st);
      break;
    case RT_STORE_INT8:
      e = rt_res_launch<int8_t>(ground, cands, a, B, D, mode, st);
      break;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bitmap rule (coverage): the bits branch of _resident_kernel
// ---------------------------------------------------------------------------
//
// There R.matrix_block is c.T: a node's on-chip matrix is the transpose
// of its (C, W) candidate words, so nothing is built and the words are
// read in place. Inputs: cands (B, C, W) and rows (B, W) 32-bit words,
// masks (B, C) 0/1 f32, ctl (B, 3) int32 (only kq = ctl[b][0] is read).
// Outputs as kernels/ref.py:greedy_loop with kq: the masked first-argmax
// of the popcount gains, accepted only when > 0, steps s >= kq frozen
// (bests -1, gains 0), the row after the last accepted winner. The
// gains are exact integer sums, so any order gives the same bits.
//
// What bounds it on the H100: neither bytes nor operations but the
// latency of a step. At kcover's level 1 (16 nodes x 128 sets x 1,290
// words, k = 64) the words are 10.6 MB, read once: 3.2 us at 3.35 TB/s,
// against 64 steps that each depend on the last winner.
//
// What the design does about it: a thread-block cluster of R blocks a
// node, launched with cudaLaunchKernelEx and no grid barrier, so a node
// waits only for its own blocks; the nodes lie along the grid's x axis
// (R B blocks), so a launch holds up to 2^31 / R of them.
// Rank r holds words [W r / R, W (r + 1) / R) of every candidate - the
// node split by WORDS - in its shared memory (cp.async once; 645 KB a
// kcover node over R = 8 blocks, 2 MiB a kdom node over a non-portable
// cluster of R = 16), with that slice of the covered row. A step:
//  1. each live candidate's popcount of its words not yet covered, over
//     the slice, by tpc threads (rt_bits_tpc: 2 at kcover's 128
//     candidates, 1 at kdom's 256) in 16-byte vectors, the rows padded
//     so that a quarter-warp's vectors fall in distinct bank groups;
//     the words' ones are added in carry-save planes, one POPC for 8
//     words (the POPC pipe runs at a quarter of the logic pipe's rate);
//  2. the partials go to EVERY rank's shared memory by st.async, 4
//     candidates a store, each completing its bytes on the receiving
//     rank's mbarrier for the step (two buffers and two barriers, by
//     step parity): a transaction barrier and no cluster barrier, whose
//     arrival fences the whole GPU's memory;
//  3. warp 0 of every block waits for its barrier's phase, adds each
//     live candidate's R partials from its own shared memory and takes
//     the masked first-argmax (two integer reductions); after a block
//     barrier every block folds the winner's words of its own slice into
//     its covered slice (all blocks find the same winner): no word
//     crosses the cluster. A rank pushes step s + 2 into a buffer only
//     after every rank's step s + 1 arrived, which each pushed after
//     reading its step s, so two buffers suffice.
// Where the words do not fit the cluster's shared memory
// (rt_greedy_loop_resident_bits_plan says which), the same steps read the
// slice from device memory (L1 and L2), 8 words a thread in flight and
// 16 warps a block, and exchange the partials through a (B, 2, R, Cp)
// int32 device scratch under a cluster barrier.
//
// Measured on the H100 (PERF.md section 6): the node split by
// CANDIDATES instead (rank r holding whole sets and the whole covered
// row, the blocks' winners meeting over distributed shared memory, the
// winner's words read from its owner) was slower at every level under
// the same cluster barrier, and that barrier cost ~1,400 cycles a step.

#define RT_BITS_CLUSTER_MAX 16  // blocks a node's cluster, at most

struct RtResBitsArgs {
  const unsigned* cands;  // (B, C, W)
  const unsigned* row_in;  // (B, W)
  const float* mask_in;   // (B, C)
  const int* ctl;         // (B, 3)
  unsigned* row_out;      // (B, W)
  int* bests;             // (B, k)
  float* gains;           // (B, k)
  int* partials;          // device tier: (B, 2, R, Cp), else null
  int C, W, k, R;
};

__device__ __forceinline__ void rt_cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void rt_cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The (C,) mask as bits, one 32-bit word a thread.
__device__ __forceinline__ void rt_mask_bits(const float* mask, int C,
                                             unsigned* bits) {
  for (int q = threadIdx.x; q < (C + 31) / 32; q += blockDim.x) {
    unsigned v = 0u;
    for (int j = 0; j < 32 && q * 32 + j < C; ++j)
      if (mask[q * 32 + j] > 0.f) v |= 1u << j;
    bits[q] = v;
  }
}

// Threads a block of the words-split kernel: 8 warps on chip (16 ran
// slower at kcover's 16 nodes), 16 on the device tier, whose L1 and L2
// loads need the warps in flight (PERF.md section 6).
__host__ __device__ constexpr int rt_bits_threads(bool onchip) {
  return onchip ? RT_THREADS : 2 * RT_THREADS;
}

// Threads a candidate's slice is summed by: the largest power of two
// <= 32 with C of them in a block of T (one round of candidates at
// C <= T).
__host__ __device__ __forceinline__ int rt_bits_tpc(int C, int T) {
  int t = 32;
  while (t > 1 && (long long)t * C > T) t >>= 1;
  return t;
}

// A slice's row stride in shared memory, in words: the slice rounded
// up to whole 16-byte vectors, then padded to 4 tpc modulo 32, so that
// the 8 lanes of a quarter-warp (8 / tpc candidates, tpc threads on
// consecutive vectors of each) read 8 distinct 16-byte bank groups.
__host__ __device__ __forceinline__ int rt_bits_ld(int WS, int tpc) {
  const int v = (WS + 3) & ~3;
  return v + ((4 * tpc - v) % 32 + 32) % 32;
}

// Bytes of dynamic shared memory of a words-split block: the covered
// slice (in whole vectors) and the mask's bits; on chip also every
// candidate's slice (C rows of rt_bits_ld), the (2, R, Cp) partials
// every rank pushes (Cp = C rounded up to 4) and their two mbarriers.
__host__ __device__ __forceinline__ size_t rt_bits_smem(int C, int W, int R,
                                                        bool onchip) {
  const int WS = (W + R - 1) / R;
  size_t words = (size_t)((WS + 3) & ~3) + (C + 31) / 32;
  if (onchip)
    words += (size_t)C * rt_bits_ld(WS, rt_bits_tpc(C, RT_THREADS)) +
             2 * (size_t)R * ((C + 3) & ~3) + 4;
  return 4 * words;
}

__device__ __forceinline__ int rt_bits_part4(uint4 r, uint4 m) {
  return rt_bits_part(r.x, m.x) + rt_bits_part(r.y, m.y) +
         rt_bits_part(r.z, m.z) + rt_bits_part(r.w, m.w);
}

// A carry-save adder of three bit-planes: lo = a ^ b ^ c, hi = the
// majority (two instructions), so a column's ones over many words are
// counted in binary planes and only the top plane is popcounted.
__device__ __forceinline__ void rt_csa(unsigned& hi, unsigned& lo,
                                       unsigned a, unsigned b, unsigned c) {
  lo = a ^ b ^ c;
  hi = (a & b) | (c & (a ^ b));
}

// The exact popcount of the 8 words m & ~r of two vector pairs added
// into (ones, twos, fours) planes and the eights' count (Harley and
// Seal): one POPC for 8 words where the plain sum takes 8 (the POPC
// pipe is a quarter of the logic pipe's rate).
__device__ __forceinline__ void rt_bits_csa8(uint4 r0, uint4 m0, uint4 r1,
                                             uint4 m1, unsigned& ones,
                                             unsigned& twos, unsigned& fours,
                                             int& eights) {
  unsigned ta, tb, fa, fb, e;
  rt_csa(ta, ones, ones, m0.x & ~r0.x, m0.y & ~r0.y);
  rt_csa(tb, ones, ones, m0.z & ~r0.z, m0.w & ~r0.w);
  rt_csa(fa, twos, twos, ta, tb);
  rt_csa(ta, ones, ones, m1.x & ~r1.x, m1.y & ~r1.y);
  rt_csa(tb, ones, ones, m1.z & ~r1.z, m1.w & ~r1.w);
  rt_csa(fb, twos, twos, ta, tb);
  rt_csa(e, fours, fours, fa, fb);
  eights += __popc(e);
}

// The cluster's transaction barriers (mbarrier) and asynchronous
// remote stores (st.async): rank o's copy of a shared address, a
// barrier's init, a phase's expected bytes, the wait for a phase of
// the given parity, and 4 or 16 bytes stored into rank o's shared
// memory that complete on rank o's barrier.
__device__ __forceinline__ unsigned rt_smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ unsigned rt_mapa(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void rt_mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void rt_mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void rt_mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "RT_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra RT_DONE;\n"
      "bra RT_WAIT;\n"
      "RT_DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void rt_st_async(unsigned addr, int v,
                                            unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(v), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void rt_st_async4(unsigned addr, int x, int y,
                                             int z, int w, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.u32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "r"(x), "r"(y), "r"(z), "r"(w), "r"(bar)
      : "memory");
}

// Grid (R B), clusters of R along x: rank r of node blockIdx.x / R. See
// above.
template <bool ONCHIP>
__global__ void __launch_bounds__(rt_bits_threads(ONCHIP))
    rt_resident_bits_kernel(const RtResBitsArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int win[2];  // the step's winner: gain, index
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const int R = a.R, C = a.C, W = a.W;
  const int Cp = (C + 3) & ~3;
  const int WS = (W + R - 1) / R;
  const int tpc = rt_bits_tpc(C, T);
  const int h = tid % tpc;  // this thread's words or vectors: h + tpc j
  const int r = (int)cl.block_rank();
  const size_t b = blockIdx.x / R;
  const int w0 = (int)((long long)W * r / R);
  const int nw = (int)((long long)W * (r + 1) / R) - w0;
  const int nv = (nw + 3) >> 2;  // 16-byte vectors of the slice
  const unsigned* src = a.cands + b * C * W + w0;
  // shared memory: covered (whole vectors), [words (C, ld), partials
  // (2, R, Cp), 2 mbarriers], mask
  unsigned* cov = reinterpret_cast<unsigned*>(smem_raw);
  unsigned* p = cov + ((WS + 3) & ~3);
  const unsigned* words = src;  // candidate c's slice at words + c * ld
  int ld = W;
  int* part = nullptr;
  unsigned bar = 0;  // the first mbarrier's shared address
  if constexpr (ONCHIP) {
    // the slices, zero past nw up to the vector (a zero word gains 0)
    ld = rt_bits_ld(WS, tpc);
    for (int i = tid; i < C * 4 * nv; i += T) {
      const int c = i / (4 * nv);
      const int w = i - c * 4 * nv;
      if (w < nw)
        rt_cp_async4(p + (size_t)c * ld + w, src + (size_t)c * W + w);
      else
        p[(size_t)c * ld + w] = 0u;
    }
    words = p;
    p += (size_t)C * ld;
    part = reinterpret_cast<int*>(p);
    p += 2 * (size_t)R * Cp;
    bar = rt_smem(p);
    p += 4;
    if (tid == 0) {
      rt_mbar_init(bar);
      rt_mbar_init(bar + 8);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  unsigned* mbits = p;
  for (int w = tid; w < nw; w += T) cov[w] = a.row_in[b * W + w0 + w];
  rt_mask_bits(a.mask_in + b * C, C, mbits);
  if constexpr (ONCHIP) {
    rt_cp_async_wait();
    cl.sync();  // every rank's barriers are set before any push to it
  } else {
    __syncthreads();
  }

  auto word = [&](int c, int w) -> unsigned {
    const unsigned* q = words + (size_t)c * ld + w;
    return ONCHIP ? *q : __ldg(q);
  };
  auto live = [&](int c) { return (mbits[c >> 5] >> (c & 31)) & 1u; };
  const int kq = min(a.k, a.ctl[b * 3]);
  for (int s = 0; s < kq; ++s) {
    // this step's partials, (R, Cp): on chip every rank's own copy,
    // else the node's in device memory
    const int par = s & 1;
    int* buf = ONCHIP ? part + (size_t)par * R * Cp
                      : a.partials + (b * 2 + par) * R * (size_t)Cp;
    if (ONCHIP && tid == 0) rt_mbar_expect(bar + 8 * par, 4u * R * Cp);
    // 1. each live candidate's sum over this slice by tpc threads, pushed
    // to buf[r][c] of every rank (on chip 4 candidates a store where a
    // warp holds whole groups of 4)
    for (int c0 = 0; c0 < C; c0 += T / tpc) {
      const int c = c0 + tid / tpc;
      const bool on = c < C && live(c);
      int acc = 0;
      if (on) {
        if constexpr (ONCHIP) {
          const uint4* m4 = reinterpret_cast<const uint4*>(words + c * ld);
          const uint4* r4 = reinterpret_cast<const uint4*>(cov);
          unsigned ones = 0u, twos = 0u, fours = 0u;
          int v = h;
          for (; v + tpc < nv; v += 2 * tpc)
            rt_bits_csa8(r4[v], m4[v], r4[v + tpc], m4[v + tpc], ones, twos,
                         fours, acc);
          acc = 8 * acc + 4 * __popc(fours) + 2 * __popc(twos) + __popc(ones);
          if (v < nv) acc += rt_bits_part4(r4[v], m4[v]);
        } else {
          int w = h;
          for (; w + 7 * tpc < nw; w += 8 * tpc) {
            unsigned m[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) m[u] = word(c, w + u * tpc);
#pragma unroll
            for (int u = 0; u < 8; ++u)
              acc += rt_bits_part(cov[w + u * tpc], m[u]);
          }
          for (; w < nw; w += tpc) acc += rt_bits_part(cov[w], word(c, w));
        }
      }
      for (int off = tpc >> 1; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if constexpr (ONCHIP) {
        const unsigned dst = rt_smem(buf + r * Cp);
        if (tpc <= 8) {  // lane g0 pushes candidates c - c % 4 .. + 3
          const int g0 = lane & ~(4 * tpc - 1);
          const int x = __shfl_sync(0xffffffffu, acc, g0);
          const int y = __shfl_sync(0xffffffffu, acc, g0 + tpc);
          const int z = __shfl_sync(0xffffffffu, acc, g0 + 2 * tpc);
          const int q = __shfl_sync(0xffffffffu, acc, g0 + 3 * tpc);
          if (lane == g0 && c < C)
            for (int o = 0; o < R; ++o)
              rt_st_async4(rt_mapa(dst + 4 * c, o), x, y, z, q,
                           rt_mapa(bar + 8 * par, o));
        } else if (h == 0 && c < Cp) {
          for (int o = 0; o < R; ++o)
            rt_st_async(rt_mapa(dst + 4 * c, o), acc,
                        rt_mapa(bar + 8 * par, o));
        }
      } else if (on && h == 0) {
        buf[(size_t)r * Cp + c] = acc;
      }
    }
    // 2. warp 0: every rank's partials are in (on chip: this step's
    // barrier phase completes; else a cluster barrier), each live
    // candidate's total, the masked first-argmax
    if constexpr (!ONCHIP) cl.sync();
    if (tid < 32) {
      if constexpr (ONCHIP) rt_mbar_wait(bar + 8 * par, (s >> 1) & 1);
      int bg = -1;
      int bi = RT_NO_INDEX;
      for (int v = lane; v < Cp / 4; v += 32) {
        int4 t = make_int4(0, 0, 0, 0);
#pragma unroll 4
        for (int o = 0; o < R; ++o) {
          const int4* q = reinterpret_cast<const int4*>(buf + o * Cp) + v;
          const int4 u = ONCHIP ? *q : __ldcg(q);
          t.x += u.x, t.y += u.y, t.z += u.z, t.w += u.w;
        }
        const int g[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)  // ascending: the first of equals stays
          if (g[j] > bg && live(4 * v + j)) {
            bg = g[j];
            bi = 4 * v + j;
          }
      }
      const int wg = __reduce_max_sync(0xffffffffu, bg);
      const unsigned wi = __reduce_min_sync(
          0xffffffffu, bg == wg ? (unsigned)bi : (unsigned)RT_NO_INDEX);
      if (lane == 0) {
        win[0] = wg;
        win[1] = (int)wi;
      }
    }
    __syncthreads();
    // 3. every block: the winner folded into this slice
    const int bg = win[0];
    const int bi = win[1];
    const bool accept = bg > 0;
    if (r == 0 && tid == 0) {
      a.bests[b * a.k + s] = accept ? bi : -1;
      a.gains[b * a.k + s] = bg < 0 ? -INFINITY : (float)bg;
    }
    if (accept) {
      for (int w = tid; w < nw; w += T)
        cov[w] = rt_bits_fold(cov[w], word(bi, w));
      if (tid == 0) mbits[bi >> 5] &= ~(1u << (bi & 31));
    }
    __syncthreads();
  }
  if (r == 0)  // frozen steps
    for (int s = max(kq, 0) + tid; s < a.k; s += T) {
      a.bests[b * a.k + s] = -1;
      a.gains[b * a.k + s] = 0.f;
    }
  for (int w = tid; w < nw; w += T) a.row_out[b * W + w0 + w] = cov[w];
  // no rank leaves while a push to it may be in flight
  if constexpr (ONCHIP) cl.sync();
}

// The tier and cluster of the words-split kernel over nodes of C
// candidates x W words: plan[0] = 1 (on chip) with plan[1] = R for the
// smallest cluster of 8 or 16 blocks whose rt_bits_smem fits both `gate`
// bytes and the card's per-block shared memory (kcover's 128 x 1,290 on
// 8, kdom's 256 x 2,048 on a non-portable 16), else plan[0] = 0 (the
// words in device memory) with R = 8. Both tiers give the same bits.
// Returns the cudaError_t.
extern "C" int rt_greedy_loop_resident_bits_plan(int C, int W, long long gate,
                                                 int* plan) {
  if (C < 0 || W < 0) return (int)cudaErrorInvalidValue;
  const long long max = rt_smem_max();
  if (gate > max) gate = max;
  plan[0] = 0;
  plan[1] = 8;
  for (int R = 8; R <= RT_BITS_CLUSTER_MAX; R *= 2)
    if ((long long)rt_bits_smem(C, W, R, true) <= gate) {
      plan[0] = 1;
      plan[1] = R;
      break;
    }
  return 0;
}

// cands (B, C, W), rows (B, W) 32-bit words, mask (B, C) 0/1 f32, ctl
// (B, 3) int32; R blocks a node's cluster (1..16; above 8 a
// non-portable cluster); partials: the device tier's (B, 2, R, Cp)
// int32 scratch (Cp = C rounded up to 4), null on chip
// (rt_greedy_loop_resident_bits_plan says which). Returns the
// cudaError_t.
extern "C" int rt_greedy_loop_resident_bits(
    const unsigned* cands, const unsigned* row_in, const float* mask_in,
    const int* ctl, unsigned* row_out, int* bests, float* gains,
    int* partials, int B, int C, int W, int k, int R, void* stream) {
  if (B == 0) return 0;
  if (B < 0 || C < 0 || W < 0 || k < 0 || R < 1 || R > RT_BITS_CLUSTER_MAX ||
      (long long)R * B > INT_MAX)
    return (int)cudaErrorInvalidValue;
  RtResBitsArgs a = {cands, row_in, mask_in, ctl,   row_out,
                     bests, gains,  partials, C,   W, k, R};
  const bool onchip = partials == nullptr;
  const void* fn = onchip ? (const void*)rt_resident_bits_kernel<true>
                          : (const void*)rt_resident_bits_kernel<false>;
  const size_t smem = rt_bits_smem(C, W, R, onchip);
  if (smem > (size_t)rt_smem_max()) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (R > 8) {
    e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(R * B));
  cfg.blockDim = dim3(rt_bits_threads(onchip));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)R;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {(void*)&a};
  e = cudaLaunchKernelExC(&cfg, fn, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
