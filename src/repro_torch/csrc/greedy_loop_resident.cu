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
// _resident_kernel runs csrc/greedy_loop.cu:rt_greedy_loop_bits with ctl.
#include <cooperative_groups.h>

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
