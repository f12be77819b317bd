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
// keeps the FMA pipes fed. Each 256-thread block owns a 128x128 output
// tile; each thread an 8x8 micro-tile (rows ty*4 + {0..3, 64..67},
// columns tx*4 + {0..3, 64..67}), so one feature step reads four 16-byte
// shared-memory vectors (two of them broadcast in the warp) for 64 FMAs.
// The feature axis is walked in slices of 8, staged k-major in a ring of
// two shared-memory stages (rows padded to 132 floats, so the transposing
// stores of the two loader halves fall on distinct banks) with ONE
// barrier a slice: while the block multiplies one stage, each thread's
// 16-byte global loads of the next slice are in flight in registers and
// land in the other stage after the multiply. A D that is not a multiple
// of 4 (or an operand not 16-byte aligned) takes scalar loads in the same
// kernel (template flag VEC); features, rows and columns past D, N and C
// are zeros or masked, never a plain-version fallback. Grid (C/128,
// N/128, B): one launch for all greedies of a level.
//
// The 'dist' norms are computed once, before the product, by a small pass
// (rt_row_norms_kernel): one float64 fma(v, v, nrm) chain a row in
// ascending feature order, cast once to f32, over the B*(N + C) rows (B*N
// when ground and candidates are one tensor), the rows staged through
// shared memory so the reads are coalesced. The product's epilogue reads
// them; no tile recomputes them.
//
// Every entry is computed as the resident build's tile computes it
// (pairwise_tile.cuh: rt_tile, rt_pairwise_tile): one f32 fmaf chain over
// ascending features from 0 (no split of D), the same float64 norms, and
// rt_entry_value, stored f32 or rounded to nearest even for bf16. So this
// kernel equals the resident kernel's build bit for bit, and the entries
// of the 64x64-tile kernel it replaced.
//
// No torch matmul, cdist, cuBLAS or tensor-core path is used.
//
// The bf16 output (pairwise_pallas with out_dtype bfloat16, the cache of
// the bf16 rung of the planner's storage ladder) is the same tile with a
// round-to-nearest-even store: half the bytes written, the same
// operations, so the bound barely moves.
#include <stdint.h>

#include "pairwise_tile.cuh"

#define PW_TILE 128
#define PW_TK 8
#define PW_LD (PW_TILE + 4)
#define PW_NORM_ROWS RT_THREADS
#define PW_NORM_TK 32

// The float64 squared norm of each row of x (R, D), cast once to f32.
// Block: 256 rows; each (256 x 32)-feature chunk is read coalesced (a warp
// reads one row's 32 features) into shared memory, then every thread
// extends its row's fma chain in ascending feature order.
__global__ void __launch_bounds__(RT_THREADS)
    rt_row_norms_kernel(const float* __restrict__ x, float* __restrict__ nrm,
                        long long R, int D) {
  __shared__ float s[PW_NORM_ROWS][PW_NORM_TK + 1];
  const int t = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * PW_NORM_ROWS;
  double acc = 0.0;
  for (int k0 = 0; k0 < D; k0 += PW_NORM_TK) {
#pragma unroll 8
    for (int i = 0; i < PW_NORM_TK; ++i) {
      const int e = t + RT_THREADS * i;
      const int rr = e / PW_NORM_TK, f = e % PW_NORM_TK;
      const long long r = r0 + rr;
      s[rr][f] = (r < R && k0 + f < D) ? x[r * D + k0 + f] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int f = 0; f < PW_NORM_TK; ++f) {
      const double v = s[t][f];
      acc = fma(v, v, acc);
    }
    __syncthreads();
  }
  if (r0 + t < R) nrm[r0 + t] = (float)acc;
}

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
  __shared__ __align__(16) float sa[2][PW_TK][PW_LD];  // ground slices
  __shared__ __align__(16) float sb[2][PW_TK][PW_LD];  // candidate slices
  const int t = threadIdx.x;
  const size_t b = blockIdx.z;
  const int n0 = blockIdx.y * PW_TILE;
  const int c0 = blockIdx.x * PW_TILE;

  // loader: thread t stages features lk .. lk + 3 of tile row lr of both
  // operands (a warp reads 16 rows x 32 bytes of each)
  const int lr = t >> 1;
  const int lk = (t & 1) * 4;
  const bool gin = n0 + lr < N;
  const bool cin = c0 + lr < C;
  const float* gp = ground + (b * N + (gin ? n0 + lr : 0)) * (size_t)D + lk;
  const float* cp = cands + (b * C + (cin ? c0 + lr : 0)) * (size_t)D + lk;
  float ra[4], rb[4];
  auto load = [&](int k0) {
    if constexpr (VEC) {
      // D % 4 == 0: the 4 features are all in or all out
      const bool kin = k0 + lk < D;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 va =
          gin && kin ? __ldg(reinterpret_cast<const float4*>(gp + k0)) : z;
      const float4 vb =
          cin && kin ? __ldg(reinterpret_cast<const float4*>(cp + k0)) : z;
      ra[0] = va.x, ra[1] = va.y, ra[2] = va.z, ra[3] = va.w;
      rb[0] = vb.x, rb[1] = vb.y, rb[2] = vb.z, rb[3] = vb.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool kin = k0 + lk + q < D;
        ra[q] = gin && kin ? __ldg(gp + k0 + q) : 0.f;
        rb[q] = cin && kin ? __ldg(cp + k0 + q) : 0.f;
      }
    }
  };
  auto stage = [&](int st) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      sa[st][lk + q][lr] = ra[q];
      sb[st][lk + q][lr] = rb[q];
    }
  };

  const int tx = t & 15;
  const int ty = t >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  stage(0);
  __syncthreads();
  int st = 0;
  for (int k0 = 0; k0 < D; k0 += PW_TK) {
    const bool more = k0 + PW_TK < D;
    if (more) load(k0 + PW_TK);  // in flight during the multiply
#pragma unroll
    for (int kk = 0; kk < PW_TK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sa[st][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sa[st][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sb[st][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&sb[st][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    if (more) stage(st ^ 1);
    // one barrier a slice: the other stage is written, and every thread
    // is done reading this one before the next slice overwrites it
    __syncthreads();
    st ^= 1;
  }

  // epilogue: entries as rt_tile_entry gives them, 4 columns a store
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
        v[q] = rt_entry_value(gn, cn[h * 4 + q], acc[i][h * 4 + q], mode);
      if (vout && c + 3 < C) {
        rt_store4(orow + c, v);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c + q < C) rt_store(orow + c + q, v[q]);
      }
    }
  }
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

static cudaError_t rt_norms(const float* x, float* nrm, long long R, int D,
                            cudaStream_t st) {
  const long long blocks = (R + PW_NORM_ROWS - 1) / PW_NORM_ROWS;
  rt_row_norms_kernel<<<(unsigned)blocks, RT_THREADS, 0, st>>>(x, nrm, R, D);
  return cudaGetLastError();
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
    cudaError_t e = rt_norms(ground, norms, (long long)B * N, D, st);
    if (e != cudaSuccess) return (int)e;
    gnorm = norms;
    if (cands == ground && C == N) {
      cnorm = norms;
    } else {
      e = rt_norms(cands, norms + (size_t)B * N, (long long)B * C, D, st);
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
