// The CALDERA low-rank half of a W4A8 projection, fused into the row-dot
// matmul of rowdot.cuh:
//
//   out[m, n] = (acc[m, n] * s[n]) * sx[m] + ylr[m, n] * Ls[n]
//   ylr[m, n] = sum_r bf16(xr[m, p(n) * rank + r]) * L[n, r]
//
// with acc the exact i32 sum of rowdot.cuh, L the int8 codes of the layer's
// N-concatenated L factors (exact in bf16) and p(n) the projection of output
// row n, found from the split boundaries (never from a per-block id, so a
// tile may straddle two projections). Products of a bf16 value and an int8
// code are exact in f32; the r sums are a fixed per-lane order and a fixed
// warp tree, so a launch is deterministic. The epilogue's multiplies and the
// final add are rounded one by one (no contraction into FMAs), in the
// reference's order.
//
// Also here: the thin factor contraction xr[m, j] = (sum_k bf16(a[m, k]) *
// R[j, k]) * Rs[j] (one warp per row j, activations staged in shared
// memory), used inside the cooperative kernels, and a grid-wide barrier.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "rowdot.cuh"

namespace lowrank {

using rowdot::allow_smem;
using rowdot::coop_grid;
using rowdot::kThreads;
using rowdot::kWarps;
using rowdot::Tile;

// Staging region of the cooperative kernels (activation chunks of the tile
// phases, bf16-rounded activations of the xr phases). Their registers hold
// them to two CTAs per SM, so 88 KB each (plus the xr windows) still fits
// two: fewer, longer chunks than rowdot.cuh's 47 KB.
constexpr int kCoopSmemBytes = 88 * 1024;

// Up to four fused projections: output rows [0, b1) are projection 0,
// [b1, b2) projection 1, [b2, b3) projection 2, the rest projection 3.
// Unused boundaries are N.
struct Splits {
  int b1, b2, b3;
};

// Activation words per staged chunk of a packed row of K codes (F per byte)
// for a staging region of `bytes` that holds mrows rows: a multiple of 4 and
// at most the row's words, as rowdot::launch picks them.
template <int F>
inline int pick_jc(int bytes, int mrows, int K) {
  const int pw = K / F / 4;
  int jc = bytes / (mrows * F * 4);
  jc -= jc % 4;
  return jc > pw ? pw : jc;
}

__device__ __forceinline__ int proj_of(int n, Splits s) {
  return (n >= s.b1) + (n >= s.b2) + (n >= s.b3);
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Global f32 loads: inputs through the read-only path; CG = true for data
// another CTA of the same launch wrote (the cooperative kernels' scratch).
template <bool CG>
__device__ __forceinline__ float ldf(const float* p) {
  return CG ? __ldcg(p) : __ldg(p);
}

template <bool CG>
__device__ __forceinline__ float4 ldf4(const float4* p) {
  return CG ? __ldcg(p) : __ldg(p);
}

__device__ __forceinline__ float warp_sum_f(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max_f(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The L factor of a projection group: xr (M, ldxr) f32 holds projection p's
// window at columns [p * rank, (p + 1) * rank); L (N, rank) int8; Ls (N) f32.
struct LFactor {
  const float* xr;
  int ldxr;
  const int8_t* L;
  const float* Ls;
  int rank;
  Splits splits;
};

// Most windows any row tile of RPB rows touches (the size of the tile's
// window buffer, in windows of MT x rank floats).
inline int max_windows(int N, int rpb, Splits s) {
  auto proj = [&](int n) { return (n >= s.b1) + (n >= s.b2) + (n >= s.b3); };
  int best = 1;
  for (int n0 = 0; n0 < N; n0 += rpb) {
    const int n1 = (n0 + rpb < N ? n0 + rpb : N) - 1;
    const int w = proj(n1) - proj(n0) + 1;
    best = w > best ? w : best;
  }
  return best;
}

// One row tile (tile index `tile`, Tile<MT>::kRowsPerBlock rows) of the
// fused W4A8 + L matmul for the mt activation rows m0 .. m0 + mt - 1: x32
// and sx point at row m0, f.xr at row m0 too. Calls emit(m, n, rloc, value)
// in one lane per output (rloc = the row's index in the tile). xs is the
// activation staging (jc_words as in rowdot.cuh), xrw the window buffer
// (max_windows x MT x rank floats). Every thread of the CTA must call it.
// CGX / CGR: the activations / xr come from this launch's scratch.
template <int BITS, int CODE, int MT, bool CGX, bool CGR, typename Emit>
__device__ __forceinline__ void lr_tile(const int* x32, const float* sx,
                                        int mt, int K,
                                        const uint8_t* __restrict__ w,
                                        const float* __restrict__ ws, int N,
                                        int jc_words, int tile,
                                        const LFactor& f, int* xs, float* xrw,
                                        Emit emit) {
  constexpr int F = 8 / BITS;
  constexpr int MAXQ = (1 << (BITS - 1)) - 1;
  constexpr int RPW = Tile<MT>::kRowsPerWarp;
  constexpr int RPB = Tile<MT>::kRowsPerBlock;
  __shared__ int rowsum[MT];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pw = K / F / 4;
  const int kw = K / 4;
  const int nb0 = tile * RPB;
  const int p0 = proj_of(nb0, f.splits);
  const int p1 = proj_of(min(nb0 + RPB, N) - 1, f.splits);
  const int rank = f.rank;

  __syncthreads();  // the previous tile is done with xrw and rowsum
  const int wn = (p1 - p0 + 1) * mt * rank;
  for (int i = threadIdx.x; i < wn; i += kThreads) {
    const int r = i % rank;
    const int t = i / rank;
    const int m = t % mt;
    const int p = t / mt;
    xrw[(p * MT + m) * rank + r] =
        bf16r(ldf<CGR>(f.xr + (size_t)m * f.ldxr + (p0 + p) * rank + r));
  }
  if (CODE == rowdot::kOffsetPacked)
    rowdot::tile_rowsum<CGX>(x32, mt, kw, rowsum);

  int acc[RPW][MT];
  const int n_first = nb0 + warp * RPW;
  rowdot::tile_accumulate<BITS, CODE, MT, CGX>(x32, mt, kw, w, N, pw,
                                               jc_words, n_first, xs, acc);

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int n = n_first + r;
    const bool live = n < N;
    const int p = live ? proj_of(n, f.splits) - p0 : 0;
    float part[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) part[m] = 0.f;
    if (live) {
      const int8_t* Lrow = f.L + (size_t)n * rank;
      const float* win = xrw + p * MT * rank;
      for (int k = lane; k < rank; k += 32) {
        const float lv = (float)Lrow[k];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          if (m < mt) part[m] = fmaf(win[m * rank + k], lv, part[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int v = rowdot::warp_sum_int(acc[r][m]);
      const float ylr = warp_sum_f(part[m]);
      if (m < mt && live && lane == (m & 31)) {
        const int a =
            CODE == rowdot::kOffsetPacked ? v - MAXQ * rowsum[m] : v;
        const float base = __fmul_rn(__fmul_rn((float)a, ws[n]), sx[m]);
        emit(m, n, warp * RPW + r,
             __fadd_rn(base, __fmul_rn(ylr, f.Ls[n])));
      }
    }
  }
}

// out[m, j0 + i] = (sum_k bf16(act[m, k]) * R[j0 + i, k]) * Rs[j0 + i] for
// the rows i < nrows (<= kWarps, one warp each) and the mt activation rows
// of act (row stride K, pointing at row m0; out at row m0, stride ldo).
// The activations are staged in xsf (cap floats), bf16-rounded, in chunks
// of whole 128-column groups, with 16-byte loads (act 16-byte aligned,
// K % 4 == 0), several in flight per thread. Every thread of the CTA must
// call it.
template <int MT, bool CG>
__device__ __forceinline__ void xr_rows(const float* act, int mt, int K,
                                        const int8_t* __restrict__ R,
                                        const float* __restrict__ Rs,
                                        int nrows, float* out, int ldo,
                                        float* xsf, int cap) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int kc = cap / MT;
  kc -= kc % 128;
  if (kc > K) kc = K;
  float part[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) part[m] = 0.f;
  const int8_t* Rrow = R + (size_t)warp * K;
  for (int k0 = 0; k0 < K; k0 += kc) {
    const int cw = min(kc, K - k0);
    const int cw4 = cw / 4;
    __syncthreads();
#pragma unroll 4
    for (int i = threadIdx.x; i < mt * cw4; i += kThreads) {
      const int m = i / cw4;
      const int c = 4 * (i - m * cw4);
      const float4 v = ldf4<CG>(
          reinterpret_cast<const float4*>(act + (size_t)m * K + k0 + c));
      *reinterpret_cast<float4*>(xsf + m * kc + c) =
          make_float4(bf16r(v.x), bf16r(v.y), bf16r(v.z), bf16r(v.w));
    }
    __syncthreads();
    if (warp < nrows) {
      for (int c = 4 * lane; c < cw; c += 128) {
        const int rw = __ldg(reinterpret_cast<const int*>(Rrow + k0 + c));
        const float r0 = (float)(int8_t)(rw & 0xFF);
        const float r1 = (float)(int8_t)((rw >> 8) & 0xFF);
        const float r2 = (float)(int8_t)((rw >> 16) & 0xFF);
        const float r3 = (float)(int8_t)((rw >> 24) & 0xFF);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m < mt) {
            const float* xp = xsf + m * kc + c;
            part[m] = fmaf(xp[0], r0, part[m]);
            part[m] = fmaf(xp[1], r1, part[m]);
            part[m] = fmaf(xp[2], r2, part[m]);
            part[m] = fmaf(xp[3], r3, part[m]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float s = warp_sum_f(part[m]);
    if (m < mt && warp < nrows && lane == (m & 31))
      out[(size_t)m * ldo + warp] = __fmul_rn(s, Rs[warp]);
  }
}

// The grid-wide barrier of a cooperative launch (cudaLaunchCooperativeKernel
// guarantees that every CTA of the grid is resident). It also orders the
// global writes before it with the reads after it.
__device__ __forceinline__ void grid_sync() {
  cooperative_groups::this_grid().sync();
}

}  // namespace lowrank
