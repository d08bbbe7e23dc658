// W4A8 matmuls with the CALDERA low-rank factors fused in, against one layer
// of stacked weights. Three TPU kernels of
// ee274_convexcaldera_llm_quantization_tpu/ops/kernels.py are replaced here:
//
// - quantized_matmul_w4a8_l_stacked (_qmm_w4a8_l_stacked_kernel):
//   w4a8_l_stacked_launch (section A, l_kernel, M <= 8) and
//   w4a8_l_tile_launch (the tile path of w4a8_tile.cuh with its L epilogue).
//   The stacked W4A8 matmul plus the L half of the factors, for a fusion
//   group of same-input projections (qkv, gate/up; o and down as groups of
//   one); the thin xr = (bf16(x) @ bf16(R[l]).T) * Rs comes from the caller.
// - quantized_matmul_w4a8_lr_stacked (_qmm_w4a8_lr_stacked_kernel): the same
//   with xr computed in the kernel: w4a8_lr_xr_launch (section D, xr on the
//   tensor cores) and then w4a8_l_tile_launch; w4a8_lr_stacked_launch
//   (section B, a cooperative launch: xr in phase 1, a grid barrier, the l
//   kernel's tiles) only for a rank or K the tile path cannot hold.
// - quantized_matmul_w4a8_mlp_stacked (_qmm_w4a8_mlp_stacked_kernel):
//   w4a8_mlp_stacked_launch (section C), down(silu(gate(x)) * up(x)) in one
//   cooperative launch of three phases split by two grid barriers, returned
//   before down's global scale as on the TPU.
//
// Section C at decode's M (<= 32 rows a tile) is a skinny GEMM bound by
// bytes: gate/up's and down's packed codes and L factors (~71 MB for a
// Llama-2-7B MLP at 4 bits, 21.7 us at 3.35 TB/s). Its parts:
//   1. gate/up on fused_proj.cuh: int8 mma.sync products of 16 gate rows
//      and the same 16 up rows of the unchanged gu_packed per group, with
//      their L dots as bf16 mma.sync on L slabs of the same weight stream;
//      the warp that finishes a group computes m = silu(gate) * up, writes
//      it (f32 scratch, L2-resident), the group's row absmax of |m| into a
//      slot of its own, and the thin R dot of down folded in: the group's
//      16 columns of m are a K chunk of xrd = bf16(m) @ bf16(dnR).T, whose
//      partial sums for every R row (one bf16 mma per 16 R rows) go to the
//      group's own slot. The R rows were prefetched into L2 at the start.
//   2. every CTA reduces the absmax slots to the row scales sm = max(amax,
//      1e-12) / 127; the grid requantizes m to int8 (round half to even,
//      clip 127) and sums each xrd output's group partials in a fixed order
//      (a CTA an output column, its warps over the groups, then in order).
//   3. down on the int8 m with its L slabs on xrd. Each warp's first down
//      slabs were issued into its ring right after its last gate/up slab,
//      so they load across both barriers.
// Deterministic for a given grid: integer sums are exact, every f32 sum has
// a fixed order, and no partial goes through an atomic. xrd's order differs
// from the reference's (a sum of per-group partials), as does the L dots'
// (the tensor cores'), so an int8 code of m may round the other way.
#include "fused_proj.cuh"
#include "lowrank.cuh"
#include "w4a8_tile.cuh"

namespace {

using lowrank::kCoopSmemBytes;
using lowrank::LFactor;
using lowrank::pick_jc;
using lowrank::Splits;
using rowdot::kSmemBytes;
using rowdot::kThreads;
using rowdot::kWarps;
using rowdot::Tile;

// ---------------------------------------------------------------------------
// A. The L-fused kernel: one CTA per (row tile, m tile).
// ---------------------------------------------------------------------------

template <int BITS, int CODE, int MT>
__global__ void __launch_bounds__(kThreads)
l_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
         const uint8_t* __restrict__ w, const float* __restrict__ ws,
         LFactor f, float* __restrict__ out, int M, int N, int K,
         int jc_words, int act_words) {
  extern __shared__ int smem[];
  const int m0 = blockIdx.y * MT;
  const int mt = min(MT, M - m0);
  LFactor fm = f;
  fm.xr = f.xr + (size_t)m0 * f.ldxr;
  lowrank::lr_tile<BITS, CODE, MT, false, false>(
      reinterpret_cast<const int*>(xq) + (size_t)m0 * (K / 4), sx + m0, mt,
      K, w, ws, N, jc_words, blockIdx.x, fm, smem,
      reinterpret_cast<float*>(smem + act_words),
      [&](int m, int n, int, float v) { out[(size_t)(m0 + m) * N + n] = v; });
}

template <int BITS, int CODE, int MT>
cudaError_t launch_l(const int8_t* xq, const float* sx, const uint8_t* w,
                     const float* ws, const LFactor& f, float* out, int M,
                     int N, int K, cudaStream_t st) {
  constexpr int F = 8 / BITS;
  constexpr int RPB = Tile<MT>::kRowsPerBlock;
  const int mrows = M < MT ? M : MT;
  const int jc = pick_jc<F>(kSmemBytes, mrows, K);
  const int act_words = mrows * F * jc;
  const int nwin = lowrank::max_windows(N, RPB, f.splits);
  const size_t smem = (size_t)act_words * 4 + (size_t)nwin * MT * f.rank * 4;
  static const cudaError_t attr =
      lowrank::allow_smem(l_kernel<BITS, CODE, MT>, 200 * 1024);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + RPB - 1) / RPB, (M + MT - 1) / MT);
  l_kernel<BITS, CODE, MT><<<grid, kThreads, smem, st>>>(
      xq, sx, w, ws, f, out, M, N, K, jc, act_words);
  return cudaGetLastError();
}

template <int BITS, int CODE>
cudaError_t dispatch_l(const int8_t* xq, const float* sx, const uint8_t* w,
                       const float* ws, const LFactor& f, float* out, int M,
                       int N, int K, cudaStream_t st) {
  return M <= 8 ? launch_l<BITS, CODE, 8>(xq, sx, w, ws, f, out, M, N, K, st)
                : launch_l<BITS, CODE, 32>(xq, sx, w, ws, f, out, M, N, K,
                                           st);
}

// ---------------------------------------------------------------------------
// B. The LR-fused kernel: cooperative, xr in phase 1.
// ---------------------------------------------------------------------------

template <int BITS, int CODE, int MT>
__global__ void __launch_bounds__(kThreads)
lr_kernel(const float* __restrict__ x, const int8_t* __restrict__ xq,
          const float* __restrict__ sx, const uint8_t* __restrict__ w,
          const float* __restrict__ ws, const int8_t* __restrict__ R,
          const float* __restrict__ Rs, int nR, LFactor f, float* xr,
          float* __restrict__ out, int M, int N, int K, int jc_words) {
  constexpr int RPB = Tile<MT>::kRowsPerBlock;
  extern __shared__ int smem[];
  const int act_words = kCoopSmemBytes / 4;
  float* xrw = reinterpret_cast<float*>(smem + act_words);
  const int mtiles = (M + MT - 1) / MT;

  // phase 1: xr = (bf16(x) @ bf16(R).T) * Rs, kWarps rows of R per unit
  const int rgroups = (nR + kWarps - 1) / kWarps;
  for (int u = blockIdx.x; u < rgroups * mtiles; u += gridDim.x) {
    const int m0 = (u / rgroups) * MT;
    const int j0 = (u % rgroups) * kWarps;
    lowrank::xr_rows<MT, false>(x + (size_t)m0 * K, min(MT, M - m0), K,
                                R + (size_t)j0 * K, Rs + j0,
                                min(kWarps, nR - j0), xr + (size_t)m0 * nR + j0,
                                nR, reinterpret_cast<float*>(smem),
                                act_words);
  }
  lowrank::grid_sync();

  // phase 2: the l kernel's tiles, xr from the scratch
  const int ntiles = (N + RPB - 1) / RPB;
  for (int u = blockIdx.x; u < ntiles * mtiles; u += gridDim.x) {
    const int m0 = (u / ntiles) * MT;
    LFactor fm = f;
    fm.xr = xr + (size_t)m0 * nR;
    lowrank::lr_tile<BITS, CODE, MT, false, true>(
        reinterpret_cast<const int*>(xq) + (size_t)m0 * (K / 4), sx + m0,
        min(MT, M - m0), K, w, ws, N, jc_words, u % ntiles, fm, smem, xrw,
        [&](int m, int n, int, float v) {
          out[(size_t)(m0 + m) * N + n] = v;
        });
  }
}

template <int BITS, int CODE, int MT>
cudaError_t launch_lr(const float* x, const int8_t* xq, const float* sx,
                      const uint8_t* w, const float* ws, const int8_t* R,
                      const float* Rs, int nR, const LFactor& f, float* xr,
                      float* out, int M, int N, int K, cudaStream_t st) {
  constexpr int F = 8 / BITS;
  constexpr int RPB = Tile<MT>::kRowsPerBlock;
  auto kernel = lr_kernel<BITS, CODE, MT>;
  int jc = pick_jc<F>(kCoopSmemBytes, MT, K);
  const int nwin = lowrank::max_windows(N, RPB, f.splits);
  const size_t smem = kCoopSmemBytes + (size_t)nwin * MT * f.rank * 4;
  static const cudaError_t attr = lowrank::allow_smem(kernel, 200 * 1024);
  if (attr != cudaSuccess) return attr;
  const int mtiles = (M + MT - 1) / MT;
  const int units = max((N + RPB - 1) / RPB, (nR + kWarps - 1) / kWarps) *
                    mtiles;
  int grid = 0;
  cudaError_t err = lowrank::coop_grid(kernel, smem, units, &grid);
  if (err != cudaSuccess) return err;
  LFactor fc = f;
  void* args[] = {(void*)&x,  (void*)&xq, (void*)&sx, (void*)&w,
                  (void*)&ws, (void*)&R,  (void*)&Rs, (void*)&nR,
                  (void*)&fc, (void*)&xr, (void*)&out, (void*)&M,
                  (void*)&N,  (void*)&K,  (void*)&jc};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(kThreads), args, smem, st);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ---------------------------------------------------------------------------
// C. The whole-MLP kernel: cooperative, three phases on fused_proj.cuh
// ---------------------------------------------------------------------------

struct MlpArgs {
  const float* sx;     // (M) row scales of the int8 x
  const float* gu_gs;  // (2): gate, up global scales of the layer
  const int8_t* dn_R;  // (rank, im) of the layer
  const float* dn_Rs;  // (rank)
  float* mbuf;         // scratch (M, im) f32: m
  int8_t* m8;          // scratch (M, im) int8
  float* amax;         // scratch (G, MT) f32: each gate/up group's absmax
  float* xpart;        // scratch (G, rank, MT) f32: each group's xrd sums
  float* xrd;          // scratch (M, rank) f32
  int4* pws;           // split-group partial slots: 32 MT int4 a warp
  int* cnt;            // split-group counters, zero (and zero again after)
  float* out;          // (M, h) f32
  int M, h, im, rank;
};

// Shared memory for a stage's xr windows (bf16): gate/up's two at 32 rows
// and rank 128; larger ones are read from global memory.
constexpr int kMlpWin = 16 * 1024;

// Stage 0 (gate/up) and 1 (down) of pl; G = mtiles x im / 16 gate/up groups.
template <int BITS, int MT>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_kernel(const __grid_constant__ MlpArgs a,
               const __grid_constant__ fproj::Plan pl) {
  constexpr int NF = MT / 8;
  __shared__ float srow[128];           // the row scales of m
  __shared__ float red[kWarps][MT];     // the xrd reduce's warp sums
  __shared__ __align__(16) __nv_bfloat16 tsc[kWarps][MT * 16];  // bf16(m)
  uint8_t* ring = hopper::smem_1k();
  auto* wsm = reinterpret_cast<uint16_t*>(ring + kWarps * fproj::kWarpRing);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t = lane & 3, ra = mproj::smem_row(g8);
  const int M = a.M, im = a.im, rank = a.rank;
  const fproj::Stage& gu = pl.st[0];
  const fproj::Stage& dn = pl.st[1];
  const int groups = gu.groups;
  fproj::Ring rg;
  fproj::Stream q;
  // the first gate/up slabs load while R goes into L2 for the fold
  fproj::stream_start(pl, ring, rg, q);
  fproj::prefetch_grid(a.dn_R, (size_t)rank * im);
  const float gs_gate = a.gu_gs[0], gs_up = a.gu_gs[1];

  // phase 1: gate/up groups (16 gate rows, the same up rows), m = silu(gate)
  // * up, each group's row absmax of |m| and its part of xrd
  fproj::run_stage<BITS, MT, MT == 8>(
      pl, 0, q, rg, a.pws, a.cnt, wsm, kMlpWin,
      [&](int G, int mt, int g, int (&acc)[2][NF][4],
          float (&accl)[2][NF][4]) {
        const int rows = M - mt * MT, c0 = 16 * g;
        __nv_bfloat16* T = tsc[warp];
        float amax[NF][2];
#pragma unroll
        for (int f = 0; f < NF; ++f) amax[f][0] = amax[f][1] = 0.f;
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int i = ra + 8 * hi;  // m column c0 + i: gate row, up row
          const float gw = __ldg(gu.ws + c0 + i), gl = __ldg(gu.Ls + c0 + i);
          const float uw = __ldg(gu.ws + gu.half + c0 + i);
          const float ul = __ldg(gu.Ls + gu.half + c0 + i);
#pragma unroll
          for (int f = 0; f < NF; ++f)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int m = 8 * f + 2 * t + e, k = 2 * hi + e;
              float mv = 0.f;
              if (m < rows) {
                const float sxm = __ldg(a.sx + mt * MT + m);
                const float gv = __fmul_rn(
                    fproj::finish(acc[0][f][k], accl[0][f][k], gw, sxm, gl),
                    gs_gate);
                const float uv =
                    fproj::finish(acc[1][f][k], accl[1][f][k], uw, sxm, ul);
                const float sig =
                    __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-gv)));
                mv = __fmul_rn(__fmul_rn(gv, sig), __fmul_rn(uv, gs_up));
                a.mbuf[(size_t)(mt * MT + m) * im + c0 + i] = mv;
              }
              amax[f][e] = fmaxf(amax[f][e], fabsf(mv));
              T[m * 16 + i] = __float2bfloat16_rn(mv);
            }
        }
        // the group's absmax of each row: over the lanes of one t
#pragma unroll
        for (int f = 0; f < NF; ++f)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = amax[f][e];
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
            if (g8 == 0) a.amax[(size_t)G * MT + 8 * f + 2 * t + e] = v;
          }
        __syncwarp();  // T
        // the fold: xpart[G, j, m] = sum_i bf16(m[m, c0 + i]) R[j, c0 + i],
        // i < 16, for every R row j (mma m16n8k16: A = R rows, k = the
        // group's columns, lane t's logical k (2t, 2t+1 | 2t+8, 2t+9) =
        // columns 4t + (0, 1 | 2, 3); B = bf16(m) from T)
        unsigned b[NF][2];
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const uint2 v =
              *reinterpret_cast<const uint2*>(T + (8 * f + g8) * 16 + 4 * t);
          b[f][0] = v.x;
          b[f][1] = v.y;
        }
        __syncwarp();  // T read before the next group's epilogue writes it
        for (int j0 = 0; j0 < rank; j0 += 128) {
          unsigned rw[8][2];
#pragma unroll
          for (int jt = 0; jt < 8; ++jt)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              rw[jt][r] = __ldg(reinterpret_cast<const unsigned*>(
                  a.dn_R + (size_t)(j0 + 16 * jt + g8 + 8 * r) * im + c0 +
                  4 * t));
#pragma unroll
          for (int jt = 0; jt < 8; ++jt) {
            const unsigned a0 = fproj::widen2<0>(rw[jt][0]);
            const unsigned a2 = fproj::widen2<2>(rw[jt][0]);
            const unsigned a1 = fproj::widen2<0>(rw[jt][1]);
            const unsigned a3 = fproj::widen2<2>(rw[jt][1]);
#pragma unroll
            for (int f = 0; f < NF; ++f) {
              float d[4] = {0.f, 0.f, 0.f, 0.f};
              fproj::mma_bf16(d, a0, a1, a2, a3, b[f][0], b[f][1]);
              const int j = j0 + 16 * jt + g8, m = 8 * f + 2 * t;
              float* dst = a.xpart + ((size_t)G * rank + j) * MT + m;
              *reinterpret_cast<float2*>(dst) = make_float2(d[0], d[1]);
              *reinterpret_cast<float2*>(dst + 8 * MT) =
                  make_float2(d[2], d[3]);
            }
          }
        }
      });
  lowrank::grid_sync();

  // phase 2: the row scales of m (every CTA, for phase 3), its int8 codes,
  // and xrd[m, j] = (sum over the groups in order of xpart) * Rs[j]
  for (int m = warp; m < M; m += kWarps) {
    const int mt = m / MT, mm = m - mt * MT;
    float amax = 0.f;
    for (int gi = lane; gi < groups; gi += 32)
      amax = fmaxf(amax, __ldcg(a.amax + ((size_t)mt * groups + gi) * MT + mm));
    amax = lowrank::warp_max_f(amax);
    if (lane == 0) srow[m] = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
  }
  __syncthreads();
  for (size_t i = (size_t)blockIdx.x * kThreads + tid; i < (size_t)M * im;
       i += (size_t)gridDim.x * kThreads)
    a.m8[i] = fproj::code8(__ldcg(a.mbuf + i), srow[i / im]);
  {
    // item (mt, j) a CTA; warp w sums groups [w G / 8, (w + 1) G / 8), lane
    // (gs, mm) every (32 / MT)-th of them from gs, then the lanes of one mm
    // by a butterfly and the warps in order
    constexpr int GS = 32 / MT;
    const int mm = lane % MT, gs = lane / MT;
    const int glo = fproj::range_lo(groups, warp, kWarps);
    const int ghi = fproj::range_lo(groups, warp + 1, kWarps);
    for (int item = blockIdx.x; item < gu.mtiles * rank; item += gridDim.x) {
      const int mt = item / rank, j = item - mt * rank;
      const float* src = a.xpart + (size_t)mt * groups * rank * MT +
                         (size_t)j * MT + mm;
      float s = 0.f;
#pragma unroll 8
      for (int gi = glo + gs; gi < ghi; gi += GS)
        s = __fadd_rn(s, __ldcg(src + (size_t)gi * rank * MT));
#pragma unroll
      for (int off = MT; off < 32; off <<= 1)
        s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
      if (gs == 0) red[warp][mm] = s;
      __syncthreads();
      if (tid < MT && mt * MT + tid < M) {
        float tot = 0.f;
        for (int ww = 0; ww < kWarps; ++ww) tot = __fadd_rn(tot, red[ww][tid]);
        a.xrd[(size_t)(mt * MT + tid) * rank + j] =
            __fmul_rn(tot, __ldg(a.dn_Rs + j));
      }
      __syncthreads();
    }
  }
  lowrank::grid_sync();

  // phase 3: down on the int8 m with the L slabs on xrd (its first slabs
  // have been in flight since each warp's last gate/up slab)
  fproj::run_stage<BITS, MT, MT == 8>(
      pl, 1, q, rg, a.pws, a.cnt, wsm, kMlpWin,
      [&](int, int mt, int g, int (&acc)[2][NF][4],
          float (&accl)[2][NF][4]) {
        const int rows = M - mt * MT;
#pragma unroll
        for (int tl = 0; tl < 2; ++tl)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int n = 32 * g + 16 * tl + ra + 8 * hi;
            const float w = __ldg(dn.ws + n), l = __ldg(dn.Ls + n);
#pragma unroll
            for (int f = 0; f < NF; ++f)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int m = 8 * f + 2 * t + e;
                if (m < rows)
                  a.out[(size_t)(mt * MT + m) * a.h + n] = fproj::finish(
                      acc[tl][f][2 * hi + e], accl[tl][f][2 * hi + e], w,
                      srow[mt * MT + m], l);
              }
          }
      });
}

// The plan of a launch (ops/kernels.py::_mlp_plan mirrors it): gate/up
// groups of 16 gate rows and the same up rows of gu_w, down groups of 32
// rows; each of mtiles tiles of MT activation rows walks every group.
template <int BITS, int MT>
fproj::Plan mlp_plan(const int8_t* xq, const float* xr_gu,
                     const uint8_t* gu_w, const float* gu_s,
                     const int8_t* gu_L, const float* gu_Ls,
                     const uint8_t* dn_w, const float* dn_s,
                     const int8_t* dn_L, const float* dn_Ls,
                     const MlpArgs& a) {
  constexpr int F = 8 / BITS, KC = fproj::kKC;
  const int mtiles = (a.M + MT - 1) / MT;
  fproj::Plan pl{};
  fproj::Stage& s0 = pl.st[0];
  s0 = {gu_w, gu_L, gu_s, gu_Ls, xq, xr_gu, a.h / F, (a.h / F + KC - 1) / KC,
        a.rank / KC, a.im / 16, a.im, mtiles, a.M, a.h, 2 * a.rank, a.rank, 0};
  fproj::Stage& s1 = pl.st[1];
  s1 = {dn_w, dn_L, dn_s, dn_Ls, a.m8, a.xrd, a.im / F,
        (a.im / F + KC - 1) / KC, a.rank / KC, a.h / 32, 0, mtiles, a.M,
        a.im, a.rank, a.rank, 1};
  pl.nst = 2;
  return pl;
}

template <int BITS, int MT>
cudaError_t launch_mlp(const fproj::Plan& pl, const MlpArgs& a, int ctas,
                       cudaStream_t st, int* grid_only) {
  auto kernel = mlp_kernel<BITS, MT>;
  constexpr int smem = fproj::smem_bytes(kWarps, kMlpWin);
  cudaError_t err = hopper::allow_smem<mlp_kernel<BITS, MT>>(smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = lowrank::coop_grid(kernel, smem, 1 << 30, &grid, kThreads);
  if (err != cudaSuccess) return err;
  if (grid_only != nullptr) {
    *grid_only = grid;
    return cudaSuccess;
  }
  if (ctas > 0 && ctas < grid) grid = ctas;
  if (!fproj::fits32(pl, (long long)grid * kWarps))
    return cudaErrorInvalidValue;
  void* args[] = {(void*)&a, (void*)&pl};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(kThreads), args, smem, st);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ---------------------------------------------------------------------------
// D. xr on the tensor cores (the LR-fused tile path)
// ---------------------------------------------------------------------------
//
// The LR-fused matmul's tile path is two launches: xr_kernel writes xr =
// (bf16(x) @ R[l].T) * Rs[l] (M x nR f32, nR = n_proj * rank, and its bf16
// rounding), then w4a8_l_tile_launch (w4a8_tile.cuh with its L epilogue)
// runs on that bf16 xr.
// A launch of its own, not a prologue of the tile kernel: that kernel fills
// 224 KB of shared memory and takes every register setmaxnreg leaves it.
//
// xr is a GEMM of M x nR x K: 2 M nR K bf16 operations (6.4 GFLOP for
// Llama-2-7B's qkv at rank 128 and M 2048, 6.5 us at 989 TFLOP/s) over
// ~20 MB of bf16 x and int8 R. The design is the grouped kernel's M > 16
// path (grouped_matmul.cu) on one plane of signed codes: swap-AB, two
// consumer warpgroups of 64 R rows each (wgmma's A, the codes widened to
// bf16 straight into registers, exactly: r + 128 under the exponent of
// 2^23, less 2^23 + 128, is r), and NT (16, 64 or 128) rows of bf16 x (the
// wrapper's cast, by TMA, 128-byte swizzle) as wgmma's n columns; one
// producer warp keeps a ring of stages (128 R rows x 64 bytes, 64-byte
// swizzle, and NT x rows x 64 values) in flight. R's 256 or 384 rows are
// only two or three tiles, so K is split while the tiles leave SMs idle:
// each split writes its partial tile to a workspace and the last CTA of a
// tile sums them in split order (counters the caller keeps zeroed per
// stream and per graph capture), so launches repeat bit for bit.
//
// Measured alternative (H100, scripts/torch_w4a8_lr_times.py --sweep): R
// widened by the wrapper and both operands read by wgmma from shared
// memory, one step's products in flight while the next was issued: no
// faster at M 512 and 2048 (the kernel reads twice R's bytes through L2,
// which binds it there), slower at M 8, and the call paid a cast of R.
//
// Sums: the tensor cores round their f32 sums toward zero, so one chain of
// the 256 k16 slices of K 4096 would drift toward zero (an estimate, up to
// ~128 ulps of xr: one ulp a pair of slices; no one-chain build was run).
// The products chain on one accumulator for a block of kBlock steps (16
// slices), then the block's sum joins the running sum by a round-to-nearest
// f32 add, and the next block starts on a fresh accumulator (wgmma's
// scale-d 0): the truncations are those of short sums, of varying sign.
namespace xrk {

constexpr int kBK = 64;            // k a step: R bytes, x bf16 values
constexpr int kRows = 128;         // R rows a CTA
constexpr int kRaw = kRows * kBK;  // bytes of a stage's R codes
constexpr int kThreads = 256 + 32;
constexpr int kStages = 6;
constexpr int kBlock = 4;          // steps chained on one accumulator

template <int NT>
struct Shape {
  static constexpr int kXT = NT * 128;  // bytes of a stage's x tile
  static constexpr int kStage = kRaw + kXT;
  static constexpr int kSmem = kStages * kStage + 1024;
  static_assert(kStage % 1024 == 0, "1 KB aligned tiles");
};

struct Ring {
  uint64_t full[kStages];   // TMA bytes landed
  uint64_t empty[kStages];  // stage read by every consumer warp
};

// bf16(r_B) and bf16(r_{B+1}) of the signed bytes B, B + 1 of w, given
// as u = w ^ 0x80808080 (r + 128 a byte), in one register (byte B low).
template <int B>
__device__ __forceinline__ uint32_t widen2(uint32_t u) {
  constexpr float kOff = 8388608.f + 128.f;
  const float lo = __fsub_rn(
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + B)), kOff);
  const float hi = __fsub_rn(
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541 + B)), kOff);
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// grid (ceil(nR / 128), ceil(M / NT), splits): CTA (x, y, z) takes R rows
// 128 x .., x rows NT y .. and steps z split_steps .. of 64 k. ws: splits x
// tiles x 128 x NT f32 partials, counters: one int a tile (both unused
// when splits == 1). Each xr value is stored twice: in f32 to xr (M, nR),
// and rounded to bf16 to xb_out (M, nR / rank, rank8), the layout of the L
// tile kernel's A boxes (w4a8_tile.cuh), so no pass of its own casts it.
template <int NT>
__global__ void __launch_bounds__(kThreads)
xr_kernel(const __grid_constant__ CUtensorMap tr,
          const __grid_constant__ CUtensorMap tx, const float* __restrict__ Rs,
          float* __restrict__ xr, __nv_bfloat16* __restrict__ xb_out,
          float* __restrict__ ws, int* __restrict__ counters, int M, int nR,
          int K, int rank, int rank8, int split_steps) {
  using S = Shape<NT>;
  constexpr int kR = NT / 2;  // accumulators a thread
  __shared__ Ring ring;
  __shared__ int last;
  uint8_t* smem = hopper::smem_1k();
  const int n0 = blockIdx.x * kRows, m0 = blockIdx.y * NT;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int tiles = gridDim.x * gridDim.y;
  const int split = blockIdx.z, splits = gridDim.z;
  const int s0 = split * split_steps;
  const int steps = min(split_steps, (K + kBK - 1) / kBK - s0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&ring.full[s], 1);
      hopper::mbar_init(&ring.empty[s], 8);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // producer
    if (lane == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % kStages;
        hopper::mbar_wait(&ring.empty[s], ((i / kStages) & 1) ^ 1);
        uint8_t* st = smem + s * S::kStage;
        hopper::mbar_expect_tx(&ring.full[s], S::kStage);
        const int k = (s0 + i) * kBK;
        hopper::tma_load_2d(st, &tr, &ring.full[s], k, n0);
        hopper::tma_load_2d(st + kRaw, &tx, &ring.full[s], k, m0);
      }
    }
    return;
  }

  // lane 4 g + t of warp w: R rows rl and rl + 8 of the CTA's, wgmma's A
  // fragment rows of its warp
  const int g = lane >> 2, t = lane & 3;
  const int rl = 16 * warp + g;
  float acc[kR], sum[kR];
#pragma unroll
  for (int e = 0; e < kR; ++e) acc[e] = sum[e] = 0.f;
  for (int i = 0; i < steps; ++i) {
    const int s = i % kStages;
    hopper::mbar_wait(&ring.full[s], (i / kStages) & 1);
    const uint8_t* st = smem + s * S::kStage;
    // the A fragments of the step's four k16 slices: bytes c, c + 1, c + 8,
    // c + 9 of rows rl and rl + 8
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c = 16 * kk + 2 * t;
      const uint32_t u0 = __byte_perm(
          *reinterpret_cast<const uint16_t*>(st + hopper::sw64_u8(rl, c)),
          *reinterpret_cast<const uint16_t*>(st + hopper::sw64_u8(rl, c + 8)),
          0x5410) ^ 0x80808080u;
      const uint32_t u1 = __byte_perm(
          *reinterpret_cast<const uint16_t*>(st + hopper::sw64_u8(rl + 8, c)),
          *reinterpret_cast<const uint16_t*>(
              st + hopper::sw64_u8(rl + 8, c + 8)),
          0x5410) ^ 0x80808080u;
      a[kk][0] = widen2<0>(u0);
      a[kk][1] = widen2<0>(u1);
      a[kk][2] = widen2<2>(u0);
      a[kk][3] = widen2<2>(u1);
    }
    // every A register written before the first product; a block's first
    // product starts a fresh accumulator
    const int fresh = i % kBlock == 0;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_m64k16_rs<NT>(acc, a[kk],
                                  hopper::desc_sw128(st + kRaw + 32 * kk),
                                  !(fresh && kk == 0));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&ring.empty[s]);
    if (i % kBlock == kBlock - 1 || i == steps - 1) {
      hopper::fence_regs(acc);
#pragma unroll
      for (int e = 0; e < kR; ++e) sum[e] = __fadd_rn(sum[e], acc[e]);
      hopper::fence_regs(acc);
    }
  }

  // accumulator e = 4 c + 2 i + j: R row rl + 8 i, x row 8 c + 2 t + j of
  // the CTA's (wgmma's D fragment, here transposed)
  const int ldb = nR / rank * rank8;
  const auto store = [&](const float (&v)[kR]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = n0 + rl + 8 * i;
      if (n >= nR) continue;
      const float rs = Rs[n];
      const int nb = n / rank * rank8 + n % rank;
#pragma unroll
      for (int c = 0; c < NT / 8; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int m = m0 + 8 * c + 2 * t + j;
          if (m >= M) continue;
          const float y = __fmul_rn(v[4 * c + 2 * i + j], rs);
          xr[(size_t)m * nR + n] = y;
          xb_out[(size_t)m * ldb + nb] = __float2bfloat16_rn(y);
        }
    }
  };
  if (splits == 1) {
    store(sum);
    return;
  }
  if (hopper::splitk_sum<kRows, NT>(sum, ws, counters, tile, tiles, split,
                                    splits, rl, t, 256, &last))
    store(sum);
}

template <int NT>
cudaError_t launch(const void* xb, const void* R, const float* Rs, float* xr,
                   __nv_bfloat16* xb_out, float* ws, int* counters, int M,
                   int nR, int K, int rank, int rank8, int split_steps,
                   int splits, cudaStream_t st) {
  using S = Shape<NT>;
  CUtensorMap tr, tx;
  if (!hopper::map_u8_rows(&tr, R, nR, K, K, kRows) ||
      !hopper::map_bf16_rows(&tx, xb, M, K, K, NT))
    return cudaErrorInvalidValue;
  const cudaError_t err = hopper::allow_smem<xr_kernel<NT>>(S::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nR + kRows - 1) / kRows, (M + NT - 1) / NT, splits);
  xr_kernel<NT><<<grid, kThreads, S::kSmem, st>>>(
      tr, tx, Rs, xr, xb_out, ws, counters, M, nR, K, rank, rank8,
      split_steps);
  return cudaGetLastError();
}

}  // namespace xrk

bool valid_bits(int bits) { return bits == 2 || bits == 4 || bits == 8; }

Splits make_splits(int N, int n_proj, const int* b) {
  Splits s{N, N, N};
  if (n_proj > 1) s.b1 = b[0];
  if (n_proj > 2) s.b2 = b[1];
  if (n_proj > 3) s.b3 = b[2];
  return s;
}

}  // namespace

// xq (M, K) int8, sx (M) f32; packed (layers, N, K / f), scales (layers, N),
// L_cat (layers, N, rank) int8, L_scale (layers, N) f32; xr (M, n_proj *
// rank) f32; out (M, N) f32. b1..b3: the ends of projections 0..2 (n_proj
// projections in all, at most 4).
extern "C" int w4a8_l_stacked_launch(const void* xq, const void* sx,
                                     const void* packed, const void* scales,
                                     const void* xr, const void* L_cat,
                                     const void* L_scale, void* out, int M,
                                     int N, int K, int bits, int layer,
                                     int rank, int n_proj, int b1, int b2,
                                     int b3, void* stream) {
  if (!valid_bits(bits) || M < 1 || N < 1 || rank < 1 || n_proj < 1 ||
      n_proj > 4 || K % (16 * (8 / bits)) != 0)
    return (int)cudaErrorInvalidValue;
  const int f = 8 / bits;
  const int bs[3] = {b1, b2, b3};
  LFactor fl{static_cast<const float*>(xr), n_proj * rank,
             static_cast<const int8_t*>(L_cat) + (size_t)layer * N * rank,
             static_cast<const float*>(L_scale) + (size_t)layer * N, rank,
             make_splits(N, n_proj, bs)};
  const auto* w = static_cast<const uint8_t*>(packed) +
                  (size_t)layer * N * (K / f);
  const auto* ws = static_cast<const float*>(scales) + (size_t)layer * N;
  const auto* x = static_cast<const int8_t*>(xq);
  const auto* s = static_cast<const float*>(sx);
  auto* y = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bits == 2)
    err = dispatch_l<2, rowdot::kOffsetPacked>(x, s, w, ws, fl, y, M, N, K, st);
  else if (bits == 4)
    err = dispatch_l<4, rowdot::kOffsetPacked>(x, s, w, ws, fl, y, M, N, K, st);
  else
    err = dispatch_l<8, rowdot::kOffset8>(x, s, w, ws, fl, y, M, N, K, st);
  return (int)err;
}

// The same function at prefill M on the int8 wgmma tile path of
// w4a8_tile.cuh with its L epilogue on bf16 wgmma (w4a8_stacked.cu's tile
// kernel plus the L half): `rows` (64 or 128) activation rows and 128 weight
// rows a tile, walked by `ctas` persistent CTAs. xq, sx, packed, scales,
// L_scale, out and the sizes as w4a8_l_stacked_launch; the factor operands
// as the tile kernel reads them: xr_b = bf16(xr) as (M, n_proj, rank8) and
// L_b = the layer's L codes as bf16 (N, rank8), rank8 = rank rounded up to
// a multiple of 8 (zeros past the rank). K % (16 f) == 0 and K <= 2^31 /
// (127 * 255); xq, the layer's packed bytes, xr_b and L_b 16-byte aligned.
// Its integer half equals w4a8_l_stacked_launch's bit for bit; its factor
// sums run in another f32 order.
extern "C" int w4a8_l_tile_launch(const void* xq, const void* sx,
                                  const void* packed, const void* scales,
                                  const void* xr_b, const void* L_b,
                                  const void* L_scale, void* out, int M,
                                  int N, int K, int bits, int layer, int rank,
                                  int n_proj, int b1, int b2, int b3,
                                  int rows, int ctas, void* stream) {
  if (!valid_bits(bits) || layer < 0 || rank < 1 || n_proj < 1 ||
      n_proj > 4)
    return (int)cudaErrorInvalidValue;
  const int f = 8 / bits;
  const int bs[3] = {b1, b2, b3};
  const Splits sp = make_splits(N, n_proj, bs);
  const tile::LSrc lf{xr_b, L_b,
                      static_cast<const float*>(L_scale) + (size_t)layer * N,
                      rank, (rank + 7) / 8 * 8, n_proj, sp.b1, sp.b2, sp.b3};
  return (int)tile::launch_bits<true>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<const uint8_t*>(packed) + (size_t)layer * N * (K / f),
      static_cast<const float*>(scales) + (size_t)layer * N,
      static_cast<float*>(out), M, N, K, bits, rows, ctas, lf,
      static_cast<cudaStream_t>(stream));
}

// x (M, K) f32 (rounded to bf16 for xr), xq / sx its int8 codes and scales;
// R (layers, n_proj * rank, K) int8, R_scale (layers, n_proj * rank) f32;
// the rest as w4a8_l_stacked_launch; xr_scratch (M, n_proj * rank) f32.
extern "C" int w4a8_lr_stacked_launch(const void* x, const void* xq,
                                      const void* sx, const void* packed,
                                      const void* scales, const void* R,
                                      const void* R_scale, const void* L_cat,
                                      const void* L_scale, void* xr_scratch,
                                      void* out, int M, int N, int K,
                                      int bits, int layer, int rank,
                                      int n_proj, int b1, int b2, int b3,
                                      void* stream) {
  if (!valid_bits(bits) || M < 1 || N < 1 || rank < 1 || n_proj < 1 ||
      n_proj > 4 || K % (16 * (8 / bits)) != 0)
    return (int)cudaErrorInvalidValue;
  const int f = 8 / bits;
  const int nR = n_proj * rank;
  const int bs[3] = {b1, b2, b3};
  auto* xr = static_cast<float*>(xr_scratch);
  LFactor fl{xr, nR,
             static_cast<const int8_t*>(L_cat) + (size_t)layer * N * rank,
             static_cast<const float*>(L_scale) + (size_t)layer * N, rank,
             make_splits(N, n_proj, bs)};
  const auto* w = static_cast<const uint8_t*>(packed) +
                  (size_t)layer * N * (K / f);
  const auto* ws = static_cast<const float*>(scales) + (size_t)layer * N;
  const auto* Rl = static_cast<const int8_t*>(R) + (size_t)layer * nR * K;
  const auto* Rsl = static_cast<const float*>(R_scale) + (size_t)layer * nR;
  const auto* xf = static_cast<const float*>(x);
  const auto* xqp = static_cast<const int8_t*>(xq);
  const auto* s = static_cast<const float*>(sx);
  auto* y = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
#define LR_LAUNCH(B, C)                                                     \
  (M <= 8 ? launch_lr<B, C, 8>(xf, xqp, s, w, ws, Rl, Rsl, nR, fl, xr, y, M, \
                               N, K, st)                                    \
          : launch_lr<B, C, 32>(xf, xqp, s, w, ws, Rl, Rsl, nR, fl, xr, y,  \
                                M, N, K, st))
  cudaError_t err;
  if (bits == 2)
    err = LR_LAUNCH(2, rowdot::kOffsetPacked);
  else if (bits == 4)
    err = LR_LAUNCH(4, rowdot::kOffsetPacked);
  else
    err = LR_LAUNCH(8, rowdot::kOffset8);
#undef LR_LAUNCH
  return (int)err;
}

// xr = (bf16(x) @ R.T) * R_scale as f32 (M, nR) on the tensor cores (section
// D), for w4a8_l_tile_launch: xb (M, K) bf16, R (nR, K) int8 and R_scale
// (nR) f32, one layer's; xr also rounded to bf16 into xr_b (M, nR / rank,
// rank8), rank8 = rank rounded up to a multiple of 8 (its columns past the
// rank are left as they are: the caller zeroes them). `cols` (16, 64 or
// 128) activation rows and 128 R rows a tile; K is walked in `splits`
// splits of split_steps 64-k steps, the last possibly shorter and none
// empty; when splits > 1, ws holds splits x tiles x 128 x cols f32 and
// counters one zeroed int a tile, left zeroed (launches that may run at
// once need their own). K % 16 == 0, nR % rank == 0; xb and R 16-byte
// aligned.
extern "C" int w4a8_lr_xr_launch(const void* xb, const void* R,
                                 const void* R_scale, void* xr, void* xr_b,
                                 void* ws, void* counters, int M, int nR,
                                 int K, int rank, int cols, int split_steps,
                                 int splits, void* stream) {
  const int k_steps = (K + xrk::kBK - 1) / xrk::kBK;
  if (M < 1 || nR < 1 || K < 16 || K % 16 != 0 || rank < 1 ||
      nR % rank != 0 || xr_b == nullptr ||
      reinterpret_cast<uintptr_t>(xb) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(R) % 16 != 0 || split_steps < 1 ||
      splits < 1 || (splits - 1) * split_steps >= k_steps ||
      splits * split_steps < k_steps ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const auto* rs = static_cast<const float*>(R_scale);
  auto* y = static_cast<float*>(xr);
  auto* yb = static_cast<__nv_bfloat16*>(xr_b);
  auto* w = static_cast<float*>(ws);
  auto* c = static_cast<int*>(counters);
  const int rank8 = (rank + 7) / 8 * 8;
  auto st = static_cast<cudaStream_t>(stream);
  if (cols == 16)
    return (int)xrk::launch<16>(xb, R, rs, y, yb, w, c, M, nR, K, rank,
                                rank8, split_steps, splits, st);
  if (cols == 64)
    return (int)xrk::launch<64>(xb, R, rs, y, yb, w, c, M, nR, K, rank,
                                rank8, split_steps, splits, st);
  if (cols == 128)
    return (int)xrk::launch<128>(xb, R, rs, y, yb, w, c, M, nR, K, rank,
                                 rank8, split_steps, splits, st);
  return (int)cudaErrorInvalidValue;
}

// xq (M, h) int8, sx (M) f32, xr_gu (M, 2 * rank) f32; gu_* the layer-stacked
// gate ++ up tensors (packed (layers, 2 im, h / f), scales (layers, 2 im),
// L (layers, 2 im, rank), L scales (layers, 2 im), global scales (layers,
// 2)); dn_* the down tensors (packed (layers, h, im / f), scales (layers,
// h), R (layers, rank, im), R scales (layers, rank), L (layers, h, rank),
// L scales (layers, h)); scratch m (M, im) f32, m8 (M, im) int8, amax (G,
// MT) f32, xpart (G, rank, MT) f32, xrd (M, rank) f32, with MT = 8 when M
// <= 8 else 32 and G = ceil(M / MT) im / 16; pws 2 x 2 x 2 x (MT / 8) x
// 32 int4 per warp of the grid (8 a CTA: two split slots of i32 and f32
// partials); cnt G zeroed ints (left zeroed);
// out (M, h) f32. M <= 128, rank % 128 == 0, h % 32 == 0, im % 16 == 0.
// ctas: the CTAs of the launch, at most w4a8_mlp_grid's (0: that many).
extern "C" int w4a8_mlp_stacked_launch(
    const void* xq, const void* sx, const void* xr_gu, const void* gu_packed,
    const void* gu_scales, const void* gu_L, const void* gu_Ls,
    const void* gu_gs, const void* dn_packed, const void* dn_scales,
    const void* dn_R, const void* dn_Rs, const void* dn_L, const void* dn_Ls,
    void* mbuf, void* m8, void* amax, void* xpart, void* xrd, void* pws,
    void* cnt, void* out, int M, int h, int im, int bits, int layer,
    int rank, int ctas, void* stream) {
  if (!valid_bits(bits) || M < 1 || M > 128 || rank < 128 ||
      rank % 128 != 0 || h % 32 != 0 || im % 16 != 0 ||
      h % (16 * (8 / bits)) != 0 || im % (16 * (8 / bits)) != 0 || ctas < 0)
    return (int)cudaErrorInvalidValue;
  const int f = 8 / bits;
  const size_t l = layer;
  MlpArgs a{};
  a.sx = static_cast<const float*>(sx);
  a.gu_gs = static_cast<const float*>(gu_gs) + l * 2;
  a.dn_R = static_cast<const int8_t*>(dn_R) + l * rank * im;
  a.dn_Rs = static_cast<const float*>(dn_Rs) + l * rank;
  a.mbuf = static_cast<float*>(mbuf);
  a.m8 = static_cast<int8_t*>(m8);
  a.amax = static_cast<float*>(amax);
  a.xpart = static_cast<float*>(xpart);
  a.xrd = static_cast<float*>(xrd);
  a.pws = static_cast<int4*>(pws);
  a.cnt = static_cast<int*>(cnt);
  a.out = static_cast<float*>(out);
  a.M = M;
  a.h = h;
  a.im = im;
  a.rank = rank;
  const auto* x8 = static_cast<const int8_t*>(xq);
  const auto* xr = static_cast<const float*>(xr_gu);
  const auto* gw = static_cast<const uint8_t*>(gu_packed) + l * 2 * im * (h / f);
  const auto* gs = static_cast<const float*>(gu_scales) + l * 2 * im;
  const auto* gL = static_cast<const int8_t*>(gu_L) + l * 2 * im * rank;
  const auto* gLs = static_cast<const float*>(gu_Ls) + l * 2 * im;
  const auto* dw = static_cast<const uint8_t*>(dn_packed) + l * h * (im / f);
  const auto* ds = static_cast<const float*>(dn_scales) + l * h;
  const auto* dL = static_cast<const int8_t*>(dn_L) + l * h * rank;
  const auto* dLs = static_cast<const float*>(dn_Ls) + l * h;
  auto st = static_cast<cudaStream_t>(stream);
#define MLP_LAUNCH(B)                                                        \
  (M <= 8 ? launch_mlp<B, 8>(mlp_plan<B, 8>(x8, xr, gw, gs, gL, gLs, dw, ds, \
                                             dL, dLs, a),                    \
                             a, ctas, st, nullptr)                           \
          : launch_mlp<B, 32>(mlp_plan<B, 32>(x8, xr, gw, gs, gL, gLs, dw,   \
                                               ds, dL, dLs, a),              \
                              a, ctas, st, nullptr))
  cudaError_t err;
  if (bits == 2)
    err = MLP_LAUNCH(2);
  else if (bits == 4)
    err = MLP_LAUNCH(4);
  else
    err = MLP_LAUNCH(8);
#undef MLP_LAUNCH
  return (int)err;
}

// The most CTAs a w4a8_mlp_stacked_launch of M rows at `bits` runs (the
// cooperative grid: CTAs an SM x SMs), into *ctas.
extern "C" int w4a8_mlp_grid(int M, int bits, void* ctas) {
  if (!valid_bits(bits) || M < 1 || M > 128 || ctas == nullptr)
    return (int)cudaErrorInvalidValue;
  int* out = static_cast<int*>(ctas);
  const fproj::Plan pl{};
  const MlpArgs a{};
#define MLP_GRID(B)                                                       \
  (M <= 8 ? launch_mlp<B, 8>(pl, a, 0, nullptr, out)                      \
          : launch_mlp<B, 32>(pl, a, 0, nullptr, out))
  cudaError_t err;
  if (bits == 2)
    err = MLP_GRID(2);
  else if (bits == 4)
    err = MLP_GRID(4);
  else
    err = MLP_GRID(8);
#undef MLP_GRID
  return (int)err;
}
