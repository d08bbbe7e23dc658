// W4A8 matmuls with the CALDERA low-rank factors fused in, against one layer
// of stacked weights. Three entries, each replacing one TPU kernel of
// ee274_convexcaldera_llm_quantization_tpu/ops/kernels.py:
//
// - w4a8_l_stacked_launch: quantized_matmul_w4a8_l_stacked
//   (_qmm_w4a8_l_stacked_kernel). The stacked W4A8 matmul of w4a8_stacked.cu
//   plus the L half of the factors, for a fusion group of same-input
//   projections (qkv, gate/up; o and down as groups of one); the thin
//   xr = (bf16(x) @ bf16(R[l]).T) * Rs comes in from the caller.
// - w4a8_lr_stacked_launch: quantized_matmul_w4a8_lr_stacked
//   (_qmm_w4a8_lr_stacked_kernel). The same with xr computed in the kernel.
//   The TPU kernel computes xr at grid step j == 0 and carries it through
//   its sequential grid; blocks of a GPU share nothing, and recomputing xr
//   in each of the ~400 CTAs would read R (1.5 MB for Llama-2-7B's qkv) and
//   x once per CTA. So it is a cooperative launch of as many CTAs as fit on
//   the card at once: phase 1 writes xr (M x n_proj * rank f32) to scratch,
//   one warp per R row, then a grid-wide barrier, then phase 2 is the l
//   kernel's tile body in a loop over the output row tiles. It runs only
//   when asked for: the same function as two launches, w4a8_lr_xr_launch
//   (section D: xr on the tensor cores) and then w4a8_l_tile_launch on its
//   xr, was faster at every M measured.
// - w4a8_mlp_stacked_launch: quantized_matmul_w4a8_mlp_stacked
//   (_qmm_w4a8_mlp_stacked_kernel). down(silu(gate(x)) * up(x)) in one
//   cooperative launch, three phases split by two grid barriers:
//   1. each tile of rows n computes gate rows n and up rows im + n (W4A8 +
//      L epilogue, global scales applied), m = (g * sigmoid(g)) * u to a
//      global f32 scratch (M x im, L2-resident), and its per-row absmax of
//      |m| into a partial buffer (one slot per tile: no atomics);
//   2. every CTA reduces the partials to the row scales sm = max(amax,
//      1e-12) / 127; the grid requantizes m to int8 (round half to even,
//      clip 127) and computes xrd = (bf16(m) @ bf16(dnR).T) * dnRs;
//   3. the down projection, W4A8 on the int8 m with the L epilogue on xrd.
//   The result is returned before down's global scale, as on the TPU.
//
// Bound on an H100: the weight bytes at decode's M (4-bit packed codes plus
// the int8 L factors: 4096 x 12288 / 2 + 12288 x 128 bytes for qkv; ~137 MB
// for a Llama-2-7B MLP), since M <= 32 rows make every phase a skinny GEMM.
// Each packed weight byte is read once (rowdot.cuh's design), each L byte
// once per row tile; the cooperative kernels keep xr, m and its int8 codes
// in global scratch that stays in the 50 MB L2 rather than recomputing per
// CTA. Sums are deterministic: integer sums are exact, the factor sums a
// fixed order, and the absmax partials are reduced by every CTA in the
// same order (max does not depend on it).
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
// C. The whole-MLP megakernel: cooperative, three phases.
// ---------------------------------------------------------------------------

struct MlpArgs {
  const int8_t* xq;      // (M, h) int8
  const float* sx;       // (M) f32
  const float* xr_gu;    // (M, 2 * rank) f32
  const uint8_t* gu_w;   // (2 * im, h / F) of this layer
  const float* gu_s;     // (2 * im)
  const int8_t* gu_L;    // (2 * im, rank)
  const float* gu_Ls;    // (2 * im)
  const float* gu_gs;    // (2): gate, up global scales
  const uint8_t* dn_w;   // (h, im / F)
  const float* dn_s;     // (h)
  const int8_t* dn_R;    // (rank, im)
  const float* dn_Rs;    // (rank)
  const int8_t* dn_L;    // (h, rank)
  const float* dn_Ls;    // (h)
  float* mbuf;           // scratch (M, im) f32: m
  float* amax_part;      // scratch (ceil(im / RPB), M) f32
  int8_t* m8;            // scratch (M, im) int8
  float* xrd;            // scratch (M, rank) f32
  float* out;            // (M, h) f32
  int M, h, im, rank, jc_gu, jc_dn;
};

template <int BITS, int CODE, int MT>
__global__ void __launch_bounds__(kThreads) mlp_kernel(MlpArgs a) {
  constexpr int RPB = Tile<MT>::kRowsPerBlock;
  extern __shared__ int smem[];
  __shared__ float g_s[RPB * MT];  // gate values, then |m|, of a tile
  __shared__ float srow[128];      // the row scales sm of m
  const int act_words = kCoopSmemBytes / 4;
  float* xrw = reinterpret_cast<float*>(smem + act_words);
  const int M = a.M, h = a.h, im = a.im, rank = a.rank;
  const int mtiles = (M + MT - 1) / MT;
  const int n1 = (im + RPB - 1) / RPB;
  const Splits one{1 << 30, 1 << 30, 1 << 30};
  const float gs_gate = a.gu_gs[0], gs_up = a.gu_gs[1];

  // phase 1: gate and up rows of a tile, m = silu(gate) * up, row absmax
  for (int u = blockIdx.x; u < n1 * mtiles; u += gridDim.x) {
    const int t = u % n1;
    const int m0 = (u / n1) * MT;
    const int mt = min(MT, M - m0);
    const int* x32 = reinterpret_cast<const int*>(a.xq) + (size_t)m0 * (h / 4);
    LFactor fg{a.xr_gu + (size_t)m0 * 2 * rank, 2 * rank, a.gu_L, a.gu_Ls,
               rank, one};
    lowrank::lr_tile<BITS, CODE, MT, false, false>(
        x32, a.sx + m0, mt, h, a.gu_w, a.gu_s, im, a.jc_gu, t, fg, smem, xrw,
        [&](int m, int, int rl, float v) {
          g_s[rl * MT + m] = __fmul_rn(v, gs_gate);
        });
    LFactor fu{a.xr_gu + (size_t)m0 * 2 * rank + rank, 2 * rank,
               a.gu_L + (size_t)im * rank, a.gu_Ls + im, rank, one};
    lowrank::lr_tile<BITS, CODE, MT, false, false>(
        x32, a.sx + m0, mt, h, a.gu_w + (size_t)im * (h / (8 / BITS)),
        a.gu_s + im, im, a.jc_gu, t, fu, smem, xrw,
        [&](int m, int n, int rl, float v) {
          const float g = g_s[rl * MT + m];
          const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g)));
          const float mv = __fmul_rn(__fmul_rn(g, sig), __fmul_rn(v, gs_up));
          a.mbuf[(size_t)(m0 + m) * im + n] = mv;
          g_s[rl * MT + m] = fabsf(mv);
        });
    __syncthreads();
    if ((int)threadIdx.x < mt) {
      float amax = 0.f;
      for (int rl = 0; rl < RPB && t * RPB + rl < im; ++rl)
        amax = fmaxf(amax, g_s[rl * MT + threadIdx.x]);
      a.amax_part[(size_t)t * M + m0 + threadIdx.x] = amax;
    }
  }
  lowrank::grid_sync();

  // phase 2: row scales, int8 m, xrd = (bf16(m) @ bf16(dnR).T) * dnRs
  for (int m = threadIdx.x; m < M; m += kThreads) {
    float amax = 0.f;
    for (int t = 0; t < n1; ++t)
      amax = fmaxf(amax, __ldcg(a.amax_part + (size_t)t * M + m));
    srow[m] = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
  }
  __syncthreads();
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
       i < (size_t)M * im; i += (size_t)gridDim.x * kThreads) {
    const float q = rintf(__fdiv_rn(__ldcg(a.mbuf + i), srow[i / im]));
    a.m8[i] = (int8_t)fminf(fmaxf(q, -127.f), 127.f);
  }
  const int rgroups = (rank + kWarps - 1) / kWarps;
  for (int u = blockIdx.x; u < rgroups * mtiles; u += gridDim.x) {
    const int m0 = (u / rgroups) * MT;
    const int j0 = (u % rgroups) * kWarps;
    lowrank::xr_rows<MT, true>(a.mbuf + (size_t)m0 * im, min(MT, M - m0), im,
                               a.dn_R + (size_t)j0 * im, a.dn_Rs + j0,
                               min(kWarps, rank - j0),
                               a.xrd + (size_t)m0 * rank + j0, rank,
                               reinterpret_cast<float*>(smem), act_words);
  }
  lowrank::grid_sync();

  // phase 3: down on the int8 m with the L epilogue on xrd
  const int n3 = (h + RPB - 1) / RPB;
  for (int u = blockIdx.x; u < n3 * mtiles; u += gridDim.x) {
    const int m0 = (u / n3) * MT;
    LFactor fd{a.xrd + (size_t)m0 * rank, rank, a.dn_L, a.dn_Ls, rank, one};
    lowrank::lr_tile<BITS, CODE, MT, true, true>(
        reinterpret_cast<const int*>(a.m8) + (size_t)m0 * (im / 4),
        srow + m0, min(MT, M - m0), im, a.dn_w, a.dn_s, h, a.jc_dn, u % n3,
        fd, smem, xrw, [&](int m, int n, int, float v) {
          a.out[(size_t)(m0 + m) * h + n] = v;
        });
  }
}

template <int BITS, int CODE, int MT>
cudaError_t launch_mlp(MlpArgs a, cudaStream_t st) {
  constexpr int F = 8 / BITS;
  constexpr int RPB = Tile<MT>::kRowsPerBlock;
  auto kernel = mlp_kernel<BITS, CODE, MT>;
  a.jc_gu = pick_jc<F>(kCoopSmemBytes, MT, a.h);
  a.jc_dn = pick_jc<F>(kCoopSmemBytes, MT, a.im);
  const size_t smem = kCoopSmemBytes + (size_t)MT * a.rank * 4;
  static const cudaError_t attr = lowrank::allow_smem(kernel, 200 * 1024);
  if (attr != cudaSuccess) return attr;
  const int mtiles = (a.M + MT - 1) / MT;
  const int units = ((a.im + RPB - 1) / RPB) * mtiles;
  int grid = 0;
  cudaError_t err = lowrank::coop_grid(kernel, smem, units, &grid);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&a};
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
// L scales (layers, h)); scratch m (M, im) f32, amax (ceil(im / tile), M)
// f32 with tile = 32 rows when M <= 8 else 8, m8 (M, im) int8, xrd (M,
// rank) f32; out (M, h) f32. M <= 128.
extern "C" int w4a8_mlp_stacked_launch(
    const void* xq, const void* sx, const void* xr_gu, const void* gu_packed,
    const void* gu_scales, const void* gu_L, const void* gu_Ls,
    const void* gu_gs, const void* dn_packed, const void* dn_scales,
    const void* dn_R, const void* dn_Rs, const void* dn_L, const void* dn_Ls,
    void* mbuf, void* amax_part, void* m8, void* xrd, void* out, int M, int h,
    int im, int bits, int layer, int rank, void* stream) {
  if (!valid_bits(bits) || M < 1 || M > 128 || rank < 1 ||
      h % (16 * (8 / bits)) != 0 || im % (16 * (8 / bits)) != 0)
    return (int)cudaErrorInvalidValue;
  const int f = 8 / bits;
  const size_t l = layer;
  MlpArgs a{};
  a.xq = static_cast<const int8_t*>(xq);
  a.sx = static_cast<const float*>(sx);
  a.xr_gu = static_cast<const float*>(xr_gu);
  a.gu_w = static_cast<const uint8_t*>(gu_packed) + l * 2 * im * (h / f);
  a.gu_s = static_cast<const float*>(gu_scales) + l * 2 * im;
  a.gu_L = static_cast<const int8_t*>(gu_L) + l * 2 * im * rank;
  a.gu_Ls = static_cast<const float*>(gu_Ls) + l * 2 * im;
  a.gu_gs = static_cast<const float*>(gu_gs) + l * 2;
  a.dn_w = static_cast<const uint8_t*>(dn_packed) + l * h * (im / f);
  a.dn_s = static_cast<const float*>(dn_scales) + l * h;
  a.dn_R = static_cast<const int8_t*>(dn_R) + l * rank * im;
  a.dn_Rs = static_cast<const float*>(dn_Rs) + l * rank;
  a.dn_L = static_cast<const int8_t*>(dn_L) + l * h * rank;
  a.dn_Ls = static_cast<const float*>(dn_Ls) + l * h;
  a.mbuf = static_cast<float*>(mbuf);
  a.amax_part = static_cast<float*>(amax_part);
  a.m8 = static_cast<int8_t*>(m8);
  a.xrd = static_cast<float*>(xrd);
  a.out = static_cast<float*>(out);
  a.M = M;
  a.h = h;
  a.im = im;
  a.rank = rank;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define MLP_LAUNCH(B, C) \
  (M <= 8 ? launch_mlp<B, C, 8>(a, st) : launch_mlp<B, C, 32>(a, st))
  if (bits == 2)
    err = MLP_LAUNCH(2, rowdot::kOffsetPacked);
  else if (bits == 4)
    err = MLP_LAUNCH(4, rowdot::kOffsetPacked);
  else
    err = MLP_LAUNCH(8, rowdot::kOffset8);
#undef MLP_LAUNCH
  return (int)err;
}
