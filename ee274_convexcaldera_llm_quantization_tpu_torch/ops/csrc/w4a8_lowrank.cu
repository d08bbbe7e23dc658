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
//   kernel's tile body in a loop over the output row tiles.
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
