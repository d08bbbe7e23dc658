// The whole decode step of an MHA Llama model, every layer, in one
// cooperative launch (csrc/megastep.cu builds it for 4-bit codes,
// csrc/megastep_2bit.cu for 2-bit ones): replaces the TPU kernel
// ee274_convexcaldera_llm_quantization_tpu/ops/megastep.py::megastep
// (_megastep_kernel).
//
// The TPU kernel walks one sequential (layer, program) grid and keeps the
// hidden state and every intermediate in VMEM scratch. Blocks of a GPU run
// in parallel and carry nothing from one to the next, so here every CTA
// that fits on the card at once (occupancy query x SMs, memoized) runs one
// loop over the layers, and each layer is eleven stages split by grid-wide
// barriers; the state between stages lives in global scratch (under 1 MB
// at Llama-2-7B, batch 8), which stays in the 50 MB L2:
//
//   1. PRE    one CTA per row: RMSNorm (attn_norm), y (f32), its int8 codes
//             and row scale;
//   2. XRQ    xr = (bf16(y) @ bf16(R_qkv).T) * Rs, one warp per R row;
//   3. QKV    the W4A8 row tiles of the fused q/k/v projection with the L
//             epilogue on xr and each row's global scale;
//   4. ATTN   one CTA per (b, head) stream: rotate-half RoPE on q and k,
//             int8 K and V of the current token (outputs), then the staged
//             flash-decode attention over the cache with f32 dots
//             (flash_decode.cuh) and the stream's absmax of the output;
//   5. FIN    every CTA reduces the absmax partials to the row scales; the
//             grid requantizes the attention output to int8 and computes
//             xr_o = (bf16(ao) @ bf16(R_o).T) * Rs;
//   6. O      the o_proj tiles, x += out * gs_o;
//   7. MLP    as PRE on mlp_norm;
//   8. XRG    as XRQ on the gate/up R;
//   9. GU     each unit one tile of gate rows and the same tile of up rows
//             of the INTERLEAVED gate/up arrays (block j of bng rows: gate
//             rows [2j bng, 2j bng + bng), up rows the next bng), m =
//             silu(gate) * up to scratch, the tile's absmax of |m| into a
//             partial slot (one per tile: no atomics);
//  10. DQ     row scales max(absmax, 1e-12) / 127 of the f32 m, the int8
//             codes of bf16(m), and xrd = (bf16(m) @ bf16(R_down).T) * Rs;
//  11. DOWN   the down_proj tiles on those codes, x += out * gs_down.
//
// The pieces are those of the per-kernel paths: lowrank.cuh's lr_tile
// (rowdot.cuh's W4A8 row tile plus the L epilogue) for the four projection
// stages, xr_rows for the thin R contractions, and flash_decode.cuh's
// decode_attend for the attention. Data written by another CTA of the launch
// is read through L2 (__ldcg, the CG flags), never the read-only path.
// Multiplies and adds upstream of an int8 rounding are rounded one by one
// (__fmul_rn / __fadd_rn), in the reference's order; the integer sums are
// exact; the f32 sums a fixed order, so a launch is deterministic.
//
// Bound on an H100: the bytes of one step, read once: every layer's packed
// codes (101 MB at Llama-2-7B, 4-bit), int8 factors (10 MB) and scales,
// plus the live int8 K/V of the cache (8.7 MB per layer at batch 8, 128
// tokens): ~3.85 GB per step, ~1.15 ms at 3.35 TB/s. The design reads each
// packed byte once and keeps every activation in L2; its cost beyond the
// bound is the 11 barriers per layer and the stages that cannot fill the
// card (PRE: B CTAs; O and DOWN: h / 32 row tiles).
#pragma once

#include "flash_decode.cuh"
#include "lowrank.cuh"

namespace megastep {

using lowrank::kCoopSmemBytes;
using lowrank::LFactor;
using lowrank::pick_jc;
using lowrank::Splits;
using rowdot::kThreads;
using rowdot::kWarps;
using rowdot::Tile;

// Pointers and sizes of one step; layer-stacked tensors point at layer 0.
// The Python side (ops/megastep.py::_MegaArgs) mirrors this layout.
struct MegaArgs {
  // inputs
  const float* x0;      // (B, h) embedding rows
  const int* pos;       // (B) current positions
  const float* cos;     // (B, D / 2) RoPE tables of the current positions
  const float* sin;
  const float* an;      // (L, h) attn_norm
  const float* mn;      // (L, h) mlp_norm
  const float* gs;      // (L, 8) global scales q, k, v, o, gate, up, down, 0
  const uint8_t* q_w;   // (L, 3 qdim, h / F) fused q/k/v codes
  const float* q_s;     // (L, 3 qdim)
  const int8_t* q_R;    // (L, 3 rank, h)
  const float* q_Rs;    // (L, 3 rank)
  const int8_t* q_L;    // (L, 3 qdim, rank) N-concatenated
  const float* q_Ls;    // (L, 3 qdim)
  const uint8_t* o_w;   // (L, h, qdim / F)
  const float* o_s;     // (L, h)
  const int8_t* o_R;    // (L, rank, qdim)
  const float* o_Rs;    // (L, rank)
  const int8_t* o_L;    // (L, h, rank)
  const float* o_Ls;    // (L, h)
  const uint8_t* g_w;   // (L, 2 im, h / F) interleaved gate/up
  const float* g_s;     // (L, 2 im)
  const int8_t* g_R;    // (L, 2 rank, h)
  const float* g_Rs;    // (L, 2 rank)
  const int8_t* g_L;    // (L, 2 im, rank) interleaved
  const float* g_Ls;    // (L, 2 im)
  const uint8_t* d_w;   // (L, h, im / F)
  const float* d_s;     // (L, h)
  const int8_t* d_R;    // (L, rank, im)
  const float* d_Rs;    // (L, rank)
  const int8_t* d_L;    // (L, h, rank)
  const float* d_Ls;    // (L, h)
  const int8_t* kc;     // (L, B, KVH, T, D) head-major int8 cache
  const int8_t* vc;
  const float* kcs;     // (L, B, KVH, T)
  const float* vcs;
  // outputs
  float* x;             // (B, h): the residual, the step's output at the end
  int8_t* k8;           // (L, B, KVH, D) this step's K codes
  float* ks8;           // (L, B, KVH)
  int8_t* v8;
  float* vs8;
  // scratch
  float* y;             // (B, h) normed activations
  int8_t* a8;           // (B, max(h, qdim, im)) int8 activations
  float* sy;            // (B) their row scales (PRE, MLP)
  float* xr;            // (B, 3 rank) the thin R contraction of a stage
  float* xrd;           // (B, rank) down's
  float* qkv;           // (B, 3 qdim)
  float* qrot;          // (B, qdim) rotated q
  float* kf;            // (B, qdim) dequantized current-token K
  float* vf;            // (B, qdim) and V
  float* ao;            // (B, qdim) attention output
  float* part;          // absmax partials: (KVH, B), then (im / RPB, B)
  float* m;             // (B, im) silu(gate) * up
  int L, B, h, im, KVH, D, T, bt, rank, bng;
  int jc_h, jc_q, jc_im;  // activation words per staged chunk (lr_tile)
  float eps, scale;
};

__device__ __forceinline__ int8_t code8(float v, float s) {
  return (int8_t)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
}

// Stages PRE and MLP for the rows b = blockIdx.x, + gridDim.x, ...: y =
// (x * rsqrt(mean(x^2) + eps)) * w, its int8 codes and row scale. At layer 0
// the rows come from x0 and are copied into the residual x.
__device__ __forceinline__ void norm_quant(const MegaArgs& a,
                                           const float* xin, bool init,
                                           const float* w, float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = a.h;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const float* xr = xin + (size_t)b * h;
    float ss = 0.f;
    for (int k = tid; k < h; k += kThreads) {
      const float v = __ldcg(xr + k);
      ss = __fadd_rn(ss, __fmul_rn(v, v));
    }
    ss = lowrank::warp_sum_f(ss);
    if (lane == 0) red[warp] = ss;
    __syncthreads();
    float tot = 0.f;
    for (int i = 0; i < kWarps; ++i) tot = __fadd_rn(tot, red[i]);
    const float r = __fdiv_rn(
        1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn(tot, (float)h), a.eps)));
    float amax = 0.f;
    for (int k = tid; k < h; k += kThreads) {
      const float v = __ldcg(xr + k);
      if (init) a.x[(size_t)b * h + k] = v;
      const float yv = __fmul_rn(__fmul_rn(v, r), w[k]);
      a.y[(size_t)b * h + k] = yv;
      amax = fmaxf(amax, fabsf(yv));
    }
    amax = lowrank::warp_max_f(amax);
    __syncthreads();  // every thread has read tot
    if (lane == 0) red[warp] = amax;
    __syncthreads();
    amax = red[0];
    for (int i = 1; i < kWarps; ++i) amax = fmaxf(amax, red[i]);
    const float sx = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
    for (int k = tid; k < h; k += kThreads) {
      const float yv = __fmul_rn(__fmul_rn(__ldcg(xr + k), r), w[k]);
      a.a8[(size_t)b * h + k] = code8(yv, sx);
    }
    if (tid == 0) a.sy[b] = sx;
    __syncthreads();  // red is reused by the next row
  }
}

// out[b, j] = (sum_k bf16(act[b, k]) * R[j, k]) * Rs[j] for the nR rows of
// R, kWarps rows per unit (lowrank::xr_rows, activations from scratch).
template <int MT>
__device__ __forceinline__ void thin_rows(const float* act, int B, int K,
                                          const int8_t* R, const float* Rs,
                                          int nR, float* out, int* smem) {
  const int groups = (nR + kWarps - 1) / kWarps;
  for (int u = blockIdx.x; u < groups; u += gridDim.x) {
    const int j0 = u * kWarps;
    lowrank::xr_rows<MT, true>(act, B, K, R + (size_t)j0 * K, Rs + j0,
                               min(kWarps, nR - j0), out + j0, nR,
                               reinterpret_cast<float*>(smem),
                               kCoopSmemBytes / 4);
  }
}

// srow[b] = max(max_t part[t * B + b], 1e-12) / 127 over n partials: one
// warp per row, the lanes over the partials (max is order-free).
__device__ __forceinline__ void row_scales(const float* part, int n, int B,
                                           float* srow) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = warp; b < B; b += kWarps) {
    float amax = 0.f;
    for (int t = lane; t < n; t += 32)
      amax = fmaxf(amax, __ldcg(part + (size_t)t * B + b));
    amax = lowrank::warp_max_f(amax);
    if (lane == 0) srow[b] = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
  }
  __syncthreads();
}

template <int BITS, int MT>
__global__ void __launch_bounds__(kThreads) megastep_kernel(MegaArgs a) {
  constexpr int F = 8 / BITS;
  constexpr int CODE = rowdot::kOffsetPacked;
  constexpr int RPB = Tile<MT>::kRowsPerBlock;
  extern __shared__ int smem[];
  __shared__ float srow[32];       // row scales of the int8 activations
  __shared__ float red[kWarps];    // block reductions
  __shared__ float g_s[RPB * MT];  // a GU tile's gate values, then |m|
  __shared__ float sq[flash_decode::kMaxD], sk[flash_decode::kMaxD];
  __shared__ float kmax_s[kWarps], vmax_s[kWarps];
  float* xrw = reinterpret_cast<float*>(smem + kCoopSmemBytes / 4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = a.B, h = a.h, im = a.im, rank = a.rank, D = a.D;
  const int KVH = a.KVH, qdim = KVH * D, nq = 3 * qdim;
  const Splits one{1 << 30, 1 << 30, 1 << 30};
  const Splits qkv_splits{qdim, 2 * qdim, nq};

  for (int l = 0; l < a.L; ++l) {
    const size_t ll = l;
    const float* gs = a.gs + ll * 8;

    // 1. PRE
    norm_quant(a, l == 0 ? a.x0 : a.x, l == 0, a.an + ll * h, red);
    lowrank::grid_sync();

    // 2. XRQ
    thin_rows<MT>(a.y, B, h, a.q_R + ll * 3 * rank * h, a.q_Rs + ll * 3 * rank,
                  3 * rank, a.xr, smem);
    lowrank::grid_sync();

    // 3. QKV
    for (int b = tid; b < B; b += kThreads) srow[b] = __ldcg(a.sy + b);
    {
      const LFactor f{a.xr, 3 * rank, a.q_L + ll * nq * rank, a.q_Ls + ll * nq,
                      rank, qkv_splits};
      const uint8_t* w = a.q_w + ll * nq * (h / F);
      const float* ws = a.q_s + ll * nq;
      for (int t = blockIdx.x; t < nq / RPB; t += gridDim.x)
        lowrank::lr_tile<BITS, CODE, MT, true, true>(
            reinterpret_cast<const int*>(a.a8), srow, B, h, w, ws, nq, a.jc_h,
            t, f, smem, xrw, [&](int m, int n, int, float v) {
              const int p = lowrank::proj_of(n, qkv_splits);
              a.qkv[(size_t)m * nq + n] = __fmul_rn(v, gs[p]);
            });
    }
    lowrank::grid_sync();

    // 4. ATTN: RoPE and K/V quantization of the stream's own head, then the
    //    staged attention over the cache
    {
      const int half = D / 2;
      const size_t lkv = ll * B * KVH;
      for (int bh = blockIdx.x; bh < B * KVH; bh += gridDim.x) {
        const int b = bh / KVH, hh = bh - b * KVH;
        const float* row = a.qkv + (size_t)b * nq + hh * D;
        if (tid < D) {
          sq[tid] = __ldcg(row + tid);
          sk[tid] = __ldcg(row + qdim + tid);
        }
        __syncthreads();
        float qr = 0.f, kr = 0.f, vv = 0.f;
        if (tid < D) {
          const int i = tid < half ? tid : tid - half;
          const float c = a.cos[(size_t)b * half + i];
          const float s = a.sin[(size_t)b * half + i];
          // rotate_half: (-x2, x1)
          const float rq = tid < half ? -sq[tid + half] : sq[tid - half];
          const float rk = tid < half ? -sk[tid + half] : sk[tid - half];
          qr = __fadd_rn(__fmul_rn(sq[tid], c), __fmul_rn(rq, s));
          kr = __fadd_rn(__fmul_rn(sk[tid], c), __fmul_rn(rk, s));
          vv = __ldcg(row + 2 * qdim + tid);
        }
        const float km = lowrank::warp_max_f(fabsf(kr));
        const float vm = lowrank::warp_max_f(fabsf(vv));
        if (lane == 0) {
          kmax_s[warp] = km;
          vmax_s[warp] = vm;
        }
        __syncthreads();
        float kamax = kmax_s[0], vamax = vmax_s[0];
        for (int i = 1; i < kWarps; ++i) {
          kamax = fmaxf(kamax, kmax_s[i]);
          vamax = fmaxf(vamax, vmax_s[i]);
        }
        const float ksc = __fdiv_rn(fmaxf(kamax, 1e-12f), 127.0f);
        const float vsc = __fdiv_rn(fmaxf(vamax, 1e-12f), 127.0f);
        if (tid < D) {
          const int8_t kq = code8(kr, ksc), vq = code8(vv, vsc);
          const size_t o = (lkv + bh) * D + tid;
          a.k8[o] = kq;
          a.v8[o] = vq;
          a.kf[(size_t)bh * D + tid] = __fmul_rn((float)kq, ksc);
          a.vf[(size_t)bh * D + tid] = __fmul_rn((float)vq, vsc);
          a.qrot[(size_t)bh * D + tid] = qr;
        }
        if (tid == 0) {
          a.ks8[lkv + bh] = ksc;
          a.vs8[lkv + bh] = vsc;
        }
        __syncthreads();
        const size_t lc = ll * B * KVH * a.T;
        const float o =
            flash_decode::decode_attend<kThreads, 1, flash_decode::kDotsF32,
                                        true, true>(
                bh, a.qrot, a.kc + lc * D, a.vc + lc * D, a.kcs + lc,
                a.vcs + lc, a.kf, a.vf, a.pos, nullptr, 0, a.ao, KVH, 1, D,
                a.T, a.bt, a.scale);
        const float om = lowrank::warp_max_f(tid < D ? fabsf(o) : 0.f);
        if (lane == 0) red[warp] = om;
        __syncthreads();
        if (tid == 0) {
          float amax = red[0];
          for (int i = 1; i < kWarps; ++i) amax = fmaxf(amax, red[i]);
          a.part[(size_t)hh * B + b] = amax;
        }
        __syncthreads();
      }
    }
    lowrank::grid_sync();

    // 5. FIN + XRO
    row_scales(a.part, KVH, B, srow);
    for (size_t i = (size_t)blockIdx.x * kThreads + tid; i < (size_t)B * qdim;
         i += (size_t)gridDim.x * kThreads)
      a.a8[i] = code8(__ldcg(a.ao + i), srow[i / qdim]);
    thin_rows<MT>(a.ao, B, qdim, a.o_R + ll * rank * qdim, a.o_Rs + ll * rank,
                  rank, a.xr, smem);
    lowrank::grid_sync();

    // 6. O: x += out * gs_o
    {
      const LFactor f{a.xr, rank, a.o_L + ll * h * rank, a.o_Ls + ll * h, rank,
                      one};
      const uint8_t* w = a.o_w + ll * h * (qdim / F);
      const float* ws = a.o_s + ll * h;
      const float g = gs[3];
      for (int t = blockIdx.x; t < h / RPB; t += gridDim.x)
        lowrank::lr_tile<BITS, CODE, MT, true, true>(
            reinterpret_cast<const int*>(a.a8), srow, B, qdim, w, ws, h,
            a.jc_q, t, f, smem, xrw, [&](int m, int n, int, float v) {
              float* xp = a.x + (size_t)m * h + n;
              *xp = __fadd_rn(__ldcg(xp), __fmul_rn(v, g));
            });
    }
    lowrank::grid_sync();

    // 7. MLP
    norm_quant(a, a.x, false, a.mn + ll * h, red);
    lowrank::grid_sync();

    // 8. XRG
    thin_rows<MT>(a.y, B, h, a.g_R + ll * 2 * rank * h, a.g_Rs + ll * 2 * rank,
                  2 * rank, a.xr, smem);
    lowrank::grid_sync();

    // 9. GU: gate and up tiles of the interleaved arrays, m, tile absmax
    for (int b = tid; b < B; b += kThreads) srow[b] = __ldcg(a.sy + b);
    {
      const uint8_t* w = a.g_w + ll * 2 * im * (h / F);
      const float* ws = a.g_s + ll * 2 * im;
      const int8_t* Lg = a.g_L + ll * 2 * im * rank;
      const float* Lgs = a.g_Ls + ll * 2 * im;
      const LFactor fg{a.xr, 2 * rank, Lg, Lgs, rank, one};
      const LFactor fu{a.xr + rank, 2 * rank, Lg, Lgs, rank, one};
      const float gs_gate = gs[4], gs_up = gs[5];
      const int bpt = a.bng / RPB;  // row tiles per gate (or up) block
      for (int t = blockIdx.x; t < im / RPB; t += gridDim.x) {
        const int i0 = t * RPB;  // the tile's first intermediate column
        const int tg = 2 * (t / bpt) * bpt + t % bpt;  // its gate tile
        lowrank::lr_tile<BITS, CODE, MT, true, true>(
            reinterpret_cast<const int*>(a.a8), srow, B, h, w, ws, 2 * im,
            a.jc_h, tg, fg, smem, xrw, [&](int m, int, int rl, float v) {
              g_s[rl * MT + m] = __fmul_rn(v, gs_gate);
            });
        lowrank::lr_tile<BITS, CODE, MT, true, true>(
            reinterpret_cast<const int*>(a.a8), srow, B, h, w, ws, 2 * im,
            a.jc_h, tg + bpt, fu, smem, xrw, [&](int m, int, int rl, float v) {
              const float g = g_s[rl * MT + m];
              const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g)));
              const float mv =
                  __fmul_rn(__fmul_rn(g, sig), __fmul_rn(v, gs_up));
              a.m[(size_t)m * im + i0 + rl] = mv;
              g_s[rl * MT + m] = fabsf(mv);
            });
        __syncthreads();
        if (tid < B) {
          float amax = 0.f;
          for (int rl = 0; rl < RPB; ++rl)
            amax = fmaxf(amax, g_s[rl * MT + tid]);
          a.part[(size_t)t * B + tid] = amax;
        }
      }
    }
    lowrank::grid_sync();

    // 10. DQ + XRD: the codes of bf16(m) on the f32 absmax
    row_scales(a.part, im / RPB, B, srow);
    for (size_t i = (size_t)blockIdx.x * kThreads + tid; i < (size_t)B * im;
         i += (size_t)gridDim.x * kThreads)
      a.a8[i] = code8(lowrank::bf16r(__ldcg(a.m + i)), srow[i / im]);
    thin_rows<MT>(a.m, B, im, a.d_R + ll * rank * im, a.d_Rs + ll * rank,
                  rank, a.xrd, smem);
    lowrank::grid_sync();

    // 11. DOWN: x += out * gs_down
    {
      const LFactor f{a.xrd, rank, a.d_L + ll * h * rank, a.d_Ls + ll * h,
                      rank, one};
      const uint8_t* w = a.d_w + ll * h * (im / F);
      const float* ws = a.d_s + ll * h;
      const float g = gs[6];
      for (int t = blockIdx.x; t < h / RPB; t += gridDim.x)
        lowrank::lr_tile<BITS, CODE, MT, true, true>(
            reinterpret_cast<const int*>(a.a8), srow, B, im, w, ws, h,
            a.jc_im, t, f, smem, xrw, [&](int m, int n, int, float v) {
              float* xp = a.x + (size_t)m * h + n;
              *xp = __fadd_rn(__ldcg(xp), __fmul_rn(v, g));
            });
    }
    lowrank::grid_sync();
  }
}

// Launch (or, with `grid_only`, size) the cooperative grid.
template <int BITS, int MT>
cudaError_t launch(MegaArgs a, cudaStream_t st, int* grid_only) {
  constexpr int F = 8 / BITS;
  auto kernel = megastep_kernel<BITS, MT>;
  a.jc_h = pick_jc<F>(kCoopSmemBytes, MT, a.h);
  a.jc_q = pick_jc<F>(kCoopSmemBytes, MT, a.KVH * a.D);
  a.jc_im = pick_jc<F>(kCoopSmemBytes, MT, a.im);
  // one L-factor window per row tile (every split is a multiple of it)
  const size_t smem = kCoopSmemBytes + (size_t)MT * a.rank * 4;
  static const cudaError_t attr = lowrank::allow_smem(kernel, 200 * 1024);
  if (attr != cudaSuccess) return attr;
  int grid = 0;
  cudaError_t err = lowrank::coop_grid(kernel, smem, 1 << 30, &grid);
  if (err != cudaSuccess) return err;
  if (grid_only != nullptr) {
    *grid_only = grid;
    return cudaSuccess;
  }
  void* args[] = {(void*)&a};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(kThreads), args, smem, st);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The support predicate of ops/megastep.py (the reference's _Plan), and what
// the pieces take: D <= kMaxD, every K a multiple of 16 codes per word, row
// tiles that stay inside one gate/up block and one projection.
template <int BITS>
cudaError_t dispatch(const MegaArgs& a, cudaStream_t st, int* grid_only) {
  constexpr int F = 8 / BITS;
  const int qdim = a.KVH * a.D;
  if (a.B < 1 || a.B > 32 || a.L < 1 || a.D % 128 != 0 ||
      a.D > flash_decode::kMaxD || a.rank % 128 != 0 || a.h % 128 != 0 ||
      a.im % 128 != 0 || a.bng % 128 != 0 || a.im % a.bng != 0 ||
      a.h % (16 * F) != 0 || a.im % (16 * F) != 0 || qdim % (16 * F) != 0 ||
      a.bt < 1 || a.T % a.bt != 0 || a.bng % Tile<8>::kRowsPerBlock != 0 ||
      a.bng % Tile<32>::kRowsPerBlock != 0)
    return cudaErrorInvalidValue;
  return a.B <= 8 ? launch<BITS, 8>(a, st, grid_only)
                  : launch<BITS, 32>(a, st, grid_only);
}

}  // namespace megastep

// The C entries of a library built for one bit width (csrc/megastep.cu,
// csrc/megastep_2bit.cu: the two build in parallel).
#define MEGASTEP_ENTRIES(BITS)                                              \
  /* sizeof(MegaArgs), for the Python side's check of its mirror */         \
  extern "C" int megastep_args_size() {                                     \
    return (int)sizeof(megastep::MegaArgs);                                 \
  }                                                                         \
  /* one step: args points at a MegaArgs (host memory, read before the */   \
  /* launch returns) */                                                     \
  extern "C" int megastep_launch(const void* args, void* stream) {          \
    return (int)megastep::dispatch<BITS>(                                   \
        *static_cast<const megastep::MegaArgs*>(args),                      \
        static_cast<cudaStream_t>(stream), nullptr);                        \
  }                                                                         \
  /* the CTAs of the cooperative grid of such a launch, into *ctas */       \
  extern "C" int megastep_grid(const void* args, void* ctas) {              \
    return (int)megastep::dispatch<BITS>(                                   \
        *static_cast<const megastep::MegaArgs*>(args), nullptr,             \
        static_cast<int*>(ctas));                                           \
  }
