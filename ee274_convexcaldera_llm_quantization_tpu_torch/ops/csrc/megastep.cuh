// The whole decode step of an MHA Llama model, every layer, in one
// cooperative launch (csrc/megastep.cu builds it for 4-bit codes,
// csrc/megastep_2bit.cu for 2-bit ones): replaces the TPU kernel
// ee274_convexcaldera_llm_quantization_tpu/ops/megastep.py::megastep
// (_megastep_kernel).
//
// The TPU kernel walks one sequential (layer, program) grid and keeps the
// hidden state and every intermediate in VMEM scratch. Blocks of a GPU run
// in parallel and carry nothing from one to the next, so here every CTA
// that fits on the card at once (occupancy query x SMs, memoized: one CTA
// of 8 warps per SM) runs one loop over the layers, and each layer is eleven
// stages split by grid-wide barriers; the state between stages lives in
// global scratch (a few MB at Llama-2-7B), which stays in the 50 MB L2:
//
//   1. PRE    one CTA per row: RMSNorm (attn_norm), y (f32), its int8 codes
//             and row scale;
//   2. XRQ    xr = (bf16(y) @ bf16(R_qkv).T) * Rs, units of 4 R rows x 1
//             activation row over every warp of the grid;
//   3. QKV    the W4A8 products of the fused q/k/v projection with the L
//             epilogue on xr and each row's global scale;
//   4. ATTN   one CTA per (b, head) stream: rotate-half RoPE on q and k,
//             int8 K and V of the current token (outputs), then the staged
//             flash-decode attention over the cache with f32 dots
//             (flash_decode.cuh) and the stream's absmax of the output;
//   5. FIN    every CTA reduces the absmax partials to the row scales; the
//             grid requantizes the attention output to int8 and computes
//             xr_o = (bf16(ao) @ bf16(R_o).T) * Rs;
//   6. O      the o_proj products, x += out * gs_o;
//   7. MLP    as PRE on mlp_norm;
//   8. XRG    as XRQ on the gate/up R;
//   9. GU     each group one 16-row tile of gate rows and the same tile of
//             up rows of the INTERLEAVED gate/up arrays (block j of bng
//             rows: gate rows [2j bng, 2j bng + bng), up rows the next bng),
//             m = silu(gate) * up to scratch, the group's absmax of |m|
//             into a partial slot (one per group: no atomics);
//  10. DQ     row scales max(absmax, 1e-12) / 127 of the f32 m, the int8
//             codes of bf16(m), and xrd = (bf16(m) @ bf16(R_down).T) * Rs;
//  11. DOWN   the down_proj products on those codes, x += out * gs_down.
//
// Bound on an H100: the bytes of one step, read once: every layer's packed
// codes (101 MB at Llama-2-7B, 4-bit), int8 factors (10 MB) and scales,
// plus the live int8 K/V of the cache (8.7 MB per layer at batch 8, 128
// tokens): ~3.85 GB per step, ~1.15 ms at 3.35 TB/s. The projection stages
// hold 106 of a layer's ~119 MB and run on megastep_proj.cuh: int8 products
// on the tensor cores (mma.sync), each warp streaming its share of every
// projection stage's weights through a cp.async ring that runs across the
// grid barriers (the next stage's first slabs load while the attention,
// the norms and the thin factor dots run), every stage's bytes cut evenly
// over every warp of the grid, and the L factor's dots spread over every
// warp too. What is left beyond the bytes is latency: eleven barriers a
// layer, the thin R dots' per-lane chains (one R row of K bytes read in
// order; the R rows are prefetched into L2 a stage ahead), the stage-start
// L dots, the split groups' hand-over and the attention (scripts/
// torch_megastep_stages.py times each stage). The attention (decode_attend)
// is flash_decode.cuh's. Data written by another CTA of the launch is read
// through L2 (__ldcg, the CG flags), never the read-only path. Multiplies
// and adds upstream of an int8 rounding are rounded one by one (__fmul_rn
// / __fadd_rn), in the reference's order; the integer sums are exact; the
// f32 sums a fixed order (the thin dots' and the L dots' that of
// lowrank.cuh's xr_rows and lr_tile, whose outputs they equal bit for
// bit), so a launch is deterministic.
#pragma once

#include "flash_decode.cuh"
#include "lowrank.cuh"
#include "megastep_proj.cuh"

namespace megastep {

using rowdot::kThreads;
using rowdot::kWarps;
using rowdot::Tile;

// Dynamic shared memory, from a 1024-byte boundary: the projection stages'
// weight rings; a region that holds each warp's projection scratch, and a
// row of the norms (h floats); the CTA's copy of a stage's xr windows.
constexpr int kXsBytes = kWarps * mproj::kWarpScratch;
constexpr int kSmemBytes =
    1024 + mproj::kRingBytes + kXsBytes + mproj::kWinBytes;
static_assert(kWarps * mproj::kWarpScratch <= kXsBytes, "epilogue scratch");

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
  int* pws;             // split-group partials: 2 slots of 32 x MT a warp
  int* cnt;             // split-group counters (zero between stages), then
                        // per warp of the grid the last projection stage
                        // whose L dots it wrote
  float* ylr;           // (rows, B) L dots of a projection stage's rows
  int L, B, h, im, KVH, D, T, bt, rank, bng;
  float eps, scale;
};


__device__ __forceinline__ int8_t code8(float v, float s) {
  return (int8_t)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
}

// Stages PRE and MLP for the rows b = blockIdx.x, + gridDim.x, ...: y =
// (x * rsqrt(mean(x^2) + eps)) * w, its int8 codes and row scale. At layer 0
// the rows come from x0 and are copied into the residual x. The first pass
// keeps the row and w in shared memory (xs, where 2 h floats fit) for the
// other two.
__device__ __forceinline__ void norm_quant(const MegaArgs& a,
                                           const float* xin, bool init,
                                           const float* w, float* red,
                                           float* xs) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = a.h;
  const bool keep = 2 * h <= kXsBytes / 4;
  float* ws = xs + h;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const float* xr = xin + (size_t)b * h;
    float ss = 0.f;
#pragma unroll 8
    for (int k = tid; k < h; k += kThreads) {
      const float v = __ldcg(xr + k);
      if (keep) {
        xs[k] = v;
        ws[k] = w[k];
      }
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
#pragma unroll 8
    for (int k = tid; k < h; k += kThreads) {
      const float v = keep ? xs[k] : __ldcg(xr + k);
      if (init) a.x[(size_t)b * h + k] = v;
      const float yv = __fmul_rn(__fmul_rn(v, r), keep ? ws[k] : w[k]);
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
#pragma unroll 8
    for (int k = tid; k < h; k += kThreads) {
      const float yv = __fmul_rn(
          __fmul_rn(keep ? xs[k] : __ldcg(xr + k), r), keep ? ws[k] : w[k]);
      a.a8[(size_t)b * h + k] = code8(yv, sx);
    }
    if (tid == 0) a.sy[b] = sx;
    __syncthreads();  // red and xs are reused by the next row
  }
}

// Prefetch `bytes` at p into L2, spread over the grid's threads (a stage's
// R rows, read by the thin dots of a later stage).
__device__ __forceinline__ void prefetch_grid(const void* p, size_t bytes) {
  const char* c = static_cast<const char*>(p);
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
       i < (bytes + 127) / 128; i += (size_t)gridDim.x * kThreads)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(c + 128 * i));
}

// out[b, j] = (sum_k bf16(act[b, k]) * R[j, k]) * Rs[j] for the nR rows of
// R (out rows of nR), in units of 4 R rows x 1 activation row spread over
// every warp of the grid (nR / 4 x B units; the activation row runs
// fastest, so the warps that share R rows run together). Each output's sum
// is lowrank::xr_rows's: lane i over k = 4 i + 128 j, four k a step in
// order, then the warp tree; the activations come from L2 (this launch's
// scratch), four steps of loads in flight.
__device__ __forceinline__ void thin_rows(const float* act, int B, int K,
                                          const int8_t* __restrict__ R,
                                          const float* __restrict__ Rs,
                                          int nR, float* out) {
  const int lane = threadIdx.x & 31;
  const int W = gridDim.x * kWarps, w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  for (int u = w; u < nR / 4 * B; u += W) {
    const int j0 = 4 * (u / B), b = u - (u / B) * B;
    const float* ar = act + (size_t)b * K;
    const int8_t* Rr = R + (size_t)j0 * K;
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int c = 4 * lane; c < K; c += 128) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(ar + c));
      const float x0 = lowrank::bf16r(v.x), x1 = lowrank::bf16r(v.y);
      const float x2 = lowrank::bf16r(v.z), x3 = lowrank::bf16r(v.w);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int rw =
            __ldg(reinterpret_cast<const int*>(Rr + (size_t)r * K + c));
        part[r] = fmaf(x0, (float)(int8_t)(rw & 0xFF), part[r]);
        part[r] = fmaf(x1, (float)(int8_t)((rw >> 8) & 0xFF), part[r]);
        part[r] = fmaf(x2, (float)(int8_t)((rw >> 16) & 0xFF), part[r]);
        part[r] = fmaf(x3, (float)(int8_t)((rw >> 24) & 0xFF), part[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float s = lowrank::warp_sum_f(part[r]);
      if (lane == r) out[(size_t)b * nR + j0 + r] = __fmul_rn(s, Rs[j0 + r]);
    }
  }
}

// srow[b] = max(max_t part[t * B + b], 1e-12) / 127 over n partials: one
// warp per row, the lanes over the partials (max is order-free), eight
// loads in flight.
__device__ __forceinline__ void row_scales(const float* part, int n, int B,
                                           float* srow) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = warp; b < B; b += kWarps) {
    float amax = 0.f;
#pragma unroll 8
    for (int t = lane; t < n; t += 32)
      amax = fmaxf(amax, __ldcg(part + (size_t)t * B + b));
    amax = lowrank::warp_max_f(amax);
    if (lane == 0) srow[b] = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
  }
  __syncthreads();
}

// The counters of the split groups: the most groups of any stage (the L-dot
// flags of the grid's warps follow them).
__host__ __device__ inline int counters(int h, int im, int qdim) {
  const int n = 3 * qdim / 32 > h / 32 ? 3 * qdim / 32 : h / 32;
  return n > im / 16 ? n : im / 16;
}

template <int BITS, int MT>
__global__ void __launch_bounds__(kThreads)
    megastep_kernel(const __grid_constant__ MegaArgs a,
                    const __grid_constant__ mproj::Plan pl) {
  constexpr int kTR = mproj::kTileRows;
  __shared__ float srow[32];       // row scales of the int8 activations
  __shared__ float red[kWarps];    // block reductions
  __shared__ float sq[flash_decode::kMaxD], sk[flash_decode::kMaxD];
  __shared__ float kmax_s[kWarps], vmax_s[kWarps];
  uint8_t* base = hopper::smem_1k();
  int* smem = reinterpret_cast<int*>(base + mproj::kRingBytes);
  __nv_bfloat16* wcta = reinterpret_cast<__nv_bfloat16*>(
      base + mproj::kRingBytes + kXsBytes);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = a.B, h = a.h, im = a.im, rank = a.rank, D = a.D;
  const int KVH = a.KVH, qdim = KVH * D, nq = 3 * qdim;
  // this warp's epilogue scratch: MT-row totals of a group, then l_tile's
  int* tot = smem + warp * (mproj::kWarpScratch / 4);
  uint8_t* scr = reinterpret_cast<uint8_t*>(tot + 32 * MT);

  mproj::Ring rg;
  mproj::Stream q;
  // the first slabs of layer 0's q/k/v load while PRE and XRQ run
  mproj::stream_start(pl, base, rg, q);
  for (int i = blockIdx.x * kThreads + tid;
       i < counters(h, im, qdim) + gridDim.x * kWarps;
       i += gridDim.x * kThreads)
    a.cnt[i] = 0;
  int* ldone = a.cnt + counters(h, im, qdim);

  for (int l = 0; l < a.L; ++l) {
    const size_t ll = l;
    const float* gs = a.gs + ll * 8;

    // 1. PRE (and the R rows of XRQ into L2)
    prefetch_grid(a.q_R + ll * 3 * rank * h, (size_t)3 * rank * h);
    norm_quant(a, l == 0 ? a.x0 : a.x, l == 0, a.an + ll * h, red,
               reinterpret_cast<float*>(smem));
    lowrank::grid_sync();

    // 2. XRQ
    thin_rows(a.y, B, h, a.q_R + ll * 3 * rank * h, a.q_Rs + ll * 3 * rank,
              3 * rank, a.xr);
    lowrank::grid_sync();

    // 3. QKV
    for (int b = tid; b < B; b += kThreads) srow[b] = __ldcg(a.sy + b);
    __syncthreads();
    {
      mproj::Epi e{};
      e.mode = mproj::kEpiStore;
      e.ws = a.q_s + ll * nq;
      e.L = a.q_L + ll * nq * rank;
      e.Ls = a.q_Ls + ll * nq;
      e.xr = a.xr;
      e.ldxr = 3 * rank;
      e.sx = srow;
      e.out = a.qkv;
      e.ldo = nq;
      e.gain[0] = gs[0];
      e.gain[1] = gs[1];
      e.gain[2] = gs[2];
      e.pw = qdim;
      e.ylr = a.ylr;
      e.done = ldone;
      e.seq = 4 * l + 1;
      mproj::run_stage<BITS, MT>(pl, l, 0, q, rg, a.a8, h, B, a.pws, a.cnt,
                                 tot, scr, e, wcta);
    }
    lowrank::grid_sync();

    // 4. ATTN: RoPE and K/V quantization of the stream's own head, then the
    //    staged attention over the cache (and the R rows of XRO into L2)
    prefetch_grid(a.o_R + ll * rank * qdim, (size_t)rank * qdim);
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
    thin_rows(a.ao, B, qdim, a.o_R + ll * rank * qdim, a.o_Rs + ll * rank,
              rank, a.xr);
    lowrank::grid_sync();

    // 6. O: x += out * gs_o
    {
      mproj::Epi e{};
      e.mode = mproj::kEpiAccum;
      e.ws = a.o_s + ll * h;
      e.L = a.o_L + ll * h * rank;
      e.Ls = a.o_Ls + ll * h;
      e.xr = a.xr;
      e.ldxr = rank;
      e.sx = srow;
      e.out = a.x;
      e.ldo = h;
      e.gain[0] = gs[3];
      e.ylr = a.ylr;
      e.done = ldone;
      e.seq = 4 * l + 2;
      mproj::run_stage<BITS, MT>(pl, l, 1, q, rg, a.a8, qdim, B, a.pws, a.cnt,
                                 tot, scr, e, wcta);
    }
    lowrank::grid_sync();

    // 7. MLP (and the R rows of XRG into L2)
    prefetch_grid(a.g_R + ll * 2 * rank * h, (size_t)2 * rank * h);
    norm_quant(a, a.x, false, a.mn + ll * h, red,
               reinterpret_cast<float*>(smem));
    lowrank::grid_sync();

    // 8. XRG
    thin_rows(a.y, B, h, a.g_R + ll * 2 * rank * h, a.g_Rs + ll * 2 * rank,
              2 * rank, a.xr);
    lowrank::grid_sync();

    // 9. GU: gate and up tiles of the interleaved arrays, m, tile absmax
    //    (and the R rows of XRD into L2)
    prefetch_grid(a.d_R + ll * rank * im, (size_t)rank * im);
    for (int b = tid; b < B; b += kThreads) srow[b] = __ldcg(a.sy + b);
    __syncthreads();
    {
      mproj::Epi e{};
      e.mode = mproj::kEpiGateUp;
      e.ws = a.g_s + ll * 2 * im;
      e.L = a.g_L + ll * 2 * im * rank;
      e.Ls = a.g_Ls + ll * 2 * im;
      e.xr = a.xr;
      e.ldxr = 2 * rank;
      e.sx = srow;
      e.out = a.m;
      e.ldo = im;
      e.gain[0] = gs[4];
      e.gain[1] = gs[5];
      e.part = a.part;
      e.ylr = a.ylr;
      e.done = ldone;
      e.seq = 4 * l + 3;
      mproj::run_stage<BITS, MT>(pl, l, 2, q, rg, a.a8, h, B, a.pws, a.cnt,
                                 tot, scr, e, wcta);
    }
    lowrank::grid_sync();

    // 10. DQ + XRD: the codes of bf16(m) on the f32 absmax
    row_scales(a.part, im / kTR, B, srow);
    for (size_t i = (size_t)blockIdx.x * kThreads + tid; i < (size_t)B * im;
         i += (size_t)gridDim.x * kThreads)
      a.a8[i] = code8(lowrank::bf16r(__ldcg(a.m + i)), srow[i / im]);
    thin_rows(a.m, B, im, a.d_R + ll * rank * im, a.d_Rs + ll * rank, rank,
              a.xrd);
    lowrank::grid_sync();

    // 11. DOWN: x += out * gs_down
    {
      mproj::Epi e{};
      e.mode = mproj::kEpiAccum;
      e.ws = a.d_s + ll * h;
      e.L = a.d_L + ll * h * rank;
      e.Ls = a.d_Ls + ll * h;
      e.xr = a.xrd;
      e.ldxr = rank;
      e.sx = srow;
      e.out = a.x;
      e.ldo = h;
      e.gain[0] = gs[6];
      e.ylr = a.ylr;
      e.done = ldone;
      e.seq = 4 * l + 4;
      mproj::run_stage<BITS, MT>(pl, l, 3, q, rg, a.a8, im, B, a.pws, a.cnt,
                                 tot, scr, e, wcta);
    }
    lowrank::grid_sync();
  }
}

// The projection stages of a launch: q/k/v, o, gate/up (groups of 16 gate
// and 16 up rows of the interleaved arrays), down.
template <int BITS>
mproj::Plan plan(const MegaArgs& a) {
  constexpr int F = 8 / BITS, KC = mproj::kKC;
  const int qdim = a.KVH * a.D, nq = 3 * qdim, h = a.h, im = a.im;
  mproj::Plan pl{};
  pl.st[0] = {h / F, (h / F + KC - 1) / KC, nq / 32, nq, 0};
  pl.st[1] = {qdim / F, (qdim / F + KC - 1) / KC, h / 32, h, 0};
  pl.st[2] = {h / F, (h / F + KC - 1) / KC, im / mproj::kTileRows, 2 * im,
              a.bng};
  pl.st[3] = {im / F, (im / F + KC - 1) / KC, h / 32, h, 0};
  const uint8_t* w[4] = {a.q_w, a.o_w, a.g_w, a.d_w};
  const int8_t* Lf[4] = {a.q_L, a.o_L, a.g_L, a.d_L};
  const float* ws[4] = {a.q_s, a.o_s, a.g_s, a.d_s};
  const float* Ls[4] = {a.q_Ls, a.o_Ls, a.g_Ls, a.d_Ls};
  for (int i = 0; i < 4; ++i) {
    pl.w[i] = w[i];
    pl.Lf[i] = Lf[i];
    pl.ws[i] = ws[i];
    pl.Ls[i] = Ls[i];
  }
  pl.nst = 4;
  pl.L = a.L;
  pl.rank = a.rank;
  return pl;
}

// Launch (or, with `grid_only`, size) the cooperative grid.
template <int BITS, int MT>
cudaError_t launch(MegaArgs a, cudaStream_t st, int* grid_only) {
  cudaError_t err =
      hopper::allow_smem<megastep_kernel<BITS, MT>>(kSmemBytes);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = lowrank::coop_grid(megastep_kernel<BITS, MT>, kSmemBytes, 1 << 30,
                           &grid);
  if (err != cudaSuccess) return err;
  if (grid_only != nullptr) {
    *grid_only = grid;
    return cudaSuccess;
  }
  mproj::Plan pl = plan<BITS>(a);
  void* args[] = {(void*)&a, (void*)&pl};
  err = cudaLaunchCooperativeKernel((const void*)megastep_kernel<BITS, MT>,
                                    dim3(grid), dim3(kThreads), args,
                                    kSmemBytes, st);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// One projection stage alone, for the card tests of megastep_proj.cuh: the
// exact i32 sums sum_k (code(w[n, k]) - MAXQ) * x8[m, k] of the N rows of w
// (B rows of x8, K codes) into out (N, B), on the stage's own stream, split
// plan (over `grid` CTAs) and group layout (bng = 0: 32 consecutive rows a
// group; else gate/up blocks of bng rows as the GU stage reads them).
template <int BITS, int MT>
__global__ void __launch_bounds__(kThreads)
    proj_sums_kernel(const __grid_constant__ mproj::Plan pl, const int8_t* x8,
                     int* out, int* pws, int* cnt, int K, int B) {
  uint8_t* base = hopper::smem_1k();
  const int warp = threadIdx.x >> 5;
  int* tot = reinterpret_cast<int*>(base + mproj::kRingBytes) +
             warp * (mproj::kWarpScratch / 4);
  mproj::Ring rg;
  mproj::Stream q;
  mproj::stream_start(pl, base, rg, q);
  mproj::Epi e{};
  e.mode = mproj::kEpiSums;
  e.sums = out;
  mproj::run_stage<BITS, MT>(pl, 0, 0, q, rg, x8, K, B, pws, cnt, tot,
                             reinterpret_cast<uint8_t*>(tot + 32 * MT), e);
}

template <int BITS>
cudaError_t proj_sums(const int8_t* x8, const uint8_t* w, int* out, int* pws,
                      int* cnt, int N, int K, int B, int bng, int grid,
                      cudaStream_t st) {
  constexpr int F = 8 / BITS;
  if (B < 1 || B > 32 || grid < 1 || K % (16 * F) != 0 ||
      (bng == 0 ? N % 32 != 0 : bng % 16 != 0 || N % (2 * bng) != 0))
    return cudaErrorInvalidValue;
  constexpr int smem = 1024 + mproj::kRingBytes + kWarps * mproj::kWarpScratch;
  mproj::Plan pl{};
  pl.st[0] = {K / F, (K / F + mproj::kKC - 1) / mproj::kKC,
              bng ? N / 2 / mproj::kTileRows : N / 32, N, bng};
  pl.w[0] = w;
  pl.nst = 1;
  pl.L = 1;
  cudaError_t err;
  if (B <= 8) {
    err = hopper::allow_smem<proj_sums_kernel<BITS, 8>>(smem);
    if (err == cudaSuccess)
      proj_sums_kernel<BITS, 8><<<grid, kThreads, smem, st>>>(
          pl, x8, out, pws, cnt, K, B);
  } else {
    err = hopper::allow_smem<proj_sums_kernel<BITS, 32>>(smem);
    if (err == cudaSuccess)
      proj_sums_kernel<BITS, 32><<<grid, kThreads, smem, st>>>(
          pl, x8, out, pws, cnt, K, B);
  }
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
  }                                                                         \
  /* one projection stage's i32 sums alone (card tests): x8, packed w, */   \
  /* out (N, B) i32, partials, zeroed counters, N, K, B, bng, grid */       \
  extern "C" int megastep_proj_launch(const void* x8, const void* w,        \
                                      void* out, void* pws, void* cnt,      \
                                      int N, int K, int B, int bng,         \
                                      int grid, void* stream) {             \
    return (int)megastep::proj_sums<BITS>(                                  \
        static_cast<const int8_t*>(x8), static_cast<const uint8_t*>(w),     \
        static_cast<int*>(out), static_cast<int*>(pws),                     \
        static_cast<int*>(cnt), N, K, B, bng, grid,                         \
        static_cast<cudaStream_t>(stream));                                 \
  }
