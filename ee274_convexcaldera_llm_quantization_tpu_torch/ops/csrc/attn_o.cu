// Flash-decode attention fused with the W4A8 o_proj and its int8 low-rank
// factors, against one layer: replaces the TPU kernel
// ee274_convexcaldera_llm_quantization_tpu/ops/attention.py::
// flash_decode_attn_o (_flash_attn_o_kernel). MHA only (one query head per
// kv head), f32 dots, staged or inline, batch <= 32.
//
// The TPU kernel walks one sequential grid: the (b, token block) steps of
// the attention into a VMEM buffer, one step that requantizes it and
// contracts it with oR, then the o_proj output blocks. Here it is one
// cooperative launch of as many CTAs as fit on the card at once, in three
// phases split by two grid-wide barriers:
// 1. the CTAs loop over the B x KVH (b, head) streams, each attended by the
//    device code of flash_decode.cu (flash_decode.cuh, f32 dots, 256
//    threads) into a flat (B, KVH * D) f32 scratch, plus the stream's
//    absmax of |attn| into a partial buffer (one slot per stream);
// 2. every CTA reduces the partials to the row scales sx = max(amax,
//    1e-12) / 127; the grid requantizes attn to int8 (round half to even,
//    clip 127) and computes xro = (bf16(attn) @ bf16(oR).T) * oRs;
// 3. the o_proj: the W4A8 row-dot tiles on the int8 attn with the L
//    epilogue on xro (lowrank.cuh), out (B, h) before o's global scale.
//
// Bound on an H100: the live K/V codes and scales plus o_proj's weight
// bytes (h x KVH * D / 2 packed + h x rank + rank x KVH * D int8 for
// Llama-2-7B: ~10.5 MB of weights against ~20 MB of K/V at batch 8 and 256
// tokens). The attention reads each live K/V byte once; the o_proj each
// packed byte once; attn and its int8 codes stay in L2-resident scratch.
#include "flash_decode.cuh"
#include "lowrank.cuh"

namespace {

using lowrank::kCoopSmemBytes;
using lowrank::LFactor;
using lowrank::Splits;
using rowdot::kThreads;
using rowdot::kWarps;
using rowdot::Tile;

struct AttnOArgs {
  // attention over one layer (pointers at the layer)
  const float* q;       // (B, KVH, 1, D) f32
  const int8_t* k;      // (B, KVH, T, D)
  const int8_t* v;
  const float* ks;      // (B, KVH, T)
  const float* vs;
  const float* kn;      // (B, KVH, D) f32, staged only
  const float* vn;
  const int* pos;       // (B)
  int KVH, D, T, bt;
  float scale;
  // o_proj of the layer
  const uint8_t* o_w;   // (h, KVH * D / F)
  const float* o_s;     // (h)
  const int8_t* oR;     // (rank, KVH * D)
  const float* oRs;     // (rank)
  const int8_t* oL;     // (h, rank)
  const float* oLs;     // (h)
  // scratch and output
  float* attn;          // (B, KVH * D) f32
  float* amax_part;     // (B * KVH) f32
  int8_t* xq8;          // (B, KVH * D) int8
  float* xro;           // (B, rank) f32
  float* out;           // (B, h) f32
  int B, h, rank, jc;
};

template <int BITS, int CODE, int MT, bool STAGED>
__global__ void __launch_bounds__(kThreads) attn_o_kernel(AttnOArgs a) {
  constexpr int RPB = Tile<MT>::kRowsPerBlock;
  extern __shared__ int smem[];
  __shared__ float wmax[kWarps];
  __shared__ float srow[32];  // the row scales sx of attn
  const int act_words = kCoopSmemBytes / 4;
  float* xrw = reinterpret_cast<float*>(smem + act_words);
  const int B = a.B, qdim = a.KVH * a.D, rank = a.rank;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // phase 1: attention of each (b, head) stream, and its absmax
  for (int bh = blockIdx.x; bh < B * a.KVH; bh += gridDim.x) {
    const float o =
        flash_decode::decode_attend<kThreads, 1, flash_decode::kDotsF32,
                                    STAGED>(
            bh, a.q, a.k, a.v, a.ks, a.vs, a.kn, a.vn, a.pos, nullptr, 0,
            a.attn, a.KVH, 1, a.D, a.T, a.bt, a.scale);
    const float m = lowrank::warp_max_f(fabsf(o));
    if (lane == 0) wmax[warp] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      float amax = wmax[0];
      for (int w = 1; w < kWarps; ++w) amax = fmaxf(amax, wmax[w]);
      a.amax_part[bh] = amax;
    }
    __syncthreads();
  }
  lowrank::grid_sync();

  // phase 2: row scales, int8 attn, xro = (bf16(attn) @ bf16(oR).T) * oRs
  for (int b = threadIdx.x; b < B; b += kThreads) {
    float amax = 0.f;
    for (int h = 0; h < a.KVH; ++h)
      amax = fmaxf(amax, __ldcg(a.amax_part + (size_t)b * a.KVH + h));
    srow[b] = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
  }
  __syncthreads();
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
       i < (size_t)B * qdim; i += (size_t)gridDim.x * kThreads) {
    const float q = rintf(__fdiv_rn(__ldcg(a.attn + i), srow[i / qdim]));
    a.xq8[i] = (int8_t)fminf(fmaxf(q, -127.f), 127.f);
  }
  const int rgroups = (rank + kWarps - 1) / kWarps;
  for (int u = blockIdx.x; u < rgroups; u += gridDim.x) {
    const int j0 = u * kWarps;
    lowrank::xr_rows<MT, true>(a.attn, B, qdim, a.oR + (size_t)j0 * qdim,
                               a.oRs + j0, min(kWarps, rank - j0), a.xro + j0,
                               rank, reinterpret_cast<float*>(smem),
                               act_words);
  }
  lowrank::grid_sync();

  // phase 3: the o_proj on the int8 attn with the L epilogue on xro
  const Splits one{1 << 30, 1 << 30, 1 << 30};
  const LFactor fo{a.xro, rank, a.oL, a.oLs, rank, one};
  const int ntiles = (a.h + RPB - 1) / RPB;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    lowrank::lr_tile<BITS, CODE, MT, true, true>(
        reinterpret_cast<const int*>(a.xq8), srow, B, qdim, a.o_w, a.o_s,
        a.h, a.jc, t, fo, smem, xrw, [&](int m, int n, int, float v) {
          a.out[(size_t)m * a.h + n] = v;
        });
  }
}

template <int BITS, int CODE, int MT, bool STAGED>
cudaError_t launch(AttnOArgs a, cudaStream_t st) {
  constexpr int F = 8 / BITS;
  constexpr int RPB = Tile<MT>::kRowsPerBlock;
  auto kernel = attn_o_kernel<BITS, CODE, MT, STAGED>;
  a.jc = lowrank::pick_jc<F>(kCoopSmemBytes, MT, a.KVH * a.D);
  const size_t smem = kCoopSmemBytes + (size_t)MT * a.rank * 4;
  static const cudaError_t attr = lowrank::allow_smem(kernel, 200 * 1024);
  if (attr != cudaSuccess) return attr;
  const int units = max(a.B * a.KVH, (a.h + RPB - 1) / RPB);
  int grid = 0;
  cudaError_t err = lowrank::coop_grid(kernel, smem, units, &grid);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&a};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(kThreads), args, smem, st);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int BITS, int CODE>
cudaError_t dispatch(const AttnOArgs& a, bool staged, cudaStream_t st) {
  if (a.B <= 8)
    return staged ? launch<BITS, CODE, 8, true>(a, st)
                  : launch<BITS, CODE, 8, false>(a, st);
  return staged ? launch<BITS, CODE, 32, true>(a, st)
                : launch<BITS, CODE, 32, false>(a, st);
}

}  // namespace

// q (B, KVH, 1, D) f32; k, v, ks, vs, k_new, v_new and pos as
// flash_decode_staged_launch's (k_new / v_new read only when staged); the
// o_proj's layer-stacked packed (layers, h, KVH * D / f), scales (layers,
// h), R (layers, rank, KVH * D) int8, R scales (layers, rank), L (layers, h,
// rank) int8, L scales (layers, h); scratch attn (B, KVH * D) f32, amax
// (B * KVH) f32, xq8 (B, KVH * D) int8, xro (B, rank) f32; out (B, h) f32.
extern "C" int attn_o_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* k_new, const void* v_new, const void* pos,
    const void* o_packed, const void* o_scales, const void* oR,
    const void* oRs, const void* oL, const void* oLs, void* attn,
    void* amax_part, void* xq8, void* xro, void* out, int B, int KVH, int D,
    int T, int block_t, float scale, int staged, int h, int bits, int layer,
    int rank, void* stream) {
  const int qdim = KVH * D;
  if ((bits != 2 && bits != 4 && bits != 8) || B < 1 || B > 32 || KVH < 1 ||
      D < 16 || D > flash_decode::kMaxD || D % 16 != 0 || block_t < 1 ||
      T % block_t != 0 || rank < 1 || qdim % (16 * (8 / bits)) != 0 ||
      (staged && (k_new == nullptr || v_new == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int f = 8 / bits;
  const size_t l = layer;
  AttnOArgs a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const int8_t*>(k);
  a.v = static_cast<const int8_t*>(v);
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.kn = static_cast<const float*>(k_new);
  a.vn = static_cast<const float*>(v_new);
  a.pos = static_cast<const int*>(pos);
  a.KVH = KVH;
  a.D = D;
  a.T = T;
  a.bt = block_t;
  a.scale = scale;
  a.o_w = static_cast<const uint8_t*>(o_packed) + l * h * (qdim / f);
  a.o_s = static_cast<const float*>(o_scales) + l * h;
  a.oR = static_cast<const int8_t*>(oR) + l * rank * qdim;
  a.oRs = static_cast<const float*>(oRs) + l * rank;
  a.oL = static_cast<const int8_t*>(oL) + l * h * rank;
  a.oLs = static_cast<const float*>(oLs) + l * h;
  a.attn = static_cast<float*>(attn);
  a.amax_part = static_cast<float*>(amax_part);
  a.xq8 = static_cast<int8_t*>(xq8);
  a.xro = static_cast<float*>(xro);
  a.out = static_cast<float*>(out);
  a.B = B;
  a.h = h;
  a.rank = rank;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bits == 2)
    err = dispatch<2, rowdot::kOffsetPacked>(a, staged != 0, st);
  else if (bits == 4)
    err = dispatch<4, rowdot::kOffsetPacked>(a, staged != 0, st);
  else
    err = dispatch<8, rowdot::kOffset8>(a, staged != 0, st);
  return (int)err;
}
