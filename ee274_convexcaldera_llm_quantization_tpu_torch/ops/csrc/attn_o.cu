// Flash-decode attention fused with the W4A8 o_proj and its int8 low-rank
// factors, against one layer: replaces the TPU kernel
// ee274_convexcaldera_llm_quantization_tpu/ops/attention.py::
// flash_decode_attn_o (_flash_attn_o_kernel). MHA only (one query head per
// kv head), head_dim 128, f32 dots, staged or inline, batch <= 32.
//
// The TPU kernel walks one sequential grid: the (b, token block) steps of
// the attention into a VMEM buffer, one step that requantizes it and
// contracts it with oR, then the o_proj output blocks. Here it is one
// cooperative launch of as many CTAs of 4 warps as fit on the card at once
// (two or three an SM), in three phases split by two grid barriers:
// 1. the CTAs loop over the B x KVH (b, head) streams (one wave at batch 8),
//    each attended by the device code of flash_decode.cu (flash_decode.cuh,
//    f32 dots, 128 threads) into a flat (B, KVH * D) f32 scratch, the
//    stream's absmax of |attn| into a slot of its own, and the thin R dot
//    folded in: the stream's 128 outputs are a K chunk of xro = bf16(attn)
//    @ bf16(oR).T, so its partial sums for every R row (one thread's
//    sequential chain a row) go to the stream's own slot while the outputs
//    are in shared memory;
// 2. every CTA reduces the absmax slots to the row scales sx = max(amax,
//    1e-12) / 127; the grid requantizes attn to int8 (round half to even,
//    clip 127) and sums each xro output's head partials in head order (a
//    warp an output: its lanes over the heads, then a fixed butterfly);
// 3. the o_proj on fused_proj.cuh: int8 mma.sync products of the packed
//    codes, the L dots as bf16 mma.sync on L slabs of the same stream, out
//    (B, h) before o's global scale.
//
// Bound on an H100: the live K/V codes and scales plus o_proj's weight
// bytes (h x KVH * D / 2 packed + h x rank + rank x KVH * D int8 for
// Llama-2-7B: ~9 MB of weights against ~8.5 MB of K/V at batch 8 and 128
// live tokens, 5.6 us at 3.35 TB/s). Each warp streams its share of o_proj's
// weights through a cp.async ring (fused_proj.cuh) that it fills once its
// CTA's attention streams are done, before the first grid barrier: at batch
// 8 a warp's share is about two slabs, so the whole o_proj loads across the
// barriers and phase 2, and phase 3 is mostly the products. (Filled at the
// launch's start, the ring took bandwidth from the attention.) The attention equals flash_decode.cu's bit for bit, and so
// do attn's int8 codes; xro's and the L dots' sums run in other orders than
// the reference's.
#include "flash_decode.cuh"
#include "fused_proj.cuh"

namespace {

// CTAs of 4 warps: two or more an SM, so that one wave of CTAs attends
// every stream of a batch of 8 (256 streams at Llama-2-7B).
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// Shared memory for o_proj's xr window (bf16): 32 rows at rank 128.
constexpr int kWin = 8 * 1024;

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
  // the thin R factor of o_proj (layer)
  const int8_t* oR;     // (rank, KVH * D)
  const float* oRs;     // (rank)
  // scratch and output
  float* attn;          // (B, KVH * D) f32
  float* amax_part;     // (B * KVH) f32
  float* xpart;         // (B * KVH, rank) f32: each stream's xro sums
  int8_t* xq8;          // (B, KVH * D) int8
  float* xro;           // (B, rank) f32
  int4* pws;            // split-group partial slots
  int* cnt;             // split-group counters, zero (and zero after)
  float* out;           // (B, h) f32
  int B, h, rank;
};

template <int BITS, int MT, bool STAGED>
__global__ void __launch_bounds__(kThreads, 2)
    attn_o_kernel(const __grid_constant__ AttnOArgs a,
                  const __grid_constant__ fproj::Plan pl) {
  constexpr int NF = MT / 8;
  __shared__ float wmax[kWarps];
  __shared__ float srow[32];  // the row scales sx of attn
  __shared__ float ob[128];   // bf16(attn) of a stream
  uint8_t* ring = hopper::smem_1k();
  auto* wsm = reinterpret_cast<uint16_t*>(ring + kWarps * fproj::kWarpRing);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = a.B, KVH = a.KVH, D = a.D, qdim = KVH * D, rank = a.rank;
  fproj::Ring rg;
  fproj::Stream q;

  // phase 1: attention of each (b, head) stream, its absmax and xro sums
  for (int bh = blockIdx.x; bh < B * KVH; bh += gridDim.x) {
    const int hh = bh % KVH;
    // the head's R columns of this thread's first R row (rank >= 128 =
    // kThreads), loaded under the attention
    uint4 rv[8];
    const uint4* rp0 =
        reinterpret_cast<const uint4*>(a.oR + (size_t)tid * qdim + hh * D);
#pragma unroll
    for (int i = 0; i < 8; ++i) rv[i] = __ldg(rp0 + i);
    const float o =
        flash_decode::decode_attend<kThreads, 1, flash_decode::kDotsF32,
                                    STAGED>(
            bh, a.q, a.k, a.v, a.ks, a.vs, a.kn, a.vn, a.pos, nullptr, 0,
            a.attn, KVH, 1, D, a.T, a.bt, a.scale);
    const float m = lowrank::warp_max_f(tid < D ? fabsf(o) : 0.f);
    if (lane == 0) wmax[warp] = m;
    if (tid < D) ob[tid] = lowrank::bf16r(o);
    __syncthreads();
    if (tid == 0) {
      float amax = wmax[0];
      for (int w = 1; w < kWarps; ++w) amax = fmaxf(amax, wmax[w]);
      a.amax_part[bh] = amax;
    }
    // xpart[bh, j] = sum_d ob[d] R[j, d] (R at the head's columns), one
    // thread's sequential chain an R row
    for (int j = tid; j < rank; j += kThreads) {
      if (j != tid) {
        const uint4* rp =
            reinterpret_cast<const uint4*>(a.oR + (size_t)j * qdim + hh * D);
#pragma unroll
        for (int i = 0; i < 8; ++i) rv[i] = __ldg(rp + i);
      }
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const unsigned w4[4] = {rv[i].x, rv[i].y, rv[i].z, rv[i].w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            s = fmaf(ob[16 * i + 4 * u + b],
                     (float)(int8_t)((w4[u] >> (8 * b)) & 0xFF), s);
      }
      a.xpart[(size_t)bh * rank + j] = s;
    }
    __syncthreads();  // ob and wmax, before the next stream
  }
  // o_proj's first slabs load across both barriers and phase 2 (started
  // earlier, they would take bandwidth from the attention)
  fproj::stream_start(pl, ring, rg, q);
  lowrank::grid_sync();

  // phase 2: row scales, int8 attn, xro = (sum over heads of xpart) * oRs
  for (int b = warp; b < B; b += kWarps) {
    float amax = 0.f;
    for (int hh = lane; hh < KVH; hh += 32)
      amax = fmaxf(amax, __ldcg(a.amax_part + (size_t)b * KVH + hh));
    amax = lowrank::warp_max_f(amax);
    if (lane == 0) srow[b] = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
  }
  __syncthreads();
  for (size_t i = (size_t)blockIdx.x * kThreads + tid; i < (size_t)B * qdim;
       i += (size_t)gridDim.x * kThreads)
    a.xq8[i] = fproj::code8(__ldcg(a.attn + i), srow[i / qdim]);
  {
    const int W = gridDim.x * kWarps, w = blockIdx.x * kWarps + warp;
    for (int item = w; item < B * rank; item += W) {
      const int b = item / rank, j = item - b * rank;
      float s = 0.f;
      for (int hh = lane; hh < KVH; hh += 32)
        s = __fadd_rn(s, __ldcg(a.xpart + ((size_t)b * KVH + hh) * rank + j));
      s = lowrank::warp_sum_f(s);
      if (lane == 0) a.xro[(size_t)b * rank + j] = __fmul_rn(s, a.oRs[j]);
    }
  }
  lowrank::grid_sync();

  // phase 3: the o_proj on the int8 attn with the L slabs on xro
  const fproj::Stage& so = pl.st[0];
  const int g8 = lane >> 2, t = lane & 3, ra = mproj::smem_row(g8);
  fproj::run_stage<BITS, MT, false>(
      pl, 0, q, rg, a.pws, a.cnt, wsm, kWin,
      [&](int, int, int g, int (&acc)[2][NF][4], float (&accl)[2][NF][4]) {
#pragma unroll
        for (int tl = 0; tl < 2; ++tl)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int n = 32 * g + 16 * tl + ra + 8 * hi;
            const float w = __ldg(so.ws + n), l = __ldg(so.Ls + n);
#pragma unroll
            for (int f = 0; f < NF; ++f)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int m = 8 * f + 2 * t + e;
                if (m < B)
                  a.out[(size_t)m * a.h + n] = fproj::finish(
                      acc[tl][f][2 * hi + e], accl[tl][f][2 * hi + e], w,
                      srow[m], l);
              }
          }
      });
}

template <int BITS, int MT, bool STAGED>
cudaError_t launch(const AttnOArgs& a, const fproj::Plan& pl, int ctas,
                   cudaStream_t st, int* grid_only) {
  auto kernel = attn_o_kernel<BITS, MT, STAGED>;
  constexpr int smem = fproj::smem_bytes(kWarps, kWin);
  cudaError_t err = hopper::allow_smem<attn_o_kernel<BITS, MT, STAGED>>(smem);
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

template <int BITS>
cudaError_t dispatch(const AttnOArgs& a, const fproj::Plan& pl, bool staged,
                     int ctas, cudaStream_t st, int* grid_only) {
  if (a.B <= 8)
    return staged ? launch<BITS, 8, true>(a, pl, ctas, st, grid_only)
                  : launch<BITS, 8, false>(a, pl, ctas, st, grid_only);
  return staged ? launch<BITS, 32, true>(a, pl, ctas, st, grid_only)
                : launch<BITS, 32, false>(a, pl, ctas, st, grid_only);
}

cudaError_t dispatch_bits(int bits, const AttnOArgs& a, const fproj::Plan& pl,
                          bool staged, int ctas, cudaStream_t st,
                          int* grid_only) {
  if (bits == 2) return dispatch<2>(a, pl, staged, ctas, st, grid_only);
  if (bits == 4) return dispatch<4>(a, pl, staged, ctas, st, grid_only);
  return dispatch<8>(a, pl, staged, ctas, st, grid_only);
}

bool valid_bits(int bits) { return bits == 2 || bits == 4 || bits == 8; }

}  // namespace

// q (B, KVH, 1, D) f32; k, v, ks, vs, k_new, v_new and pos as
// flash_decode_staged_launch's (k_new / v_new read only when staged); the
// o_proj's layer-stacked packed (layers, h, KVH * D / f), scales (layers,
// h), R (layers, rank, KVH * D) int8, R scales (layers, rank), L (layers, h,
// rank) int8, L scales (layers, h); scratch attn (B, KVH * D) f32, amax
// (B * KVH) f32, xpart (B * KVH, rank) f32, xq8 (B, KVH * D) int8, xro (B,
// rank) f32, pws 32 MT int4 per warp of the grid (MT = 8 when B <= 8 else
// 32; 4 warps a CTA: two split slots of i32 and f32 partials), cnt h / 32
// zeroed ints (left zeroed); out (B, h) f32. D 128, rank % 128 == 0, h % 32 == 0. ctas: the CTAs of
// the launch, at most attn_o_grid's (0: that many).
extern "C" int attn_o_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* k_new, const void* v_new, const void* pos,
    const void* o_packed, const void* o_scales, const void* oR,
    const void* oRs, const void* oL, const void* oLs, void* attn,
    void* amax_part, void* xpart, void* xq8, void* xro, void* pws, void* cnt,
    void* out, int B, int KVH, int D, int T, int block_t, float scale,
    int staged, int h, int bits, int layer, int rank, int ctas,
    void* stream) {
  const int qdim = KVH * D;
  if (!valid_bits(bits) || B < 1 || B > 32 || KVH < 1 || D != 128 ||
      block_t < 1 || T % block_t != 0 || rank < 128 || rank % 128 != 0 ||
      h % 32 != 0 || qdim % (16 * (8 / bits)) != 0 || ctas < 0 ||
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
  a.oR = static_cast<const int8_t*>(oR) + l * rank * qdim;
  a.oRs = static_cast<const float*>(oRs) + l * rank;
  a.attn = static_cast<float*>(attn);
  a.amax_part = static_cast<float*>(amax_part);
  a.xpart = static_cast<float*>(xpart);
  a.xq8 = static_cast<int8_t*>(xq8);
  a.xro = static_cast<float*>(xro);
  a.pws = static_cast<int4*>(pws);
  a.cnt = static_cast<int*>(cnt);
  a.out = static_cast<float*>(out);
  a.B = B;
  a.h = h;
  a.rank = rank;
  // the o_proj stage: groups of 32 rows, one activation tile
  constexpr int KC = fproj::kKC;
  fproj::Plan pl{};
  pl.st[0] = {static_cast<const uint8_t*>(o_packed) + l * h * (qdim / f),
              static_cast<const int8_t*>(oL) + l * h * rank,
              static_cast<const float*>(o_scales) + l * h,
              static_cast<const float*>(oLs) + l * h,
              a.xq8, a.xro, qdim / f, (qdim / f + KC - 1) / KC, rank / KC,
              h / 32, 0, 1, B, qdim, rank, rank, 1};
  pl.nst = 1;
  return (int)dispatch_bits(bits, a, pl, staged != 0, ctas,
                            static_cast<cudaStream_t>(stream), nullptr);
}

// The most CTAs an attn_o_launch of batch B at `bits` (staged or not) runs
// (the cooperative grid: CTAs an SM x SMs), into *ctas.
extern "C" int attn_o_grid(int B, int bits, int staged, void* ctas) {
  if (!valid_bits(bits) || B < 1 || B > 32 || ctas == nullptr)
    return (int)cudaErrorInvalidValue;
  AttnOArgs a{};
  a.B = B;
  const fproj::Plan pl{};
  return (int)dispatch_bits(bits, a, pl, staged != 0, 0, nullptr,
                            static_cast<int*>(ctas));
}
