// Causal GQA flash self-attention for prefill, f32, on the tensor cores in
// 3xTF32 (wgmma).
//
// Replaces the TPU kernel ee274_convexcaldera_llm_quantization_tpu/ops/
// attention.py::flash_prefill (_flash_prefill_kernel): q (B, S, H, D),
// k/v (B, S, KVH, D) f32, head h = kvh * G + g; out[b, i, h] is the softmax
// over the keys j <= i of (q . k_j) / sqrt(D), applied to v, in f32.
//
// Bounds on an H100, S 2048, H 32, D 128: the causal operations are
// 4 H D S (S + 1) / 2 = 34.4 GFLOP. In 3xTF32 the card does three tf32
// products for each: 103 GFLOP over 495 TFLOP/s, 0.208 ms (the bound this
// kernel is held to). The same work in f32 FMAs outside the tensor cores
// takes 0.513 ms at 67 TFLOP/s. The bytes (q, k, v, out once each, 100 MB)
// take 0.03 ms. One tf32 product per dot would round the operands to 10-bit
// mantissas and miss the f32 reference by ~1e-3. The split x = big + small
// (hopper_gemm.cuh: split_tf32) keeps the dots at the f32 version's error.
//
// Route: wgmma m64nNk8 tf32. A version on mma.sync m16n8k8 tf32
// (operands split in registers by each warp) ran 1.40 ms at S 2048 on an
// H100, above SDPA's f32 time there (0.89 ms). wgmma reads tf32 operands
// K-major from shared memory (A may come from registers), so the operands
// are split once, in shared memory, by a warpgroup of their own:
// - a two-stage ring of 32-key tiles, each stage K big and small in TMA's
//   own layout (K-major, 128-byte swizzle) and V transposed to D rows of
//   32 keys (K-major for the P v product), big and small. TMA (mbarriers,
//   hopper_gemm.cuh) loads raw K straight into its stage, two tiles ahead,
//   and raw V into a two-buffer staging ring, so no load waits on a split;
//   its zero fill covers the ragged tail and D up to the next of 32, 64,
//   128;
// - warpgroup 0 (the splitter) splits q once into big and small copies,
//   then each tile: K in place, V transposed into its stage;
// - warpgroup 1 (the consumer) owns 64 query rows: row r = i G + g is head
//   kvh G + g at position q0 + i (BQ = 64 / G positions), so each tile
//   serves the G heads of its group. Per tile it takes S = q k^T on
//   m64n32k8 (q and K from shared memory), the online softmax (max, exp,
//   sum, rescale) in f32 in registers, and P v on m64nDk8 with P as the
//   register A operand; the split of the next tile overlaps these dots;
// - each product is big.small, small.big, big.big. The tensor cores round
//   their f32 sums toward zero, so a long chain on one accumulator drifts
//   (up to 1.8x the f32 version's error on sharp logits, in the mma.sync
//   version that chained every product): S sums each 32-value box of D in
//   a fresh accumulator and adds it in f32, and P v of a tile goes to a
//   fresh accumulator added to the rescaled output;
// - P feeds wgmma's A operand without a shuffle. The accumulator of S holds
//   keys 2t and 2t + 1 of each 8-key slice where the A fragment wants t and
//   t + 4, so logical key l of a slice is physical key 2l (l < 4) or
//   2 (l - 4) + 1, and the splitter writes V's keys in that order;
// - causal work: a CTA walks the tiles up to its last row; block 0 takes
//   the last q-block, so the heaviest CTAs start first; only tiles that
//   cross a row's diagonal are masked;
// - one CTA owns each output row and sums in a fixed order: no atomics, and
//   repeated launches give the same bits.
#include <cstdint>
#include <cuda_runtime.h>

#include "hopper_gemm.cuh"

namespace {

using namespace hopper;

constexpr int kRows = 64;       // query rows per CTA (one wgmma M)
constexpr int kBK = 32;         // keys per tile: one 128-byte row of V^T
constexpr int kThreads = 256;   // splitter and consumer warpgroups
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;

struct Bars {
  uint64_t qraw;      // raw q landed
  uint64_t q;         // q split
  uint64_t k[2];      // raw K landed in a stage
  uint64_t v[2];      // raw V landed in a staging buffer
  uint64_t full[2];   // a stage is split
  uint64_t empty[2];  // the consumer is done with a stage
};

// Shared memory from a 1024-byte boundary, NB boxes of 32 head_dim values
// (128-byte rows): q big, q small (kRows rows a box); two stages of K (raw,
// then big in place), K small (kBK rows a box), V^T big, V^T small (32 NB
// rows of kBK keys); two raw V buffers, which first hold raw q.
template <int NB>
struct Smem {
  static constexpr int kQBox = kRows * 128;
  static constexpr int kKBox = kBK * 128;
  static constexpr int kQs = NB * kQBox;
  static constexpr int kStage = 2 * NB * kQBox;
  static constexpr int kStageBytes = 4 * NB * kKBox;
  static constexpr int kKs = NB * kKBox, kVb = 2 * NB * kKBox,
                       kVs = 3 * NB * kKBox;
  static constexpr int kVraw = kStage + 2 * kStageBytes;
  static constexpr int kBytes = 1024 + kVraw + 2 * NB * kKBox;
  static_assert(2 * kKBox == kQBox, "raw q fills the raw V buffers");
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int R>
__device__ __forceinline__ void fence_u32(uint32_t (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// n float4 at src split into big (dst_b) and small (dst_s) halves, the
// splitter's 128 threads each taking every 128th.
__device__ __forceinline__ void split_copy(const uint8_t* src, uint8_t* dst_b,
                                           uint8_t* dst_s, int n, int tid) {
  for (int i = tid; i < n; i += 128) {
    const float4 x = reinterpret_cast<const float4*>(src)[i];
    uint4 b, s;
    split_tf32(x.x, b.x, s.x);
    split_tf32(x.y, b.y, s.y);
    split_tf32(x.z, b.z, s.z);
    split_tf32(x.w, b.w, s.w);
    reinterpret_cast<uint4*>(dst_b)[i] = b;
    reinterpret_cast<uint4*>(dst_s)[i] = s;
  }
}

// Grid: nqb x B x KVH CTAs, one a (q-block, b, kv-head), the last q-block
// first.
template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     float* __restrict__ out, int S, int KVH, int G, int D,
                     int BQ, float scale) {
  using L = Smem<NB>;
  constexpr int kN = 32 * NB;  // P v's width: D padded to a box
  __shared__ Bars bars;
  uint8_t* smem = smem_1k();

  const int nqb = (S + BQ - 1) / BQ;
  const int heads = gridDim.x / nqb;  // B x KVH
  const int qb = nqb - 1 - (int)blockIdx.x / heads;
  const int pair = (int)blockIdx.x % heads;
  const int kvh = pair % KVH, b = pair / KVH;
  const int q0 = qb * BQ;
  const int rows = BQ * G;  // rows past these are not loaded
  const int nkb = (min(q0 + BQ, S) - 1) / kBK + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(&bars.qraw, 1);
    mbar_init(&bars.q, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&bars.k[s], 1);
      mbar_init(&bars.v[s], 1);
      mbar_init(&bars.full[s], 1);
      mbar_init(&bars.empty[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // one thread: raw K (V) of tile kb into stage (V buffer) kb % 2
  uint8_t* vraw = smem + L::kVraw;
  const auto load_k = [&](int kb) {
    uint8_t* dst = smem + L::kStage + (kb & 1) * L::kStageBytes;
    mbar_expect_tx(&bars.k[kb & 1], NB * L::kKBox);
    for (int c = 0; c < NB; ++c)
      tma_load_4d(dst + c * L::kKBox, &tk, &bars.k[kb & 1], 32 * c, kvh,
                  kb * kBK, b);
  };
  const auto load_v = [&](int kb) {
    uint8_t* dst = vraw + (kb & 1) * NB * L::kKBox;
    mbar_expect_tx(&bars.v[kb & 1], NB * L::kKBox);
    for (int c = 0; c < NB; ++c)
      tma_load_4d(dst + c * L::kKBox, &tv, &bars.v[kb & 1], 32 * c, kvh,
                  kb * kBK, b);
  };

  if (warp < 4) {  // the splitter
    const int tid = threadIdx.x;
    if (tid == 0) {
      mbar_expect_tx(&bars.qraw, NB * rows * 128);
      for (int c = 0; c < NB; ++c)
        tma_load_4d(vraw + c * L::kQBox, &tq, &bars.qraw, 32 * c, kvh * G, q0,
                    b);
      for (int kb = 0; kb < min(nkb, 2); ++kb) load_k(kb);
    }
    mbar_wait(&bars.qraw, 0);
    split_copy(vraw, smem, smem + L::kQs, NB * L::kQBox / 16, tid);
    fence_proxy_async();
    bar_sync(1, 128);
    if (tid == 0) {
      mbar_arrive(&bars.q);
      for (int kb = 0; kb < min(nkb, 2); ++kb) load_v(kb);
    }
    // V: thread (key kp, 4-column chunk m) writes column kl (kp in the P
    // order) of rows 4 m .. 4 m + 3 of V^T
    const int kp = tid & 31, e = kp & 7;
    const int kl = (kp & ~7) + (e & 1 ? 4 + (e >> 1) : e >> 1);
    // (K of tile kb >= 2 is loaded by the consumer once it has released
    // the stage, so its arrival also means the stage is free)
    for (int kb = 0; kb < nkb; ++kb) {
      const int s = kb & 1;
      mbar_wait(&bars.k[s], (kb >> 1) & 1);
      mbar_wait(&bars.v[s], (kb >> 1) & 1);
      uint8_t* st = smem + L::kStage + s * L::kStageBytes;
      split_copy(st, st, st + L::kKs, NB * L::kKBox / 16, tid);
      const uint8_t* rv = vraw + s * NB * L::kKBox;
      for (int m = tid >> 5; m < 8 * NB; m += 4) {
        const float4 x = *reinterpret_cast<const float4*>(
            rv + (m >> 3) * L::kKBox + kp * 128 + (((m & 7) ^ (kp & 7)) << 4));
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int off = 4 * sw128_f32(4 * m + u, kl);
          uint32_t vb, vs;
          split_tf32(xs[u], vb, vs);
          *reinterpret_cast<uint32_t*>(st + L::kVb + off) = vb;
          *reinterpret_cast<uint32_t*>(st + L::kVs + off) = vs;
        }
      }
      fence_proxy_async();
      bar_sync(1, 128);
      if (tid == 0) {
        mbar_arrive(&bars.full[s]);
        if (kb + 2 < nkb) load_v(kb + 2);
      }
    }
    return;
  }

  // the consumer: this thread's rows r0 and r1 of warp w's 16 (lane = 4 g
  // + t); accumulator i of a 64 x n product is row (i & 2 ? r1 : r0),
  // column 8 (i / 4) + 2 t + (i & 1)
  const int w = warp - 4, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * w + g, r1 = r0 + 8;
  const int p0 = q0 + r0 / G, p1 = q0 + r1 / G;
  float o[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) o[i] = 0.f;
  // running max and this thread's share of the running sum, rows r0, r1
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  mbar_wait(&bars.q, 0);

  for (int kb = 0; kb < nkb; ++kb) {
    const int s = kb & 1;
    mbar_wait(&bars.full[s], (kb >> 1) & 1);
    const uint8_t* st = smem + L::kStage + s * L::kStageBytes;
    const int k0 = kb * kBK;

    // S = q k^T, one fresh accumulator per box of D, added in f32
    float sc[16], t0[16], t1[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      float(&tc)[16] = c & 1 ? t1 : t0;
      fence_regs(tc);
      wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        const int qo = c * L::kQBox + 32 * kq, ko = c * L::kKBox + 32 * kq;
        const uint64_t qbig = desc_sw128(smem + qo);
        const uint64_t qsmall = desc_sw128(smem + L::kQs + qo);
        const uint64_t kbig = desc_sw128(st + ko);
        const uint64_t ksmall = desc_sw128(st + L::kKs + ko);
        wgmma_m64n32k8_tf32_ss(tc, qbig, ksmall, kq);
        wgmma_m64n32k8_tf32_ss(tc, qsmall, kbig, 1);
        wgmma_m64n32k8_tf32_ss(tc, qbig, kbig, 1);
      }
      wgmma_commit();
      if (c > 0) {
        float(&tp)[16] = c & 1 ? t0 : t1;
        wgmma_wait<1>();
        fence_regs(tp);
#pragma unroll
        for (int i = 0; i < 16; ++i) sc[i] += tp[i];
      }
    }
    {
      float(&tl)[16] = (NB - 1) & 1 ? t1 : t0;
      wgmma_wait<0>();
      fence_regs(tl);
#pragma unroll
      for (int i = 0; i < 16; ++i) sc[i] += tl[i];
    }

    // online softmax; a tile below every row's diagonal needs no mask
    const bool diag = k0 + kBK - 1 > q0;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const bool hi = i & 2;
      sc[i] = !diag || key <= (hi ? p1 : p0) ? sc[i] * scale : kNegInf;
      if (hi)
        mx1 = fmaxf(mx1, sc[i]);
      else
        mx0 = fmaxf(mx0, sc[i]);
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // P as the A fragments of the four 8-key slices, big and small: slice
    // j holds {(r0, 2t), (r1, 2t), (r0, 2t + 1), (r1, 2t + 1)}
    uint32_t pb[4][4], ps[4][4];
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const bool hi = i & 2;
      const float p = expf(sc[i] - (hi ? mn1 : mn0));
      if (hi)
        s1 += p;
      else
        s0 += p;
      const int a = 2 * (i & 1) + (hi ? 1 : 0);
      split_tf32(p, pb[i >> 2][a], ps[i >> 2][a]);
    }
    l0 = l0 * a0 + s0;
    l1 = l1 * a1 + s1;

    // P v of the tile into a fresh accumulator; the A registers stay
    // untouched until the products are done
    float ot[kN / 2];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      fence_u32(pb[jj]);
      fence_u32(ps[jj]);
    }
    fence_regs(ot);
    wgmma_fence();
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const uint64_t vbig = desc_sw128(st + L::kVb + 32 * jj);
      const uint64_t vsmall = desc_sw128(st + L::kVs + 32 * jj);
      wgmma_m64k8_tf32_rs<kN>(ot, ps[jj], vbig, jj);
      wgmma_m64k8_tf32_rs<kN>(ot, pb[jj], vsmall, 1);
      wgmma_m64k8_tf32_rs<kN>(ot, pb[jj], vbig, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(ot);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      fence_u32(pb[jj]);
      fence_u32(ps[jj]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars.empty[s]);
    if (threadIdx.x == 128 && kb + 2 < nkb) {
      mbar_wait(&bars.empty[s], (kb >> 1) & 1);
      load_k(kb + 2);
    }
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) o[i] = o[i] * (i & 2 ? a1 : a0) + ot[i];
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int H = KVH * G;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? r1 : r0, p = h ? p1 : p0;
    if (r >= rows || p >= S) continue;
    const float l = h ? l1 : l0;
    float* orow = out + (((size_t)b * S + p) * H + kvh * G + r % G) * D;
#pragma unroll
    for (int n = 0; n < kN / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < D)
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(o[4 * n + 2 * h] / l, o[4 * n + 2 * h + 1] / l);
    }
  }
}

template <int NB>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, float* out, int B, int S, int KVH, int G,
           int D, int BQ, float scale, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<NB>::kBytes);
  if (err != cudaSuccess) return (int)err;
  const int nqb = (S + BQ - 1) / BQ;
  flash_prefill_kernel<NB><<<nqb * B * KVH, kThreads, Smem<NB>::kBytes, st>>>(
      tq, tk, tv, out, S, KVH, G, D, BQ, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, S, H, D), k/v (B, S, KVH, D), out (B, S, H, D): f32, contiguous,
// 16-byte aligned; D % 4 == 0, D <= 128, at most 64 heads per kv head.
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, void* out, int B, int S,
                                    int H, int KVH, int D, float scale,
                                    void* stream) {
  if (B < 1 || S < 1 || KVH < 1 || H % KVH != 0 || H / KVH > kRows ||
      D < 4 || D > kMaxD || D % 4 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int G = H / KVH, BQ = kRows / G;
  const uint64_t d = D, s = S, h = H, kvh = KVH;
  CUtensorMap tq, tk, tv;
  if (!map_f32_4d(&tq, q, {d, h, s, (uint64_t)B}, {d, h * d, s * h * d},
                  {(uint32_t)G, (uint32_t)BQ, 1}) ||
      !map_f32_4d(&tk, k, {d, kvh, s, (uint64_t)B},
                  {d, kvh * d, s * kvh * d}, {1, (uint32_t)kBK, 1}) ||
      !map_f32_4d(&tv, v, {d, kvh, s, (uint64_t)B},
                  {d, kvh * d, s * kvh * d}, {1, (uint32_t)kBK, 1}))
    return (int)cudaErrorInvalidValue;
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (D <= 32) return launch<1>(tq, tk, tv, o, B, S, KVH, G, D, BQ, scale, st);
  if (D <= 64) return launch<2>(tq, tk, tv, o, B, S, KVH, G, D, BQ, scale, st);
  return launch<4>(tq, tk, tv, o, B, S, KVH, G, D, BQ, scale, st);
}
