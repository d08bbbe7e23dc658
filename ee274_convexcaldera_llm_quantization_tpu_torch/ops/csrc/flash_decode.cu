// Flash-decode attention over a head-major int8 KV cache: one query token
// per (b, kv-head) with G grouped query heads, online softmax over the live
// token blocks of one layer (int8 codes, per-(token, head) f32 scales).
//
// One kernel template, four entry points, each replacing one TPU kernel of
// ee274_convexcaldera_llm_quantization_tpu/ops/attention.py:
// - flash_decode_staged_launch: flash_decode_q8_staged
//   (_flash_decode_q8_staged_kernel). The cache holds the tokens < pos[b];
//   the staged f32 K/V of the current token add one online-softmax update
//   at the end (pos 0 attends the current token alone).
// - flash_decode_inline_launch: flash_decode_q8 (_flash_decode_q8_kernel).
//   The current token is already in the cache: the tokens <= pos[b] are
//   attended (pos 0 attends token 0), the live blocks are t <= pos / bt,
//   and there is no current-token update.
// - flash_decode_ab_launch: flash_decode_q8_ab (_flash_decode_q8_ab_kernel),
//   staged or inline. The TPU kernel attends a (Bb, KVH) slab of rows per
//   program with a per-slab compute guard (a block runs while any row of
//   the slab is live). A block that is past a row's last live block is
//   fully masked for that row and leaves its softmax state exactly as it
//   was (alpha = 1, p = 0, and in i8 the quantized p is 0), so the slab
//   guard does not change the result: this per-(b, kv-head) CTA over the
//   row's own live blocks, walking ab's block partition (the caller passes
//   _ab_blocks' block_t, which in dots="i8" is part of the result), computes
//   the ab kernel's function. The slab exists on the TPU to make fewer,
//   larger DMAs; on the GPU every (b, head) stream is already one CTA.
// - flash_decode_paged_launch: flash_decode_q8_paged (the staged kernel on a
//   grid whose block t of row b is pool page page_tables[b, t]: block ==
//   page). The cache is one layer of a paged pool (NP, KVH, P, D) int8 with
//   (NP, KVH, P) scales; block t of (b, h) starts at ((pt[b, t] * KVH + h) *
//   P) * D. The same body runs with the page table as a pointer (null for
//   the contiguous entries), so the staged and paged functions are one code
//   path. Only the live pages t < ceil(pos[b] / P) are read: the TPU's
//   clamped re-reads of the last page for dead blocks never contribute.
//
// Bound on an H100: the live K/V codes and scales (2 * live * (D + 4) bytes
// per (b, head)); the operations are 4 * G * D per live token, far below
// the card's rate. Design:
// - one CTA per (b, kv-head); a loop inside the CTA walks the live token
//   blocks, which takes the place of the TPU's sequential grid axis, and
//   skips the masked tokens of the last block (their probabilities are
//   exactly 0, so nothing is read for them);
// - one thread per live token computes its logits from its K row (16-byte
//   loads, all in flight together); the four warps split the block's tokens
//   for p @ V (4-byte loads, 128 B per warp and token) and add their
//   partial sums; logits and probabilities stay in shared memory, the f32
//   output accumulator in registers (one head_dim column per thread);
// - I8 = true is the reference's dots="i8": q quantizes per g over D
//   (qs = max(|q|, 1e-12) * (1/127)), p * vs quantizes per g over each
//   block_t block (pvs = max(pv, 1e-30) * (1/127)) and both dots run as
//   exact integer sums (__dp4a for QK). The block partition is therefore
//   part of the result, and the blocks here are the reference's blocks.
//   I8 = false is dots="f32", the exactness twin.
// - block_t is at most 256 (logits of a whole block sit in shared memory);
//   the wrappers raise on a larger block rather than re-partition it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr int kMaxD = 128;
constexpr int kMaxBT = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// q (B, KVH, G, D) f32; k, v (B, KVH, T, D) int8 of the selected layer;
// ks, vs (B, KVH, T) f32; kn, vn (B, KVH, D) f32 (read only when STAGED);
// pos (B) int32; out (B, KVH, G, D) f32. With a page table pt (B,
// max_pages) int32, k, v are (NP, KVH, bt, D) and ks, vs (NP, KVH, bt)
// instead, and T = max_pages * bt.
template <bool I8, bool STAGED>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const float* __restrict__ q,
                    const int8_t* __restrict__ k,
                    const int8_t* __restrict__ v,
                    const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const float* __restrict__ kn,
                    const float* __restrict__ vn,
                    const int* __restrict__ pos,
                    const int* __restrict__ pt, int max_pages,
                    float* __restrict__ out, int KVH, int G, int D, int T,
                    int bt, float scale) {
  __shared__ float qf[kMaxG * kMaxD];
  __shared__ __align__(16) int8_t qi[kMaxG * kMaxD];
  __shared__ float lg[kMaxG * kMaxBT];  // logits, then p * vs
  __shared__ int8_t pq[kMaxG * kMaxBT];  // I8: quantized p * vs
  __shared__ float part[kWarps * kMaxG * kMaxD];  // PV partial sums per warp
  __shared__ float qs_s[kMaxG], m_s[kMaxG], s_s[kMaxG], alpha_s[kMaxG],
      pvs_s[kMaxG], pcur_s[kMaxG];

  const int bh = blockIdx.x;  // b * KVH + h
  const int b = bh / KVH;
  const int h = bh - b * KVH;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // cache tokens attended: < pos (staged) or <= pos (inline), at most T
  const int P = min(STAGED ? pos[b] : pos[b] + 1, T);
  const int nblk = P > 0 ? (P - 1) / bt + 1 : 0;
  const int dw = D / 4;

  const float* qb = q + (size_t)bh * G * D;
  for (int i = tid; i < G * D; i += kThreads) qf[i] = qb[i];
  __syncthreads();
  if (I8) {
    for (int g = warp; g < G; g += kWarps) {
      float a = 0.f;
      for (int d = lane; d < D; d += 32) a = fmaxf(a, fabsf(qf[g * D + d]));
      a = warp_max(a);
      const float sc = fmaxf(a, 1e-12f) * (1.0f / 127.0f);
      for (int d = lane; d < D; d += 32)
        qi[g * D + d] = (int8_t)rintf(qf[g * D + d] / sc);
      if (lane == 0) qs_s[g] = sc;
    }
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    s_s[tid] = 0.f;
  }
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;

  const int* qi32 = reinterpret_cast<const int*>(qi);
  __syncthreads();

  for (int t = 0; t < nblk; ++t) {
    const int t0 = t * bt;
    const int nvalid = min(bt, P - t0);  // attended tokens in this block
    // the block's first token, as a row of k viewed as (rows, D): token t0
    // of the (b, h) stream, or the start of (page pt[b, t], head h)
    const size_t row =
        pt != nullptr
            ? ((size_t)pt[(size_t)b * max_pages + t] * KVH + h) * bt
            : (size_t)bh * T + t0;
    const int8_t* kt = k + row * D;
    const int8_t* vt = v + row * D;
    const float* kst = ks + row;
    const float* vst = vs + row;

    // 1. logits of the live tokens: one thread per token, its K row read as
    //    16-byte vectors (D / 16 loads in flight), q from shared memory
    for (int i = tid; i < nvalid; i += kThreads) {
      const float kscale = kst[i] * scale;
      const uint4* krow = reinterpret_cast<const uint4*>(kt + (size_t)i * D);
      uint4 kv[kMaxD / 16];
#pragma unroll
      for (int j = 0; j < kMaxD / 16; ++j)
        if (j < D / 16) kv[j] = __ldg(krow + j);
      for (int g = 0; g < G; ++g) {
        float logit;
        if (I8) {
          int is = 0;
#pragma unroll
          for (int j = 0; j < kMaxD / 16; ++j) {
            if (j < D / 16) {
              const int* qw = qi32 + g * dw + 4 * j;
              is = __dp4a((int)kv[j].x, qw[0], is);
              is = __dp4a((int)kv[j].y, qw[1], is);
              is = __dp4a((int)kv[j].z, qw[2], is);
              is = __dp4a((int)kv[j].w, qw[3], is);
            }
          }
          logit = ((float)is * qs_s[g]) * kscale;
        } else {
          float fs = 0.f;
#pragma unroll
          for (int j = 0; j < kMaxD / 16; ++j) {
            if (j < D / 16) {
              const unsigned w4[4] = {kv[j].x, kv[j].y, kv[j].z, kv[j].w};
#pragma unroll
              for (int c = 0; c < 16; ++c)
                fs += qf[g * D + 16 * j + c] *
                      (float)(int8_t)((w4[c / 4] >> (8 * (c % 4))) & 0xFFu);
            }
          }
          logit = fs * kscale;
        }
        lg[g * bt + i] = logit;
      }
    }
    __syncthreads();

    // 2. online-softmax update, one warp per query head g
    for (int g = warp; g < G; g += kWarps) {
      float bm = kNegInf;
      for (int i = lane; i < nvalid; i += 32) bm = fmaxf(bm, lg[g * bt + i]);
      bm = warp_max(bm);
      const float m_prev = m_s[g];
      const float s_prev = s_s[g];
      const float m_new = fmaxf(m_prev, bm);
      const float alpha = expf(m_prev - m_new);
      float ps = 0.f, pvm = 0.f;
      for (int i = lane; i < nvalid; i += 32) {
        const float p = expf(lg[g * bt + i] - m_new);
        const float pv = p * vst[i];
        ps += p;
        pvm = fmaxf(pvm, pv);
        lg[g * bt + i] = pv;
      }
      ps = warp_sum(ps);
      if (I8) {
        pvm = warp_max(pvm);
        const float sc = fmaxf(pvm, 1e-30f) * (1.0f / 127.0f);
        for (int i = lane; i < nvalid; i += 32)
          pq[g * bt + i] = (int8_t)rintf(lg[g * bt + i] / sc);
        if (lane == 0) pvs_s[g] = sc;
      }
      if (lane == 0) {
        m_s[g] = m_new;
        s_s[g] = s_prev * alpha + ps;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // 3. acc = acc * alpha + (p * vs) @ v: warp w sums the tokens
    //    i = w (mod 4), each lane four head_dim columns (one 4-byte load per
    //    token, 128 B per warp), then the four partial sums are added
    {
      const int d0 = 4 * lane;
      float fs[kMaxG][4];
      int is[kMaxG][4];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          fs[g][c] = 0.f;
          is[g][c] = 0;
        }
      if (d0 < D) {
#pragma unroll 4
        for (int i = warp; i < nvalid; i += kWarps) {
          const unsigned vw = __ldg(reinterpret_cast<const unsigned*>(
              vt + (size_t)i * D + d0));
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            if (g < G) {
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const int vv = (int)(int8_t)((vw >> (8 * c)) & 0xFFu);
                if (I8)
                  is[g][c] += (int)pq[g * bt + i] * vv;
                else
                  fs[g][c] += lg[g * bt + i] * (float)vv;
              }
            }
          }
        }
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              part[(warp * kMaxG + g) * kMaxD + d0 + c] =
                  I8 ? (float)is[g][c] : fs[g][c];
      }
    }
    __syncthreads();
    if (tid < D) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float contrib;
          if (I8) {
            // exact: each partial is an integer below 2^24
            int tot = 0;
            for (int w = 0; w < kWarps; ++w)
              tot += (int)part[(w * kMaxG + g) * kMaxD + tid];
            contrib = (float)tot * pvs_s[g];
          } else {
            contrib = 0.f;
            for (int w = 0; w < kWarps; ++w)
              contrib += part[(w * kMaxG + g) * kMaxD + tid];
          }
          acc[g] = acc[g] * alpha_s[g] + contrib;
        }
      }
    }
    __syncthreads();
  }

  if (!STAGED) {
    // inline: every row attends at least token 0, so s > 0
    if (tid < D) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) out[((size_t)bh * G + g) * D + tid] = acc[g] / s_s[g];
    }
    return;
  }

  // 4. staged: the current token (f32 dots), then normalize
  for (int g = warp; g < G; g += kWarps) {
    float part = 0.f;
    for (int d = lane; d < D; d += 32)
      part += qf[g * D + d] * kn[(size_t)bh * D + d];
    const float logit = warp_sum(part) * scale;
    const float m_prev = m_s[g];
    const float s_prev = s_s[g];
    const float m_new = fmaxf(m_prev, logit);
    const float alpha = expf(m_prev - m_new);
    const float p = expf(logit - m_new);
    if (lane == 0) {
      s_s[g] = s_prev * alpha + p;
      alpha_s[g] = alpha;
      pcur_s[g] = p;
    }
  }
  __syncthreads();
  if (tid < D) {
    const float vcur = vn[(size_t)bh * D + tid];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G)
        out[((size_t)bh * G + g) * D + tid] =
            (acc[g] * alpha_s[g] + pcur_s[g] * vcur) / s_s[g];
  }
}

int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* k_new, const void* v_new,
           const void* pos, const void* page_tables, int max_pages,
           void* out, int B, int KVH, int G, int D, int T, int block_t,
           float scale, int i8, bool staged, void* stream) {
  if (B < 1 || KVH < 1 || G < 1 || G > kMaxG || D < 16 || D > kMaxD ||
      D % 16 != 0 || block_t < 1 || block_t > kMaxBT || T % block_t != 0 ||
      (page_tables != nullptr && (max_pages < 1 || T != max_pages * block_t)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * KVH);
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const int8_t*>(k);
  const auto* vp = static_cast<const int8_t*>(v);
  const auto* ksp = static_cast<const float*>(ks);
  const auto* vsp = static_cast<const float*>(vs);
  const auto* knp = static_cast<const float*>(k_new);
  const auto* vnp = static_cast<const float*>(v_new);
  const auto* pp = static_cast<const int*>(pos);
  const auto* ptp = static_cast<const int*>(page_tables);
  auto* op = static_cast<float*>(out);
  if (i8 && staged)
    flash_decode_kernel<true, true><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, ksp, vsp, knp, vnp, pp, ptp, max_pages, op, KVH, G, D, T,
        block_t, scale);
  else if (i8)
    flash_decode_kernel<true, false><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, ksp, vsp, knp, vnp, pp, ptp, max_pages, op, KVH, G, D, T,
        block_t, scale);
  else if (staged)
    flash_decode_kernel<false, true><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, ksp, vsp, knp, vnp, pp, ptp, max_pages, op, KVH, G, D, T,
        block_t, scale);
  else
    flash_decode_kernel<false, false><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, ksp, vsp, knp, vnp, pp, ptp, max_pages, op, KVH, G, D, T,
        block_t, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_decode_staged_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* k_new, const void* v_new, const void* pos,
    void* out, int B, int KVH, int G, int D, int T, int block_t, float scale,
    int i8, void* stream) {
  return launch(q, k, v, ks, vs, k_new, v_new, pos, nullptr, 0, out, B, KVH,
                G, D, T, block_t, scale, i8, true, stream);
}

extern "C" int flash_decode_inline_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* pos, void* out, int B, int KVH, int G, int D,
    int T, int block_t, float scale, int i8, void* stream) {
  return launch(q, k, v, ks, vs, nullptr, nullptr, pos, nullptr, 0, out, B,
                KVH, G, D, T, block_t, scale, i8, false, stream);
}

extern "C" int flash_decode_ab_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* k_new, const void* v_new, const void* pos,
    void* out, int B, int KVH, int G, int D, int T, int block_t, float scale,
    int i8, int staged, void* stream) {
  if (staged && (k_new == nullptr || v_new == nullptr))
    return (int)cudaErrorInvalidValue;
  return launch(q, k, v, ks, vs, k_new, v_new, pos, nullptr, 0, out, B, KVH,
                G, D, T, block_t, scale, i8, staged != 0, stream);
}

// k, v: one layer of the pool (NP, KVH, page_size, D) int8; ks, vs (NP, KVH,
// page_size) f32; page_tables (B, max_pages) int32, every id < NP (the
// wrapper checks); the staged current token's k_new, v_new (B, KVH, D) f32.
extern "C" int flash_decode_paged_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* k_new, const void* v_new, const void* pos,
    const void* page_tables, void* out, int B, int KVH, int G, int D,
    int max_pages, int page_size, float scale, int i8, void* stream) {
  if (k_new == nullptr || v_new == nullptr || page_tables == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch(q, k, v, ks, vs, k_new, v_new, pos, page_tables, max_pages,
                out, B, KVH, G, D, max_pages * page_size, page_size, scale, i8,
                true, stream);
}
