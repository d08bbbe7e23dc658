// The flash-decode attention of one (b, kv-head) stream, as a device
// function of a CTA of NT threads: csrc/flash_decode.cu's kernels run it
// with NT = 128 on one stream per CTA, csrc/attn_o.cu's cooperative kernel
// with NT = 128 on a loop of streams. See flash_decode.cu for what it
// computes and how.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash_decode {

constexpr int kMaxD = 128;
// Tokens of a block whose logits sit in shared memory at once (a sub-tile).
constexpr int kSub = 256;
constexpr float kNegInf = -1e30f;

// Dot modes of the cache blocks: the C entries' `dots` argument.
constexpr int kDotsF32 = 0;
constexpr int kDotsBF16 = 1;  // q and p * vs rounded to bf16, f32 sums
constexpr int kDotsI8 = 2;    // q and p * vs quantized to int8, i32 sums

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

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A load of q or of the staged current token: CG = true reads data that
// another thread of the same launch wrote (csrc/megastep.cu's scratch) from
// L2, never through the non-coherent read-only path.
template <bool CG>
__device__ __forceinline__ float ld_in(const float* p) {
  return CG ? __ldcg(p) : *p;
}

// Attends stream bh = b * KVH + h and returns, in thread tid < D, the output
// of query head 0 at column tid (the value it wrote to out); every thread of
// the CTA must call it. Calls in a loop need a __syncthreads() between them.
// q (B, KVH, G, D) f32; k, v (B, KVH, T, D) int8 of the selected layer;
// ks, vs (B, KVH, T) f32; kn, vn (B, KVH, D) f32 (read only when STAGED);
// pos (B) int32; out (B, KVH, G, D) f32. With a page table pt (B,
// max_pages) int32, k, v are (NP, KVH, bt, D) and ks, vs (NP, KVH, bt)
// instead, and T = max_pages * bt. DOTS is one of the kDots* modes. CG:
// q, kn and vn were written earlier in the same launch (ld_in).
//
// A block of any length bt: the online-softmax update of a block needs its
// max before any probability, and in kDotsI8 the absmax of all its p * vs
// before any code (the block is the quantization group, so it cannot be
// split into smaller blocks without changing the result). A block of at
// most kSub live tokens keeps its logits in shared memory and is walked
// once. A longer one is walked in sub-tiles of kSub tokens, in passes that
// recompute the same logits with the same code: (1) the block max, (2) the
// sum of p and, in i8, the absmax of p * vs, (3) the codes and the PV sums
// (f32 and bf16 fold (3) into (2)). Each lane and each warp meets its
// tokens in the same order as in one walk (kSub is a multiple of 32 and of
// the warp count), so the result has the same bits as a single pass over
// the whole block. Shared memory stays static and small (the block length
// is unbounded: 7 heads x 32768 tokens would need 1.1 MB), at the price of
// reading K two or three times for blocks over kSub tokens only.
template <int NT, int MAXG, int DOTS, bool STAGED, bool CG = false>
__device__ __forceinline__ float decode_attend(
                    int bh, const float* __restrict__ q,
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
  constexpr int kThreads = NT;
  constexpr int kWarps = NT / 32;
  constexpr int kMaxG = MAXG;
  constexpr int kGPW = (kMaxG + kWarps - 1) / kWarps;  // heads per warp
  constexpr bool I8 = DOTS == kDotsI8;
  static_assert(kSub % 32 == 0 && kSub % kWarps == 0, "sub-tile order");
  __shared__ float qf[kMaxG * kMaxD];  // q as the cache dots take it
  __shared__ __align__(16) int8_t qi[kMaxG * kMaxD];
  __shared__ float lg[kMaxG * kSub];  // a sub-tile's logits, then p * vs
  __shared__ int8_t pq[kMaxG * kSub];  // I8: quantized p * vs
  __shared__ float part[kWarps * kMaxG * kMaxD];  // PV partial sums per warp
  __shared__ float qs_s[kMaxG], m_s[kMaxG], s_s[kMaxG], alpha_s[kMaxG],
      pvs_s[kMaxG], pcur_s[kMaxG];

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
  for (int i = tid; i < G * D; i += kThreads)
    qf[i] = DOTS == kDotsBF16 ? bf16_round(ld_in<CG>(qb + i))
                                : ld_in<CG>(qb + i);
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
    const int nsub = (nvalid + kSub - 1) / kSub;
    // walks over the block's sub-tiles: one when it is a single sub-tile,
    // else max, then sum (and PV), then in i8 the codes and PV
    const int nwalk = nsub == 1 ? 1 : (I8 ? 3 : 2);

    // this warp's heads g = warp + j * kWarps: lane partials of the block
    // max, the sum of p and the absmax of p * vs; the block's new max
    float bmax[kGPW], m_new[kGPW], ps[kGPW], pvm[kGPW];
#pragma unroll
    for (int j = 0; j < kGPW; ++j) {
      bmax[j] = kNegInf;
      m_new[j] = kNegInf;
      ps[j] = 0.f;
      pvm[j] = 0.f;
    }
    // PV partial sums of this thread (four head_dim columns per head)
    float fs[kMaxG][4];
    int is[kMaxG][4];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        fs[g][c] = 0.f;
        is[g][c] = 0;
      }

    // one walk over the sub-tile of tokens [s0, s0 + kSub) of the block;
    // `more`: another walk follows and rewrites lg and pq
    auto walk_sub = [&](const int walk, const int s0, const bool more) {
      const int ns = min(kSub, nvalid - s0);
      const bool do_max = walk == 0;
      const bool do_sum = nwalk == 1 || walk == 1;
      const bool do_pv = walk == nwalk - 1;

      // 1. logits of the sub-tile's tokens: one thread per token, its K
      //    row read as 16-byte vectors (D / 16 loads in flight), q from
      //    shared memory
      for (int i = tid; i < ns; i += kThreads) {
        const float kscale = kst[s0 + i] * scale;
        const uint4* krow =
            reinterpret_cast<const uint4*>(kt + (size_t)(s0 + i) * D);
        uint4 kv[kMaxD / 16];
#pragma unroll
        for (int j = 0; j < kMaxD / 16; ++j)
          if (j < D / 16) kv[j] = __ldg(krow + j);
        for (int g = 0; g < G; ++g) {
          float logit;
          if (I8) {
            int isum = 0;
#pragma unroll
            for (int j = 0; j < kMaxD / 16; ++j) {
              if (j < D / 16) {
                const int* qw = qi32 + g * dw + 4 * j;
                isum = __dp4a((int)kv[j].x, qw[0], isum);
                isum = __dp4a((int)kv[j].y, qw[1], isum);
                isum = __dp4a((int)kv[j].z, qw[2], isum);
                isum = __dp4a((int)kv[j].w, qw[3], isum);
              }
            }
            logit = ((float)isum * qs_s[g]) * kscale;
          } else {
            // f32, or bf16 q: each product with an int8 code is exact
            float fsum = 0.f;
#pragma unroll
            for (int j = 0; j < kMaxD / 16; ++j) {
              if (j < D / 16) {
                const unsigned w4[4] = {kv[j].x, kv[j].y, kv[j].z, kv[j].w};
#pragma unroll
                for (int c = 0; c < 16; ++c)
                  fsum += qf[g * D + 16 * j + c] *
                          (float)(int8_t)((w4[c / 4] >> (8 * (c % 4))) & 0xFFu);
              }
            }
            logit = fsum * kscale;
          }
          lg[g * kSub + i] = logit;
        }
      }
      __syncthreads();

      // 2. online-softmax pieces, one warp per query head g
#pragma unroll
      for (int j = 0; j < kGPW; ++j) {
        const int g = warp + j * kWarps;
        if (g >= G) continue;
        float* lgg = lg + g * kSub;
        if (do_max) {
          for (int i = lane; i < ns; i += 32) bmax[j] = fmaxf(bmax[j], lgg[i]);
          if (s0 + ns == nvalid) m_new[j] = fmaxf(m_s[g], warp_max(bmax[j]));
        }
        if (do_sum || do_pv) {
          for (int i = lane; i < ns; i += 32) {
            const float p = expf(lgg[i] - m_new[j]);
            const float pv = p * vst[s0 + i];
            if (do_sum) {
              ps[j] += p;
              pvm[j] = fmaxf(pvm[j], pv);
            }
            if (do_pv) lgg[i] = DOTS == kDotsBF16 ? bf16_round(pv) : pv;
          }
        }
        if (I8 && do_pv) {
          // every p * vs of the block has been seen by now
          const float sc = fmaxf(warp_max(pvm[j]), 1e-30f) * (1.0f / 127.0f);
          for (int i = lane; i < ns; i += 32)
            pq[g * kSub + i] = (int8_t)rintf(lgg[i] / sc);
          if (lane == 0) pvs_s[g] = sc;
        }
      }

      // 3. (p * vs) @ v: warp w sums the tokens i = w (mod kWarps), each
      //    lane four head_dim columns (one 4-byte load per token, 128 B per
      //    warp)
      if (do_pv) {
        __syncthreads();
        const int d0 = 4 * lane;
        if (d0 < D) {
#pragma unroll 4
          for (int i = warp; i < ns; i += kWarps) {
            const unsigned vw = __ldg(reinterpret_cast<const unsigned*>(
                vt + (size_t)(s0 + i) * D + d0));
#pragma unroll
            for (int g = 0; g < kMaxG; ++g) {
              if (g < G) {
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                  const int vv = (int)(int8_t)((vw >> (8 * c)) & 0xFFu);
                  if (I8)
                    is[g][c] += (int)pq[g * kSub + i] * vv;
                  else
                    fs[g][c] += lg[g * kSub + i] * (float)vv;
                }
              }
            }
          }
        }
      }
      if (more) __syncthreads();
    };
    // a block of one sub-tile (every block of at most 256 tokens) takes
    // the walk with its flags known, as one straight pass; the generic
    // loop alone cost 12% on 16-token pages (PERF.md)
    if (nsub == 1) {
      walk_sub(0, 0, false);
    } else {
      for (int it = 0; it < nwalk * nsub; ++it) {
        const int walk = it / nsub;
        walk_sub(walk, (it - walk * nsub) * kSub, it + 1 < nwalk * nsub);
      }
    }

    // 4. the block's softmax state, then acc = acc * alpha + contrib with
    //    the warps' partial sums added in a fixed order
#pragma unroll
    for (int j = 0; j < kGPW; ++j) {
      const int g = warp + j * kWarps;
      if (g >= G) continue;
      const float tot = warp_sum(ps[j]);
      if (lane == 0) {
        const float alpha = expf(m_s[g] - m_new[j]);
        m_s[g] = m_new[j];
        s_s[g] = s_s[g] * alpha + tot;
        alpha_s[g] = alpha;
      }
    }
    {
      const int d0 = 4 * lane;
      if (d0 < D) {
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

  float first = 0.f;  // this thread's output of head 0, column tid
  if (!STAGED) {
    // inline: every row attends at least token 0, so s > 0
    if (tid < D) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float o = acc[g] / s_s[g];
          out[((size_t)bh * G + g) * D + tid] = o;
          if (g == 0) first = o;
        }
      }
    }
    return first;
  }

  // 5. staged: the current token (f32 dots on the unrounded q), then
  //    normalize
  for (int g = warp; g < G; g += kWarps) {
    float part = 0.f;
    for (int d = lane; d < D; d += 32)
      part += ld_in<CG>(qb + g * D + d) *
              ld_in<CG>(kn + (size_t)bh * D + d);
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
    const float vcur = ld_in<CG>(vn + (size_t)bh * D + tid);
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float o = (acc[g] * alpha_s[g] + pcur_s[g] * vcur) / s_s[g];
        out[((size_t)bh * G + g) * D + tid] = o;
        if (g == 0) first = o;
      }
    }
  }
  return first;
}

}  // namespace flash_decode
