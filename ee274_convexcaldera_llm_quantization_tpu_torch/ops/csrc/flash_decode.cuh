// The flash-decode attention of one (b, kv-head) stream, as a device
// function of a CTA of NT threads: csrc/flash_decode.cu's kernels run it
// with NT = 128 on one stream per CTA, csrc/attn_o.cu's cooperative kernel
// with NT = 256 on a loop of streams. See flash_decode.cu for what it
// computes and how.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace flash_decode {

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

// Attends stream bh = b * KVH + h and returns, in thread tid < D, the output
// of query head 0 at column tid (the value it wrote to out); every thread of
// the CTA must call it. Calls in a loop need a __syncthreads() between them.
// q (B, KVH, G, D) f32; k, v (B, KVH, T, D) int8 of the selected layer;
// ks, vs (B, KVH, T) f32; kn, vn (B, KVH, D) f32 (read only when STAGED);
// pos (B) int32; out (B, KVH, G, D) f32. With a page table pt (B,
// max_pages) int32, k, v are (NP, KVH, bt, D) and ks, vs (NP, KVH, bt)
// instead, and T = max_pages * bt.
template <int NT, int MAXG, bool I8, bool STAGED>
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
  __shared__ float qf[kMaxG * kMaxD];
  __shared__ __align__(16) int8_t qi[kMaxG * kMaxD];
  __shared__ float lg[kMaxG * kMaxBT];  // logits, then p * vs
  __shared__ int8_t pq[kMaxG * kMaxBT];  // I8: quantized p * vs
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
