// Causal GQA flash self-attention for prefill, f32.
//
// Replaces the TPU kernel ee274_convexcaldera_llm_quantization_tpu/ops/
// attention.py::flash_prefill (_flash_prefill_kernel): q (B, S, H, D),
// k/v (B, S, KVH, D) f32, head h = kvh * G + g; out[b, i, h] is the softmax
// over the keys j <= i of (q . k_j) / sqrt(D), applied to v, in f32.
//
// Bound on an H100: the causal operations, 4 * H * D * S (S + 1) / 2 flops,
// over the 67 TFLOP/s of f32 outside the tensor cores (the bytes, q/k/v/out
// once each, are far below that at S >= 512). TF32 tensor cores would move
// results past the 2e-5 agreement with the reference, so the dots are f32
// FMAs. Design:
// - one CTA per (q-block, kv-head, b) holds the G grouped heads of that
//   q-block: 64 query rows = G heads x 64 / G positions, so the K/V tiles it
//   loads serve all G heads of the group;
// - a loop inside the CTA walks the 64-token k-blocks up to the causal
//   diagonal of its last row, which takes the place of the TPU's innermost
//   sequential grid axis; tokens above the diagonal and past S are masked
//   here (no padding of S is needed, unlike the TPU's lcm padding);
// - q, the K and V tiles and the tile's probabilities sit in shared memory
//   (113 KB at D = 128); each warp owns 8 query rows for both dots, so the
//   online-softmax state (running max, sum, rescale) stays in registers and
//   the row max and sum are warp shuffles; the f32 output accumulator is in
//   registers (8 rows x 4 head_dim columns per thread);
// - K rows are padded to D + 1 floats so that the 32 lanes, each on its own
//   key, read distinct banks; q and p are read as 16-byte broadcasts.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;          // query rows per CTA
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kBK = 64;            // keys per tile
constexpr int kMaxD = 128;
constexpr int kCols = kMaxD / 32;  // head_dim columns per lane
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

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kRows * D + (size_t)kRows * kBK +
                          (size_t)kBK * D + (size_t)kBK * (D + 1));
}

__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int S, int KVH, int G, int D, int BQ, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                      // [kRows][D]
  float* Ps = Qs + kRows * D;            // [kRows][kBK]
  float* Vs = Ps + kRows * kBK;          // [kBK][D]
  float* Ks = Vs + kBK * D;              // [kBK][D + 1]

  const int q0 = blockIdx.x * BQ;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int H = KVH * G;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int KD = D + 1;

  // row r = g * BQ + i is head kvh * G + g at position q0 + i
  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int g = r / BQ, tq = q0 + r % BQ;
    float val = 0.f;
    if (g < G && tq < S)
      val = q[(((size_t)b * S + tq) * H + kvh * G + g) * D + d];
    Qs[idx] = val;
  }

  int tqr[kRowsPerWarp];
  bool live[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    tqr[i] = q0 + r % BQ;
    live[i] = r / BQ < G && tqr[i] < S;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + BQ, S) - 1;
  const int nkb = q_last / kBK + 1;
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int j = idx / D, d = idx - j * D;
      const int tk = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (tk < S) {
        const size_t off = (((size_t)b * S + tk) * KVH + kvh) * D + d;
        kv = k[off];
        vv = v[off];
      }
      Ks[j * KD + d] = kv;
      Vs[idx] = vv;
    }
    __syncthreads();

    // logits of this warp's 8 rows against keys lane and lane + 32
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i][0] = s[i][1] = 0.f;
    const float* k0p = Ks + lane * KD;
    const float* k1p = Ks + (lane + 32) * KD;
    for (int d = 0; d < D; d += 4) {
      const float ka[4] = {k0p[d], k0p[d + 1], k0p[d + 2], k0p[d + 3]};
      const float kc[4] = {k1p[d], k1p[d + 1], k1p[d + 2], k1p[d + 3]};
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(
            Qs + (warp + kWarps * i) * D + d);
        s[i][0] = fmaf(qv.x, ka[0], s[i][0]);
        s[i][0] = fmaf(qv.y, ka[1], s[i][0]);
        s[i][0] = fmaf(qv.z, ka[2], s[i][0]);
        s[i][0] = fmaf(qv.w, ka[3], s[i][0]);
        s[i][1] = fmaf(qv.x, kc[0], s[i][1]);
        s[i][1] = fmaf(qv.y, kc[1], s[i][1]);
        s[i][1] = fmaf(qv.z, kc[2], s[i][1]);
        s[i][1] = fmaf(qv.w, kc[3], s[i][1]);
      }
    }

    // online softmax per row: the warp holds all 64 keys of its rows
    float alpha[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      const bool v0 = live[i] && k0 + lane <= tqr[i];
      const bool v1 = live[i] && k0 + lane + 32 <= tqr[i];
      const float x0 = v0 ? s[i][0] * scale : kNegInf;
      const float x1 = v1 ? s[i][1] * scale : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(fmaxf(x0, x1)));
      alpha[i] = expf(m[i] - m_new);
      const float p0 = v0 ? expf(x0 - m_new) : 0.f;
      const float p1 = v1 ? expf(x1 - m_new) : 0.f;
      l[i] = l[i] * alpha[i] + warp_sum(p0 + p1);
      m[i] = m_new;
      Ps[r * kBK + lane] = p0;
      Ps[r * kBK + lane + 32] = p1;
    }
    __syncwarp();

    // acc = acc * alpha + p @ v over this tile's keys
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha[i];
    const int nk = min(kBK, q_last + 1 - k0);
    for (int j = 0; j < nk; j += 4) {
      float vv[4][kCols];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = lane + 32 * c;
          vv[jj][c] = d < D ? Vs[(j + jj) * D + d] : 0.f;
        }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 p = *reinterpret_cast<const float4*>(
            Ps + (warp + kWarps * i) * kBK + j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc[i][c] = fmaf(p.x, vv[0][c], acc[i][c]);
          acc[i][c] = fmaf(p.y, vv[1][c], acc[i][c]);
          acc[i][c] = fmaf(p.z, vv[2][c], acc[i][c]);
          acc[i][c] = fmaf(p.w, vv[3][c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (!live[i]) continue;
    const int r = warp + kWarps * i;
    const int g = r / BQ;
    float* o = out + (((size_t)b * S + tqr[i]) * H + kvh * G + g) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) o[d] = acc[i][c] / l[i];
    }
  }
}

}  // namespace

// q (B, S, H, D), k/v (B, S, KVH, D), out (B, S, H, D): f32, contiguous.
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, void* out, int B, int S,
                                    int H, int KVH, int D, float scale,
                                    void* stream) {
  if (B < 1 || S < 1 || KVH < 1 || H % KVH != 0 || H / KVH > kRows ||
      D < 4 || D > kMaxD || D % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int G = H / KVH;
  const int BQ = kRows / G;
  const size_t smem = smem_bytes(D);
  // once per process, for the largest D: never inside a CUDA graph capture
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(kMaxD));
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, KVH, B);
  flash_prefill_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, KVH, G, D,
      BQ, scale);
  return (int)cudaGetLastError();
}
