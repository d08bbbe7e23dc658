// Grouped-scale packed matmul in bf16 with f32 accumulation.
//
// Replaces the TPU kernel ee274_convexcaldera_llm_quantization_tpu/ops/
// kernels.py::quantized_matmul (_qmm_kernel):
//   y[m, n] = sum_k x[m, k] * bf16((u[n, k] - maxq) * s[n, k / G])
// with x in bf16, u the offset-binary 2/4/8-bit codes in row-global planes
// (byte j of a row holds k = j + p * K / F at shift BITS * (F - 1 - p)) and
// s the per-(row, group) f32 scales; each weight is the f32 product rounded
// once to bf16, as the reference's dequantization does.
//
// Bound on an H100: at decode (M <= 32) the packed weight bytes, as in the
// W4A8 kernel (about 8 MB for a 4096 x 4096 projection at 4 bits); at
// prefill M the bf16 operations (2 M N K at 989 TFLOP/s). The design:
// - one CTA owns a 64-column tile of y (64 weight rows) and BM activation
//   rows (16 when M <= 16, else 64), and walks the packed rows in steps of
//   32 bytes, which hold 32 consecutive k of every plane; each packed byte
//   is read from device memory once per M tile (once in all at decode);
// - each thread loads 16 bytes of one weight row per step and the group
//   scale of each plane (G % 16 == 0, so 16 bytes share one), dequantizes
//   them to bf16 in registers and stores them to shared memory; the next
//   step's bytes, scales and activations are loaded before this step's
//   products, so their latency overlaps the tensor-core work;
// - the products are bf16 mma.sync m16n8k16 with f32 accumulators: a
//   bf16 x bf16 product is exact in f32, so the result differs from an f32
//   FMA loop only in the order of its f32 sums (TF32 would round the
//   operands and is not used).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBN = 64;  // weight rows (output columns) per CTA
constexpr int kCB = 32;  // packed bytes of each weight row per step

// Four warps split the (BM, 64) tile: WM x WN warps, each MI x NI mma tiles.
template <int BM>
struct Warps;
template <>
struct Warps<16> {
  static constexpr int WM = 1, WN = 4, MI = 1, NI = 2;
};
template <>
struct Warps<64> {
  static constexpr int WM = 2, WN = 2, MI = 2, NI = 4;
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x (M, K) bf16, w (N, K / F) uint8, s (N, K / G) f32, out (M, N) f32.
// K % (32 * F) == 0, G % 16 == 0, (K / F) % G == 0.
template <int BITS, int BM>
__global__ void __launch_bounds__(kThreads)
grouped_kernel(const __nv_bfloat16* __restrict__ x,
               const uint8_t* __restrict__ w, const float* __restrict__ s,
               float* __restrict__ out, int M, int N, int K, int G) {
  constexpr int F = 8 / BITS;
  constexpr int MAXQ = (1 << (BITS - 1)) - 1;
  constexpr unsigned kMask = ((1u << BITS) - 1u) * 0x01010101u;
  constexpr int D = F * kCB;   // k values per step (F planes x 32)
  constexpr int LD = D + 8;    // shared row stride in bf16: no bank conflicts
  constexpr int XN = BM * F * 4;  // 16-byte activation loads per step
  constexpr int XV = (XN + kThreads - 1) / kThreads;  // per thread
  using WP = Warps<BM>;

  __shared__ __align__(16) __nv_bfloat16 xs[BM * LD];
  __shared__ __align__(16) __nv_bfloat16 ws[kBN * LD];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const int P = K / F;   // packed bytes per weight row
  const int SG = K / G;  // scales per weight row

  // This thread's weight bytes: row wr, bytes 16 * wh .. 16 * wh + 15 of
  // every 32-byte step.
  const int wr = tid >> 1, wh = tid & 1;
  const bool wok = n0 + wr < N;
  const uint8_t* wrow = w + (size_t)(wok ? n0 + wr : 0) * P + 16 * wh;
  const float* srow = s + (size_t)(wok ? n0 + wr : 0) * SG;

  auto load_w = [&](int j0, uint4& v, float (&sc)[F]) {
    v = wok ? __ldg(reinterpret_cast<const uint4*>(wrow + j0))
            : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int p = 0; p < F; ++p)
      sc[p] = wok ? __ldg(srow + (p * P + j0 + 16 * wh) / G) : 0.f;
  };
  // activation load i: row m, plane p, 8 bf16 at column 8 * c of the step
  auto load_x = [&](int j0, uint4 (&xv)[XV]) {
#pragma unroll
    for (int v = 0; v < XV; ++v) {
      const int i = tid + v * kThreads;
      const int m = i / (F * 4), p = (i / 4) % F, c = i % 4;
      xv[v] = i < XN && m0 + m < M
                  ? __ldg(reinterpret_cast<const uint4*>(
                        x + (size_t)(m0 + m) * K + p * P + j0 + 8 * c))
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  float acc[WP::MI][WP::NI][4];
#pragma unroll
  for (int mi = 0; mi < WP::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < WP::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int wm = warp / WP::WN, wn = warp % WP::WN;
  uint4 wv;
  float sc[F];
  uint4 xv[XV];
  load_w(0, wv, sc);
  load_x(0, xv);

  for (int j0 = 0; j0 < P; j0 += kCB) {
    // dequantize this step's weight bytes into shared memory, plane by
    // plane: four codes of a word at a time (shift, byte-parallel mask)
    const unsigned words[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int p = 0; p < F; ++p) {
      uint32_t h[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned c = BITS == 8 ? words[q]
                                     : (words[q] >> (BITS * (F - 1 - p))) & kMask;
        float f[4];
#pragma unroll
        for (int b = 0; b < 4; ++b)
          f[b] = (float)((int)((c >> (8 * b)) & 0xFFu) - MAXQ) * sc[p];
        h[2 * q] = pack_bf16(f[0], f[1]);
        h[2 * q + 1] = pack_bf16(f[2], f[3]);
      }
      uint4* dst = reinterpret_cast<uint4*>(ws + wr * LD + p * kCB + 16 * wh);
      dst[0] = make_uint4(h[0], h[1], h[2], h[3]);
      dst[1] = make_uint4(h[4], h[5], h[6], h[7]);
    }
#pragma unroll
    for (int v = 0; v < XV; ++v) {
      const int i = tid + v * kThreads;
      const int m = i / (F * 4), p = (i / 4) % F, c = i % 4;
      if (i < XN)
        *reinterpret_cast<uint4*>(xs + m * LD + p * kCB + 8 * c) = xv[v];
    }
    __syncthreads();
    if (j0 + kCB < P) {
      load_w(j0 + kCB, wv, sc);
      load_x(j0 + kCB, xv);
    }
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[WP::MI][4], b[WP::NI][2];
#pragma unroll
      for (int mi = 0; mi < WP::MI; ++mi) {
        const __nv_bfloat16* r0 =
            xs + ((wm * WP::MI + mi) * 16 + g8) * LD + kk + 2 * t4;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(r0);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(r0 + 8 * LD);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(r0 + 8 * LD + 8);
      }
#pragma unroll
      for (int ni = 0; ni < WP::NI; ++ni) {
        const __nv_bfloat16* c0 =
            ws + ((wn * WP::NI + ni) * 8 + g8) * LD + kk + 2 * t4;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(c0);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(c0 + 8);
      }
#pragma unroll
      for (int mi = 0; mi < WP::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < WP::NI; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < WP::MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < WP::NI; ++ni) {
      const int col = n0 + (wn * WP::NI + ni) * 8 + 2 * t4;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + (wm * WP::MI + mi) * 16 + g8 + (e >= 2 ? 8 : 0);
        const int n = col + (e & 1);
        if (m < M && n < N) out[(size_t)m * N + n] = acc[mi][ni][e];
      }
    }
  }
}

template <int BITS>
cudaError_t launch(const __nv_bfloat16* x, const uint8_t* w, const float* s,
                   float* out, int M, int N, int K, int G,
                   cudaStream_t stream) {
  constexpr int F = 8 / BITS;
  if (M <= 0 || N <= 0 || K <= 0 || K % (kCB * F) != 0 || G <= 0 ||
      G % 16 != 0 || (K / F) % G != 0)
    return cudaErrorInvalidValue;
  const int nblocks = (N + kBN - 1) / kBN;
  if (M <= 16) {
    grouped_kernel<BITS, 16><<<dim3(nblocks, 1), kThreads, 0, stream>>>(
        x, w, s, out, M, N, K, G);
  } else {
    grouped_kernel<BITS, 64><<<dim3(nblocks, (M + 63) / 64), kThreads, 0,
                               stream>>>(x, w, s, out, M, N, K, G);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int grouped_matmul_launch(const void* x, const void* packed,
                                     const void* scales, void* out, int M,
                                     int N, int K, int bits, int group,
                                     void* stream) {
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* w = static_cast<const uint8_t*>(packed);
  const auto* s = static_cast<const float*>(scales);
  auto* y = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bits == 2)
    err = launch<2>(xb, w, s, y, M, N, K, group, st);
  else if (bits == 4)
    err = launch<4>(xb, w, s, y, M, N, K, group, st);
  else if (bits == 8)
    err = launch<8>(xb, w, s, y, M, N, K, group, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
