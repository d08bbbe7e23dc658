// W4A8 matmul against one layer of a stacked packed weight tensor, and
// against a flat one.
//
// Replaces the TPU kernels ee274_convexcaldera_llm_quantization_tpu/ops/
// kernels.py::quantized_matmul_w4a8_stacked (_qmm_w4a8_stacked_kernel),
// quantized_matmul_w4a8_stacked_persistent (_qmm_w4a8_persistent_kernel:
// the same function, one program per M tile walking every output block
// with hand double-buffered weight DMAs; here w4a8_stacked_persistent_launch,
// rowdot.cuh's persistent launch) and quantized_matmul_w4a8
// (_qmm_w4a8_kernel), the same function without the layer axis:
//   y[m, n] = sx[m] * s[n] * (sum_k xq[m, k] * u[n, k] - maxq * sum_k xq[m, k])
// with u the offset-binary 2/4/8-bit codes of layer `layer`.
//
// Two designs, picked by M on the host (ops/kernels.py::_w4a8_plan):
//
// - rowdot (M at or below the threshold, decode): bound by the packed weight
//   bytes (N * K / F per call; about 101 MB per Llama-2-7B layer at 4 bits),
//   since a few activation rows make it a skinny GEMM at a few int8
//   operations per byte. See rowdot.cuh for how it reads each weight byte
//   once with __dp4a on the SMs' integer pipes.
// - tile (above it, prefill): bound by the int8 operations (2 M N K at 1979
//   TOP/s), so the products go to the tensor cores: wgmma m64n144k32 with the
//   int8 activations as A (s8) and the unpacked codes as B (u8), both K-major
//   in 128-byte swizzled shared memory (below).
//
// The layer is a pointer offset into the stacked tensor: no layer slice is
// ever copied. Both designs compute the exact i32 sum and the epilogue
// ((float)(acc - maxq * rowsum) * s[n]) * sx[m], so their outputs are equal
// bit for bit.
#include "hopper_gemm.cuh"
#include "rowdot.cuh"

namespace {

// The layer's weights and scales: pointer offsets into the stacked tensors.
struct Layer {
  const uint8_t* w;
  const float* ws;
};

Layer layer_of(const void* packed, const void* scales, int N, int K,
               int bits, int layer) {
  const int f = 8 / bits;
  return {static_cast<const uint8_t*>(packed) +
              (size_t)layer * (size_t)N * (size_t)(K / f),
          static_cast<const float*>(scales) + (size_t)layer * N};
}

}  // namespace

extern "C" int w4a8_stacked_launch(const void* xq, const void* sx,
                                   const void* packed, const void* scales,
                                   void* out, int M, int N, int K, int bits,
                                   int layer, void* stream) {
  if (bits != 2 && bits != 4 && bits != 8) return (int)cudaErrorInvalidValue;
  const Layer l = layer_of(packed, scales, N, K, bits, layer);
  const int8_t* x = static_cast<const int8_t*>(xq);
  const float* s = static_cast<const float*>(sx);
  float* y = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bits == 2)
    err = rowdot::launch<2, rowdot::kOffsetPacked>(x, s, l.w, l.ws, y, M, N,
                                                   K, st);
  else if (bits == 4)
    err = rowdot::launch<4, rowdot::kOffsetPacked>(x, s, l.w, l.ws, y, M, N,
                                                   K, st);
  else
    err = rowdot::launch<8, rowdot::kOffset8>(x, s, l.w, l.ws, y, M, N, K,
                                              st);
  return (int)err;
}

// The same function on the persistent grid (rowdot::launch_persistent):
// bit-equal output. The activations of min(M, 8) rows of K and two 32-row
// weight stages must fit in shared memory (M * K + 64 KB <= 226 KB for M
// <= 8).
extern "C" int w4a8_stacked_persistent_launch(
    const void* xq, const void* sx, const void* packed, const void* scales,
    void* out, int M, int N, int K, int bits, int layer, void* stream) {
  if (bits != 2 && bits != 4 && bits != 8) return (int)cudaErrorInvalidValue;
  const Layer l = layer_of(packed, scales, N, K, bits, layer);
  const int8_t* x = static_cast<const int8_t*>(xq);
  const float* s = static_cast<const float*>(sx);
  float* y = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bits == 2)
    err = rowdot::launch_persistent<2, rowdot::kOffsetPacked>(
        x, s, l.w, l.ws, y, M, N, K, st);
  else if (bits == 4)
    err = rowdot::launch_persistent<4, rowdot::kOffsetPacked>(
        x, s, l.w, l.ws, y, M, N, K, st);
  else
    err = rowdot::launch_persistent<8, rowdot::kOffset8>(x, s, l.w, l.ws, y,
                                                         M, N, K, st);
  return (int)err;
}

// The flat kernel: layer 0 of a one-layer stack.
extern "C" int w4a8_launch(const void* xq, const void* sx, const void* packed,
                           const void* scales, void* out, int M, int N, int K,
                           int bits, void* stream) {
  return w4a8_stacked_launch(xq, sx, packed, scales, out, M, N, K, bits, 0,
                             stream);
}

// ---------------------------------------------------------------------------
// The tile path: TMA, an unpacker warpgroup and int8 wgmma
// ---------------------------------------------------------------------------
//
// A CTA owns 64 WGS activation rows (WGS consumer warpgroups of 64) and 128
// weight rows. A step is 128 packed bytes of a weight row: with row-global
// planes (byte j of a row holds k = j + p P, P = K / F) one raw box of the
// CTA's 128 rows holds the codes of F k slices, [j0 + p P, j0 + p P + 128)
// for p = 0 .. F - 1, and each slice multiplies its own activation box, at
// column p P + j0 of x. A sub-step is one (step, plane): its x box (TMA, a
// 3-d map of x as (M, F, P), zero-filled past each plane's end, so a box that
// straddles the end of a plane never reads the next plane) and its B tile of
// 128 rows of u8 codes.
//
// - One producer warp keeps a ring of raw stages (128 rows x 128 bytes, TMA,
//   128-byte swizzle) in flight.
// - An unpacker warpgroup turns each raw stage into F B tiles in a ring of
//   sub-steps: one shift and one byte-parallel AND per four codes (8-bit
//   codes are copied as they are, u in 0..255). Both tiles are 128-byte rows
//   under the same swizzle, so a 16-byte chunk of the raw stage lands at the
//   same offset of each B tile: no address arithmetic. Its thread 0 also
//   issues the sub-step's x box once the sub-step is free. Each thread makes
//   its writes visible to the tensor cores (fence.proxy.async) before it
//   arrives on the sub-step, and releases the raw stage only after its planes
//   are written (a stage released while its values were still being read was
//   overwritten under the loads in the grouped kernel's first design).
// - WGS consumer warpgroups each run wgmma m64n144k32 s32.s8.u8 on their 64 x
//   rows against the 144 rows of the B tile, with one wgmma group in flight.
//   Rows 128..143 of every B tile are ones, written once at the start, so D's
//   column 128 is the exact row sum of xq over the whole K (TMA's zero fill
//   adds nothing): the bias maxq * rowsum comes from the tensor cores, at an
//   eighth more products, with no second pass over x.
//
// The ragged edges: raw rows past N and x rows past M are TMA's zero fill,
// and their outputs are not stored; a zero-filled code is 0 (the bias is
// removed from the true row sum), so the ragged end of a plane contributes
// nothing. The i32 sums cannot overflow while K <= 2^31 / (127 * 255).
//
// The CTAs are persistent: each walks its share of the tiles, so its
// producer and unpacker fill the next tile's stages while its consumers run
// the epilogue, whose scales the unpacker stages in shared memory (global
// loads behind the epilogue's ragged-edge branches each waited out their
// latency: a third of the time at M 2048). The tiles go with M fastest, so
// the CTAs at work at once share each weight tile, read from device memory
// about once, its other M tiles hitting L2.
namespace {
namespace tile {

using namespace hopper;

constexpr int kBK = 128;                  // packed bytes of a row a step
constexpr int kBN = 128;                  // weight rows a CTA
constexpr int kOnes = 16;                 // rows of ones below them
constexpr int kRaw = kBN * kBK;           // bytes of a raw stage
constexpr int kBT = (kBN + kOnes) * kBK;  // bytes of a B tile
constexpr int kMaxK = 2147483647 / (127 * 255);

template <int WGS>
struct Shape {
  static constexpr int kRows = 64 * WGS;   // activation rows a CTA
  static constexpr int kXT = kRows * kBK;  // bytes of a sub-step's x box
  static constexpr int kSub = kXT + kBT;   // a sub-step: x box, then B tile
  // one CTA an SM: 219 KB at 128 rows; at 64, 111 KB, but two such CTAs
  // would need more registers than an SM has (127 a thread)
  static constexpr int kRawStages = WGS == 2 ? 3 : 2;
  static constexpr int kSubStages = WGS == 2 ? 5 : 3;
  static constexpr int kSmem = kRawStages * kRaw + kSubStages * kSub + 1024;
  static constexpr int kThreads = 128 * WGS + 128 + 32;
  static_assert(kSub % 1024 == 0, "1 KB aligned tiles");
};

template <int R, int S>
struct Bars {
  uint64_t raw_full[R];   // TMA bytes of a raw stage landed
  uint64_t raw_empty[R];  // raw stage unpacked by every unpacker thread
  uint64_t sub_full[S];   // x box landed and B tile written
  uint64_t sub_empty[S];  // sub-step read by every consumer warp
  uint64_t ep_empty[2];   // a tile's scales read by every consumer warp
};

// The codes of plane p of 16 packed bytes, one a byte.
template <int BITS>
__device__ __forceinline__ uint4 plane16(uint4 w, int p) {
  if constexpr (BITS == 8) {
    return w;
  } else {
    constexpr int F = 8 / BITS;
    constexpr uint32_t kMask = ((1u << BITS) - 1u) * 0x01010101u;
    const int sh = BITS * (F - 1 - p);
    return make_uint4((w.x >> sh) & kMask, (w.y >> sh) & kMask,
                      (w.z >> sh) & kMask, (w.w >> sh) & kMask);
  }
}

// Persistent: CTA b walks the tiles b, b + gridDim.x, ... of m_tiles x
// ceil(N / 128) (M tiles fastest), so its producer and unpacker fill the
// next tile's stages while its consumers store the last one. s: the
// layer's N row scales.
template <int BITS, int WGS>
__global__ void __launch_bounds__(Shape<WGS>::kThreads, 1)
tile_kernel(const __grid_constant__ CUtensorMap tw,
            const __grid_constant__ CUtensorMap tx,
            const float* __restrict__ sx, const float* __restrict__ s,
            float* __restrict__ out, int M, int N, int P, int m_tiles) {
  using S = Shape<WGS>;
  constexpr int F = 8 / BITS;
  constexpr int MAXQ = (1 << (BITS - 1)) - 1;
  constexpr int R = S::kRawStages, SS = S::kSubStages;
  __shared__ Bars<R, SS> bars;
  // each tile's scales, double-buffered: the unpacker writes them before
  // its first sub-step of the tile (the sub-step's barrier publishes them)
  // and the consumers read them in the epilogue
  __shared__ float s_tile[2][kBN], sx_tile[2][S::kRows];
  uint8_t* raw = smem_1k();
  uint8_t* sub = raw + R * kRaw;
  const int tiles = m_tiles * ((N + kBN - 1) / kBN);
  const int steps = (P + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ut = threadIdx.x - 128 * WGS;  // unpacker thread: 0..127
  const bool unpacker = warp >= 4 * WGS && warp < 4 * WGS + 4;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      mbar_init(&bars.raw_full[i], 1);
      mbar_init(&bars.raw_empty[i], 128);
    }
#pragma unroll
    for (int i = 0; i < SS; ++i) {
      mbar_init(&bars.sub_full[i], 129);  // thread 0's expect_tx + 128
      mbar_init(&bars.sub_empty[i], 4 * WGS);
    }
    mbar_init(&bars.ep_empty[0], 4 * WGS);
    mbar_init(&bars.ep_empty[1], 4 * WGS);
    mbar_fence_init();
  }
  if (unpacker) {
    // the rows of ones: 16 x 128 bytes a B tile, one 16-byte chunk a thread
#pragma unroll
    for (int i = 0; i < SS; ++i)
      reinterpret_cast<uint4*>(sub + i * S::kSub + S::kXT + kRaw)[ut] =
          make_uint4(0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u);
    fence_proxy_async();
  }
  __syncthreads();

  if (warp == 4 * WGS + 4) {  // producer
    if (lane == 0) {
      int i = 0;  // raw stages loaded so far
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = tile / m_tiles * kBN;
        for (int k = 0; k < steps; ++k, ++i) {
          const int r = i % R;
          mbar_wait(&bars.raw_empty[r], ((i / R) & 1) ^ 1);
          mbar_expect_tx(&bars.raw_full[r], kRaw);
          tma_load_2d(raw + r * kRaw, &tw, &bars.raw_full[r], k * kBK, n0);
        }
      }
    }
    return;
  }

  if (unpacker) {
    int i = 0, q = 0, local = 0;  // raw stages, sub-steps, tiles so far
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++local) {
      const int m0 = tile % m_tiles * S::kRows, n0 = tile / m_tiles * kBN;
      const int e = local & 1;
      mbar_wait(&bars.ep_empty[e], ((local >> 1) & 1) ^ 1);
      s_tile[e][ut] = n0 + ut < N ? s[n0 + ut] : 0.f;
      if (ut < S::kRows) sx_tile[e][ut] = m0 + ut < M ? sx[m0 + ut] : 0.f;
      for (int k = 0; k < steps; ++k, ++i) {
        const int r = i % R;
        mbar_wait(&bars.raw_full[r], (i / R) & 1);
        const uint4* src = reinterpret_cast<const uint4*>(raw + r * kRaw);
        uint4 w[kRaw / 16 / 128];
#pragma unroll
        for (int v = 0; v < kRaw / 16 / 128; ++v) w[v] = src[ut + 128 * v];
#pragma unroll
        for (int p = 0; p < F; ++p, ++q) {
          const int b = q % SS;
          mbar_wait(&bars.sub_empty[b], ((q / SS) & 1) ^ 1);
          uint8_t* st = sub + b * S::kSub;
          if (ut == 0) {
            mbar_expect_tx(&bars.sub_full[b], S::kXT);
            tma_load_3d(st, &tx, &bars.sub_full[b], k * kBK, p, m0);
          }
          uint4* dst = reinterpret_cast<uint4*>(st + S::kXT);
#pragma unroll
          for (int v = 0; v < kRaw / 16 / 128; ++v)
            dst[ut + 128 * v] = plane16<BITS>(w[v], p);
          fence_proxy_async();
          mbar_arrive(&bars.sub_full[b]);
        }
        mbar_arrive(&bars.raw_empty[r]);
      }
    }
    return;
  }

  // consumers: warpgroup wg multiplies x rows m0 + 64 wg ..
  const int wg = warp / 4;
  const int g = lane >> 2, t = lane & 3;
  const int rl = 64 * wg + 16 * (warp % 4) + g;
  const bool pairs = N % 2 == 0;  // float2 stores stay 8-byte aligned
  int q = 0, local = 0;  // sub-steps, tiles so far
  int d[72];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++local) {
    const int m0 = tile % m_tiles * S::kRows, n0 = tile / m_tiles * kBN;
#pragma unroll
    for (int e = 0; e < 72; ++e) d[e] = 0;
    const int q0 = q;
    for (int k = 0; k < steps * F; ++k, ++q) {
      const int b = q % SS;
      mbar_wait(&bars.sub_full[b], (q / SS) & 1);
      const uint8_t* st = sub + b * S::kSub;
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        wgmma_m64n144k32_s8u8(d, desc_sw128(st + wg * 64 * kBK + 32 * kk),
                              desc_sw128(st + S::kXT + 32 * kk));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(d);
      __syncwarp();
      if (lane == 0 && q > q0)
        mbar_arrive(&bars.sub_empty[(q + SS - 1) % SS]);
    }
    wgmma_wait<0>();
    fence_regs(d);
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars.sub_empty[(q + SS - 1) % SS]);

    // accumulator e = 4 c + 2 i + j: x row rl + 8 i, weight row 8 c + 2 t +
    // j of the tile; column 128 (c = 16, t = 0, j = 0) is the row sum
    const int rs[2] = {__shfl_sync(0xffffffffu, d[64], lane & ~3),
                       __shfl_sync(0xffffffffu, d[66], lane & ~3)};
    const float* sc = s_tile[local & 1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + rl + 8 * i;
      const float xs = sx_tile[local & 1][rl + 8 * i];
      const int bias = MAXQ * rs[i];
      float* row = out + (size_t)m * N;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int n = n0 + 8 * c + 2 * t;
        const float a = __fmul_rn(
            __fmul_rn((float)(d[4 * c + 2 * i] - bias), sc[8 * c + 2 * t]),
            xs);
        const float e = __fmul_rn(
            __fmul_rn((float)(d[4 * c + 2 * i + 1] - bias),
                      sc[8 * c + 2 * t + 1]),
            xs);
        if (m >= M) continue;
        if (pairs && n + 1 < N) {
          *reinterpret_cast<float2*>(row + n) = make_float2(a, e);
        } else {
          if (n < N) row[n] = a;
          if (n + 1 < N) row[n + 1] = e;
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars.ep_empty[local & 1]);
  }
}

template <int BITS, int WGS>
cudaError_t launch(const int8_t* x, const float* sx, const uint8_t* w,
                   const float* s, float* y, int M, int N, int K, int ctas,
                   cudaStream_t st) {
  using S = Shape<WGS>;
  constexpr int F = 8 / BITS;
  const int P = K / F;
  CUtensorMap tw, tx;
  if (!map_u8_rows128(&tw, w, N, P, P, kBN) ||
      !map_i8_planes(&tx, x, M, F, P, S::kRows))
    return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem<tile_kernel<BITS, WGS>>(S::kSmem);
  if (err != cudaSuccess) return err;
  tile_kernel<BITS, WGS><<<ctas, S::kThreads, S::kSmem, st>>>(
      tw, tx, sx, s, y, M, N, P, (M + S::kRows - 1) / S::kRows);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_rows(const int8_t* x, const float* sx, const uint8_t* w,
                        const float* s, float* y, int M, int N, int K,
                        int rows, int ctas, cudaStream_t st) {
  if (rows == 64) return launch<BITS, 1>(x, sx, w, s, y, M, N, K, ctas, st);
  if (rows == 128) return launch<BITS, 2>(x, sx, w, s, y, M, N, K, ctas, st);
  return cudaErrorInvalidValue;
}

}  // namespace tile
}  // namespace

// The tile path on layer `layer`: `rows` (64 or 128) activation rows and 128
// weight rows a tile, ceil(M / rows) x ceil(N / 128) tiles walked by `ctas`
// persistent CTAs. K % (16 F) == 0 and K <= 2^31 / (127 * 255); xq and the
// layer's packed bytes 16-byte aligned (P % 16 == 0 keeps every layer so when
// the stack is). Its output equals w4a8_stacked_launch's bit for bit.
extern "C" int w4a8_tile_launch(const void* xq, const void* sx,
                                const void* packed, const void* scales,
                                void* out, int M, int N, int K, int bits,
                                int layer, int rows, int ctas, void* stream) {
  if (bits != 2 && bits != 4 && bits != 8) return (int)cudaErrorInvalidValue;
  const int f = 8 / bits;
  if (M <= 0 || N <= 0 || K <= 0 || K % (16 * f) != 0 || K > tile::kMaxK ||
      layer < 0 || ctas <= 0)
    return (int)cudaErrorInvalidValue;
  const Layer l = layer_of(packed, scales, N, K, bits, layer);
  if (reinterpret_cast<uintptr_t>(xq) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(l.w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int8_t* x = static_cast<const int8_t*>(xq);
  const float* s = static_cast<const float*>(sx);
  float* y = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bits == 2)
    err = tile::launch_rows<2>(x, s, l.w, l.ws, y, M, N, K, rows, ctas, st);
  else if (bits == 4)
    err = tile::launch_rows<4>(x, s, l.w, l.ws, y, M, N, K, rows, ctas, st);
  else
    err = tile::launch_rows<8>(x, s, l.w, l.ws, y, M, N, K, rows, ctas, st);
  return (int)err;
}
