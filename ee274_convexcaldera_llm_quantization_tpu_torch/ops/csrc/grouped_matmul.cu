// Grouped-scale packed matmul in bf16 with f32 sums, on Hopper's TMA and
// wgmma (hopper_gemm.cuh).
//
// Replaces the TPU kernel ee274_convexcaldera_llm_quantization_tpu/ops/
// kernels.py::quantized_matmul (_qmm_kernel):
//   y[m, n] = sum_k bf16(x[m, k]) * bf16((u[n, k] - maxq) * s[n, k / G])
// with x in bf16, u the offset-binary 2/4/8-bit codes in F = 8 / BITS
// row-global planes (byte j of a weight row holds k = j + p P, P = K / F, at
// shift BITS (F - 1 - p)) and s the per-(row, group) f32 scales.
//
// Dequantization, the reference's bits: the code under the exponent of
// 2^23 is the f32 2^23 + u; subtracting 2^23 + maxq leaves the exact f32
// u - maxq; one f32 multiply by the scale (never fused into anything) and a
// round to nearest-even bf16 give the weight. Each bf16 x bf16 product is
// exact in f32, so the result differs from the plain version only in the
// order of its f32 sums.
//
// Bound on an H100: the packed bytes at decode M (8.4 MB for 4096 x 4096 at
// 4 bits, 2.5 us at 3.35 TB/s), the bf16 operations (2 M N K at 989
// TFLOP/s) at prefill M. Every code also costs about four integer and float
// operations before the tensor cores can take it (~2 us of the SMs' issue
// slots at 4096 x 4096), so the dequantization overlaps the loads.
//
// A step is 64 packed bytes of a weight row: 64 k of each plane. TMA brings
// the raw bytes (64-byte swizzle, so the reads below are conflict-free) and
// the activations through a 3-d map of x as (M, F, P), one box a plane: the
// box of plane p at column j covers x[m, p P + j ..] and TMA zero-fills it
// past P. A zero-filled byte is the code -maxq, not 0, so the ragged end of
// a plane, of K or of N is right because x is zero there, never because of
// the codes.
//
// Swap-AB: y^T = W_tile x^T. Each consumer warpgroup owns 64 weight rows,
// wgmma's 64-row A slot, and the CTA's NT activation rows are wgmma's n
// columns. A producer thread keeps a ring of stages (the raw bytes of the
// CTA's weight rows, then F x tiles) in flight. The consumers dequantize a
// stage straight into wgmma's A registers, never through shared memory:
// lane 4 g + t reads bytes 2t, 2t + 1, 2t + 8, 2t + 9 of each 16-byte run of
// its two rows, and each of those bytes feeds the same fragment slot of F k
// slices, one a plane. All 4 F fragments of the stage are written before
// its first product and the products are waited for before the next
// stage's are written: ptxas serializes every wgmma whose register inputs
// are written while another is in flight, so dequantizing one run while the
// run before multiplies ran no faster. The host picks the shape by M
// (ops/kernels.py::_grouped_plan):
//
// 0. M <= 16: one warpgroup (64 weight rows) and n = 8 or 16, so nothing is
//    padded to 16 rows at M 8; four accumulators, one a 16-byte run, keep
//    each chain of these short products short; several CTAs an SM, so one
//    CTA's loads and products overlap another's dequantization.
// 1. M > 16: two warpgroups (128 weight rows) and n = 64 or 128 activation
//    rows, one CTA an SM. Each weight tile is dequantized once per n rows.
//
// Measured alternatives (4096 x 4096 at 4 bits on an H100, M 512): a
// dequantizer warpgroup writing bf16 W tiles to shared memory for two
// consumer warpgroups, 0.046 ms; consumers writing their own A tiles to
// shared memory, double-buffered so a plane's dequantization overlaps the
// products of the one before, 0.047 ms (and slower at M 8); this design
// 0.039 ms.
//
// K is split while the tiles alone leave SMs idle: each split writes its f32
// partial tile to a workspace, and the last CTA of a tile to arrive on its
// counter (counters[tile], which the caller keeps zeroed per stream, and
// which that CTA sets back to 0) sums the partials in split order, so
// repeated launches and graph replays give the same bits.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_gemm.cuh"

namespace {

using namespace hopper;

constexpr int kBK = 64;  // packed bytes of a weight row per step

// The codes of one bit width: F planes, offset maxq.
template <int BITS>
struct Codes {
  static constexpr int F = 8 / BITS;
  static constexpr int MAXQ = (1 << (BITS - 1)) - 1;
  // the codes of plane p in the four bytes of w, one a byte
  __device__ __forceinline__ static uint32_t plane(uint32_t w, int p) {
    if constexpr (BITS == 8) {
      return w;
    } else {
      constexpr uint32_t kMask = ((1u << BITS) - 1u) * 0x01010101u;
      return (w >> (BITS * (F - 1 - p))) & kMask;
    }
  }
};

// bf16((c_B - maxq) s) and bf16((c_{B+1} - maxq) s) of bytes B, B + 1 of c,
// in one register (byte B in the low half).
template <int MAXQ, int B>
__device__ __forceinline__ uint32_t dequant2(uint32_t c, float s) {
  constexpr float kOff = 8388608.f + MAXQ;
  const float lo = __fmul_rn(
      __fsub_rn(__uint_as_float(__byte_perm(c, 0x4B000000u, 0x7540 + B)),
                kOff), s);
  const float hi = __fmul_rn(
      __fsub_rn(__uint_as_float(__byte_perm(c, 0x4B000000u, 0x7541 + B)),
                kOff), s);
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// The kernel: WGS consumer warpgroups of 64 weight rows each, NT activation
// rows, one producer warp
// ---------------------------------------------------------------------------

constexpr int kMaxStages = 6;
constexpr int kSmemBudget = 232448 - 2048;  // of a block, less alignment

template <int BITS, int NT, int WGS>
struct Shape {
  static constexpr int F = 8 / BITS;
  static constexpr int kRows = 64 * WGS;      // weight rows a CTA
  static constexpr int kRaw = kRows * kBK;    // raw bytes a stage
  static constexpr int kXT = NT * 128;        // bytes of one plane's x tile
  static constexpr int kStage = kRaw + F * kXT;
  static constexpr int kStages =
      kSmemBudget / kStage < kMaxStages ? kSmemBudget / kStage : kMaxStages;
  static constexpr int kSmem = kStages * kStage + 1024;
  static constexpr int kThreads = 128 * WGS + 32;
  // path 0's products are short: four accumulators (one a 16-byte run)
  // keep the chain on each short
  static constexpr int kAcc = NT <= 16 ? 4 : 1;
  static_assert(kRaw % 1024 == 0 && kXT % 1024 == 0, "1 KB aligned tiles");
  static_assert(kStages >= 2, "a ring of two stages at least");
};

struct Bars {
  uint64_t full[kMaxStages];   // TMA bytes landed
  uint64_t empty[kMaxStages];  // stage read by every consumer warp
};

// grid (ceil(N / (64 WGS)), ceil(M / NT), splits): CTA (x, y, z) takes
// weight rows 64 WGS x .., activation rows NT y .. and steps z split_steps ..
// of 64 packed bytes. ws: splits x tiles x 64 WGS x NT f32 partials,
// counters: one int a tile (both unused when splits == 1).
template <int BITS, int NT, int WGS>
__global__ void __launch_bounds__(Shape<BITS, NT, WGS>::kThreads)
grouped_kernel(const __grid_constant__ CUtensorMap tw,
               const __grid_constant__ CUtensorMap tx,
               const float* __restrict__ scales, float* __restrict__ out,
               float* __restrict__ ws, int* __restrict__ counters, int M,
               int N, int P, int G, int split_steps) {
  using C = Codes<BITS>;
  using S = Shape<BITS, NT, WGS>;
  constexpr int F = C::F;
  constexpr int kR = NT / 2;  // accumulators a thread
  constexpr int kAcc = S::kAcc;
  __shared__ Bars bars;
  __shared__ int last;
  uint8_t* smem = smem_1k();
  uint8_t* ring = smem;
  const int n0 = blockIdx.x * S::kRows, m0 = blockIdx.y * NT;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int tiles = gridDim.x * gridDim.y;
  const int split = blockIdx.z, splits = gridDim.z;
  const int k_steps = (P + kBK - 1) / kBK;
  const int s0 = split * split_steps;
  const int steps = min(split_steps, k_steps - s0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&bars.full[s], 1);
      mbar_init(&bars.empty[s], 4 * WGS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * WGS) {  // producer
    if (lane == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % S::kStages;
        mbar_wait(&bars.empty[s], ((i / S::kStages) & 1) ^ 1);
        uint8_t* st = ring + s * S::kStage;
        mbar_expect_tx(&bars.full[s], S::kStage);
        const int j = (s0 + i) * kBK;
        tma_load_2d(st, &tw, &bars.full[s], j, n0);
#pragma unroll
        for (int p = 0; p < F; ++p)
          tma_load_3d(st + S::kRaw + p * S::kXT, &tx, &bars.full[s], j, p,
                      m0);
      }
    }
    return;
  }

  // lane 4 g + t of warp w: rows rl and rl + 8 of the CTA's weight rows,
  // wgmma's A fragment rows of its warp
  const int g = lane >> 2, t = lane & 3;
  const int rl = 16 * warp + g;
  const int PG = P / G, SG = F * PG;  // scale groups a plane, a row
  const float* srow0 = scales + (size_t)min(n0 + rl, N - 1) * SG;
  const float* srow1 = scales + (size_t)min(n0 + rl + 8, N - 1) * SG;
  // the scales of step i: [row][plane][16-byte run]; a run past the end of
  // a plane takes the step's first (x is zero there, and any finite scale
  // serves)
  const bool g64 = G % 64 == 0;  // a step of a plane shares one scale
  const auto load_scales = [&](int i, float (&v)[2][F][4]) {
    const int j0 = (s0 + i) * kBK;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (g64 && kk > 0) {
#pragma unroll
        for (int p = 0; p < F; ++p) {
          v[0][p][kk] = v[0][p][0];
          v[1][p][kk] = v[1][p][0];
        }
        continue;
      }
      const int gj = (j0 + 16 * kk < P ? j0 + 16 * kk : j0) / G;
#pragma unroll
      for (int p = 0; p < F; ++p) {
        v[0][p][kk] = __ldg(srow0 + p * PG + gj);
        v[1][p][kk] = __ldg(srow1 + p * PG + gj);
      }
    }
  };

  float d[kAcc][kR];
#pragma unroll
  for (int a = 0; a < kAcc; ++a)
#pragma unroll
    for (int e = 0; e < kR; ++e) d[a][e] = 0.f;
  float sc[2][F][4], scn[2][F][4];
  load_scales(0, sc);
  for (int i = 0; i < steps; ++i) {
    const int s = i % S::kStages;
    if (i + 1 < steps) load_scales(i + 1, scn);
    mbar_wait(&bars.full[s], (i / S::kStages) & 1);
    const uint8_t* st = ring + s * S::kStage;
    // the A fragments of the step's 4 x F k slices: [run][plane]
    uint32_t a[4][F][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c = 16 * kk + 2 * t;
      // bytes c, c + 1, c + 8, c + 9 of rows rl and rl + 8; each feeds the
      // same fragment slot of the F planes' slices
      const uint32_t w0 = __byte_perm(
          *reinterpret_cast<const uint16_t*>(st + sw64_u8(rl, c)),
          *reinterpret_cast<const uint16_t*>(st + sw64_u8(rl, c + 8)),
          0x5410);
      const uint32_t w1 = __byte_perm(
          *reinterpret_cast<const uint16_t*>(st + sw64_u8(rl + 8, c)),
          *reinterpret_cast<const uint16_t*>(st + sw64_u8(rl + 8, c + 8)),
          0x5410);
#pragma unroll
      for (int p = 0; p < F; ++p) {
        const uint32_t c0 = C::plane(w0, p), c1 = C::plane(w1, p);
        a[kk][p][0] = dequant2<C::MAXQ, 0>(c0, sc[0][p][kk]);
        a[kk][p][1] = dequant2<C::MAXQ, 0>(c1, sc[1][p][kk]);
        a[kk][p][2] = dequant2<C::MAXQ, 2>(c0, sc[0][p][kk]);
        a[kk][p][3] = dequant2<C::MAXQ, 2>(c1, sc[1][p][kk]);
      }
    }
    // every A register is written before the first product and read until
    // the last is done, so no product waits on a dequantization
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < F; ++p)
        wgmma_m64k16_rs<NT>(d[kAcc > 1 ? kk : 0], a[kk][p],
                            desc_sw128(st + S::kRaw + p * S::kXT + 32 * kk));
    wgmma_commit();
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars.empty[s]);
    if (i + 1 < steps) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int p = 0; p < F; ++p)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) sc[h][p][kk] = scn[h][p][kk];
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int a = 0; a < kAcc; ++a) fence_regs(d[a]);
#pragma unroll
  for (int a = 1; a < kAcc; ++a)
#pragma unroll
    for (int e = 0; e < kR; ++e) d[0][e] += d[a][e];
  float(&acc)[kR] = d[0];

  // accumulator e = 4 c + 2 i + j: weight row rl + 8 i, activation row
  // 8 c + 2 t + j of the CTA's (wgmma's D fragment, here transposed)
  const auto store = [&](const float (&v)[kR]) {
#pragma unroll
    for (int c = 0; c < NT / 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + rl + 8 * i, m = m0 + 8 * c + 2 * t + j;
          if (n < N && m < M) out[(size_t)m * N + n] = v[4 * c + 2 * i + j];
        }
  };
  if (splits == 1) {
    store(acc);
    return;
  }

  if (splitk_sum<S::kRows, NT>(acc, ws, counters, tile, tiles, split, splits,
                               rl, t, 128 * WGS, &last))
    store(acc);
}

struct Args {
  const float* s;
  float* y;
  float* ws;
  int* counters;
  int M, N, P, G, split_steps, splits;
};

template <int BITS, int NT, int WGS>
cudaError_t launch_kernel(const void* x, const void* packed, const Args& a,
                          cudaStream_t st) {
  using S = Shape<BITS, NT, WGS>;
  CUtensorMap tw, tx;
  if (!map_u8_rows(&tw, packed, a.N, a.P, a.P, S::kRows) ||
      !map_bf16_planes(&tx, x, a.M, S::F, a.P, NT))
    return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem<grouped_kernel<BITS, NT, WGS>>(S::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + S::kRows - 1) / S::kRows, (a.M + NT - 1) / NT,
                  a.splits);
  grouped_kernel<BITS, NT, WGS><<<grid, S::kThreads, S::kSmem, st>>>(
      tw, tx, a.s, a.y, a.ws, a.counters, a.M, a.N, a.P, a.G, a.split_steps);
  return cudaGetLastError();
}

template <int BITS>
int launch(const void* x, const void* packed, Args a, int K, int path,
           int cols, cudaStream_t st) {
  constexpr int F = 8 / BITS;
  a.P = K / F;
  if (K % F != 0 || a.P % 32 != 0 || a.G % 16 != 0 || a.P % a.G != 0)
    return (int)cudaErrorInvalidValue;
  const int k_steps = (a.P + kBK - 1) / kBK;
  if (a.split_steps < 1 || a.splits < 1 ||
      (a.splits - 1) * a.split_steps >= k_steps ||
      a.splits * a.split_steps < k_steps ||
      (a.splits > 1 && (a.ws == nullptr || a.counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (path == 0 && cols == 8 && a.M <= 8)
    return (int)launch_kernel<BITS, 8, 1>(x, packed, a, st);
  if (path == 0 && cols == 16 && a.M <= 16)
    return (int)launch_kernel<BITS, 16, 1>(x, packed, a, st);
  if (path == 1 && cols == 64)
    return (int)launch_kernel<BITS, 64, 2>(x, packed, a, st);
  if (path == 1 && cols == 128)
    return (int)launch_kernel<BITS, 128, 2>(x, packed, a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (M, K) bf16, packed (N, K / F) uint8, scales (N, K / G) f32, out (M, N)
// f32: y = x @ W.T with W dequantized per (row, group). K / F % 32 == 0,
// G % 16 == 0 and (K / F) % G == 0; x and packed 16-byte aligned. K is
// walked in `splits` splits of split_steps steps of 64 packed bytes, the
// last possibly shorter and none empty. path 0 (split-K swap-AB, M <= cols,
// cols 8 or 16): 64 weight rows a CTA; path 1 (cols 64 or 128): 128 weight
// rows and `cols` activation rows a CTA. grid (ceil(N / rows), ceil(M /
// cols), splits); when splits > 1, ws holds splits x tiles x rows x cols
// f32 and counters one zeroed int a tile, left zeroed (launches that may
// run at once need their own).
extern "C" int grouped_matmul_launch(const void* x, const void* packed,
                                     const void* scales, void* out, void* ws,
                                     void* counters, int M, int N, int K,
                                     int bits, int group, int path, int cols,
                                     int split_steps, int splits,
                                     void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || group <= 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(packed) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(scales), static_cast<float*>(out),
               static_cast<float*>(ws), static_cast<int*>(counters), M, N,
               0, group, split_steps, splits};
  auto st = static_cast<cudaStream_t>(stream);
  if (bits == 2) return launch<2>(x, packed, a, K, path, cols, st);
  if (bits == 4) return launch<4>(x, packed, a, K, path, cols, st);
  if (bits == 8) return launch<8>(x, packed, a, K, path, cols, st);
  return (int)cudaErrorInvalidValue;
}

// The id of the stream capture under way on `stream` (0 when none) into
// *id: split-K counters made during a capture belong to that graph.
extern "C" int grouped_capture_id(void* stream, void* id) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long cid = 0;
  const cudaError_t err = cudaStreamGetCaptureInfo(
      static_cast<cudaStream_t>(stream), &status, &cid);
  if (err != cudaSuccess) return (int)err;
  *static_cast<unsigned long long*>(id) =
      status == cudaStreamCaptureStatusActive ? cid : 0;
  return 0;
}
