// W8A8 matmul: int8 weights times per-row int8 activations, i32 sums, then
// the rank-1 rescale y[m, n] = (acc[m, n] * s[n]) * sx[m].
//
// Replaces the TPU kernel ee274_convexcaldera_llm_quantization_tpu/ops/
// kernels.py::int8_matmul (_qmm_int8_kernel), which the port runs as the int8
// lm_head: of every decode step (M = the batch), and of the unfused forward
// that the perplexity harness runs (M = batch x window).
//
// One design at every M, its tile picked on the host (ops/kernels.py::
// _int8_plan): TMA and int8 wgmma (int8_tile_launch, below), every weight
// byte read once per weight tile and multiplied on the tensor cores. It
// computes the exact i32 sum and ((float)acc * s[n]) * sx[m], one rounding
// at a time, so its output equals the plain version's bit for bit.
//
// No unpacker: the signed weights (N, K) and the activations xq (M, K) are
// both K-major int8, so TMA stores each 128-byte row of k (four k32 slices)
// with the 128-byte swizzle straight into the tiles that wgmma m64nNk32
// s32.s8.s8 reads. One producer warp keeps a ring of stages in flight (an A
// box of 128 rows and a B box of NB rows, 128 k each); two consumer
// warpgroups each multiply their 64 A rows against the B box, one wgmma
// group in flight, and release a stage once its products are done. The CTAs
// are persistent, one an SM, walking tiles b, b + gridDim.x, ... with the A
// tiles fastest, so the producer fills the next tile's stages while the
// consumers run the epilogue.
//
// - Swapped (SWAP, M <= 64 by default, decode): bound by the weight bytes.
//   The weight rows are the A operand (128 a tile) and the activation rows
//   the B operand (NB = 64 columns of wgmma, TMA's zero fill past M), so one
//   B box of x serves 128 weight rows; the ring holds 9 stages (144 KB of
//   weights in flight an SM). The walk is over the weight tiles (then the M
//   tiles, where M > 64). Each thread stores its outputs directly: a store
//   instruction writes, for four activation rows, 8 consecutive floats each
//   (32-byte sectors, whole).
// - Not swapped (M > 64): bound by the int8 operations. A is 128 activation
//   rows, B NB = 128 or 256 weight rows; M tiles fastest, so the CTAs at work
//   at once share each weight tile, read from device memory about once and
//   from L2 for its other M tiles. The output (as large as the weights at M
//   1024) leaves through TMA stores: each warpgroup writes its 64 x 128 block
//   of results into four 64 x 32 f32 boxes of shared memory (128-byte
//   swizzle: two wavefronts per 256 bytes), then one thread stores them
//   asynchronously and the warpgroup goes on with the next tile. TMA writes
//   only the part of a box inside the output, so ragged M and N need no
//   branch; the output's row stride must be a multiple of 16 bytes (N % 4 ==
//   0, checked on the host).
//
// Ragged k, M and N rows are TMA's zero fill, which adds nothing to a sum,
// and their outputs are not stored. acc is exact while K <= 2^31 / 127^2
// (the codes are within +-127: quantize_int8_rowwise's and
// quantize_activations_int8's clip). Each tile's scales are loaded into
// registers before its mainloop and put in shared memory after it (double
// buffered by tile), so the epilogue waits on no global load.
#include "hopper_gemm.cuh"

namespace {
namespace i8tile {

using namespace hopper;

constexpr int kBK = 128;  // k a stage: one 128-byte swizzled row
constexpr int kBA = 128;  // A rows a tile: two consumer warpgroups of 64
constexpr int kMaxK = 2147483647 / (127 * 127);
constexpr int kSmemLimit = 232448;  // an H100 block's shared memory
constexpr int kBox = 64 * 32 * 4;   // an output box: 64 rows x 32 f32

template <bool SWAP, int NB>
struct Shape {
  static constexpr int kA = kBA * kBK;  // bytes of an A box
  static constexpr int kB = NB * kBK;   // bytes of a B box
  static constexpr int kStage = kA + kB;
  // the output's staging (not swapped): four boxes a warpgroup, 128 columns
  static constexpr int kOut = SWAP ? 0 : 2 * 4 * kBox;
  // every stage that fits beside the staging, the 1 KB alignment and the
  // static shared memory (barriers, scales: at most 5 KB)
  static constexpr int kStages = (kSmemLimit - 6 * 1024 - kOut) / kStage;
  static constexpr int kSmem = kStages * kStage + kOut + 1024;
  static constexpr int kThreads = 2 * 128 + 32;
  static_assert(kStage % 1024 == 0, "1 KB aligned tiles");
  static_assert(kStages >= 3, "a ring of at least three stages");
};

// Tile t is A tile t % a_tiles and B tile t / a_tiles. Not swapped, A is xq
// (M rows) and B the weights (N rows); swapped, the other way round. `to`:
// the output's map for TMA stores (not swapped only).
template <bool SWAP, int NB>
__global__ void __launch_bounds__(Shape<SWAP, NB>::kThreads, 1)
tile_kernel(const __grid_constant__ CUtensorMap ta,
            const __grid_constant__ CUtensorMap tb,
            const __grid_constant__ CUtensorMap to,
            const float* __restrict__ sx, const float* __restrict__ s,
            float* __restrict__ out, int M, int N, int K, int a_tiles,
            int b_tiles) {
  using S = Shape<SWAP, NB>;
  constexpr int SS = S::kStages;
  constexpr int kS = SWAP ? 64 : NB;  // weight scales of a warpgroup's block
  constexpr int kX = SWAP ? NB : 64;  // activation scales of it
  constexpr int kSU = (kS + 127) / 128;
  __shared__ uint64_t full[SS], empty[SS];
  __shared__ float s_buf[2][2][kS], x_buf[2][2][kX];  // [warpgroup][tile & 1]
  uint8_t* ring = smem_1k();
  uint8_t* staging = ring + SS * S::kStage;
  const int tiles = a_tiles * b_tiles;
  const int steps = (K + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < SS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // producer
    if (lane == 0) {
      int q = 0;  // stages loaded so far
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int a0 = tile % a_tiles * kBA, b0 = tile / a_tiles * NB;
        for (int k = 0; k < steps; ++k, ++q) {
          const int r = q % SS;
          mbar_wait(&empty[r], ((q / SS) & 1) ^ 1);
          mbar_expect_tx(&full[r], S::kStage);
          uint8_t* st = ring + r * S::kStage;
          tma_load_2d(st, &ta, &full[r], k * kBK, a0);
          tma_load_2d(st + S::kA, &tb, &full[r], k * kBK, b0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg multiplies A rows a0 + 64 wg ..
  const int wg = warp / 4, wt = threadIdx.x % 128;
  const int g = lane >> 2, t = lane & 3;
  const int rl = 16 * (warp % 4) + g;  // D rows rl and rl + 8
  int q = 0, local = 0;  // stages, tiles so far
  int d[NB / 2];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++local) {
    const int a0 = tile % a_tiles * kBA, b0 = tile / a_tiles * NB;
    const int p = local & 1;
    // this block's scales, loaded now and used after the mainloop
    const int n0 = SWAP ? a0 + 64 * wg : b0, m0 = SWAP ? b0 : a0 + 64 * wg;
    float s_reg[kSU], x_reg = 0.f;
#pragma unroll
    for (int u = 0; u < kSU; ++u) {
      const int n = n0 + wt + 128 * u;
      s_reg[u] = wt + 128 * u < kS && n < N ? s[n] : 0.f;
    }
    if (wt < kX && m0 + wt < M) x_reg = sx[m0 + wt];

#pragma unroll
    for (int e = 0; e < NB / 2; ++e) d[e] = 0;
    const int q0 = q;
    for (int k = 0; k < steps; ++k, ++q) {
      const int r = q % SS;
      mbar_wait(&full[r], (q / SS) & 1);
      const uint8_t* st = ring + r * S::kStage;
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        wgmma_m64k32_s8s8<NB>(d, desc_sw128(st + wg * 64 * kBK + 32 * kk),
                              desc_sw128(st + S::kA + 32 * kk));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(d);
      __syncwarp();
      if (lane == 0 && q > q0) mbar_arrive(&empty[(q + SS - 1) % SS]);
    }
    wgmma_wait<0>();
    fence_regs(d);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(q + SS - 1) % SS]);

#pragma unroll
    for (int u = 0; u < kSU; ++u)
      if (wt + 128 * u < kS) s_buf[wg][p][wt + 128 * u] = s_reg[u];
    if (wt < kX) x_buf[wg][p][wt] = x_reg;
    // (not swapped) the last tile's stores have read the staging
    if (!SWAP && wt == 0) bulk_wait_read<0>();
    bar_sync(1 + wg, 128);
    const float* sc = s_buf[wg][p];
    const float* xc = x_buf[wg][p];
    // accumulator e = 4 c + 2 i + j: A row rl + 8 i, B row 8 c + 2 t + j
    if constexpr (SWAP) {
#pragma unroll
      for (int c = 0; c < NB / 8; ++c)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int m = m0 + 8 * c + 2 * t + j, n = n0 + rl + 8 * i;
            if (m < M && n < N)
              out[(size_t)m * N + n] =
                  __fmul_rn(__fmul_rn((float)d[4 * c + 2 * i + j],
                                      sc[rl + 8 * i]),
                            xc[8 * c + 2 * t + j]);
          }
    } else {
      uint8_t* ob = staging + wg * 4 * kBox;
#pragma unroll
      for (int h = 0; h < NB / 128; ++h) {
        if (h > 0) {
          if (wt == 0) bulk_wait_read<0>();
          bar_sync(1 + wg, 128);
        }
#pragma unroll
        for (int c = 0; c < 16; ++c)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * (16 * h + c) + 2 * i, col = 128 * h + 8 * c + 2 * t;
            const int row = rl + 8 * i;
            const float v0 = __fmul_rn(__fmul_rn((float)d[e], sc[col]), xc[row]);
            const float v1 =
                __fmul_rn(__fmul_rn((float)d[e + 1], sc[col + 1]), xc[row]);
            float* box = reinterpret_cast<float*>(ob + (c / 4) * kBox);
            *reinterpret_cast<float2*>(box + sw128_f32(row, 8 * (c % 4) + 2 * t)) =
                make_float2(v0, v1);
          }
        fence_proxy_async();
        bar_sync(1 + wg, 128);
        if (wt == 0 && m0 < M) {
#pragma unroll
          for (int bx = 0; bx < 4; ++bx)
            if (n0 + 128 * h + 32 * bx < N)
              tma_store_2d(&to, ob + bx * kBox, n0 + 128 * h + 32 * bx, m0);
          bulk_commit();
        }
      }
    }
  }
  // the stores' writes are done before the CTA leaves
  if (!SWAP && wt == 0) bulk_wait<0>();
}

template <bool SWAP, int NB>
cudaError_t launch(const int8_t* x, const float* sx, const int8_t* w,
                   const float* s, float* y, int M, int N, int K, int ctas,
                   cudaStream_t st) {
  using S = Shape<SWAP, NB>;
  const void* a = SWAP ? static_cast<const void*>(w)
                       : static_cast<const void*>(x);
  const void* b = SWAP ? static_cast<const void*>(x)
                       : static_cast<const void*>(w);
  const int a_rows = SWAP ? N : M, b_rows = SWAP ? M : N;
  CUtensorMap ta, tb, to{};
  if (!map_u8_rows128(&ta, a, a_rows, K, K, kBA) ||
      !map_u8_rows128(&tb, b, b_rows, K, K, NB) ||
      (!SWAP && !map_f32_rows(&to, y, M, N, N, 64)))
    return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem<tile_kernel<SWAP, NB>>(S::kSmem);
  if (err != cudaSuccess) return err;
  tile_kernel<SWAP, NB><<<ctas, S::kThreads, S::kSmem, st>>>(
      ta, tb, to, sx, s, y, M, N, K, (a_rows + kBA - 1) / kBA,
      (b_rows + NB - 1) / NB);
  return cudaGetLastError();
}

}  // namespace i8tile
}  // namespace

// The tile path: `rows` activation rows and `cols` weight rows a tile,
// walked by `ctas` persistent CTAs. rows 64 with cols 128 is the swapped
// design; rows 128 with cols 128 or 256 the other, which needs N % 4 == 0
// (the TMA stores' 16-byte row stride). K % 16 == 0 and K <= 2^31 / 127^2;
// xq, w8 and out 16-byte aligned.
extern "C" int int8_tile_launch(const void* xq, const void* sx,
                                const void* w8, const void* scales, void* out,
                                int M, int N, int K, int rows, int cols,
                                int ctas, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || K > i8tile::kMaxK ||
      ctas <= 0 || reinterpret_cast<uintptr_t>(xq) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w8) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int8_t* x = static_cast<const int8_t*>(xq);
  const int8_t* w = static_cast<const int8_t*>(w8);
  const float* xs = static_cast<const float*>(sx);
  const float* s = static_cast<const float*>(scales);
  float* y = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 64 && cols == 128)
    return (int)i8tile::launch<true, 64>(x, xs, w, s, y, M, N, K, ctas, st);
  if (rows != 128 || N % 4 != 0) return (int)cudaErrorInvalidValue;
  if (cols == 128)
    return (int)i8tile::launch<false, 128>(x, xs, w, s, y, M, N, K, ctas, st);
  if (cols == 256)
    return (int)i8tile::launch<false, 256>(x, xs, w, s, y, M, N, K, ctas, st);
  return (int)cudaErrorInvalidValue;
}
