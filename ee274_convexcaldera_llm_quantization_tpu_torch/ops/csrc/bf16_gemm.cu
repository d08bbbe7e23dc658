// y = x @ W[layer].T in f32, x (M, K) bf16, W (layers, N, K) bf16, on
// Hopper's TMA and wgmma (hopper_gemm.cuh).
//
// Replaces the TPU kernel ee274_convexcaldera_llm_quantization_tpu/ops/
// kernels.py::bf16_matmul_stacked (_bf16_stacked_kernel). Each bf16 x bf16
// product is exact in f32 and the sums are f32 (no TF32), so the result
// differs from an f32 loop over the same operands only in the order of its
// sums. The layer is a pointer offset: its slab is read in place, never
// copied.
//
// Bound on an H100: the layer's bf16 weight bytes at decode M (3.35 TB/s),
// the bf16 operations (2 M N K at 989 TFLOP/s) at prefill M. The host picks
// one of two paths by M, and how K is split (ops/kernels.py::
// _bf16_stacked_plan):
//
// 0. M <= 16, "split-K, swap-AB": y.T = W_tile @ x.T. Sixty-four weight rows
//    fill wgmma's 64-row slot and the M activation rows are its n = 8 or 16
//    columns, so nothing is padded to 16 rows at M 8. A (64 x 64) weight
//    tile per stage streams through a ring of kStages TMA stages fed by one
//    producer thread; several such CTAs fit an SM.
// 1. M > 16, "tiled": 128 x 128 output tiles, 64 k per stage, a ring of
//    kTiledStages stages (192 KB, one CTA an SM). One producer warp issues
//    the TMA loads of the x and W tiles; two consumer warpgroups each run
//    m64n128k16 on 64 of the tile's rows, keeping one wgmma group in
//    flight, and store their accumulators straight to y, masked at the
//    ragged M and N edges.
//
// Both paths split K when their tiles alone leave SMs idle: each split
// writes its f32 partial tile to a workspace, and the last CTA of a tile to
// finish (a per-tile counter, reset by that CTA) sums the partials in split
// order, so repeated launches give the same bits. TMA's zero fill covers
// ragged M, N and K, so K needs only K % 8 == 0 (16-byte row strides).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_gemm.cuh"

namespace {

using namespace hopper;

constexpr int kBK = 64;     // k values per stage: one 128-byte swizzled row
constexpr int kStages = 4;  // ring depth of the split-K path
constexpr int kMaxTiles = 4096;  // split-K tile counters (N <= 262144)

// Arrivals a tile's split-K counter has taken in the current launch; the
// last CTA of the tile sets it back to 0.
__device__ int g_tile_arrivals[kMaxTiles];

template <int S>
struct Ring {
  uint64_t full[S];   // TMA bytes landed (one producer arrival)
  uint64_t empty[S];  // slot read by every consumer warp
};

template <int S>
__device__ __forceinline__ void init_ring(Ring<S>& ring, uint32_t consumers) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], consumers);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// Called by the `threads` consumer threads (thread 0 among them) of a split-K
// CTA once its partial tile is in the workspace: true in the last of the
// tile's `splits` CTAs to get here, which then reads every partial (and has
// set the tile's counter back to 0 for the next launch).
__device__ __forceinline__ bool last_split(int tile, int splits, int threads,
                                           int* flag) {
  __threadfence();
  bar_sync(1, threads);
  if (threadIdx.x == 0) {
    *flag = atomicAdd(&g_tile_arrivals[tile], 1) == splits - 1;
    if (*flag) g_tile_arrivals[tile] = 0;
  }
  bar_sync(1, threads);
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// ---------------------------------------------------------------------------
// Path 0: split-K, swap-AB, M <= NT
// ---------------------------------------------------------------------------

constexpr int kSplitThreads = 160;  // one consumer warpgroup, one producer
constexpr int kWTile = 64 * kBK * 2;  // bytes of a 64 x 64 weight tile

template <int NT>
__host__ __device__ constexpr int split_stage_bytes() {
  return kWTile + (NT * kBK * 2 < 1024 ? 1024 : NT * kBK * 2);
}

template <int NT>
__host__ __device__ constexpr int split_smem_bytes() {
  return kStages * split_stage_bytes<NT>() + 1024;
}

// grid (ceil(N / 64), splits): CTA (t, s) takes weight rows 64 t .. 64 t + 63
// and k steps s * split_steps .. of 64 values. ws: splits x tiles x 64 x NT
// f32 partials (unused when splits == 1).
template <int NT>
__global__ void __launch_bounds__(kSplitThreads)
splitk_kernel(const __grid_constant__ CUtensorMap tw,
              const __grid_constant__ CUtensorMap tx, float* __restrict__ out,
              float* __restrict__ ws, int M, int N, int K, int split_steps) {
  constexpr int kStage = split_stage_bytes<NT>();
  constexpr int kR = NT / 2;  // accumulators a thread
  __shared__ Ring<kStages> ring;
  __shared__ int last;
  uint8_t* smem = smem_1k();
  const int tile = blockIdx.x, split = blockIdx.y;
  const int tiles = gridDim.x, splits = gridDim.y;
  const int k_steps = (K + kBK - 1) / kBK;
  const int s0 = split * split_steps;
  const int steps = min(split_steps, k_steps - s0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_ring(ring, 4);

  if (warp == 4) {  // producer
    if (lane == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % kStages;
        mbar_wait(&ring.empty[s], ((i / kStages) & 1) ^ 1);
        uint8_t* st = smem + s * kStage;
        mbar_expect_tx(&ring.full[s], kWTile + NT * kBK * 2);
        const int k = (s0 + i) * kBK;
        tma_load_2d(st, &tw, &ring.full[s], k, tile * 64);
        tma_load_2d(st + kWTile, &tx, &ring.full[s], k, 0);
      }
    }
    return;
  }

  float d[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) d[i] = 0.f;
  for (int i = 0; i < steps; ++i) {
    const int s = i % kStages;
    mbar_wait(&ring.full[s], (i / kStages) & 1);
    const uint8_t* st = smem + s * kStage;
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_m64k16<NT>(d, desc_sw128(st + 32 * kk),
                       desc_sw128(st + kWTile + 32 * kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
    __syncwarp();
    if (lane == 0) mbar_arrive(&ring.empty[s]);
  }

  // accumulator e = 4 c + 2 i + j: weight row r + 8 i, activation row
  // 8 c + col + j (wgmma's D fragment, here transposed)
  const int r = 16 * warp + lane / 4, col = 2 * (lane % 4);
  const int n0 = tile * 64;
  auto store = [&](const float (&v)[kR]) {
#pragma unroll
    for (int c = 0; c < NT / 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + r + 8 * i, m = 8 * c + col + j;
          if (n < N && m < M) out[(size_t)m * N + n] = v[4 * c + 2 * i + j];
        }
  };
  if (splits == 1) {
    store(d);
    return;
  }

  float* part = ws + ((size_t)split * tiles + tile) * 64 * NT;
#pragma unroll
  for (int c = 0; c < NT / 8; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(part + (r + 8 * i) * NT + 8 * c + col) =
          make_float2(d[4 * c + 2 * i], d[4 * c + 2 * i + 1]);
  if (!last_split(tile, splits, 128, &last)) return;
  // the partials summed in split order, whichever CTA came last
  float v[kR];
#pragma unroll
  for (int e = 0; e < kR; ++e) v[e] = 0.f;
#pragma unroll 8
  for (int sp = 0; sp < splits; ++sp) {
    const float* p = ws + ((size_t)sp * tiles + tile) * 64 * NT;
#pragma unroll
    for (int c = 0; c < NT / 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 q = __ldcg(reinterpret_cast<const float2*>(
            p + (r + 8 * i) * NT + 8 * c + col));
        v[4 * c + 2 * i] += q.x;
        v[4 * c + 2 * i + 1] += q.y;
      }
  }
  store(v);
}

// ---------------------------------------------------------------------------
// Path 1: 128 x 128 tiles, M > 16
// ---------------------------------------------------------------------------

constexpr int kTile = 128;
constexpr int kTiledStages = 6;
constexpr int kTiledThreads = 288;  // two consumer warpgroups, one producer
constexpr int kOperand = kTile * kBK * 2;  // bytes of a 128 x 64 tile
constexpr int kTiledSmem = kTiledStages * 2 * kOperand + 1024;

// grid (ceil(N / 128), ceil(M / 128), splits): CTA (x, y, z) takes the
// output tile (y, x) and k steps z * split_steps .. of 64 values. ws: splits
// x tiles x 128 x 128 f32 partials (unused when splits == 1), summed in
// split order by the last CTA of each tile as in path 0. Stage s holds the x
// tile, then the W tile.
__global__ void __launch_bounds__(kTiledThreads, 1)
tiled_kernel(const __grid_constant__ CUtensorMap tx,
             const __grid_constant__ CUtensorMap tw, float* __restrict__ out,
             float* __restrict__ ws, int M, int N, int K, int split_steps) {
  __shared__ Ring<kTiledStages> ring;
  __shared__ int last;
  uint8_t* smem = smem_1k();
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  const int split = blockIdx.z, splits = gridDim.z;
  const int k_steps = (K + kBK - 1) / kBK;
  const int s0 = split * split_steps;
  const int steps = min(split_steps, k_steps - s0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_ring(ring, 8);

  if (warp == 8) {  // producer
    if (lane == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % kTiledStages;
        mbar_wait(&ring.empty[s], ((i / kTiledStages) & 1) ^ 1);
        uint8_t* st = smem + s * 2 * kOperand;
        mbar_expect_tx(&ring.full[s], 2 * kOperand);
        const int k = (s0 + i) * kBK;
        tma_load_2d(st, &tx, &ring.full[s], k, m0);
        tma_load_2d(st + kOperand, &tw, &ring.full[s], k, n0);
      }
    }
    return;
  }

  const int wg = warp / 4;  // this warpgroup's rows: m0 + 64 wg ..
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  // one wgmma group stays in flight: step i's products overlap the wait for
  // step i + 1's stage, and step i - 1's stage is released once they are
  // done
  for (int i = 0; i < steps; ++i) {
    const int s = i % kTiledStages;
    mbar_wait(&ring.full[s], (i / kTiledStages) & 1);
    const uint8_t* st = smem + s * 2 * kOperand;
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_m64k16<128>(d, desc_sw128(st + wg * 64 * 128 + 32 * kk),
                        desc_sw128(st + kOperand + 32 * kk));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(d);
    __syncwarp();
    if (lane == 0 && i > 0)
      mbar_arrive(&ring.empty[(i + kTiledStages - 1) % kTiledStages]);
  }
  wgmma_wait<0>();
  fence_regs(d);

  // accumulator e = 4 c + 2 i + j: row rl + 8 i, column cl + 8 c + j of
  // the tile
  const int rl = 64 * wg + 16 * (warp % 4) + lane / 4, cl = 2 * (lane % 4);
  if (splits > 1) {
    const int tiles = gridDim.x * gridDim.y;
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    // only rows below M go through the workspace (at M 17 most of the
    // tile's rows are TMA's zero fill)
    float* part = ws + ((size_t)split * tiles + tile) * kTile * kTile;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (m0 + rl + 8 * i >= M) continue;
#pragma unroll
      for (int c = 0; c < 16; ++c)
        *reinterpret_cast<float2*>(part + (rl + 8 * i) * kTile + cl + 8 * c) =
            make_float2(d[4 * c + 2 * i], d[4 * c + 2 * i + 1]);
    }
    if (!last_split(tile, splits, 256, &last)) return;
    // the partials summed in split order, whichever CTA came last
#pragma unroll
    for (int e = 0; e < 64; ++e) d[e] = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      const float* p = ws + ((size_t)sp * tiles + tile) * kTile * kTile;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (m0 + rl + 8 * i >= M) continue;
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const float2 q = __ldcg(reinterpret_cast<const float2*>(
              p + (rl + 8 * i) * kTile + cl + 8 * c));
          d[4 * c + 2 * i] += q.x;
          d[4 * c + 2 * i + 1] += q.y;
        }
      }
    }
  }
  const int r = m0 + rl, cn = n0 + cl;
  const bool pairs = N % 2 == 0;  // float2 stores stay 8-byte aligned
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = r + 8 * i;
    if (m >= M) continue;
    float* row = out + (size_t)m * N;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int n = cn + 8 * c;
      const float a = d[4 * c + 2 * i], b = d[4 * c + 2 * i + 1];
      if (pairs && n + 1 < N) {
        *reinterpret_cast<float2*>(row + n) = make_float2(a, b);
      } else {
        if (n < N) row[n] = a;
        if (n + 1 < N) row[n + 1] = b;
      }
    }
  }
}

}  // namespace

// x (M, K) bf16, W (layers, N, K) bf16, out (M, N) f32: y = x @ W[layer].T.
// K is walked in `splits` splits of split_steps steps of 64 values, the last
// possibly shorter and none empty. path 0 (split-K swap-AB, M <= cols, cols
// 8 or 16): grid (ceil(N / 64), splits); ws holds splits x ceil(N / 64) x
// 64 x cols f32 when splits > 1. path 1 (tiled, any M, cols 128): grid
// (ceil(N / 128), ceil(M / 128), splits); ws holds splits x tiles x 128 x
// 128 f32 when splits > 1. x and W 16-byte aligned, K % 8 == 0.
extern "C" int bf16_stacked_launch(const void* x, const void* W, void* out,
                                   void* ws, int M, int N, int K, int layer,
                                   int path, int cols, int split_steps,
                                   int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || layer < 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(W) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const auto* w = static_cast<const __nv_bfloat16*>(W) +
                  (size_t)layer * (size_t)N * (size_t)K;
  auto* y = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int k_steps = (K + kBK - 1) / kBK;
  const int tiles = path == 0 ? (N + 63) / 64
                              : ((N + kTile - 1) / kTile) *
                                    ((M + kTile - 1) / kTile);
  if (split_steps < 1 || splits < 1 ||
      (splits - 1) * split_steps >= k_steps ||
      splits * split_steps < k_steps ||
      (splits > 1 && (ws == nullptr || tiles > kMaxTiles)))
    return (int)cudaErrorInvalidValue;
  auto* part = static_cast<float*>(ws);
  CUtensorMap tx, tw;
  if (path == 0) {
    if ((cols != 8 && cols != 16) || M > cols ||
        !map_bf16_rows(&tw, w, N, K, K, 64) ||
        !map_bf16_rows(&tx, x, M, K, K, cols))
      return (int)cudaErrorInvalidValue;
    const dim3 grid(tiles, splits);
    if (cols == 8)
      splitk_kernel<8><<<grid, kSplitThreads, split_smem_bytes<8>(), st>>>(
          tw, tx, y, part, M, N, K, split_steps);
    else
      splitk_kernel<16><<<grid, kSplitThreads, split_smem_bytes<16>(), st>>>(
          tw, tx, y, part, M, N, K, split_steps);
  } else if (path == 1) {
    if (cols != kTile || !map_bf16_rows(&tx, x, M, K, K, kTile) ||
        !map_bf16_rows(&tw, w, N, K, K, kTile))
      return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kTiledSmem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, splits);
    tiled_kernel<<<grid, kTiledThreads, kTiledSmem, st>>>(
        tx, tw, y, part, M, N, K, split_steps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
