// Skinny int8 row-dot GEMM shared by the W4A8 stacked matmul and the int8
// matmul: y[m, n] = (acc[m, n] * ws[n]) * sx[m] with acc the exact i32 sum
// of int8 activations times weight codes.
//
// Decode is bound by the weight bytes (M <= 32 activation rows against N x K
// codes), so the design reads every weight byte once from device memory and
// reuses it for all M rows:
// - one CTA owns a tile of output rows n; each warp walks four whole rows
//   together, each lane loading 16 contiguous packed bytes of every row per
//   step (coalesced 512 B per warp and row, four loads in flight);
// - the int8 activations of the CTA's M rows sit in shared memory, staged in
//   chunks of the packed row so that M x F x chunk fits 48 KB (K is tiled
//   when M * K does not fit, e.g. down_proj at K = 11008); each staged word
//   is read once per step for all four rows, since shared-memory reads, not
//   device memory, would otherwise bound the kernel;
// - sub-byte codes unpack with one shift and one byte-parallel mask per
//   plane (row-global planes: byte j of a row holds k = j + p * K / F at
//   shift BITS * (F - 1 - p)), and four codes at a time meet four
//   activations in one __dp4a;
// - the offset-binary bias is removed once per output with the rank-1 term
//   maxq * rowsum(xq); 8-bit offset codes take the signed per-code path and
//   signed int8 weights feed __dp4a directly.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

namespace rowdot {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// dynamic activation staging; the rest of the 48 KB default holds rowsum
constexpr int kSmemBytes = 47 * 1024;

// Weight code formats.
constexpr int kOffsetPacked = 0;  // BITS < 8 offset-binary, row-global planes
constexpr int kOffset8 = 1;       // 8-bit offset-binary: signed code u - 127

template <int MT>
struct Tile {
  static constexpr int kRowsPerWarp = MT <= 8 ? 4 : 1;
  static constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
};

template <int BITS, int CODE>
__device__ __forceinline__ int dot_word(unsigned word, int p, int xw, int acc) {
  constexpr int F = 8 / BITS;
  constexpr unsigned kMask = ((1u << BITS) - 1u) * 0x01010101u;
  if (CODE == kOffsetPacked) {
    const int codes = (int)((word >> (BITS * (F - 1 - p))) & kMask);
    return __dp4a(codes, xw, acc);
  } else {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = (int)((word >> (8 * b)) & 0xFFu) - 127;
      const int xv = (int)(int8_t)((xw >> (8 * b)) & 0xFF);
      acc += c * xv;
    }
    return acc;
  }
}

// Global loads of activations: read-only inputs through the non-coherent
// cache; CG = true reads data another CTA of the same launch wrote (the
// cooperative kernels' scratch) from L2.
template <bool CG>
__device__ __forceinline__ int ld_act(const int* p) {
  return CG ? __ldcg(p) : p[0];
}

// rowsum[m] = sum_k xq[m0 + m, k] for the tile's mt rows (x32 points at row
// m0), one warp per row. Needed by the offset-binary codes only.
template <bool CG = false>
__device__ __forceinline__ void tile_rowsum(const int* x32, int mt, int kw,
                                            int* rowsum) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int m = warp; m < mt; m += kWarps) {
    int s = 0;
    for (int i = lane; i < kw; i += 32)
      s = __dp4a(ld_act<CG>(x32 + (size_t)m * kw + i), 0x01010101, s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) rowsum[m] = s;
  }
}

// The exact i32 sums acc[r][m] = sum_k xq[m0 + m, k] * code(w[n_first + r, k])
// of one tile: this warp's RPW rows n_first + r against the CTA's mt
// activation rows (x32 points at row m0; staged through xs, jc_words words
// of each plane per chunk). Every thread of the CTA must call it: it
// synchronizes the CTA before each chunk is staged. Lanes hold partial sums;
// reduce them over the warp.
template <int BITS, int CODE, int MT, bool CG = false>
__device__ __forceinline__ void tile_accumulate(
    const int* x32, int mt, int kw, const uint8_t* __restrict__ w, int N,
    int pw, int jc_words, int n_first, int* xs,
    int (&acc)[Tile<MT>::kRowsPerWarp][MT]) {
  constexpr int F = 8 / BITS;
  constexpr int RPW = Tile<MT>::kRowsPerWarp;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[r][m] = 0;

  for (int j0 = 0; j0 < pw; j0 += jc_words) {
    const int cw = min(jc_words, pw - j0);
    __syncthreads();
    const int total = mt * F * cw;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int wd = i % cw;
      const int t = i / cw;
      const int p = t % F;
      const int m = t / F;
      xs[(m * F + p) * jc_words + wd] =
          ld_act<CG>(x32 + (size_t)m * kw + p * pw + j0 + wd);
    }
    __syncthreads();
    // All RPW rows' 16-byte weight loads go out together, and each staged
    // activation word is read from shared memory once for all RPW rows.
    for (int v4 = lane; v4 < cw / 4; v4 += 32) {
      unsigned words[RPW][4];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        uint4 wv = make_uint4(0u, 0u, 0u, 0u);
        if (n_first + r < N)
          wv = __ldg(reinterpret_cast<const uint4*>(
                         w + (size_t)(n_first + r) * pw * 4) + j0 / 4 + v4);
        words[r][0] = wv.x;
        words[r][1] = wv.y;
        words[r][2] = wv.z;
        words[r][3] = wv.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int p = 0; p < F; ++p) {
          const int* xp = xs + p * jc_words + 4 * v4 + q;
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m < mt) {
              const int xw = xp[m * F * jc_words];
#pragma unroll
              for (int r = 0; r < RPW; ++r)
                acc[r][m] = dot_word<BITS, CODE>(words[r][q], p, xw,
                                                 acc[r][m]);
            }
          }
        }
      }
    }
  }
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// xq (M, K) int8, sx (M) f32, w (N, K / F) uint8 or int8, ws (N) f32,
// out (M, N) f32. K % (16 * F) == 0; jc_words % 4 == 0.
template <int BITS, int CODE, int MT>
__global__ void __launch_bounds__(kThreads)
rowdot_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
              const uint8_t* __restrict__ w, const float* __restrict__ ws,
              float* __restrict__ out, int M, int N, int K, int jc_words) {
  constexpr int F = 8 / BITS;
  constexpr int MAXQ = (1 << (BITS - 1)) - 1;
  constexpr int RPW = Tile<MT>::kRowsPerWarp;
  extern __shared__ int xs[];  // [mt][F][jc_words] activation words
  __shared__ int rowsum[MT];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * MT;
  const int mt = min(MT, M - m0);
  const int pw = K / F / 4;  // 32-bit words per packed weight row
  const int kw = K / 4;      // 32-bit words per activation row
  const int* x32 = reinterpret_cast<const int*>(xq) + (size_t)m0 * kw;

  if (CODE == kOffsetPacked) tile_rowsum(x32, mt, kw, rowsum);

  int acc[RPW][MT];
  const int n_first = blockIdx.x * Tile<MT>::kRowsPerBlock + warp * RPW;
  tile_accumulate<BITS, CODE, MT>(x32, mt, kw, w, N, pw, jc_words, n_first,
                                  xs, acc);

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int n = n_first + r;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      int v = warp_sum_int(acc[r][m]);
      if (m < mt && n < N && lane == (m & 31)) {
        if (CODE == kOffsetPacked) v -= MAXQ * rowsum[m];
        out[(size_t)(m0 + m) * N + n] = ((float)v * ws[n]) * sx[m0 + m];
      }
    }
  }
}

// Launch over all M rows: MT = 8 when M <= 8, else 32-row tiles.
template <int BITS, int CODE>
inline cudaError_t launch(const int8_t* xq, const float* sx, const uint8_t* w,
                          const float* ws, float* out, int M, int N, int K,
                          cudaStream_t stream) {
  constexpr int F = 8 / BITS;
  if (M <= 0 || N <= 0 || K <= 0 || K % (16 * F) != 0)
    return cudaErrorInvalidValue;
  const int pw = K / F / 4;
  const int mt = M <= 8 ? 8 : 32;
  const int mrows = M < mt ? M : mt;
  int jc = kSmemBytes / (mrows * F * 4);
  jc -= jc % 4;
  if (jc > pw) jc = pw;
  const size_t smem = (size_t)mrows * F * jc * 4;
  if (mt == 8) {
    dim3 grid((N + Tile<8>::kRowsPerBlock - 1) / Tile<8>::kRowsPerBlock,
              (M + 7) / 8);
    rowdot_kernel<BITS, CODE, 8>
        <<<grid, kThreads, smem, stream>>>(xq, sx, w, ws, out, M, N, K, jc);
  } else {
    dim3 grid((N + Tile<32>::kRowsPerBlock - 1) / Tile<32>::kRowsPerBlock,
              (M + 31) / 32);
    rowdot_kernel<BITS, CODE, 32>
        <<<grid, kThreads, smem, stream>>>(xq, sx, w, ws, out, M, N, K, jc);
  }
  return cudaGetLastError();
}

// Grid size of a cooperative or persistent launch: at most the CTAs (of
// `threads` threads) that fit on the card at once (occupancy query x SMs,
// asked once per kernel, device and shared memory size, so that launches
// captured in a CUDA graph query nothing), and no more than the work's
// units.
template <typename Kernel>
inline cudaError_t coop_grid(Kernel kernel, size_t smem, int units,
                             int* grid, int threads = kThreads) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t>, int> caps;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple((const void*)kernel, dev, smem);
  int cap = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = caps.find(key);
    if (it != caps.end()) cap = it->second;
  }
  if (cap == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    cap = per_sm * sms;
    std::lock_guard<std::mutex> lock(mu);
    caps[key] = cap;
  }
  *grid = units < cap ? units : cap;
  if (*grid < 1) *grid = 1;
  return cudaSuccess;
}

// Allow up to `bytes` of dynamic shared memory for `kernel` (above the 48 KB
// default), once per kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace rowdot
