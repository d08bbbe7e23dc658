// The int8 wgmma tile path of the W4A8 matmuls at prefill M, one mainloop
// with two epilogues:
//
// - plain (csrc/w4a8_stacked.cu::w4a8_tile_launch, rows 3 and 2):
//     y[m, n] = ((float)(acc[m, n] - maxq * rowsum(xq[m])) * s[n]) * sx[m]
// - L (csrc/w4a8_lowrank.cu::w4a8_l_tile_launch, row 6): the same plus the
//   L half of the CALDERA factors,
//     y[m, n] = __fadd_rn(that, __fmul_rn(ylr[m, n], Ls[n]))
//     ylr[m, n] = sum_r bf16(xr[m, p(n) * rank + r]) * L[n, r]
//   with p(n) the projection of output row n, in lowrank.cuh's rounding
//   order (one multiply or add at a time, no FMA contraction).
//
// acc is the exact i32 sum, so both epilogues' integer half equals rowdot's
// and the plain version's bit for bit.
//
// The mainloop: TMA, an unpacker warpgroup and int8 wgmma
// -------------------------------------------------------
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
//
// The L epilogue: bf16 wgmma on sub-steps of the same ring
// ---------------------------------------------------------
//
// ylr is 2 M N rank bf16 operations (6% of the int8 products' time at rank
// 128), so it runs on the tensor cores too: wgmma m64n64k16 f32.bf16.bf16
// with both operands in shared memory. After a tile's int8 sub-steps the
// unpacker's thread 0 fills one more sub-step per (projection window, 64
// ranks) of the tile with two TMA boxes: in the x box's place A, the tile's
// window of bf16(xr) (64 WGS rows x 64 values), and in the B tile's place
// the 128 rows of bf16(L) (the host rounds xr to bf16 as the plain version
// does and widens the int8 codes, exactly, padding the rank to a multiple
// of 8), zero-filled past the rank, M and N. So the L operands cost no
// shared memory of their own (the ring's five sub-steps fill 224,256 of the
// 232,448 bytes at 128 rows) and no unpacker registers, and neither the
// consumers nor the epilogue wait on a global load. The rank is walked in
// whole 64-rank sub-steps (four k16 slices; zeros past the rank): a wgmma
// skipped under a branch serializes every wgmma of the kernel (ptxas
// C7520). A tile whose 128 rows straddle projections (splits not multiples
// of 128) takes one pass per projection it touches, and each output adds
// the pass of its own projection only.
//
// Registers: with 416 threads a CTA, four warps share each SM sub-partition
// (warp w on w % 4), so ptxas caps a thread at 128 registers. The
// consumers convert the i32 sums to the f32 first half of the output (64
// registers, the 72 of acc die), then, for each projection window, hold its
// sub-steps (at most the ring's depth: the host checks the rank) and run
// them twice, once per 64-column half of the tile into a 32-register f32
// accumulator, adding ylr * Ls to that half. That needs ~150 registers, so
// at 128 rows a tile the unpacker warpgroup gives registers back
// (setmaxnreg.dec to 72) and the consumers take them (setmaxnreg.inc to
// 152); the producer warp keeps its 128. First designs, measured: a
// 64-register accumulator beside the 64 outputs, and the unpacker writing
// A and B itself (bf16 conversions with 24 loads in flight), spilled 800
// and 1,040 bytes a thread and ran 1.5x and 1.6x row 3's time.
#pragma once

#include "hopper_gemm.cuh"

namespace {
namespace tile {

using namespace hopper;

constexpr int kBK = 128;                  // packed bytes of a row a step
constexpr int kBN = 128;                  // weight rows a CTA
constexpr int kOnes = 16;                 // rows of ones below them
constexpr int kRaw = kBN * kBK;           // bytes of a raw stage
constexpr int kBT = (kBN + kOnes) * kBK;  // bytes of a B tile
constexpr int kMaxK = 2147483647 / (127 * 255);
constexpr int kLK = 64;                   // ranks an L sub-step (128 bytes)

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

// The L factor of a fusion group of same-input projections (the L epilogue
// only), as the kernel reads it: ta, bf16(xr) as (M, n_proj, rank8) in
// boxes of 64 WGS rows x 1 projection x 64 ranks; tb, the layer's L codes
// as bf16 (N, rank8) in boxes of 128 rows x 64 ranks; Ls (N) f32. Output
// rows [0, b1) are projection 0, [b1, b2) 1, [b2, b3) 2, the rest 3 (N
// where unused).
struct LArgs {
  CUtensorMap ta, tb;
  const float* Ls;
  int rank, b1, b2, b3;
};

// What the host passes for it: xr (M, n_proj, rank8) and L (N, rank8)
// bf16, 16-byte aligned, rank8 = rank rounded up to a multiple of 8.
struct LSrc {
  const void* xr;
  const void* L;
  const float* Ls;
  int rank, rank8, n_proj, b1, b2, b3;
};

__device__ __forceinline__ int proj_of(int n, const LArgs& l) {
  return (n >= l.b1) + (n >= l.b2) + (n >= l.b3);
}

// The projections that the tile at weight rows n0 .. touches (the first in
// *p0): one L pass each, of ceil(rank / 64) sub-steps.
__device__ __forceinline__ int l_windows(const LArgs& l, int n0, int N,
                                         int* p0) {
  *p0 = proj_of(n0, l);
  return proj_of(min(n0 + kBN, N) - 1, l) - *p0 + 1;
}

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
// layer's N row scales. LF: the L epilogue on `lf` (unused without it).
template <int BITS, int WGS, bool LF>
__global__ void __launch_bounds__(Shape<WGS>::kThreads, 1)
tile_kernel(const __grid_constant__ CUtensorMap tw,
            const __grid_constant__ CUtensorMap tx,
            const float* __restrict__ sx, const float* __restrict__ s,
            float* __restrict__ out, int M, int N, int P, int m_tiles,
            const __grid_constant__ LArgs lf) {
  using S = Shape<WGS>;
  constexpr int F = 8 / BITS;
  constexpr int MAXQ = (1 << (BITS - 1)) - 1;
  constexpr int R = S::kRawStages, SS = S::kSubStages;
  __shared__ Bars<R, SS> bars;
  // each tile's scales, double-buffered: the unpacker writes them before
  // its first sub-step of the tile (the sub-step's barrier publishes them)
  // and the consumers read them in the epilogue
  __shared__ float s_tile[2][kBN], sx_tile[2][S::kRows];
  __shared__ float ls_tile[2][LF ? kBN : 1];
  uint8_t* raw = smem_1k();
  uint8_t* sub = raw + R * kRaw;
  const int tiles = m_tiles * ((N + kBN - 1) / kBN);
  const int steps = (P + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ut = threadIdx.x - 128 * WGS;  // unpacker thread: 0..127
  const int chunks = (lf.rank + kLK - 1) / kLK;  // L sub-steps a window
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
    if constexpr (LF && WGS == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n" ::: "memory");
    int i = 0, q = 0, local = 0;  // raw stages, sub-steps, tiles so far
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++local) {
      const int m0 = tile % m_tiles * S::kRows, n0 = tile / m_tiles * kBN;
      const int e = local & 1;
      mbar_wait(&bars.ep_empty[e], ((local >> 1) & 1) ^ 1);
      s_tile[e][ut] = n0 + ut < N ? s[n0 + ut] : 0.f;
      if (ut < S::kRows) sx_tile[e][ut] = m0 + ut < M ? sx[m0 + ut] : 0.f;
      if constexpr (LF) ls_tile[e][ut] = n0 + ut < N ? lf.Ls[n0 + ut] : 0.f;
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
      if constexpr (LF) {
        int p0;
        const int nl = l_windows(lf, n0, N, &p0) * chunks;
        for (int j = 0; j < nl; ++j, ++q) {
          const int b = q % SS;
          mbar_wait(&bars.sub_empty[b], ((q / SS) & 1) ^ 1);
          if (ut == 0) {
            uint8_t* st = sub + b * S::kSub;
            const int r0 = j % chunks * kLK;
            mbar_expect_tx(&bars.sub_full[b], S::kXT + kBN * kLK * 2);
            tma_load_3d(st, &lf.ta, &bars.sub_full[b], r0, p0 + j / chunks,
                        m0);
            tma_load_2d(st + S::kXT, &lf.tb, &bars.sub_full[b], r0, n0);
          }
          mbar_arrive(&bars.sub_full[b]);
        }
      }
    }
    return;
  }

  if constexpr (LF && WGS == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n" ::: "memory");
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
    const float* xsc = sx_tile[local & 1];
    // output (x row rl + 8 i, weight row 8 c + 2 t + j): its integer half
    // and its store
    auto base = [&](int i, int c, int j) {
      return __fmul_rn(__fmul_rn((float)(d[4 * c + 2 * i + j] - MAXQ * rs[i]),
                                 sc[8 * c + 2 * t + j]),
                       xsc[rl + 8 * i]);
    };
    auto store = [&](int i, int c, float v0, float v1) {
      const int m = m0 + rl + 8 * i, n = n0 + 8 * c + 2 * t;
      if (m >= M) return;
      float* row = out + (size_t)m * N;
      if (pairs && n + 1 < N) {
        *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
      } else {
        if (n < N) row[n] = v0;
        if (n + 1 < N) row[n + 1] = v1;
      }
    };
    if constexpr (!LF) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 16; ++c) store(i, c, base(i, c, 0), base(i, c, 1));
    } else {
      float y[64];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 16; ++c)
#pragma unroll
          for (int j = 0; j < 2; ++j) y[4 * c + 2 * i + j] = base(i, c, j);
      // a window's sub-steps at once (chunks <= SS, checked on the host),
      // one 64-column half of the tile at a time into a fresh f32
      // accumulator, then y += ylr * Ls on the half's outputs of the
      // window's projection (all of them unless the tile straddles)
      const float* lsc = ls_tile[local & 1];
      int p0;
      const int nw = l_windows(lf, n0, N, &p0);
      for (int w = 0; w < nw; ++w, q += chunks) {
        for (int c = 0; c < chunks; ++c)
          mbar_wait(&bars.sub_full[(q + c) % SS], ((q + c) / SS) & 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float a[32];
#pragma unroll
          for (int e = 0; e < 32; ++e) a[e] = 0.f;
          fence_regs(a);
          wgmma_fence();
          for (int c = 0; c < chunks; ++c) {
            const uint8_t* st = sub + (q + c) % SS * S::kSub;
            // all four k16 slices, also past the rank (zeros there): a
            // wgmma under a branch serializes every wgmma of the kernel
            // (ptxas C7520)
#pragma unroll
            for (int kk = 0; kk < kLK / 16; ++kk)
              wgmma_m64n64k16(
                  a, desc_sw128(st + wg * 64 * kBK + 32 * kk),
                  desc_sw128(st + S::kXT + h * 64 * kBK + 32 * kk));
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(a);
#pragma unroll
          for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int e = 4 * c + 2 * i + j, n = 64 * h + 8 * c + 2 * t + j;
                if (nw == 1 || proj_of(n0 + n, lf) == p0 + w)
                  y[32 * h + e] =
                      __fadd_rn(y[32 * h + e], __fmul_rn(a[e], lsc[n]));
              }
        }
        __syncwarp();
        if (lane == 0)
          for (int c = 0; c < chunks; ++c)
            mbar_arrive(&bars.sub_empty[(q + c) % SS]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 16; ++c)
          store(i, c, y[4 * c + 2 * i], y[4 * c + 2 * i + 1]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars.ep_empty[local & 1]);
  }
}

template <int BITS, int WGS, bool LF>
cudaError_t launch(const int8_t* x, const float* sx, const uint8_t* w,
                   const float* s, float* y, int M, int N, int K, int ctas,
                   const LSrc& src, cudaStream_t st) {
  using S = Shape<WGS>;
  constexpr int F = 8 / BITS;
  const int P = K / F;
  CUtensorMap tw, tx;
  if (!map_u8_rows128(&tw, w, N, P, P, kBN) ||
      !map_i8_planes(&tx, x, M, F, P, S::kRows))
    return cudaErrorInvalidValue;
  LArgs lf{};
  if constexpr (LF) {
    // a window's sub-steps must fit the ring at once
    if ((src.rank + kLK - 1) / kLK > S::kSubStages ||
        !map_bf16_planes(&lf.ta, src.xr, M, src.n_proj, src.rank8,
                         S::kRows) ||
        !map_bf16_rows(&lf.tb, src.L, N, src.rank8, src.rank8, kBN))
      return cudaErrorInvalidValue;
    lf.Ls = src.Ls;
    lf.rank = src.rank;
    lf.b1 = src.b1;
    lf.b2 = src.b2;
    lf.b3 = src.b3;
  }
  const cudaError_t err =
      hopper::allow_smem<tile_kernel<BITS, WGS, LF>>(S::kSmem);
  if (err != cudaSuccess) return err;
  tile_kernel<BITS, WGS, LF><<<ctas, S::kThreads, S::kSmem, st>>>(
      tw, tx, sx, s, y, M, N, P, (M + S::kRows - 1) / S::kRows, lf);
  return cudaGetLastError();
}

// `rows` (64 or 128) activation rows and 128 weight rows a tile,
// ceil(M / rows) x ceil(N / 128) tiles walked by `ctas` persistent CTAs, at
// `bits` 2, 4 or 8; w and s the layer's packed bytes and row scales.
// K % (16 F) == 0 and K <= kMaxK; xq and w 16-byte aligned.
template <bool LF>
cudaError_t launch_bits(const int8_t* x, const float* sx, const uint8_t* w,
                        const float* s, float* y, int M, int N, int K,
                        int bits, int rows, int ctas, const LSrc& lf,
                        cudaStream_t st) {
  const int f = 8 / (bits > 0 ? bits : 1);
  if ((bits != 2 && bits != 4 && bits != 8) || M <= 0 || N <= 0 || K <= 0 ||
      K % (16 * f) != 0 || K > kMaxK || ctas <= 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return cudaErrorInvalidValue;
#define TILE_ROWS(B)                                                        \
  (rows == 64    ? launch<B, 1, LF>(x, sx, w, s, y, M, N, K, ctas, lf, st) \
   : rows == 128 ? launch<B, 2, LF>(x, sx, w, s, y, M, N, K, ctas, lf, st) \
                 : cudaErrorInvalidValue)
  if (bits == 2) return TILE_ROWS(2);
  if (bits == 4) return TILE_ROWS(4);
  return TILE_ROWS(8);
#undef TILE_ROWS
}

}  // namespace tile
}  // namespace
