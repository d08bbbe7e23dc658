// The W4A8 matmul's persistent launch at decode M (M <= 8 activation rows):
// row 3's function on one layer of a stacked packed tensor,
//
//   y[m, n] = ((float)acc[m, n] * ws[n]) * sx[m],
//   acc[m, n] = sum_k xq[m, k] * (u[n, k] - maxq),
//
// as a weight stream cut over every SM. It replaces rowdot.cuh's persistent
// __dp4a kernel for the TPU kernel ops/kernels.py::
// quantized_matmul_w4a8_stacked_persistent (_qmm_w4a8_persistent_kernel).
//
// Bound: the packed weight bytes (N K / F: 8.4 MB for Llama-2-7B's o_proj
// at 4 bits, 22.5 MB for down_proj), read once, against at most 8
// activation rows: about 2.5 and 6.7 us at 3.35 TB/s. So the design keeps
// every SM's bytes in flight from the start and spends as few instructions
// a byte as it can:
//
// - Products on the tensor cores: mma.sync m16n8k32 s8 x s8 -> s32, 16
//   weight rows as A and the M <= 8 activation rows as the n = 8 side (rows
//   past M are zeros). One shift and one mask of a packed word give four
//   codes of one plane (row-global planes: byte j of a row holds k = j +
//   p K / F), made signed as c - MAXQ (megastep_proj.cuh's scodes), so the
//   i32 sums are the grid launch's acc - MAXQ rowsum(xq) with no row sum;
//   8-bit codes as u - 128 plus a product with ones (fused_proj.cuh's
//   slab_codes, with the activations from the slot). Every sum is exact,
//   and the epilogue is the grid launch's, so the output equals it bit for
//   bit.
// - The layer is cut into slabs of (group of 32 weight rows, chunk of 128
//   packed bytes), group-major, and the S slabs into W = CTAs x warps equal
//   contiguous ranges, one a warp (one CTA of 8 warps an SM: every SM busy
//   at N 4096, where o has 2048 slabs and down 5504).
// - Each warp streams its range through a ring of kDepth slots in shared
//   memory, and issues its next slab as soon as it has used one: no CTA
//   barrier anywhere. A slot holds a slab's weights, one TMA box (32 rows x
//   128 bytes, the 128-byte swizzle, zeros past a row's end and past N),
//   and the activations of the same 128-byte chunk of each plane (one box
//   of 8 rows a plane, zeros past M): the band of K the slab multiplies,
//   never the whole of x. One lane issues the boxes; the slot's mbarrier
//   completes them. At 4 bits a CTA's rings hold 96 KB in flight.
// - A group split between warps is summed exactly in i32: each contributor
//   adds its partials into the group's sums (red.add; integer sums do not
//   depend on the order) and counts itself on the group's counter, and the
//   last one reads the totals (one round trip) and leaves the sums and the
//   counter zero, so launches repeat bit for bit. Counters and sums come
//   zeroed per (device, stream) and per CUDA-graph capture from the wrapper
//   (ops/kernels.py::_split_counters). No cooperative launch and no grid
//   barrier: a warp only ever waits on its own slabs and, as the last
//   contributor, reads sums added before its count.
#pragma once

#include "fused_proj.cuh"
#include "hopper_gemm.cuh"

namespace wstream {

using mproj::kKC;
using mproj::kSlabBytes;
using mproj::kTileRows;
constexpr int kWarps = 8;   // warps of a CTA (fewer only for fewer slabs)
constexpr int kDepth = 2;   // slabs in flight a warp
constexpr int kXBox = 8 * kKC;      // a plane's activations of a slab
constexpr int kGroupSums = 8 * 32;  // a split group's i32 sums: 8 a lane

// A ring slot: the slab's weights, then its activations, one box of 8 rows
// x 128 bytes a plane.
template <int BITS>
__host__ __device__ constexpr int slot_bytes() {
  return kSlabBytes + (8 / BITS) * kXBox;
}

// Dynamic shared memory of a CTA of `warps` warps: their rings (from a
// 1024-byte boundary, which the swizzle needs), then a ring's mbarriers.
template <int BITS>
__host__ __device__ constexpr int smem_bytes(int warps) {
  return 1024 + warps * kDepth * slot_bytes<BITS>() + warps * kDepth * 8;
}

// The launch, as a __grid_constant__ parameter.
struct Plan {
  const uint8_t* w;  // the layer's packed codes, N rows of P bytes
  const float* ws;   // its row scales
  const int8_t* x;   // int8 activations, M rows of K
  const float* sx;   // their scales
  float* out;        // (M, N)
  int* cnt;          // a counter a group, zero
  int* sums;         // kGroupSums i32 sums a group, zero
  int M, N, K, P;
  int nk;            // chunks of kKC bytes a row (the last may be ragged)
  int S;             // slabs: ceil(N / 32) groups x nk
};

// A warp's ring: slot n % kDepth holds the n-th slab of its range, landed
// when its barrier bar[n % kDepth] completes phase n / kDepth; nc
// consumed, n issued; map: the layer's tensor map (rows x P bytes), xmap
// the activations' (rows x planes x P bytes).
struct Ring {
  uint8_t* buf;
  uint64_t* bar;
  const CUtensorMap* map;
  const CUtensorMap* xmap;
  int nc, n;
};
// The warp's issue cursor: the next slab to issue, and its range's first.
struct Cursor {
  int s, lo;
};

// Called by the whole warp once slot rg.n % kDepth is free (its previous
// slab's values used): lane 0 loads slab q.s, the TMA box at (128 c, 32 G)
// of the layer (32 rows x 128 bytes in the 128-byte swizzle slab_codes
// reads: chunk k of row r at chunk k ^ (r % 8); TMA fills zeros past a
// row's end and past N) and chunk c of each activation plane (8 rows x 128
// bytes, the same swizzle, zeros past M and past a plane's end), on the
// slot's barrier, and, at a group's first slab in this range,
// prefetches the group's row scales into L2 for its epilogue; every lane
// advances the cursor.
template <int BITS>
__device__ __forceinline__ void issue(Cursor& q, const Plan& pl, Ring& rg,
                                      int hi) {
  if (q.s < hi) {
    const int G = q.s / pl.nk, c = q.s - G * pl.nk;
    if ((threadIdx.x & 31) == 0) {
      const int slot = rg.n % kDepth;
      uint8_t* dst = rg.buf + slot * slot_bytes<BITS>();
      hopper::mbar_expect_tx(rg.bar + slot, slot_bytes<BITS>());
      hopper::tma_load_2d(dst, rg.map, rg.bar + slot, c * kKC, 32 * G);
      for (int p = 0; p < 8 / BITS; ++p)
        hopper::tma_load_3d(dst + kSlabBytes + p * kXBox, rg.xmap,
                            rg.bar + slot, c * kKC, p, 0);
      if (c == 0 || q.s == q.lo) mproj::prefetch_line(pl.ws + 32 * G);
    }
    ++rg.n;
    ++q.s;
  }
}

// Wait until slab rg.nc has landed (each lane on the slot's barrier).
__device__ __forceinline__ void ring_wait(const Ring& rg) {
  hopper::mbar_wait(rg.bar + rg.nc % kDepth, (rg.nc / kDepth) & 1);
}

// Group G split between warps: add this warp's partials into the group's
// zeroed sums (red.add: i32 sums are exact in any order) and count it on
// the group's counter; false unless this warp is the last contributor,
// which reads the totals into acc and leaves the sums and the counter
// zero. With S >= W (the plan's rule) every range is nonempty, so the
// contributors are the owners of the group's first and last slabs and
// every warp between.
__device__ __forceinline__ bool split_sum(int (&acc)[2][1][4],
                                          const Plan& pl, int G) {
  const int lane = threadIdx.x & 31;
  const int W = gridDim.x * (blockDim.x >> 5);
  const int g0 = G * pl.nk;
  const int n = fproj::owner(g0 + pl.nk - 1, pl.S, W) -
                fproj::owner(g0, pl.S, W) + 1;
  int* sum = pl.sums + (size_t)G * kGroupSums + lane;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    asm volatile("red.relaxed.gpu.global.add.s32 [%0], %1;\n" ::"l"(
                     sum + 32 * i),
                 "r"(acc[i >> 2][0][i & 3])
                 : "memory");
  // the warp's adds, then one lane's count, an acquire-release atomic: the
  // last contributor's reads come after every other's adds
  __syncwarp();
  int last = 0;
  if (lane == 0) {
    int old;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(pl.cnt + G)
                 : "memory");
    last = old == n - 1;
    if (last) pl.cnt[G] = 0;
  }
  last = __shfl_sync(0xffffffffu, last, 0);
  if (!last) return false;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i >> 2][0][i & 3] = __ldcg(sum + 32 * i);
#pragma unroll
  for (int i = 0; i < 8; ++i) sum[32 * i] = 0;
  return true;
}

// The B fragments of a slot's activations, as slab_codes takes them: lane
// (g8, t) takes the 16-byte chunk t of 64-byte segment q of activation row
// g8 in each plane.
template <int BITS>
__device__ __forceinline__ void ring_x(const uint8_t* sl,
                                       fproj::XFrag<BITS, 1>& xf) {
  const int lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t = lane & 3;
#pragma unroll
  for (int p = 0; p < 8 / BITS; ++p)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      xf.v[p][q][0] = *reinterpret_cast<const uint4*>(
          sl + kSlabBytes + p * kXBox + g8 * kKC + (((4 * q + t) ^ g8) << 4));
}

// y of group G: accumulator e of tile tl is weight row 32 G + 16 tl +
// smem_row(g8) + 8 (e >> 1), activation row 2 t + (e & 1); the grid
// launch's ((float)acc * ws[n]) * sx[m].
__device__ __forceinline__ void epilogue(const int (&acc)[2][1][4],
                                         const Plan& pl, int G) {
  const int lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t = lane & 3;
  const int r = 32 * G + mproj::smem_row(g8);
  float wsv[2][2], sxv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = 2 * t + h;
    sxv[h] = m < pl.M ? __ldg(pl.sx + m) : 0.f;
#pragma unroll
    for (int tl = 0; tl < 2; ++tl) {
      const int n = r + kTileRows * tl + 8 * h;
      wsv[tl][h] = n < pl.N ? __ldg(pl.ws + n) : 0.f;
    }
  }
#pragma unroll
  for (int tl = 0; tl < 2; ++tl)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = r + kTileRows * tl + 8 * (e >> 1), m = 2 * t + (e & 1);
      if (n < pl.N && m < pl.M)
        pl.out[(size_t)m * pl.N + n] = __fmul_rn(
            __fmul_rn((float)acc[tl][0][e], wsv[tl][e >> 1]), sxv[e & 1]);
    }
}

// tw: the layer's packed bytes as a TMA map of N rows x P bytes in boxes of
// 32 rows x 128 bytes (hopper::map_u8_rows128); tx: the activations as
// M rows x F planes x P bytes in boxes of 8 rows x 128 bytes
// (hopper::map_i8_planes).
template <int BITS>
__global__ void __launch_bounds__(kWarps * 32)
    stream_kernel(const __grid_constant__ CUtensorMap tw,
                  const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ Plan pl) {
  uint8_t* base = hopper::smem_1k();
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int W = gridDim.x * nw, w = blockIdx.x * nw + warp;
  const int lo = fproj::range_lo(pl.S, w, W);
  const int hi = fproj::range_lo(pl.S, w + 1, W);
  constexpr int kRing = kDepth * slot_bytes<BITS>();
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(base + nw * kRing) + warp * kDepth;
  if ((threadIdx.x & 31) == 0) {
    for (int i = 0; i < kDepth; ++i) hopper::mbar_init(bars + i, 1);
    hopper::mbar_fence_init();
  }
  __syncwarp();
  Ring rg;
  Cursor q;
  rg = Ring{base + warp * kRing, bars, &tw, &tx, 0, 0};
  q = Cursor{lo, lo};
  for (int i = 0; i < kDepth; ++i) issue<BITS>(q, pl, rg, hi);
  fproj::XFrag<BITS, 1> xf;
  for (int s = lo; s < hi;) {
    const int G = s / pl.nk, g0 = G * pl.nk;
    const int end = min(hi, g0 + pl.nk);
    int acc[2][1][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i >> 2][0][i & 3] = 0;
    for (; s < end; ++s) {
      ring_wait(rg);
      const uint8_t* sl = rg.buf + (rg.nc % kDepth) * slot_bytes<BITS>();
      ring_x<BITS>(sl, xf);
      fproj::slab_codes<BITS, 8, true>(sl, xf, nullptr, 0, 0, 0, 0, false,
                                       acc);
      ++rg.nc;
      __syncwarp();  // every lane has used the slot's values: refill it
      issue<BITS>(q, pl, rg, hi);
    }
    if (!(lo <= g0 && end == g0 + pl.nk) && !split_sum(acc, pl, G))
      continue;
    epilogue(acc, pl, G);
  }
}

// The i32 sums hold while K * 127 * 128 < 2^31 (|x| <= 127, |code| <= 128).
constexpr int kMaxK = 2147483647 / (127 * 128);

// xq (M, K) int8 and the layer's packed bytes 16-byte aligned, K % (16 F)
// == 0, 1 <= M <= 8; `ctas` CTAs of `warps` warps with S >= ctas x warps
// and S x ctas x warps < 2^32 (ops/kernels.py::_w4a8_stream_plan); cnt a
// zeroed int a group, sums kGroupSums zeroed ints a group.
template <int BITS>
inline cudaError_t launch(const Plan& pl, int ctas, int warps,
                          cudaStream_t stream) {
  CUtensorMap tw, tx;
  constexpr int F = 8 / BITS;
  const long long W = (long long)ctas * warps;
  if (pl.M < 1 || pl.M > 8 || pl.N < 1 || pl.K < 1 || pl.K % (16 * F) != 0 ||
      pl.K > kMaxK || pl.P * F != pl.K ||
      pl.nk != (pl.P + kKC - 1) / kKC ||
      pl.S != (pl.N + 31) / 32 * pl.nk || warps < 1 || warps > kWarps ||
      ctas < 1 || W > pl.S || (long long)pl.S * W >= (1ll << 32) ||
      reinterpret_cast<uintptr_t>(pl.w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(pl.x) % 16 != 0)
    return cudaErrorInvalidValue;
  if (!hopper::map_u8_rows128(&tw, pl.w, pl.N, pl.P, pl.P, 32) ||
      !hopper::map_i8_planes(&tx, pl.x, pl.M, F, pl.P, 8))
    return cudaErrorInvalidValue;
  const int smem = smem_bytes<BITS>(warps);
  cudaError_t err =
      hopper::allow_smem<stream_kernel<BITS>>(smem_bytes<BITS>(kWarps));
  if (err != cudaSuccess) return err;
  stream_kernel<BITS><<<ctas, warps * 32, smem, stream>>>(tw, tx, pl);
  return cudaGetLastError();
}

}  // namespace wstream
