// The projection stages of the two cooperative fusion kernels
// (w4a8_lowrank.cu's whole-MLP kernel, attn_o.cu's attention + o_proj): a
// W4A8 projection of B <= 32 activation rows (a stage may walk several
// tiles of 32 rows) with the CALDERA L half of its factors,
//
//   out[m, n] = (acc[m, n] * ws[n]) * sx[m] + ylr[m, n] * Ls[n],
//   ylr[m, n] = sum_r bf16(xr[m, window(n) * rank + r]) * L[n, r],
//
// both products on the tensor cores, fed by one weight stream per warp that
// runs across the launch's grid barriers.
//
// - The stream (megastep_proj.cuh's): each warp owns a ring of kDepth slabs
//   of 32 weight rows x 128 bytes in shared memory, filled by cp.async, and
//   issues the next slab of ITS sequence as soon as it has used one. A
//   stage's slabs are cut into W = CTAs x warps equal contiguous ranges, one
//   per warp, and a warp's sequence runs on from one stage into the next,
//   so the slabs of a stage behind a grid barrier are in flight while the
//   warp waits there (they depend on no activation).
// - A group (two 16-row tiles: 32 consecutive rows, or 16 gate rows and the
//   same 16 up rows) is nk slabs of packed codes and then nl = rank / 128
//   slabs of its L rows. Codes: mma.sync m16n8k32 s8 x s8 -> s32 on the
//   signed codes c - MAXQ (2, 4 bits; 8 bits as (u - 128) plus a product
//   with ones: u - 127 does not fit in s8), exact. L rows: mma.sync
//   m16n8k16 bf16 -> f32, the int8 L codes widened to bf16 exactly, xr
//   rounded to bf16 as the reference rounds it (staged in shared memory at
//   the stage's start where it fits). The L dots thus ride the same stream
//   as the weights (about 1/nk more bytes), and no phase of its own
//   computes them.
// - A group split between warps is summed through per-warp partial slots
//   (exact i32 codes; the f32 L sums of its one or two L-slab owners, added
//   in owner order) by the last warp to count itself on the group's counter,
//   which resets it, so a launch is deterministic for its grid and the
//   counters are zero again after it.
// - Where a warp walks many slabs (the whole-MLP kernel at 8-row tiles),
//   the x operands of the next slab are loaded into registers before the
//   current slab's products, so that their latency does not stall every
//   slab.
#pragma once

#include "megastep_proj.cuh"

namespace fproj {

using mproj::kKC;
using mproj::kSlabBytes;
using mproj::kTileBytes;
using mproj::kTileRows;
constexpr int kDepth = 3;
constexpr int kWarpRing = kDepth * kSlabBytes;  // a warp's ring
constexpr int kMaxStages = 4;

// Dynamic shared memory of a CTA of `warps` warps: the rings from a
// 1024-byte boundary, then `win` bytes for a stage's xr windows (bf16).
__host__ __device__ constexpr int smem_bytes(int warps, int win) {
  return 1024 + warps * kWarpRing + win;
}

__device__ __forceinline__ int cta_warps() { return blockDim.x >> 5; }

// One projection of a launch.
struct Stage {
  const uint8_t* w;   // packed codes of the layer, rows of P bytes
  const int8_t* L;    // L codes of the layer, rows of rank bytes
  const float* ws;    // row scales, L scales
  const float* Ls;
  const int8_t* x;    // int8 activations, rows of K codes
  const float* xr;    // xr rows of ldxr floats; window i at xr + i * rank
  int P, nk, nl;      // packed bytes of a row; code slabs, L slabs a group
  int groups;         // groups of one activation tile
  int half;           // 0: group g is rows 32 g ..; else rows 16 g .. and
                      // half + 16 g .. (gate and up), windows 0 and 1
  int mtiles, rows;   // activation tiles of MT rows; activation rows
  int K, ldxr, rank;
  int cg;             // x and xr were written by this launch (read from L2)
};

// The stages of a launch, in stream order, as a __grid_constant__
// parameter (read through the constant cache, never local memory).
struct Plan {
  Stage st[kMaxStages];
  int nst;
};

__device__ __forceinline__ int per_group(const Stage& d) { return d.nk + d.nl; }

__device__ __forceinline__ int stage_slabs(const Stage& d) {
  return d.mtiles * d.groups * per_group(d);
}

__device__ __forceinline__ void group_rows(const Stage& d, int g, int& r0,
                                           int& r1) {
  if (d.half == 0) {
    r0 = 32 * g;
    r1 = r0 + kTileRows;
  } else {
    r0 = kTileRows * g;
    r1 = d.half + r0;
  }
}

// First slab of warp w's range of S slabs cut W ways, and the warp whose
// range holds slab s (megastep_proj.cuh's, in 32-bit arithmetic: the
// launches check S * W < 2^32).
__device__ __forceinline__ int range_lo(int S, int w, int W) {
  return (int)((unsigned)S * (unsigned)w / (unsigned)W);
}
__device__ __forceinline__ int owner(int s, int S, int W) {
  return (int)(((unsigned)(s + 1) * (unsigned)W - 1u) / (unsigned)S);
}

// A warp's ring (kDepth slabs, nc consumed) and its issue cursor: stage si,
// slab s of the warp's range [s, hi) of it; n slabs issued so far.
struct Ring {
  uint8_t* buf;
  int nc;
};
struct Stream {
  int si, s, hi, n, lo;
};

__device__ __forceinline__ void stream_seek(Stream& q, const Plan& pl, int w,
                                            int W) {
  for (; q.si < pl.nst; ++q.si) {
    const int S = stage_slabs(pl.st[q.si]);
    q.s = q.lo = range_lo(S, w, W);
    q.hi = range_lo(S, w + 1, W);
    if (q.s < q.hi) return;
  }
}

// Called by the whole warp once slot n % kDepth is free: copy the cursor's
// slab (32 rows x 128 bytes of codes or of L rows, in the 128-byte swizzle
// the consumers read: chunk k of row r at chunk k ^ (r % 8); zeros past a
// row's end) and, at a group's first slab, prefetch the scales of its rows
// into L2; then advance the cursor. Each call commits one copy group (an
// empty one past the end), so that slab n is always group n.
__device__ __forceinline__ void stream_issue(Stream& q, const Plan& pl,
                                             Ring& rg, int w, int W) {
  const int lane = threadIdx.x & 31;
  if (q.si < pl.nst) {
    const Stage& d = pl.st[q.si];
    const int per = per_group(d);
    const int G = q.s / per, c = q.s - G * per;
    int r0, r1;
    group_rows(d, G % d.groups, r0, r1);
    const bool code = c < d.nk;
    const uint8_t* base = code ? d.w : reinterpret_cast<const uint8_t*>(d.L);
    const int ld = code ? d.P : d.rank;
    const int col = (code ? c : c - d.nk) * kKC + 16 * (lane & 7);
    const int bytes = col < ld ? 16 : 0;
    uint8_t* dst = rg.buf + (q.n % kDepth) * kSlabBytes;
#pragma unroll
    for (int u = 0; u < kSlabBytes / 16 / 32; ++u) {
      const int i = lane + 32 * u, tl = i / (kTileBytes / 16);
      const int rr = (i >> 3) % kTileRows;
      mproj::cp_async16(
          dst + tl * kTileBytes + rr * kKC + (((lane & 7) ^ (rr & 7)) << 4),
          base + (size_t)((tl ? r1 : r0) + rr) * ld + (bytes ? col : 0),
          bytes);
    }
    if (lane < 4 && (c == 0 || q.s == q.lo))
      mproj::prefetch_line((lane < 2 ? d.ws : d.Ls) + (lane & 1 ? r1 : r0));
    ++q.n;
    if (++q.s == q.hi) {
      ++q.si;
      stream_seek(q, pl, w, W);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Set up the calling warp's ring in `ring` (the CTA's) and issue its first
// kDepth slabs.
__device__ __forceinline__ void stream_start(const Plan& pl, uint8_t* ring,
                                             Ring& rg, Stream& q) {
  const int warp = threadIdx.x >> 5, nw = cta_warps();
  const int W = gridDim.x * nw, w = blockIdx.x * nw + warp;
  rg = Ring{ring + warp * kWarpRing, 0};
  q = Stream{0, 0, 0, 0, 0};
  stream_seek(q, pl, w, W);
  for (int i = 0; i < kDepth; ++i) stream_issue(q, pl, rg, w, W);
}

// D (16 x 8, f32) += A (16 x 16, bf16, row) * B (16 x 8, bf16, col).
__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0,
                                         unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// bf16(r_B), bf16(r_{B+1}) of the signed bytes B, B + 1 of word w, in one
// register (byte B low): r + 128 under the exponent of 2^23, less 2^23 +
// 128, is r exactly, and bf16 holds every int8 value.
template <int B>
__device__ __forceinline__ unsigned widen2(unsigned w) {
  constexpr float kOff = 8388608.f + 128.f;
  const unsigned u = w ^ 0x80808080u;
  const float lo = __fsub_rn(
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + B)), kOff);
  const float hi = __fsub_rn(
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541 + B)), kOff);
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The activation words of one code slab, as slab_codes reads them: plane
// p, half q (64-byte segment) and n-fragment f of the lane's row g8 and
// chunk t: 16 bytes at k = p P + c 128 + 64 q + 16 t of row 8 f + g8 (rows
// of ldx bytes), zero past the row's end or the tile's rows; cg: x was
// written by this launch (read from L2), else the read-only path.

template <int BITS, int NF>
struct XFrag {
  uint4 v[8 / BITS][2][NF];
};

__device__ __forceinline__ uint4 x_words(const int8_t* x, int ldx, int P,
                                         int c, int q, int p, int m,
                                         int rows, bool cg) {
  const int t = threadIdx.x & 3;
  const int j = c * kKC + 64 * q + 16 * t;
  if (j >= P || m >= rows) return make_uint4(0u, 0u, 0u, 0u);
  const uint4* src =
      reinterpret_cast<const uint4*>(x + (size_t)m * ldx + (size_t)p * P + j);
  return cg ? __ldcg(src) : __ldg(src);
}

template <int BITS, int NF>
__device__ __forceinline__ void load_x(XFrag<BITS, NF>& xf, const int8_t* x,
                                       int ldx, int P, int c, int rows,
                                       bool cg) {
  const int g8 = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int p = 0; p < 8 / BITS; ++p)
#pragma unroll
      for (int f = 0; f < NF; ++f)
        xf.v[p][q][f] = x_words(x, ldx, P, c, q, p, 8 * f + g8, rows, cg);
}

// One code slab's products (chunk c of the group's rows, megastep_proj's
// slab_mma with the activations in registers when PRE, else loaded here):
// lane (g8, t) reads the 16-byte chunk t of each 64-byte segment of rows
// smem_row(g8) and + 8 of both tiles; its four words are the k of two mma
// steps, and the activation words of the same k come in one 16-byte load.
template <int BITS, int MT, bool PRE>
__device__ __forceinline__ void slab_codes(const uint8_t* sl,
                                           const XFrag<BITS, MT / 8>& xf,
                                           const int8_t* x, int ldx, int P,
                                           int c, int rows, bool cg,
                                           int (&acc)[2][MT / 8][4]) {
  constexpr int F = 8 / BITS;
  constexpr int NF = MT / 8;
  const int lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t = lane & 3;
  const int ra = mproj::smem_row(g8);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int off = ((4 * q + t) ^ ra) << 4;
    uint4 u[2], v[2];
#pragma unroll
    for (int tl = 0; tl < 2; ++tl) {
      u[tl] = *reinterpret_cast<const uint4*>(sl + tl * kTileBytes +
                                              ra * kKC + off);
      v[tl] = *reinterpret_cast<const uint4*>(sl + tl * kTileBytes +
                                              (ra + 8) * kKC + off);
    }
#pragma unroll
    for (int p = 0; p < F; ++p) {
      uint4 xb[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f)
        xb[f] = PRE ? xf.v[p][q][f]
                    : x_words(x, ldx, P, c, q, p, 8 * f + g8, rows, cg);
#pragma unroll
      for (int tl = 0; tl < 2; ++tl) {
        const unsigned w0[4] = {u[tl].x, v[tl].x, u[tl].y, v[tl].y};
        const unsigned w1[4] = {u[tl].z, v[tl].z, u[tl].w, v[tl].w};
        unsigned a[4], e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // 8-bit: the signed byte u - 128 (and 1 x below)
          a[i] = BITS == 8 ? w0[i] ^ 0x80808080u : mproj::scodes<BITS>(w0[i], p);
          e[i] = BITS == 8 ? w1[i] ^ 0x80808080u : mproj::scodes<BITS>(w1[i], p);
        }
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          mproj::mma_s8(acc[tl][f], a[0], a[1], a[2], a[3], xb[f].x, xb[f].y);
          mproj::mma_s8(acc[tl][f], e[0], e[1], e[2], e[3], xb[f].z, xb[f].w);
          if (BITS == 8) {
            constexpr unsigned k1 = 0x01010101u;
            mproj::mma_s8(acc[tl][f], k1, k1, k1, k1, xb[f].x, xb[f].y);
            mproj::mma_s8(acc[tl][f], k1, k1, k1, k1, xb[f].z, xb[f].w);
          }
        }
      }
    }
  }
}

// One L slab's products (ranks cl 128 .. of the group's rows): the lane's
// 16 bytes of a 64-byte segment q are four k16 steps; in step s the lane's
// logical k (2t, 2t + 1 | 2t + 8, 2t + 9) are ranks 64 q + 16 t + 4 s + (0,
// 1 | 2, 3), for the L codes (A, rows smem_row(g8) and + 8) and for xr (B,
// activation row 8 f + g8 of the tile's window) alike.
template <int MT>
__device__ __forceinline__ void slab_l(const uint8_t* sl, const Stage& d,
                                       int mt, int cl, const uint16_t* win,
                                       float (&accl)[2][MT / 8][4]) {
  constexpr int NF = MT / 8;
  const int lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t = lane & 3;
  const int ra = mproj::smem_row(g8);
  const int rows = d.rows - mt * MT;
  const bool two = d.half != 0;  // tile 1 reads window 1
  const int mp = d.mtiles * MT;  // rows of a staged window
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int off = ((4 * q + t) ^ ra) << 4;
    uint4 u[2], v[2];
#pragma unroll
    for (int tl = 0; tl < 2; ++tl) {
      u[tl] = *reinterpret_cast<const uint4*>(sl + tl * kTileBytes +
                                              ra * kKC + off);
      v[tl] = *reinterpret_cast<const uint4*>(sl + tl * kTileBytes +
                                              (ra + 8) * kKC + off);
    }
    // B: the lane's xr row of each fragment, 16 ranks of segment q
    const int r0 = cl * kKC + 64 * q + 16 * t;
    const float* xq = d.xr + (size_t)mt * MT * d.ldxr + r0;
    const unsigned uw[2][4] = {{u[0].x, u[0].y, u[0].z, u[0].w},
                               {u[1].x, u[1].y, u[1].z, u[1].w}};
    const unsigned vw[2][4] = {{v[0].x, v[0].y, v[0].z, v[0].w},
                               {v[1].x, v[1].y, v[1].z, v[1].w}};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int m = 8 * f + g8;
        unsigned b[2][2];
#pragma unroll
        for (int wi = 0; wi < 2; ++wi) {
          if (wi == 1 && !two) {
            b[1][0] = b[1][1] = 0u;
          } else if (win != nullptr) {  // bf16 in shared memory, zeros past rows
            const uint2 bw = *reinterpret_cast<const uint2*>(
                win + ((size_t)(wi * mp + mt * MT + m)) * d.rank + r0 + 4 * s);
            b[wi][0] = bw.x;
            b[wi][1] = bw.y;
          } else {
            const float4* src = reinterpret_cast<const float4*>(
                xq + (size_t)m * d.ldxr + wi * d.rank) + s;
            const float4 bb = m >= rows ? make_float4(0.f, 0.f, 0.f, 0.f)
                              : d.cg ? __ldcg(src)
                                     : __ldg(src);
            b[wi][0] = bf16x2(bb.x, bb.y);
            b[wi][1] = bf16x2(bb.z, bb.w);
          }
        }
#pragma unroll
        for (int tl = 0; tl < 2; ++tl) {
          const int wi = tl == 1 && two ? 1 : 0;
          mma_bf16(accl[tl][f], widen2<0>(uw[tl][s]), widen2<0>(vw[tl][s]),
                   widen2<2>(uw[tl][s]), widen2<2>(vw[tl][s]), b[wi][0],
                   b[wi][1]);
        }
      }
    }
  }
}

// Stage d's xr windows as bf16 into the CTA's win (wbytes of shared
// memory): window i of activation row m (of mtiles x MT, zeros past the
// rows) at win + (i mp + m) rank. Returns win, or null (nothing staged)
// when they do not fit. Every thread of the CTA calls it.
template <int MT>
__device__ __forceinline__ const uint16_t* stage_windows(const Stage& d,
                                                         uint16_t* win,
                                                         int wbytes) {
  const int nwin = d.half ? 2 : 1, mp = d.mtiles * MT;
  const int n4 = nwin * mp * d.rank / 4;  // groups of four values
  if (win == nullptr || n4 * 8 > wbytes) return nullptr;
  __syncthreads();  // every warp is done with the previous stage's windows
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    const int r = 4 * i % d.rank, wm = 4 * i / d.rank;
    const int wi = wm / mp, m = wm - wi * mp;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m < d.rows) {
      const float4* src = reinterpret_cast<const float4*>(
          d.xr + (size_t)m * d.ldxr + wi * d.rank + r);
      v = d.cg ? __ldcg(src) : __ldg(src);
    }
    *reinterpret_cast<uint2*>(win + 4 * (size_t)i) =
        make_uint2(bf16x2(v.x, v.y), bf16x2(v.z, v.w));
  }
  __syncthreads();
  return win;
}

// A group split between warps: store this warp's partials (i32 codes, f32
// L sums) in its slot (0 for the first group of its range, 1 for the last),
// count it on the group's counter; false unless this warp is the last
// contributor, which resets the counter and sums every contributor's
// partials in owner order (the i32 exactly; the f32 of the L-slab owners,
// the others' being zeros). Contributors: from the owner of the group's
// first slab, each next one owns the slab after the previous one's range.
template <int MT>
__device__ __forceinline__ bool split_sum(int (&acc)[2][MT / 8][4],
                                          float (&accl)[2][MT / 8][4],
                                          int4* pws, int* cnt, int G, int per,
                                          int S, int W, int w) {
  constexpr int NF = MT / 8;
  constexpr int kSlot = 2 * 2 * NF * 32;  // int4s: i32 then f32 partials
  const int lane = threadIdx.x & 31;
  const int g0 = G * per, g1 = g0 + per;
  // slot 0 unless the group is not the first of ww's range: only the
  // owner of its first slab can have begun its range before it
  auto slot = [&](int ww) {
    const bool first = ww != owner(g0, S, W) || range_lo(S, ww, W) == g0;
    return pws + ((size_t)ww * 2 + (first ? 0 : 1)) * kSlot;
  };
  int4* mine = slot(w);
#pragma unroll
  for (int tl = 0; tl < 2; ++tl)
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      mine[(tl * NF + f) * 32 + lane] = make_int4(
          acc[tl][f][0], acc[tl][f][1], acc[tl][f][2], acc[tl][f][3]);
      mine[((2 + tl) * NF + f) * 32 + lane] = make_int4(
          __float_as_int(accl[tl][f][0]), __float_as_int(accl[tl][f][1]),
          __float_as_int(accl[tl][f][2]), __float_as_int(accl[tl][f][3]));
    }
  // the warp's stores, then one lane's count, an acquire-release atomic:
  // the last contributor's reads come after every other's stores
  __syncwarp();
  // contributors: with S >= W every warp's range is nonempty, so they are
  // the owners of the group's first and last slabs and every warp between
  const bool dense = S >= W;
  const int w0 = owner(g0, S, W), w1 = owner(g1 - 1, S, W);
  int last = 0;
  if (lane == 1) {
    int n = w1 - w0 + 1;
    if (!dense) {
      n = 0;
      for (int s = g0; s < g1; s = range_lo(S, owner(s, S, W) + 1, W)) ++n;
    }
    int old;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(cnt + G)
                 : "memory");
    last = old == n - 1;
    if (last) cnt[G] = 0;
  }
  last = __shfl_sync(0xffffffffu, last, 1);
  if (!last) return false;
  __syncwarp();
#pragma unroll
  for (int tl = 0; tl < 2; ++tl)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[tl][f][e] = 0;
        accl[tl][f][e] = 0.f;
      }
  // the contributors kB at a time: every load of a batch in flight at once
  // (one L2 round trip a batch, not one a contributor), added in order
  constexpr int kB = NF == 1 ? 4 : 1;
  const int nc = dense ? w1 - w0 + 1 : 0;
  for (int s = g0, k = 0; dense ? k < nc : s < g1;) {
    int ws[kB];
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      ws[b] = -1;
      if (dense) {
        if (k < nc) ws[b] = w0 + k++;
      } else if (s < g1) {
        ws[b] = owner(s, S, W);
        s = range_lo(S, ws[b] + 1, W);
      }
    }
    int4 v[kB][2][NF], l[kB][2][NF];
#pragma unroll
    for (int b = 0; b < kB; ++b)
#pragma unroll
      for (int tl = 0; tl < 2; ++tl)
#pragma unroll
        for (int f = 0; f < NF; ++f)
          if (ws[b] >= 0) {
            const int4* p = slot(ws[b]);
            v[b][tl][f] = __ldcg(p + (tl * NF + f) * 32 + lane);
            l[b][tl][f] = __ldcg(p + ((2 + tl) * NF + f) * 32 + lane);
          }
#pragma unroll
    for (int b = 0; b < kB; ++b)
#pragma unroll
      for (int tl = 0; tl < 2; ++tl)
#pragma unroll
        for (int f = 0; f < NF; ++f)
          if (ws[b] >= 0) {
            acc[tl][f][0] += v[b][tl][f].x;
            acc[tl][f][1] += v[b][tl][f].y;
            acc[tl][f][2] += v[b][tl][f].z;
            acc[tl][f][3] += v[b][tl][f].w;
            accl[tl][f][0] =
                __fadd_rn(accl[tl][f][0], __int_as_float(l[b][tl][f].x));
            accl[tl][f][1] =
                __fadd_rn(accl[tl][f][1], __int_as_float(l[b][tl][f].y));
            accl[tl][f][2] =
                __fadd_rn(accl[tl][f][2], __int_as_float(l[b][tl][f].z));
            accl[tl][f][3] =
                __fadd_rn(accl[tl][f][3], __int_as_float(l[b][tl][f].w));
          }
  }
  return true;
}

// out of one accumulator: (acc * ws) * sx + ylr * Ls, each product and the
// add rounded on its own, as lowrank::lr_tile rounds them.
__device__ __forceinline__ float finish(int acc, float ylr, float ws, float sx,
                                        float Ls) {
  return __fadd_rn(__fmul_rn(__fmul_rn((float)acc, ws), sx),
                   __fmul_rn(ylr, Ls));
}

// Stage si for this warp (every thread of the CTA calls it; wsmem: wbytes
// of the CTA's shared memory for the stage's xr windows): its slabs, the
// products of each group in its range, the split sums, and epi(G, mt, g,
// acc, accl) for each group this warp finishes (accumulator e of fragment (tl, f): weight row smem_row(g8)
// + 8 (e >> 1) of tile tl, activation row 8 f + 2 t + (e & 1) of tile mt).
// After each slab the warp issues the next slab of its stream into the
// freed slot. PRE: the x words of the next slab are loaded before the
// current slab's products (a help where a warp walks many slabs).
template <int BITS, int MT, bool PRE, typename Epi>
__device__ __forceinline__ void run_stage(const Plan& pl, int si, Stream& q,
                                          Ring& rg, int4* pws, int* cnt,
                                          uint16_t* wsmem, int wbytes,
                                          Epi&& epi) {
  constexpr int NF = MT / 8;
  const int warp = threadIdx.x >> 5, nw = cta_warps();
  const int W = gridDim.x * nw, w = blockIdx.x * nw + warp;
  const Stage& d = pl.st[si];
  const int per = per_group(d);
  const int S = stage_slabs(d);
  const int lo = range_lo(S, w, W), hi = range_lo(S, w + 1, W);
  const bool cg = d.cg != 0;
  XFrag<BITS, NF> xf;
  auto fetch = [&](int s, XFrag<BITS, NF>& dst) {
    const int G = s / per, c = s - G * per, mt = G / d.groups;
    if (c < d.nk)
      load_x<BITS, NF>(dst, d.x + (size_t)mt * MT * d.K, d.K, d.P, c,
                       d.rows - mt * MT, cg);
  };
  if (PRE && lo < hi) fetch(lo, xf);  // in flight while the windows load
  const uint16_t* win = stage_windows<MT>(d, wsmem, wbytes);
  for (int s = lo; s < hi;) {
    const int G = s / per, g0 = G * per;
    const int mt = G / d.groups;
    const int end = min(hi, g0 + per);
    const int8_t* xm = d.x + (size_t)mt * MT * d.K;
    const int rows = d.rows - mt * MT;
    int acc[2][NF][4];
    float accl[2][NF][4];
#pragma unroll
    for (int tl = 0; tl < 2; ++tl)
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[tl][f][i] = 0;
          accl[tl][f][i] = 0.f;
        }
    for (; s < end; ++s) {
      const int c = s - g0;
      XFrag<BITS, NF> nxt;
      if (PRE && s + 1 < hi) fetch(s + 1, nxt);
      const int slot = rg.nc % kDepth;
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kDepth - 1) : "memory");
      __syncwarp();  // every lane's copies of slab nc have landed
      const uint8_t* sl = rg.buf + slot * kSlabBytes;
      if (c < d.nk)
        slab_codes<BITS, MT, PRE>(sl, xf, xm, d.K, d.P, c, rows, cg, acc);
      else
        slab_l<MT>(sl, d, mt, c - d.nk, win, accl);
      ++rg.nc;
      __syncwarp();
      stream_issue(q, pl, rg, w, W);
      if (PRE) xf = nxt;
    }
    if (!(lo <= g0 && end == g0 + per) &&
        !split_sum<MT>(acc, accl, pws, cnt, G, per, S, W, w))
      continue;
    epi(G, mt, G - mt * d.groups, acc, accl);
  }
}

// Prefetch `bytes` at p into L2, spread over the grid's threads.
__device__ __forceinline__ void prefetch_grid(const void* p, size_t bytes) {
  const char* c = static_cast<const char*>(p);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < (bytes + 127) / 128; i += (size_t)gridDim.x * blockDim.x)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(c + 128 * i));
}

// The int8 code of v at row scale s (round half to even, clip 127).
__device__ __forceinline__ int8_t code8(float v, float s) {
  return (int8_t)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
}


// Whether every stage of pl cut over `warps` warps keeps range_lo and
// owner in 32 bits (S * W < 2^32).
inline bool fits32(const Plan& pl, long long warps) {
  for (int i = 0; i < pl.nst; ++i) {
    const Stage& d = pl.st[i];
    const long long S = (long long)d.mtiles * d.groups * (d.nk + d.nl);
    if (S * warps >= (1ll << 32)) return false;
  }
  return true;
}

}  // namespace fproj
