// The projection stages of the whole-step megakernel (megastep.cuh): the
// W4A8 products of q/k/v, o, gate/up and down with their L epilogue, on the
// tensor cores, fed by a weight stream that never stops.
//
// Bound: a projection stage reads its packed codes once (25 MB for q/k/v at
// Llama-2-7B, 4-bit), against B <= 32 activation rows, so it is bound by
// device-memory bytes; at 8 activation rows an __dp4a design also spends
// about as many integer operations as the card can do in that time. Here:
//
// - Products: mma.sync m16n8k32 s8 x s8 -> s32. A is 16 weight rows, B the
//   activation rows (n 8; four n-8 fragments at 32 rows). In the row-global
//   plane layout (byte j of a packed row holds k = j + p K / F of plane p at
//   shift BITS (F - 1 - p)), one shift and one mask of a 32-bit word give
//   four codes of one plane at consecutive k, which meet the activation word
//   of the same four k. The codes become signed (c - MAXQ, a byte-parallel
//   subtract), so the i32 sums are rowdot.cuh's acc - MAXQ rowsum(x) with no
//   row sum: exact, as every integer sum here.
// - The stream: each warp owns a ring of kDepth slabs in shared memory (a
//   slab is 32 weight rows x 128 packed bytes, two 16-row tiles in the
//   128-byte swizzle) and keeps kDepth slabs in flight with cp.async (each
//   lane eight 16-byte copies a slab, one commit group a slab): as soon as
//   it has used one it issues the next slab of ITS sequence, which runs on
//   through every projection stage of every layer. Weights do not depend on
//   activations, so the next stage's first slabs are already in flight when
//   the warp reaches a grid barrier, and land during the stages that read
//   no weights (attention, norms, thin factor dots).
// - Every CTA busy: a stage's slabs (groups of 32 rows x chunks of 128
//   bytes, group-major) are cut into W = grid x 8 equal contiguous ranges,
//   one per warp. A group split between warps is summed through per-warp
//   partial slots (exact i32, any order) by the last warp to arrive on the
//   group's counter, which resets it; that warp, or the warp that owns the
//   whole group, runs the epilogue.
// - The L dots (sum_r bf16(xr) L) do not depend on the products: every warp
//   computes an even share of a stage's at its start (ylr_phase), with
//   lowrank::lr_tile's f32 arithmetic in its order (each output summed per
//   lane over k = lane + 32 i, then the same warp tree, as a reduce-scatter:
//   each lane ends with one output). The warp that finishes a group only
//   combines them with its totals (epilogue), the multiplies and the add
//   rounded one by one as lr_tile rounds them.
#pragma once

#include "hopper_gemm.cuh"
#include "lowrank.cuh"

namespace mproj {

constexpr int kWarps = rowdot::kWarps;
constexpr int kKC = 128;                 // packed bytes of a weight row per slab
constexpr int kTileRows = 16;            // rows of an mma tile
constexpr int kTileBytes = kTileRows * kKC;
constexpr int kSlabBytes = 2 * kTileBytes;
constexpr int kDepth = 3;                // slabs in flight per warp
constexpr int kRingBytes = kWarps * kDepth * kSlabBytes;
// each warp's scratch (a group's totals, its share of a stage's L rows)
constexpr int kWarpScratch = 8 * 1024;
// the CTA's copy of a stage's xr windows (bf16): 3 windows of 32 rows at
// rank 128
constexpr int kWinBytes = 24 * 1024;

// One projection of a layer, as the stream and the consumers see it.
struct StageDesc {
  int P;       // packed bytes of a weight row
  int nk;      // chunks of kKC bytes per row (the last one may be ragged)
  int groups;  // groups of two 16-row tiles
  int nrows;   // weight rows of one layer
  int bng;     // 0: group g is rows 32 g .. 32 g + 31; else the gate rows
               // of intermediate columns 16 g .. 16 g + 15 of blocks of bng
               // gate then bng up rows, and the same up rows
};

// Every projection of the launch: nst stages a layer, L layers. A kernel
// takes it as a __grid_constant__ parameter: indexed by the stage at run
// time, it is read through the constant cache. (Kept in local memory it
// was not: with ~221 KB of shared memory an SM keeps ~28 KB of L1, so the
// stack went to L2, about a microsecond a read under the stream's load.)
struct Plan {
  StageDesc st[4];
  const uint8_t* w[4];   // packed codes (layer 0) of each stage, rows of P
  const int8_t* Lf[4];   // L codes (layer 0) of each stage, rows x rank
  const float* ws[4];    // their row scales and L scales (layer 0)
  const float* Ls[4];
  int nst, L, rank;
};

__device__ __forceinline__ void group_rows(const StageDesc& d, int g, int& r0,
                                           int& r1) {
  if (d.bng == 0) {
    r0 = 32 * g;
    r1 = r0 + kTileRows;
  } else {
    const int i0 = kTileRows * g;
    r0 = 2 * (i0 / d.bng) * d.bng + i0 % d.bng;
    r1 = r0 + d.bng;
  }
}

// First slab of warp w's range of S slabs cut W ways, and the warp whose
// range holds slab s.
__device__ __forceinline__ int range_lo(int S, int w, int W) {
  return (int)((long long)S * w / W);
}
__device__ __forceinline__ int owner(int s, int S, int W) {
  return (int)(((long long)(s + 1) * W - 1) / S);
}

// A warp's ring: kDepth slabs; nc slabs consumed so far.
struct Ring {
  uint8_t* buf;
  int nc;
};

// A warp's issue cursor over its slab sequence: layer l, stage si, slab s of
// the warp's range [s, hi); n slabs issued so far.
struct Stream {
  int l, si, s, hi, n;
};

__device__ __forceinline__ void stream_seek(Stream& q, const Plan& pl, int w,
                                            int W) {
  while (q.l < pl.L) {
    const int S = pl.st[q.si].groups * pl.st[q.si].nk;
    q.s = range_lo(S, w, W);
    q.hi = range_lo(S, w + 1, W);
    if (q.s < q.hi) return;
    if (++q.si == pl.nst) {
      q.si = 0;
      ++q.l;
    }
  }
}

// 16 bytes global -> shared, asynchronous; zeros where bytes is 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void prefetch_line(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Called by the whole warp once slot n % kDepth is free: the warp's lanes
// copy the cursor's slab into it (32 rows x 128 bytes, eight 16-byte
// copies a lane, in the 128-byte swizzle of the consumers' reads: chunk k
// of row r at chunk k ^ (r % 8); zeros past a row's end), and, at the
// first slab of a group, prefetch the group's L rows and scales into L2 for
// its epilogue; then every lane advances the cursor. Each call commits one
// copy group (an empty one past the end of the stream), so that slab n is
// always group n.
__device__ __forceinline__ void stream_issue(Stream& q, const Plan& pl,
                                             Ring& rg, int w, int W) {
  const int lane = threadIdx.x & 31;
  if (q.l < pl.L) {
    const StageDesc& d = pl.st[q.si];
    const int g = q.s / d.nk, c = q.s - g * d.nk;
    int r0, r1;
    group_rows(d, g, r0, r1);
    const size_t row = (size_t)q.l * d.nrows;
    const uint8_t* wl = pl.w[q.si] + row * d.P;
    uint8_t* dst = rg.buf + (q.n % kDepth) * kSlabBytes;
    const int k = lane & 7, col = c * kKC + 16 * k;
    const int bytes = col < d.P ? 16 : 0;
#pragma unroll
    for (int u = 0; u < kSlabBytes / 16 / 32; ++u) {
      const int i = lane + 32 * u, tl = i / (kTileBytes / 16);
      const int rr = (i >> 3) % kTileRows;
      cp_async16(dst + tl * kTileBytes + rr * kKC + ((k ^ (rr & 7)) << 4),
                 wl + (size_t)((tl ? r1 : r0) + rr) * d.P + (bytes ? col : 0),
                 bytes);
    }
    if (pl.ws[q.si] != nullptr && lane < 4 &&
        (c == 0 || q.s == range_lo(d.groups * d.nk, w, W)))
      prefetch_line((lane < 2 ? pl.ws[q.si] : pl.Ls[q.si]) + row +
                    (lane & 1 ? r1 : r0));  // the tiles' row and L scales
    ++q.n;
    if (++q.s == q.hi) {
      if (++q.si == pl.nst) {
        q.si = 0;
        ++q.l;
      }
      stream_seek(q, pl, w, W);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Set up the calling warp's ring at `ring` (the CTA's) and issue its first
// kDepth slabs.
__device__ __forceinline__ void stream_start(const Plan& pl, uint8_t* ring,
                                             Ring& rg, Stream& q) {
  const int warp = threadIdx.x >> 5;
  const int W = gridDim.x * kWarps, w = blockIdx.x * kWarps + warp;
  rg = Ring{ring + warp * kDepth * kSlabBytes, 0};
  q = Stream{0, 0, 0, 0, 0};
  stream_seek(q, pl, w, W);
  for (int i = 0; i < kDepth; ++i) stream_issue(q, pl, rg, w, W);
}

// Four codes of plane p of a packed word as signed bytes c - MAXQ.
template <int BITS>
__device__ __forceinline__ unsigned scodes(unsigned word, int p) {
  constexpr int F = 8 / BITS;
  constexpr unsigned kMask = ((1u << BITS) - 1u) * 0x01010101u;
  constexpr unsigned kMaxq = ((1u << (BITS - 1)) - 1u) * 0x01010101u;
  const unsigned c = ((word >> (BITS * (F - 1 - p))) & kMask) | 0x80808080u;
  return (c - kMaxq) ^ 0x80808080u;
}

// D (16 x 8, s32) += A (16 x 32, s8, row) * B (32 x 8, s8, col).
__device__ __forceinline__ void mma_s8(int (&d)[4], unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The shared-memory row of mma row g8 (and g8 + 8 -> that row + 8): rows g8
// and g8 + 1, which one quarter of the warp reads together, land on swizzle
// rows h and h + 4, whose 16-byte chunks take disjoint banks.
__device__ __forceinline__ int smem_row(int g8) {
  return (g8 >> 1) | ((g8 & 1) << 2);
}

// One slab's products: chunk c of the two tiles' rows against the B <= MT
// activation rows of x32 (int8, rows of kw words). Lane (g8, t) takes the
// 16-byte chunk t of each 64-byte segment of its rows: its four words are
// the k of two mma steps (a0/a2 the first two, for the rows of the mma's
// lower and upper halves), and the activation words of the same k come in
// one 16-byte load. Bytes past the row's end (the last chunk of a ragged
// row: the copies fill zeros, which the signed codes turn into -MAXQ) meet zero
// activations.
template <int BITS, int MT>
__device__ __forceinline__ void slab_mma(const uint8_t* sl, const int* x32,
                                         int kw, int P, int c, int B,
                                         int (&acc)[2][MT / 8][4]) {
  constexpr int F = 8 / BITS;
  constexpr int NF = MT / 8;
  const int lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t = lane & 3;
  const int ra = smem_row(g8);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int j = c * kKC + 64 * q + 16 * t;
    const int off = ((4 * q + t) ^ ra) << 4;
    uint4 u[2], v[2];
#pragma unroll
    for (int tl = 0; tl < 2; ++tl) {
      u[tl] = *reinterpret_cast<const uint4*>(sl + tl * kTileBytes + ra * kKC +
                                              off);
      v[tl] = *reinterpret_cast<const uint4*>(sl + tl * kTileBytes +
                                              (ra + 8) * kKC + off);
    }
    const bool live = j < P;
#pragma unroll
    for (int p = 0; p < F; ++p) {
      uint4 xb[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int m = 8 * f + g8;
        xb[f] = make_uint4(0u, 0u, 0u, 0u);
        if (live && m < B)
          xb[f] = __ldcg(reinterpret_cast<const uint4*>(
              x32 + (size_t)m * kw + (p * P + j) / 4));
      }
#pragma unroll
      for (int tl = 0; tl < 2; ++tl) {
        const unsigned a0 = scodes<BITS>(u[tl].x, p);
        const unsigned a1 = scodes<BITS>(v[tl].x, p);
        const unsigned a2 = scodes<BITS>(u[tl].y, p);
        const unsigned a3 = scodes<BITS>(v[tl].y, p);
#pragma unroll
        for (int f = 0; f < NF; ++f)
          mma_s8(acc[tl][f], a0, a1, a2, a3, xb[f].x, xb[f].y);
        const unsigned e0 = scodes<BITS>(u[tl].z, p);
        const unsigned e1 = scodes<BITS>(v[tl].z, p);
        const unsigned e2 = scodes<BITS>(u[tl].w, p);
        const unsigned e3 = scodes<BITS>(v[tl].w, p);
#pragma unroll
        for (int f = 0; f < NF; ++f)
          mma_s8(acc[tl][f], e0, e1, e2, e3, xb[f].z, xb[f].w);
      }
    }
  }
}

// Sum a group split between warps: store this warp's partial in its slot
// (0 for the first group of its range, 1 for the last), count it on the
// group's counter; false unless this warp is the last of the group's
// contributors, which resets the counter and sets acc to the sum of every
// contributor's partial (exact in any order). The contributors are the
// owners of the group's slabs: from the owner of its first slab, each next
// one owns the slab after the previous one's range (a stage of fewer slabs
// than warps leaves some warps' ranges empty).
template <int MT>
__device__ __forceinline__ bool split_sum(int (&acc)[2][MT / 8][4], int* pws,
                                          int* cnt, int g, int nk, int S,
                                          int W, int w) {
  constexpr int NF = MT / 8;
  const int lane = threadIdx.x & 31;
  const int g0 = g * nk, g1 = g0 + nk;
  auto slot = [&](int ww) {
    return reinterpret_cast<int4*>(pws) +
           ((size_t)ww * 2 + (g == range_lo(S, ww, W) / nk ? 0 : 1)) *
               (2 * NF * 32);
  };
  int4* mine = slot(w);
#pragma unroll
  for (int tl = 0; tl < 2; ++tl)
#pragma unroll
    for (int f = 0; f < NF; ++f)
      mine[(tl * NF + f) * 32 + lane] = make_int4(
          acc[tl][f][0], acc[tl][f][1], acc[tl][f][2], acc[tl][f][3]);
  // the warp's stores, then one lane's count, an acquire-release atomic:
  // the last contributor's reads come after every other's stores
  __syncwarp();
  int last = 0;
  if (lane == 1) {
    int n = 0;
    for (int s = g0; s < g1; s = range_lo(S, owner(s, S, W) + 1, W)) ++n;
    int old;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(cnt + g)
                 : "memory");
    last = old == n - 1;
    if (last) cnt[g] = 0;
  }
  last = __shfl_sync(0xffffffffu, last, 1);
  if (!last) return false;
  __syncwarp();
#pragma unroll
  for (int tl = 0; tl < 2; ++tl)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[tl][f][e] = 0;
  for (int s = g0; s < g1;) {
    const int ww = owner(s, S, W);
    const int4* p = slot(ww);
#pragma unroll
    for (int tl = 0; tl < 2; ++tl)
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int4 v = __ldcg(p + (tl * NF + f) * 32 + lane);
        acc[tl][f][0] += v.x;
        acc[tl][f][1] += v.y;
        acc[tl][f][2] += v.z;
        acc[tl][f][3] += v.w;
      }
    s = range_lo(S, ww + 1, W);
  }
  return true;
}

// A group's totals into the warp's scratch: tot[r * MT + m] for its 32 rows
// (tile 0 rows 0..15, tile 1 rows 16..31) and MT activation rows.
template <int MT>
__device__ __forceinline__ void store_totals(const int (&acc)[2][MT / 8][4],
                                             int* tot) {
  const int lane = threadIdx.x & 31;
  const int ra = smem_row(lane >> 2), t = lane & 3;
  __syncwarp();  // the previous group's epilogue is done with tot
#pragma unroll
  for (int tl = 0; tl < 2; ++tl)
#pragma unroll
    for (int f = 0; f < MT / 8; ++f)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * f + 2 * t + e;
        tot[(tl * kTileRows + ra) * MT + m] = acc[tl][f][e];
        tot[(tl * kTileRows + ra + 8) * MT + m] = acc[tl][f][2 + e];
      }
  __syncwarp();
}

// What a stage's epilogue does with out[m, n].
enum EpiMode : int {
  kEpiStore = 0,   // out[m, n] = out * gain[n / pw] (q/k/v)
  kEpiAccum = 1,   // out[m, n] += out * gain[0] (x after o and down)
  kEpiGateUp = 2,  // gate/up groups: m = silu(gate * gain[0]) * (up *
                   // gain[1]) into out, the group's absmax of |m| into part
  kEpiSums = 3,    // the i32 totals into sums (N, B): card tests
};

struct Epi {
  int mode;
  const float* ws;   // the layer's row scales, L codes (rows x rank), L scales
  const int8_t* L;
  const float* Ls;
  const float* xr;   // xr: window p of a row at xr + p * rank, rows of ldxr
  int ldxr;
  const float* sx;   // the activation rows' scales
  float* out;        // rows of ldo
  int ldo;
  float gain[3];
  int pw;            // kEpiStore: rows of one projection
  float* part;       // kEpiGateUp: (groups, B) absmax partials
  int* sums;         // kEpiSums
  float* ylr;        // (rows, B): the L dots of the stage's rows
  int* done;         // per warp: the last stage (seq) whose L dots it wrote
  int seq;           // this stage's: 4 l + si + 1
};

// Reduce 32 per-lane values of 32 outputs so that lane i ends with output
// i: recursive halving over the lane offsets 16, 8, 4, 2, 1. Each output's
// sum pairs the lanes as lowrank::warp_sum_f's butterfly does (lanes i and
// i ^ 16 first, ..., i and i ^ 1 last), so it is the butterfly's value bit
// for bit, for 31 shuffles instead of 32 x 5.
template <int N>
__device__ __forceinline__ void halve(float (&v)[32], int lane) {
  const bool hi = lane & N;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float send = hi ? v[j] : v[j + N];
    const float keep = hi ? v[j + N] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, N);
  }
}

__device__ __forceinline__ float reduce_scatter32(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0];
}

// The window of xr that row n of stage d's weights reads: its projection's
// (q/k/v), gate's or up's (gate/up), else the only one.
__device__ __forceinline__ int window_of(const Epi& e, const StageDesc& d,
                                         int n) {
  if (e.mode == kEpiStore) return n / e.pw;
  if (e.mode == kEpiGateUp) return n % (2 * d.bng) >= d.bng;
  return 0;
}

// The L dots of the stage's rows, spread evenly over the grid's warps:
// e.ylr[n * B + m] = sum_k bf16(xr[m, k]) * L[n, k] (the row's window of
// xr) for the rows of this warp's chunks of 4 (chunks c0 .. c1 - 1 of the
// stage's rows / 4 cut W ways), then the warp sets its flag e.done[w].
// They do not depend on the W4A8 products, so every warp does its share
// before its slabs, and the warp that finishes a group only combines.
// The CTA first copies the stage's windows (nw of them, B rows each) into
// wcta as bf16, once for its 8 warps (every warp would otherwise read the
// same bytes from L2), where they fit (wcta null: they are read from
// global memory in the dots). Activation rows go 8 at a time: lane i takes
// row i / 8 of the chunk and activation row i % 8, sums its part of every
// output's L dot over k = lane + 32 j as lowrank::lr_tile does, and
// reduce_scatter32 (the same tree as lr_tile's warp sum) hands it its own.
// The warp's L rows sit in scr where they fit. Every thread of the CTA
// calls it.
template <int MT>
__device__ __forceinline__ void ylr_phase(const Epi& e, const StageDesc& d,
                                          int B, int rank, uint8_t* scr,
                                          __nv_bfloat16* wcta) {
  constexpr int MC = 8, RC = 4;
  const int lane = threadIdx.x & 31;
  const int W = gridDim.x * kWarps, w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int nw = e.mode == kEpiStore ? 3 : e.mode == kEpiGateUp ? 2 : 1;
  if (nw * B * rank * 2 > kWinBytes) wcta = nullptr;
  if (wcta != nullptr) {
    const int r4 = rank / 4;
    for (int i = threadIdx.x; i < nw * B * r4; i += kWarps * 32) {
      const int wm = i / r4, k = 4 * (i - wm * r4);  // wm = wi * B + m
      const int wi = wm / B, m = wm - wi * B;
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
          e.xr + wi * rank + (size_t)m * e.ldxr + k));
      __nv_bfloat162* dv =
          reinterpret_cast<__nv_bfloat162*>(wcta + (size_t)wm * rank + k);
      dv[0] = __floats2bfloat162_rn(v.x, v.y);
      dv[1] = __floats2bfloat162_rn(v.z, v.w);
    }
  }
  const int C = d.nrows / RC;
  const int c0 = range_lo(C, w, W), c1 = range_lo(C, w + 1, W);
  const int rr0 = lane / MC, mm = lane % MC;
  int8_t* Lr = reinterpret_cast<int8_t*>(scr);
  const int8_t* Lg = e.L + (size_t)RC * c0 * rank;
  const bool staged =
      RC * (c1 - c0) * rank <= kWarpScratch - 32 * MT * 4;
  if (staged) {  // this warp's L rows, contiguous
    const uint4* src = reinterpret_cast<const uint4*>(Lg);
    const int n16 = RC * (c1 - c0) * rank / 16;
    for (int i0 = lane; i0 < n16; i0 += 8 * 32) {
      uint4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (i0 + 32 * u < n16) v[u] = __ldg(src + i0 + 32 * u);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (i0 + 32 * u < n16) reinterpret_cast<uint4*>(Lr)[i0 + 32 * u] = v[u];
    }
  }
  __syncthreads();  // the windows, and each warp's L rows
  for (int m0 = 0; m0 < B; m0 += MC) {
    for (int c = c0; c < c1; ++c) {
      const int n0 = RC * c;
      const int wi = window_of(e, d, n0);
      const float* xw = e.xr + wi * rank;
      float part[32];
#pragma unroll
      for (int o = 0; o < 32; ++o) part[o] = 0.f;
      for (int k = lane; k < rank; k += 32) {
        float lv[RC], wv[MC];
#pragma unroll
        for (int rr = 0; rr < RC; ++rr) {
          const size_t off = (size_t)(n0 - RC * c0 + rr) * rank + k;
          lv[rr] = (float)(staged ? Lr[off] : __ldg(Lg + off));
        }
#pragma unroll
        for (int j = 0; j < MC; ++j)
          wv[j] = m0 + j >= B ? 0.f
                  : wcta != nullptr
                      ? __bfloat162float(wcta[(wi * B + m0 + j) * rank + k])
                      : lowrank::bf16r(
                            __ldcg(xw + (size_t)(m0 + j) * e.ldxr + k));
#pragma unroll
        for (int rr = 0; rr < RC; ++rr)
#pragma unroll
          for (int j = 0; j < MC; ++j)
            part[rr * MC + j] = fmaf(wv[j], lv[rr], part[rr * MC + j]);
      }
      const float y = reduce_scatter32(part);
      if (m0 + mm < B) e.ylr[(size_t)(n0 + rr0) * B + m0 + mm] = y;
    }
  }
  __syncwarp();  // the warp's writes, then its flag (a release)
  if (lane == 0)
    asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(e.done + w),
                 "r"(e.seq)
                 : "memory");
}

// The epilogue of group g of a stage laid out as d (rows r0 .. r0 + 15 and
// r1 .. r1 + 15 of e.ws and e.Ls; totals tot[r * MT + m], r < 32, the
// warp's scratch): out = (tot * ws[n]) * sx[m] + ylr[n, m] * Ls[n], as
// lowrank::lr_tile's epilogue, once the warps that wrote those rows' L dots
// (ylr_phase) have set their flags; then by e.mode: store out * gain at e.out (gain of the rows'
// projection); add it to e.out; gate/up: gate = out * gain[0] of the first
// tile, m = (gate * sigmoid(gate)) * (out * gain[1]) of the second into
// e.out at column 16 g + r, and the group's absmax of |m| into e.part; or
// (card tests) the totals into e.sums. The whole warp calls it.
template <int MT>
__device__ __forceinline__ void epilogue(const Epi& e, const StageDesc& d,
                                         int g, int B, int* tot) {
  const int lane = threadIdx.x & 31;
  int r0, r1;
  group_rows(d, g, r0, r1);
  if (e.mode == kEpiSums) {
    for (int i = lane; i < 32 * B; i += 32) {
      const int r = i / B, m = i - r * B;
      const int n = r < kTileRows ? r0 + r : r1 + r - kTileRows;
      e.sums[(size_t)n * B + m] = tot[r * MT + m];
    }
    return;
  }
  // the flags of the warps that wrote the group's L dots: the owners of its
  // chunks of 4 rows (two runs of 4 chunks each, one a tile)
  if (lane < 8) {
    const int W = gridDim.x * kWarps, C = d.nrows / 4;
    const int ww = owner((lane < 4 ? r0 : r1) / 4 + (lane & 3), C, W);
    int n;
    do {
      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
                   : "=r"(n)
                   : "l"(e.done + ww)
                   : "memory");
    } while (n < e.seq);
  }
  __syncwarp();
  auto out_of = [&](int n, int r, int m) {
    const float ylr = __ldcg(e.ylr + (size_t)n * B + m);
    const float base = __fmul_rn(
        __fmul_rn((float)tot[r * MT + m], __ldg(e.ws + n)), e.sx[m]);
    return __fadd_rn(base, __fmul_rn(ylr, __ldg(e.Ls + n)));
  };
  // eight outputs a lane at a time, every load of the eight before any
  // store (the stores may alias them, so no load would pass one)
  if (e.mode != kEpiGateUp) {
    const int p = e.mode == kEpiStore ? r0 / e.pw : 0;
    // (a selection, not e.gain[p]: a run-time index would put e in local
    // memory)
    const float gain = p == 0 ? e.gain[0] : p == 1 ? e.gain[1] : e.gain[2];
    for (int i0 = lane; i0 < 32 * B; i0 += 8 * 32) {
      float v[8], xv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + 32 * u, r = i / B, m = i - r * B;
        const int n = r < kTileRows ? r0 + r : r1 + r - kTileRows;
        if (i < 32 * B) {
          v[u] = out_of(n, r, m);
          xv[u] = e.mode == kEpiAccum ? __ldcg(e.out + (size_t)m * e.ldo + n)
                                      : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + 32 * u, r = i / B, m = i - r * B;
        const int n = r < kTileRows ? r0 + r : r1 + r - kTileRows;
        if (i < 32 * B)
          e.out[(size_t)m * e.ldo + n] =
              e.mode == kEpiStore ? __fmul_rn(v[u], gain)
                                  : __fadd_rn(xv[u], __fmul_rn(v[u], gain));
      }
    }
    return;
  }
  float* am = reinterpret_cast<float*>(tot);  // |m|, over the gate totals
  for (int i0 = lane; i0 < kTileRows * B; i0 += 8 * 32) {
    float gv[8], uv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + 32 * u, r = i / B, m = i - r * B;
      if (i < kTileRows * B) {
        gv[u] = __fmul_rn(out_of(r0 + r, r, m), e.gain[0]);
        uv[u] = out_of(r1 + r, kTileRows + r, m);
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + 32 * u, r = i / B, m = i - r * B;
      if (i < kTileRows * B) {
        const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-gv[u])));
        const float mv =
            __fmul_rn(__fmul_rn(gv[u], sig), __fmul_rn(uv[u], e.gain[1]));
        e.out[(size_t)m * e.ldo + kTileRows * g + r] = mv;
        am[r * MT + m] = fabsf(mv);
      }
    }
  }
  __syncwarp();
  if (lane < B) {
    float a = 0.f;
    for (int r = 0; r < kTileRows; ++r) a = fmaxf(a, am[r * MT + lane]);
    e.part[(size_t)g * B + lane] = a;
  }
}

// Stage si of layer l for this warp (wcta: its CTA's window copy, see
// ylr_phase): its share of the stage's L dots, then its slabs, the products
// of each group in its range, the split sums, and the epilogue of each
// group this warp finishes (its 32 x MT totals in tot, the warp's scratch;
// scr after them). After each slab the warp issues the next slab of its
// stream into the freed slot; at the end it prefetches the L rows of its
// share of the next projection stage.
template <int BITS, int MT>
__device__ __forceinline__ void run_stage(const Plan& pl, int l, int si,
                                          Stream& q, Ring& rg,
                                          const int8_t* x8, int K, int B,
                                          int* pws, int* cnt, int* tot,
                                          uint8_t* scr, const Epi& e,
                                          __nv_bfloat16* wcta = nullptr) {
  const int warp = threadIdx.x >> 5;
  const int W = gridDim.x * kWarps, w = blockIdx.x * kWarps + warp;
  const StageDesc d = pl.st[si];
  const int S = d.groups * d.nk;
  const int lo = range_lo(S, w, W), hi = range_lo(S, w + 1, W);
  const int* x32 = reinterpret_cast<const int*>(x8);
  if (e.mode != kEpiSums) ylr_phase<MT>(e, d, B, pl.rank, scr, wcta);
  for (int s = lo; s < hi;) {
    const int g = s / d.nk, g0 = g * d.nk;
    const int end = min(hi, g0 + d.nk);
    int acc[2][MT / 8][4];
#pragma unroll
    for (int tl = 0; tl < 2; ++tl)
#pragma unroll
      for (int f = 0; f < MT / 8; ++f)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[tl][f][i] = 0;
    for (; s < end; ++s) {
      const int slot = rg.nc % kDepth;
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kDepth - 1) : "memory");
      __syncwarp();  // every lane's copies of slab nc have landed
      slab_mma<BITS, MT>(rg.buf + slot * kSlabBytes, x32, K / 4, d.P, s - g0,
                         B, acc);
      ++rg.nc;
      __syncwarp();
      stream_issue(q, pl, rg, w, W);
    }
    if (!(lo <= g0 && end == g0 + d.nk) &&
        !split_sum<MT>(acc, pws, cnt, g, d.nk, S, W, w))
      continue;
    store_totals<MT>(acc, tot);
    epilogue<MT>(e, d, g, B, tot);
  }
  // the L rows of this warp's share of the next projection stage, into L2
  const int sn = si + 1 == pl.nst ? 0 : si + 1, ln = l + (si + 1 == pl.nst);
  if (pl.Lf[sn] != nullptr && ln < pl.L) {
    const StageDesc& dn = pl.st[sn];
    const int C = dn.nrows / 4;
    const int c0 = range_lo(C, w, W), c1 = range_lo(C, w + 1, W);
    const int8_t* Lb =
        pl.Lf[sn] + ((size_t)ln * dn.nrows + 4 * c0) * pl.rank;
    const int lines = (4 * (c1 - c0) * pl.rank + 127) / 128;
    for (int i = threadIdx.x & 31; i < lines; i += 32)
      prefetch_line(Lb + 128 * (size_t)i);
  }
}

}  // namespace mproj
