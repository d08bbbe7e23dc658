// Flash-decode attention over a head-major int8 KV cache: one query token
// per (b, kv-head) with G grouped query heads, online softmax over the live
// token blocks of one layer (int8 codes, per-(token, head) f32 scales).
//
// Two entry points, each replacing one TPU kernel of
// ee274_convexcaldera_llm_quantization_tpu/ops/attention.py:
// - flash_decode_staged_launch: flash_decode_q8_staged
//   (_flash_decode_q8_staged_kernel). The cache holds the tokens < pos[b];
//   the staged f32 K/V of the current token add one online-softmax update
//   at the end (pos 0 attends the current token alone).
// - flash_decode_inline_launch: flash_decode_q8 (_flash_decode_q8_kernel).
//   The current token is already in the cache: the tokens <= pos[b] are
//   attended (pos 0 attends token 0), the live blocks are t <= pos / bt,
//   and there is no current-token update.
// The all-batch and paged kernels (flash_decode_q8_ab, flash_decode_q8_paged)
// compute the same function block-parallel in flash_decode_split.cu.
//
// The function is flash_decode.cuh's sequential walk (decode_attend) over
// the live blocks of each stream, and the outputs equal it bit for bit:
// three dot modes of the cache blocks (the entries' `dots`): kDotsI8 is the
// reference's dots="i8": q quantizes per g over D (qs = max(|q|, 1e-12) *
// (1/127)), p * vs quantizes per g over each block_t block (pvs =
// max(pv, 1e-30) * (1/127)) and both dots run as exact integer sums. The
// block partition is therefore part of the result, and the blocks here are
// the reference's blocks. kDotsBF16 is dots="bf16": q and p * vs round to
// bf16 before their dots with the int8 codes (exact products, f32 sums).
// The staged current token keeps f32 dots in every mode, as in the
// reference. For block t the walk computes p = expf(logit - m_t) with m_t
// the running max over blocks 0..t, the sum of p (lane i mod 32 in token
// order, then a butterfly), the i8 codes of p * vs over the block, p @ V
// (token i to chain i mod 4, in order, the chains added in a fixed order),
// and chains acc = acc * alpha_t + contrib_t, s = s * alpha_t + tot_t with
// alpha_t = expf(m_{t-1} - m_t). A max is exact in any order, and block t's
// pieces depend only on its own data and on m_{t-1}, m_t: so the blocks can
// run on several CTAs and be chained afterwards in block order with the
// same bits (the argument of flash_decode_split.cu).
//
// Bound on an H100: the live K/V codes and scales (2 * live * (D + 4) bytes
// per (b, head)); the operations are 4 * G * D per live token, far below
// the card's rates. The walk (one CTA of 4 warps a stream, its blocks one
// after another, V requested only after each block's softmax, ~8 serial
// rounds of memory latency a block) reached 2.6-18% of that bound
// (PERF.md). row_kernel, for blocks of at most 256 tokens:
// - a stream's live blocks go to a thread-block cluster of C CTAs (C from
//   shapes only: enough CTAs to cover the SMs at B * KVH streams), each a
//   contiguous range of ceil(live / C) blocks found from pos on the device;
// - each CTA asks for its q and scales at its start, and for its windows'
//   K rows and then V rows (a window: whole blocks of at most 256 tokens)
//   with 16-byte cp.async through a ring of kSlots slots (one: shared
//   memory and registers per CTA, which set how many CTAs an SM holds,
//   weigh more than a second slot). A window's K slot is given to the next
//   copy (its V rows) as soon as each thread holds its token's K row in
//   registers, so V lands while the logits run;
// - every thread takes part in each phase: logits one token a thread, each
//   int8 code converted to f32 once for every head (byte_f32); each
//   (block, head)'s softmax pieces one warp; p @ V from shared memory, f32
//   and bf16 as the walk's four token chains (a thread a chain, several
//   columns, a share of the heads), i8 as exact integer sums on __dp4a;
// - each CTA publishes its maxima in shared memory; after a cluster barrier
//   each reads the maxima of the CTAs before it over distributed shared
//   memory and computes its blocks' (m_t, alpha_t, tot_t, code scale,
//   contrib_t); after a second barrier the cluster's first CTA copies every
//   block's state and contribution over distributed shared memory, lets the
//   others go, chains the blocks in order, then runs the current token and
//   the normalization. No global scratch, no counters: the launch can be
//   captured in a CUDA graph.
// A block over 256 tokens runs the walk itself, walk_kernel: decode_attend
// in sub-tile passes that recompute the logits, one CTA a stream (see
// flash_decode.cuh). A cache of shorter blocks too long for a cluster's
// shared memory is not taken here: the wrappers
// (ops/attention.py::_launch_decode) launch flash_decode_split.cu on it,
// whose outputs are the same bits.
#include <cooperative_groups.h>

#include <type_traits>

#include "flash_decode.cuh"

namespace {

namespace cg = cooperative_groups;
using flash_decode::bf16_round;
using flash_decode::kDotsBF16;
using flash_decode::kDotsF32;
using flash_decode::kDotsI8;
using flash_decode::kMaxD;
using flash_decode::kNegInf;
using flash_decode::warp_max;
using flash_decode::warp_sum;

constexpr int kMaxG = 8;
constexpr int kWalkThreads = 128;
constexpr int kWin = 256;        // tokens of a window
constexpr int kWinPairs = 16;    // (block, head) pairs of a window
constexpr int kMaxCluster = 8;   // CTAs of a stream (portable cluster size)
constexpr int kSlots = 1;        // ring slots (2, 3: slower, PERF.md)
constexpr int kMaxPairs = 128;   // (block, head) pairs of a CTA
constexpr int kMaxSmem = 232448; // dynamic shared memory of a CTA
constexpr int kCtas = 3;         // CTAs an SM the registers leave room for
constexpr int kRowThreads = 256; // 8 warps (4: 1.02-1.30x slower, PERF.md)

// ---------------------------------------------------------------------------
// the walk: one CTA a stream (blocks over 256 tokens)
// ---------------------------------------------------------------------------

template <int DOTS, bool STAGED>
__global__ void __launch_bounds__(kWalkThreads)
walk_kernel(const float* __restrict__ q, const int8_t* __restrict__ k,
            const int8_t* __restrict__ v, const float* __restrict__ ks,
            const float* __restrict__ vs, const float* __restrict__ kn,
            const float* __restrict__ vn, const int* __restrict__ pos,
            float* __restrict__ out, int KVH, int G, int D, int T, int bt,
            float scale) {
  flash_decode::decode_attend<kWalkThreads, kMaxG, DOTS, STAGED>(
      blockIdx.x, q, k, v, ks, vs, kn, vn, pos, nullptr, 0, out, KVH, G, D,
      T, bt, scale);
}

// ---------------------------------------------------------------------------
// row_kernel: a stream's blocks over a cluster of CTAs
// ---------------------------------------------------------------------------

struct RowArgs {
  const float* q;    // (B, KVH, G, D)
  const int8_t* k;   // the layer's codes (B, KVH, T, D)
  const int8_t* v;
  const float* ks;   // its scales (B, KVH, T)
  const float* vs;
  const float* kn;   // staged current token (B, KVH, D), or null
  const float* vn;
  const int* pos;    // (B)
  float* out;        // (B, KVH, G, D)
  int KVH, G, D, T, bt;
  int C;      // CTAs of a stream (the cluster)
  int nbw;    // blocks of a window
  int maxb;   // blocks of a CTA at most: ceil(T / bt / C)
  int incl;   // 1: inline (tokens <= pos), 0: staged
  float scale;
};

// Byte offsets of the dynamic shared memory, each 128-byte aligned: the
// ring's slots (a window's K rows, swizzled, or V rows; then, in the first
// CTA of a cluster, every block's state and contribution), the CTA's K and V
// scales, logits (then p * vs) and i8 codes of each head over the CTA's
// tokens, the chains' partial sums of a window, each block's contribution
// and state (m, alpha, tot, code scale) and max, the CTA's max a head, q
// (as the dots take it), its codes and scales, the current token's logits,
// and the staged current token (unrounded q, then K and V).
struct RowLayout {
  int slot, slots, ks, vs, lg, pq, part, contrib, state, bm, cmax, qf, qi,
      qs, fm, cur, total;
};

__host__ __device__ inline int take(int& at, int bytes) {
  const int o = at;
  at += (bytes + 127) / 128 * 128;
  return o;
}

__host__ __device__ inline RowLayout row_layout(int G, int D, int bt,
                                                int maxb, int nbw, int C) {
  RowLayout L;
  int at = 0;
  const int span = maxb * bt;
  L.slot = (nbw * bt * D + 127) / 128 * 128;
  // the first CTA of a cluster stages every block's state and contribution
  // in the ring's slots (consumed by then) before it chains them
  const int stage = C > 1 ? C * maxb * G * (16 + 4 * D) : 0;
  L.slots = take(at, kSlots * L.slot > stage ? kSlots * L.slot : stage);
  L.ks = take(at, 4 * span);
  L.vs = take(at, 4 * span);
  L.lg = take(at, 4 * G * span);
  L.pq = take(at, G * span);
  L.part = take(at, 4 * nbw * G * 4 * D);
  L.contrib = take(at, 4 * maxb * G * D);
  L.state = take(at, 16 * maxb * G);
  L.bm = take(at, 4 * maxb * G);
  L.cmax = take(at, 4 * kMaxG);
  L.qf = take(at, 4 * G * D);
  L.qi = take(at, G * D);
  L.qs = take(at, 4 * kMaxG);
  L.fm = take(at, 4 * kMaxG);
  L.cur = take(at, 4 * (G + 2) * D);
  L.total = at;
  return L;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's newest commit groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// every thread of every CTA of the cluster (C > 1) or of the CTA; the
// cluster barrier releases and acquires shared memory at cluster scope
__device__ __forceinline__ void cluster_sync(int C) {
  if (C > 1) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  } else {
    __syncthreads();
  }
}

// CTA r's copy of this CTA's shared-memory object p (r == own rank: p)
template <typename T>
__device__ __forceinline__ T* at_rank(T* p, int C, int r) {
  return C > 1 ? cg::this_cluster().map_shared_rank(p, (unsigned)r) : p;
}

// 16-byte piece c of a window's K rows (token c / (D / 16), piece c % (D /
// 16)) lies at piece swz(c): the eight tokens of a quarter warp read eight
// bank groups
__device__ __forceinline__ int swz(int c) { return c ^ ((c >> 3) & 7); }

// acc = acc * alpha + contrib and s = s * alpha + tot for block state st
// (m, alpha, tot, i8 code scale) and contribution c (the i8 integer sum's
// bits), rounded as the walk rounds them (its i8 contribution is (float)tot
// * pvs)
template <bool I8>
__device__ __forceinline__ void chain(float& acc, float& s, float4 st,
                                      float c) {
  if (I8)
    acc = __fmaf_rn((float)__float_as_int(c), st.w, __fmul_rn(acc, st.y));
  else
    acc = __fmaf_rn(acc, st.y, c);
  s = __fmaf_rn(s, st.y, st.z);
}

// (float)(int8_t) of byte k of a word w, from wb = w ^ 0x80808080: the byte
// permute builds the float 2^23 + (b + 128), less 2^23 + 128 (integers below
// 2^24: exact, the value I2F gives, at the rate of a permute and an add)
__device__ __forceinline__ float byte_f32(unsigned wb, int k) {
  return __int_as_float(__byte_perm(wb, 0x4B000000u, 0x7650 + k)) -
         8388736.f;
}

// The walk's step 1 for one token whose K row is in kv (registers) and whose
// K scale times the softmax scale is kscale: its logit for each head g into
// lg[g * span] (i8: the __dp4a chain; f32, bf16: each head's FMA chain in
// column order, each code converted once for every head).
template <int DOTS>
__device__ __forceinline__ void token_logits(int G, int D, float kscale,
                                             const float* qf,
                                             const int8_t* qi,
                                             const float* qs,
                                             const uint4 (&kv)[kMaxD / 16],
                                             float* lg, int span) {
  const int pieces = D / 16;
  if (DOTS == kDotsI8) {
    const int dw = D / 4;
    const int* qi32 = reinterpret_cast<const int*>(qi);
    for (int g = 0; g < G; ++g) {
      int isum = 0;
#pragma unroll
      for (int j = 0; j < kMaxD / 16; ++j) {
        if (j < pieces) {
          const int* qw = qi32 + g * dw + 4 * j;
          isum = __dp4a((int)kv[j].x, qw[0], isum);
          isum = __dp4a((int)kv[j].y, qw[1], isum);
          isum = __dp4a((int)kv[j].z, qw[2], isum);
          isum = __dp4a((int)kv[j].w, qw[3], isum);
        }
      }
      lg[g * span] = ((float)isum * qs[g]) * kscale;
    }
    return;
  }
  // f32, or bf16 q: each product with an int8 code is exact
  float fsum[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) fsum[g] = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxD / 16; ++j) {
    if (j < pieces) {
      const unsigned w4[4] = {kv[j].x ^ 0x80808080u, kv[j].y ^ 0x80808080u,
                              kv[j].z ^ 0x80808080u, kv[j].w ^ 0x80808080u};
      float kf[16];
#pragma unroll
      for (int cc = 0; cc < 16; ++cc) kf[cc] = byte_f32(w4[cc / 4], cc % 4);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;  // a uniform branch: no head's work predicated
#pragma unroll
        for (int cc = 0; cc < 16; ++cc)
          fsum[g] += qf[g * D + 16 * j + cc] * kf[cc];
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
    lg[g * span] = fsum[g] * kscale;
  }
}

// The walk's step 3 in f32 (or bf16: the values are rounded already) for
// the nbk blocks from CTA block j0 of a window whose V rows are in vt: a
// thread a (block, chain c, CW columns, heads [g0, g1)), chain c summing
// the block's tokens c, c + 4, ... in order, each code converted once for
// every head, into part[((block * G + g) * 4 + c) * D + column].
template <int NT, int CW>
__device__ __forceinline__ void pv_f32(int tid, int nbk, int G, int D,
                                       int bt, int j0, int ntok, int span,
                                       int hsplit, const int8_t* vt,
                                       const float* lg, float* part) {
  using Word = typename std::conditional<CW == 4, unsigned,
                                         unsigned short>::type;
  const int ncg = D / CW, gper = (G + hsplit - 1) / hsplit;
  const int t0 = j0 * bt;
  for (int t = tid; t < nbk * 4 * ncg * hsplit; t += NT) {
    const int cgi = t % ncg, c = (t / ncg) & 3, r = t / (4 * ncg);
    const int jj = r / hsplit, g0 = (r - jj * hsplit) * gper;
    const int g1 = min(G, g0 + gper);
    const int x0 = (j0 + jj) * bt;
    const int nv = min(bt, ntok - x0);
    const int8_t* vb = vt + (size_t)(x0 - t0) * D + CW * cgi;
    const float* pb = lg + x0;
    float f[kMaxG][CW];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
#pragma unroll
      for (int q = 0; q < CW; ++q) f[g][q] = 0.f;
#pragma unroll 2
    for (int i = c; i < nv; i += 4) {
      const unsigned wb =
          *reinterpret_cast<const Word*>(vb + (size_t)i * D) ^ 0x80808080u;
      float vf[CW];
#pragma unroll
      for (int q = 0; q < CW; ++q) vf[q] = byte_f32(wb, q);
#pragma unroll
      for (int h = 0; h < kMaxG; ++h) {
        if (g0 + h >= g1) break;
        const float p = pb[(g0 + h) * span + i];
#pragma unroll
        for (int q = 0; q < CW; ++q) f[h][q] += p * vf[q];
      }
    }
#pragma unroll
    for (int h = 0; h < kMaxG; ++h) {
      if (g0 + h >= g1) break;
#pragma unroll
      for (int q = 0; q < CW; ++q)
        part[(((jj * G + g0 + h) * 4 + c) * D) + CW * cgi + q] = f[h][q];
    }
  }
}

// The walk's step 3 in i8 with the tokens in groups of four: a thread a
// (block, 4 columns, slice s of the block's 4-token groups), each group's
// four V rows transposed into one word a column and __dp4a'd with the four
// codes of each head, added into the block's integer sums ci (zeroed) by
// shared-memory atomics. The walk's sums are exact integers (each chain's
// below 2^24 at 256 tokens, so its trip through an f32 is exact too), so
// any grouping gives its bits. Needs bt % 4 == 0 and each block's codes
// zero past its last token to a multiple of 4.
template <int NT>
__device__ __forceinline__ void pv_i8(int tid, int nbk, int G, int D,
                                      int bt, int j0, int ntok, int span,
                                      const int8_t* vt, const int8_t* pq,
                                      int* ci) {
  const int ncg = D / 4;
  const int S = max(1, NT / (nbk * ncg));
  const int t0 = j0 * bt;
  for (int t = tid; t < nbk * ncg * S; t += NT) {
    const int cg = t % ncg, s = (t / ncg) % S, jj = t / (ncg * S);
    const int x0 = (j0 + jj) * bt;
    const int nu = (min(bt, ntok - x0) + 3) / 4;
    const int8_t* vb = vt + (size_t)(x0 - t0) * D + 4 * cg;
    const int8_t* pb = pq + x0;
    int acc[kMaxG][4];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[g][q] = 0;
    for (int u = s; u < nu; u += S) {
      const int8_t* v4 = vb + (size_t)(4 * u) * D;
      const unsigned w0 = *reinterpret_cast<const unsigned*>(v4);
      const unsigned w1 = *reinterpret_cast<const unsigned*>(v4 + D);
      const unsigned w2 = *reinterpret_cast<const unsigned*>(v4 + 2 * D);
      const unsigned w3 = *reinterpret_cast<const unsigned*>(v4 + 3 * D);
      const unsigned lo01 = __byte_perm(w0, w1, 0x5140);
      const unsigned hi01 = __byte_perm(w0, w1, 0x7362);
      const unsigned lo23 = __byte_perm(w2, w3, 0x5140);
      const unsigned hi23 = __byte_perm(w2, w3, 0x7362);
      const int col[4] = {(int)__byte_perm(lo01, lo23, 0x5410),
                          (int)__byte_perm(lo01, lo23, 0x7632),
                          (int)__byte_perm(hi01, hi23, 0x5410),
                          (int)__byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        const int pw = *reinterpret_cast<const int*>(pb + g * span + 4 * u);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[g][q] = __dp4a(col[q], pw, acc[g][q]);
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        atomicAdd(ci + ((j0 + jj) * G + g) * D + 4 * cg + q, acc[g][q]);
    }
  }
}

// The walk's step 3 in i8 for any block length: a thread a (block, head,
// chain c, 4 columns), chain c summing the block's tokens c, c + 4, ... as
// exact integers, each chain's sum through an f32 as the walk adds it, into
// part[((block * G + g) * 4 + c) * D + column].
template <int NT>
__device__ __forceinline__ void pv_i8_chains(int tid, int nbk, int G, int D,
                                             int bt, int j0, int ntok,
                                             int span, const int8_t* vt,
                                             const int8_t* pq, float* part) {
  const int ncg = D / 4;
  const int t0 = j0 * bt;
  for (int t = tid; t < nbk * G * 4 * ncg; t += NT) {
    const int cgi = t % ncg, c = (t / ncg) & 3, k = t / (4 * ncg);
    const int jj = k / G, g = k - jj * G;
    const int x0 = (j0 + jj) * bt;
    const int nv = min(bt, ntok - x0);
    const int8_t* vb = vt + (size_t)(x0 - t0) * D + 4 * cgi;
    const int8_t* pqg = pq + g * span + x0;
    int is[4] = {0, 0, 0, 0};
    for (int i = c; i < nv; i += 4) {
      const unsigned vw = *reinterpret_cast<const unsigned*>(vb + (size_t)i * D);
      const int cd = pqg[i];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        is[q] += cd * (int)(int8_t)((vw >> (8 * q)) & 0xFFu);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) part[(k * 4 + c) * D + 4 * cgi + q] = (float)is[q];
  }
}

template <int DOTS, bool STAGED, int NT>
__global__ void __launch_bounds__(NT, kCtas)
row_kernel(const RowArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool I8 = DOTS == kDotsI8;
  constexpr int kWarps = NT / 32;
  constexpr int kE = (kMaxG * kMaxD + NT - 1) / NT;  // (g, d) a thread
  constexpr int kTPT = kWin / NT;                     // tokens a thread
  const RowLayout L = row_layout(a.G, a.D, a.bt, a.maxb, a.nbw, a.C);
  int8_t* slots = reinterpret_cast<int8_t*>(smem + L.slots);
  float* ks_s = reinterpret_cast<float*>(smem + L.ks);
  float* vs_s = reinterpret_cast<float*>(smem + L.vs);
  float* lg = reinterpret_cast<float*>(smem + L.lg);
  int8_t* pq = reinterpret_cast<int8_t*>(smem + L.pq);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* contrib = reinterpret_cast<float*>(smem + L.contrib);
  float4* state = reinterpret_cast<float4*>(smem + L.state);
  float* bm = reinterpret_cast<float*>(smem + L.bm);
  float* cmax = reinterpret_cast<float*>(smem + L.cmax);
  float* qf = reinterpret_cast<float*>(smem + L.qf);
  int8_t* qi = reinterpret_cast<int8_t*>(smem + L.qi);
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* fm = reinterpret_cast<float*>(smem + L.fm);
  float* cur = reinterpret_cast<float*>(smem + L.cur);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = a.G, D = a.D, bt = a.bt, C = a.C, nbw = a.nbw;
  const int bh = blockIdx.x / C, rank = blockIdx.x - bh * C;
  const int b = bh / a.KVH;
  const int span = a.maxb * bt;
  // cache tokens attended: < pos (staged) or <= pos (inline), at most T;
  // the live blocks, ceil(nb / C) a CTA, contiguous
  const int n = min(a.pos[b] + a.incl, a.T);
  const int nb = n > 0 ? (n - 1) / bt + 1 : 0;
  const int per = (nb + C - 1) / C;
  const int lo = min(rank * per, nb);
  const int nbc = min(lo + per, nb) - lo;        // this CTA's blocks
  const int ntok = nbc > 0 ? min((lo + nbc) * bt, n) - lo * bt : 0;
  const int nwin = (nbc + nbw - 1) / nbw;        // its windows
  const size_t row0 = (size_t)bh * a.T + (size_t)lo * bt;  // first row
  // i8 p @ V in 4-token groups (pv_i8) where the blocks allow it
  const bool quad = I8 && bt % 4 == 0;

  // group 0: q and the CTA's scales; in the first CTA of a staged launch
  // also the unrounded q, k_new and v_new for the current token
  const float* qb = a.q + (size_t)bh * G * D;
  for (int i = tid; i < G * D / 4; i += NT) cp_async16(qf + 4 * i, qb + 4 * i);
  if (STAGED && rank == 0) {
    for (int i = tid; i < G * D / 4; i += NT)
      cp_async16(cur + 4 * i, qb + 4 * i);
    for (int i = tid; i < D / 4; i += NT) {
      cp_async16(cur + G * D + 4 * i, a.kn + (size_t)bh * D + 4 * i);
      cp_async16(cur + (G + 1) * D + 4 * i, a.vn + (size_t)bh * D + 4 * i);
    }
  }
  for (int i = tid; i < ntok; i += NT) {
    cp_async4(ks_s + i, a.ks + row0 + i);
    cp_async4(vs_s + i, a.vs + row0 + i);
  }
  cp_async_commit();
  // copy s of the ring (one commit group each, empty past the last): the K
  // rows of window s < nwin, else the V rows of window s - nwin, into slot
  // s % kSlots
  auto issue = [&](int s) {
    if (s < 2 * nwin) {
      const bool isv = s >= nwin;
      const int t0 = (isv ? s - nwin : s) * nbw * bt;
      const int pieces = min(nbw * bt, ntok - t0) * D / 16;
      const int8_t* src = (isv ? a.v : a.k) + (row0 + t0) * D;
      int8_t* dst = slots + (s % kSlots) * L.slot;
      for (int r = tid; r < pieces; r += NT)
        cp_async16(dst + 16 * (isv ? r : swz(r)), src + 16 * r);
    }
    cp_async_commit();
  };
  for (int s = 0; s < kSlots; ++s) issue(s);

  // the i8 sums of this CTA's blocks start at zero
  if (quad)
    for (int i = tid; i < nbc * G * D; i += NT)
      reinterpret_cast<int*>(contrib)[i] = 0;

  // q as the cache dots take it: i8 its codes per head over D, bf16 rounded
  cp_async_wait<kSlots>();
  __syncthreads();
  if (DOTS == kDotsBF16)
    for (int i = tid; i < G * D; i += NT) qf[i] = bf16_round(qf[i]);
  if (I8) {
    for (int g = warp; g < G; g += kWarps) {
      float m = 0.f;
      for (int d = lane; d < D; d += 32) m = fmaxf(m, fabsf(qf[g * D + d]));
      m = warp_max(m);
      const float sc = fmaxf(m, 1e-12f) * (1.0f / 127.0f);
      for (int d = lane; d < D; d += 32)
        qi[g * D + d] = (int8_t)rintf(qf[g * D + d] / sc);
      if (lane == 0) qs[g] = sc;
    }
  }

  // 1. the logits of each window's tokens: each thread takes its tokens' K
  //    rows into registers, the slot goes to the next copy (the V rows, with
  //    one slot), then the dots
  const int pieces = D / 16;
  for (int w = 0; w < nwin; ++w) {
    cp_async_wait<kSlots - 1>();
    __syncthreads();
    const int t0 = w * nbw * bt;
    const int wn = min(nbw * bt, ntok - t0);
    const int8_t* kt = slots + (w % kSlots) * L.slot;
    uint4 kv[kTPT][kMaxD / 16];
#pragma unroll
    for (int r = 0; r < kTPT; ++r) {
      const int i = tid + NT * r;
#pragma unroll
      for (int j = 0; j < kMaxD / 16; ++j)
        if (i < wn && j < pieces)
          kv[r][j] = *reinterpret_cast<const uint4*>(
              kt + (swz(i * pieces + j) << 4));
    }
    __syncthreads();
    issue(w + kSlots);
#pragma unroll
    for (int r = 0; r < kTPT; ++r) {
      const int i = tid + NT * r;
      if (i < wn)
        token_logits<DOTS>(G, D, ks_s[t0 + i] * a.scale, qf, qi, qs, kv[r],
                           lg + t0 + i, span);
    }
  }
  __syncthreads();
  // each block's max, one warp a (block, head) pair e = j * G + g, and the
  // CTA's max a head
  for (int e = warp; e < nbc * G; e += kWarps) {
    const int j = e / G, g = e - j * G;
    const int x1 = min((j + 1) * bt, ntok);
    float m = kNegInf;
    for (int x = j * bt + lane; x < x1; x += 32) m = fmaxf(m, lg[g * span + x]);
    m = warp_max(m);
    if (lane == 0) bm[e] = m;
  }
  __syncthreads();
  if (tid < G) {
    float m = kNegInf;
    for (int j = 0; j < nbc; ++j) m = fmaxf(m, bm[j * G + tid]);
    cmax[tid] = m;
  }
  cluster_sync(C);
  // the running max before this CTA's first block (the maxima of the CTAs
  // before it), then each block's m_t and alpha_t
  if (tid < G) {
    float m = kNegInf;
    for (int r = 0; r < rank; ++r) m = fmaxf(m, at_rank(cmax, C, r)[tid]);
    for (int j = 0; j < nbc; ++j) {
      const float mt = fmaxf(m, bm[j * G + tid]);
      state[j * G + tid] = make_float4(mt, expf(m - mt), 0.f, 0.f);
      m = mt;
    }
  }
  __syncthreads();

  // 2. each block's probabilities, sum, absmax and i8 codes, one warp a
  //    (block, head) pair (lane i mod 32 in token order); in i8 the codes
  //    are zero past the block's last token to a multiple of 4
  for (int e = warp; e < nbc * G; e += kWarps) {
    const int j = e / G, g = e - j * G;
    const int x0 = j * bt, nv = min(bt, ntok - x0);
    const float m = state[e].x;
    float* lgg = lg + g * span + x0;
    const float* vsb = vs_s + x0;
    float ps = 0.f, pvm = 0.f;
    for (int i = lane; i < nv; i += 32) {
      const float p = expf(lgg[i] - m);
      const float pv = p * vsb[i];
      ps += p;
      pvm = fmaxf(pvm, pv);
      lgg[i] = DOTS == kDotsBF16 ? bf16_round(pv) : pv;
    }
    float sc = 0.f;
    if (I8) {
      sc = fmaxf(warp_max(pvm), 1e-30f) * (1.0f / 127.0f);
      int8_t* pqg = pq + g * span + x0;
      for (int i = lane; i < nv; i += 32)
        pqg[i] = (int8_t)rintf(lgg[i] / sc);
      if (quad)
        for (int i = nv + lane; i < ((nv + 3) & ~3); i += 32) pqg[i] = 0;
    }
    const float tot = warp_sum(ps);
    if (lane == 0) {
      state[e].z = tot;
      state[e].w = sc;
    }
  }

  // 3. (p * vs) @ v of each window's blocks; f32, bf16 (and i8 with blocks
  //    of other lengths): each pair's four chains then added in a fixed order
  for (int w = 0; w < nwin; ++w) {
    cp_async_wait<kSlots - 1>();
    __syncthreads();
    const int j0 = w * nbw, nbk = min(nbw, nbc - j0);
    const int8_t* vt = slots + ((nwin + w) % kSlots) * L.slot;
    if (quad) {
      pv_i8<NT>(tid, nbk, G, D, bt, j0, ntok, span, vt, pq,
                reinterpret_cast<int*>(contrib));
    } else if (I8) {
      pv_i8_chains<NT>(tid, nbk, G, D, bt, j0, ntok, span, vt, pq, part);
    } else if (nbk * D >= NT) {
      // four columns a thread; where that leaves threads idle, two columns
      // (one head) or the heads split over several threads
      pv_f32<NT, 4>(tid, nbk, G, D, bt, j0, ntok, span, 1, vt, lg, part);
    } else if (G == 1) {
      pv_f32<NT, 2>(tid, nbk, G, D, bt, j0, ntok, span, 1, vt, lg, part);
    } else {
      pv_f32<NT, 4>(tid, nbk, G, D, bt, j0, ntok, span,
                    min(G, NT / (nbk * D)), vt, lg, part);
    }
    __syncthreads();
    issue(nwin + w + kSlots);
    if (!quad) {
      for (int e = tid; e < nbk * G * D; e += NT) {
        const int k = e / D, d = e - k * D;
        const float* pk = part + k * 4 * D + d;
        float cv;
        if (I8) {
          int tot = 0;
          for (int c = 0; c < 4; ++c) tot += (int)pk[c * D];
          cv = __int_as_float(tot);
        } else {
          cv = 0.f;
          for (int c = 0; c < 4; ++c) cv += pk[c * D];
        }
        contrib[(j0 * G + k) * D + d] = cv;
      }
    }
  }
  cluster_sync(C);

  // 4. the first CTA chains every block of the stream in order. In a
  //    cluster it first copies each CTA's states and contributions into its
  //    slots (every thread, many reads of distributed shared memory in
  //    flight), after which the other CTAs may exit.
  const float4* stb = state;
  const float* cbb = contrib;
  if (C > 1) {
    if (rank == 0) {
      float4* sst = reinterpret_cast<float4*>(slots);
      float4* scb = sst + nb * G;
      const int w4 = G * D / 4;  // a block's contribution in float4
      for (int e = tid; e < nb * (G + w4); e += NT) {
        const bool is_state = e < nb * G;
        const int f = is_state ? e : e - nb * G;
        const int j = is_state ? f / G : f / w4;
        const int r = j / per, jl = j - r * per;
        if (is_state)
          sst[f] = at_rank(state, C, r)[jl * G + (f - j * G)];
        else
          scb[f] = reinterpret_cast<const float4*>(at_rank(
              contrib, C, r))[jl * w4 + (f - j * w4)];
      }
      stb = sst;
      cbb = reinterpret_cast<const float*>(scb);
    }
    cluster_sync(C);  // the other CTAs' shared memory is read: they may exit
  }
  if (rank != 0) return;
  float acc[kE], ssum[kE], mrun[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    acc[e] = 0.f;
    ssum[e] = 0.f;
    mrun[e] = kNegInf;
  }
  for (int j = 0; j < nb; ++j) {
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int x = tid + NT * e;
      if (x >= G * D) break;
      const float4 sv = stb[j * G + x / D];
      chain<I8>(acc[e], ssum[e], sv, cbb[j * G * D + x]);
      mrun[e] = sv.x;
    }
  }

  // 5. staged: the current token (f32 dots on the unrounded q), then
  //    normalize; inline: normalize (every row attends token 0, s > 0)
  if (STAGED) {
    for (int g = warp; g < G; g += kWarps) {
      float pd = 0.f;
      for (int d = lane; d < D; d += 32) pd += cur[g * D + d] * cur[G * D + d];
      const float logit = warp_sum(pd) * a.scale;
      if (lane == 0) fm[g] = logit;
    }
    __syncthreads();
  }
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int x = tid + NT * e;
    if (x >= G * D) continue;
    float o;
    if (STAGED) {
      const float logit = fm[x / D];
      const float m_prev = mrun[e];
      const float s_prev = ssum[e];
      const float m_new = fmaxf(m_prev, logit);
      const float alpha = expf(m_prev - m_new);
      const float p = expf(logit - m_new);
      const float s_new = s_prev * alpha + p;
      o = (acc[e] * alpha + p * cur[(G + 1) * D + x % D]) / s_new;
    } else {
      o = acc[e] / ssum[e];
    }
    a.out[(size_t)bh * G * D + x] = o;
  }
}

// the row kernel's dynamic shared memory over 48 KB, allowed once per
// device and instance (internal linkage: a library of its own per build)
template <int DOTS, bool STAGED, int NT>
cudaError_t allow_smem() {
  static unsigned long long done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(row_kernel<DOTS, STAGED, NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess) done |= bit;
  return err;
}

template <int DOTS, bool STAGED>
int launch_row(const RowArgs& a, int streams, int smem, cudaStream_t st) {
  constexpr int NT = kRowThreads;
  cudaError_t err = allow_smem<DOTS, STAGED, NT>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(streams * a.C);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.C > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, row_kernel<DOTS, STAGED, NT>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int DOTS, bool STAGED>
void launch_walk(int streams, cudaStream_t st, const RowArgs& a) {
  walk_kernel<DOTS, STAGED><<<streams, kWalkThreads, 0, st>>>(
      a.q, a.k, a.v, a.ks, a.vs, a.kn, a.vn, a.pos, a.out, a.KVH, a.G, a.D,
      a.T, a.bt, a.scale);
}

// cluster 0: the walk; else the row kernel on the plan (cluster, nbw, maxb,
// smem) of ops/attention.py::_row_decode_plan. row_layout owns the shared
// memory's layout; the plan's smem is a mirror of it, and a plan whose smem
// differs is refused.
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* k_new, const void* v_new,
           const void* pos, void* out, int B, int KVH, int G, int D, int T,
           int block_t, float scale, int dots, int cluster, int nbw,
           int maxb, int smem, bool staged, void* stream) {
  if (B < 1 || KVH < 1 || G < 1 || G > kMaxG || D < 16 || D > kMaxD ||
      D % 16 != 0 || block_t < 1 || T % block_t != 0 ||
      dots < kDotsF32 || dots > kDotsI8 ||
      (staged && (k_new == nullptr || v_new == nullptr)) ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(k_new) |
       reinterpret_cast<uintptr_t>(v_new)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  RowArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const int8_t*>(k);
  a.v = static_cast<const int8_t*>(v);
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.kn = static_cast<const float*>(k_new);
  a.vn = static_cast<const float*>(v_new);
  a.pos = static_cast<const int*>(pos);
  a.out = static_cast<float*>(out);
  a.KVH = KVH;
  a.G = G;
  a.D = D;
  a.T = T;
  a.bt = block_t;
  a.C = cluster;
  a.nbw = nbw;
  a.maxb = maxb;
  a.incl = staged ? 0 : 1;
  a.scale = scale;
  const auto st = static_cast<cudaStream_t>(stream);
  const int streams = B * KVH;
  if (cluster == 0) {
    const auto fn =
        dots == kDotsI8
            ? (staged ? launch_walk<kDotsI8, true> : launch_walk<kDotsI8, false>)
        : dots == kDotsBF16
            ? (staged ? launch_walk<kDotsBF16, true>
                      : launch_walk<kDotsBF16, false>)
            : (staged ? launch_walk<kDotsF32, true>
                      : launch_walk<kDotsF32, false>);
    fn(streams, st, a);
    return (int)cudaGetLastError();
  }
  const int nblk = T / block_t;
  if (block_t > kWin || cluster < 1 || cluster > kMaxCluster || nbw < 1 ||
      nbw * block_t > kWin || nbw * G > kWinPairs ||
      maxb != (nblk + cluster - 1) / cluster || maxb * G > kMaxPairs ||
      smem != row_layout(G, D, block_t, maxb, nbw, cluster).total ||
      smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const auto fn =
      dots == kDotsI8
          ? (staged ? launch_row<kDotsI8, true> : launch_row<kDotsI8, false>)
      : dots == kDotsBF16
          ? (staged ? launch_row<kDotsBF16, true>
                    : launch_row<kDotsBF16, false>)
          : (staged ? launch_row<kDotsF32, true>
                    : launch_row<kDotsF32, false>);
  return fn(a, streams, smem, st);
}

}  // namespace

// q (B, KVH, G, D) f32; k, v one layer of the cache (B, KVH, T, D) int8; ks,
// vs its (B, KVH, T) f32 scales; k_new, v_new (B, KVH, D) f32 (staged);
// pos (B) int32; out (B, KVH, G, D) f32. cluster, nbw, maxb, smem: the
// plan of ops/attention.py::_row_decode_plan (cluster 0: the walk).
extern "C" int flash_decode_staged_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* k_new, const void* v_new, const void* pos,
    void* out, int B, int KVH, int G, int D, int T, int block_t, float scale,
    int dots, int cluster, int nbw, int maxb, int smem, void* stream) {
  return launch(q, k, v, ks, vs, k_new, v_new, pos, out, B, KVH, G, D, T,
                block_t, scale, dots, cluster, nbw, maxb, smem, true, stream);
}

extern "C" int flash_decode_inline_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* pos, void* out, int B, int KVH, int G, int D,
    int T, int block_t, float scale, int dots, int cluster, int nbw,
    int maxb, int smem, void* stream) {
  return launch(q, k, v, ks, vs, nullptr, nullptr, pos, out, B, KVH, G, D, T,
                block_t, scale, dots, cluster, nbw, maxb, smem, false,
                stream);
}

