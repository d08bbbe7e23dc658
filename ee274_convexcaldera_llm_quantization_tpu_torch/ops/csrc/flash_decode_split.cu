// Block-parallel flash-decode attention over a head-major int8 KV cache, for
// the all-batch and the paged decode attention. Replaces two TPU kernels of
// ee274_convexcaldera_llm_quantization_tpu/ops/attention.py:
// - flash_decode_q8_ab (_flash_decode_q8_ab_kernel), staged or inline, on
//   the block partition of _ab_blocks (contiguous cache, page_tables null);
// - flash_decode_q8_paged (the staged kernel on a grid whose block t of row
//   b is pool page page_tables[b, t]: block == page). A layer of the pool is
//   (NP, KVH, P, D) int8 with (NP, KVH, P) scales; block t of (b, h) starts
//   at row (pt[b, t] * KVH + h) * P.
//
// The function is csrc/flash_decode.cuh's sequential walk (decode_attend)
// over the live blocks of each (b, kv-head) stream, and the outputs equal
// it bit for bit. That walk computes, for block t, p = expf(logit - m_t)
// with m_t the running max over blocks 0..t, the sum of p, in dots "i8" the
// codes of p * vs over the block (the reference's quantization group), the
// block's p @ V, and then chains acc = acc * alpha_t + contrib_t and
// s = s * alpha_t + tot_t with alpha_t = expf(m_{t-1} - m_t). A max is
// exact in any order, and contrib_t, tot_t and alpha_t of block t depend
// only on the block's own data and on m_{t-1}, m_t. So the blocks can run
// in parallel and be chained afterwards in block order, with the same bits.
// One launch of persistent CTAs takes work items in ticket order (an
// atomic counter), each item a CTA's:
//
// A. a chunk of a stream (whole blocks of at most kChunk tokens, or a
//    kChunk-token piece of a longer block): its K rows copied into shared
//    memory (16-byte cp.async, all in flight at once; a paged chunk's page
//    ids read once), each (token, g) logit with the walk's arithmetic (i8:
//    the __dp4a chain; f32, bf16: the FMA chain in column order), the
//    logits and each block's (or piece's) max written to scratch;
// B. a window of a stream (whole blocks of at most kChunk tokens and kSlots
//    (block, head) pairs, or one longer block walked in kChunk-token
//    sub-tiles), once its stream's chunks are done: V rows, scales and
//    logits in shared memory (V copied before the wait), m_{t-1} from the
//    block maxima, and the walk's steps 2-4 on each block: the lane order
//    of the sums, the four-warp token partition of p @ V (token i to chain
//    i mod 4, in order), the fixed-order sum of the chains; a block over
//    kChunk tokens keeps the sub-tile order (i8: one pass for the sum and
//    absmax, one for the codes and p @ V). It writes (m_t, alpha_t, tot_t,
//    the i8 code scale) and contrib_t (f32, or the i8 integer sums);
// C. a stream, once its windows are done: the blocks chained in order, then
//    the walk's step 5 (the staged current token in f32) and the
//    normalization;
// W. the whole stream of a row with no cache token, or whose live tokens
//    fit one chunk, one window and kWholeBytes of K: K and V copied
//    together, then A, B and C's steps in one CTA. Three items in turn
//    take longer than the walk over such a stream: without W items, rows of
//    Llama-2-7B heads at position 128 took 1.36-1.57x as long on an H100
//    (scripts/torch_decode_split_ablate.py, copy no_whole).
//
// The rows go in tiles of kMaxRows, and a tile's tickets go to the A and W
// items of its streams first, then the B items, then the C items, and then
// to the next tile's; an item waits only for items of smaller tickets, which
// CTAs already hold, so the launch cannot deadlock whatever the CTAs'
// residency. The counters are zero at the launch (the last CTA out zeroes
// them, for the next launch on the stream); the grid and the scratch are
// sized from shapes only (the live
// items are found on the device from pos), nothing is read back to the
// host, and the launch can be captured in a CUDA graph. The wrapper
// (ops/attention.py::_launch_split) plans the chunks and windows
// (_decode_split_plan) and allocates the scratch with torch.empty.
//
// Bound on an H100: the live K/V codes and scales (2 * live * (D + 4)
// bytes per (b, head)); the operations are 4 * G * D per live token, far
// below the card's rates. The scratch adds 4 * G bytes a token of logits
// written and read, and 4 * G * (D + 4) bytes a block of contributions
// written and read: ~5% over the K/V bytes at 128-token blocks, ~25% at
// 16-token pages.
#include "flash_decode.cuh"

namespace {

using flash_decode::bf16_round;
using flash_decode::kDotsBF16;
using flash_decode::kDotsF32;
using flash_decode::kDotsI8;
using flash_decode::kMaxD;
using flash_decode::kNegInf;
using flash_decode::warp_max;
using flash_decode::warp_sum;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;  // the walk's four p @ V chains
constexpr int kMaxG = 8;
constexpr int kChunk = 256;   // tokens of a chunk and of a window
constexpr int kSlots = 12;    // (block, head) pairs of a window
constexpr int kTaskSlots = kSlots / kWarps;  // of them per warp
constexpr int kMaxSegs = 1024;  // segment maxima of a window
constexpr int kMaxRows = 128;   // rows of a tile
constexpr int kPartFloats = kSlots * kWarps * kMaxD;
constexpr int kWholeBytes = 4 * kPartFloats;  // a whole stream's K rows
static_assert(kChunk % 32 == 0 && kChunk % kWarps == 0, "sub-tile order");
static_assert(kMaxSegs <= kPartFloats, "segment maxima live in part_s");

// Dynamic shared memory, in bytes. R0: V rows (D bytes apart) | a chunk's
// K rows | C's first stage. R1: the chains' partial sums (a window's
// segment maxima before them; a whole stream's after its K rows) | C's
// second stage.
// R2: logits, then p * vs or the i8 codes. R3: V scales | a chunk's K
// scales. R4: a whole stream's K scales. Then q, its codes, page ids, pos
// and each row's A and B items a stream, block rows, small per-block and
// per-head state, the ticket.
constexpr int kR0 = 0;
constexpr int kR1 = kR0 + kChunk * kMaxD;
constexpr int kR2 = kR1 + kWholeBytes;
constexpr int kR3 = kR2 + 4 * kMaxG * kChunk;
constexpr int kR4 = kR3 + 4 * kChunk;
constexpr int kQF = kR4 + 4 * kChunk;
constexpr int kQI = kQF + 4 * kMaxG * kMaxD;
constexpr int kPID = kQI + kMaxG * kMaxD;
constexpr int kPOS = kPID + 4 * kChunk;
constexpr int kUA = kPOS + 4 * kMaxRows;
constexpr int kUB = kUA + 4 * kMaxRows;
constexpr int kBROW = kUB + 4 * kMaxRows;
constexpr int kSMALL = kBROW + 8 * kSlots;
constexpr int kSmallFloats = 5 * kSlots + 6 * kMaxG + 4;
constexpr int kSmem = kSMALL + 4 * kSmallFloats;
// C's stages: a chunk of a stream's blocks, D contribution words and a
// 4-word state a head, in R0 and R1
constexpr int kCStage = kWholeBytes / 4;
static_assert(kR1 - kR0 >= kWholeBytes, "C's first stage fits R0");

struct Split {
  const float* q;        // (B, KVH, G, D)
  const int8_t* k;       // the layer's codes: (B, KVH, T, D), or the
                         // pool's (NP, KVH, bt, D)
  const int8_t* v;
  const float* ks;       // its scales: (B, KVH, T) or (NP, KVH, bt)
  const float* vs;
  const float* kn;       // staged current token (B, KVH, D), or null
  const float* vn;
  const int* pos;        // (B)
  const int* pt;         // page tables (B, max_pages), or null
  float* out;            // (B, KVH, G, D)
  float* logits;         // (B * KVH, G, T)
  float* smax;           // (B * KVH, G, nseg): segment maxima
  float4* state;         // (B * KVH, nblk, G): m, alpha, tot, code scale
  float* contrib;        // (B * KVH, nblk, G, D): f32, or i8 integer sums
  int* counters;         // the ticket, then A and B items done a stream
  int B, KVH, G, D, T, bt, nblk, max_pages;
  int seg, spb, nseg, asegs;  // segments: min(bt, kChunk) tokens; per
                              // block; per stream; per chunk
  int nbw;                    // blocks per window
  int incl;                   // 1: inline (tokens <= pos), 0: staged
  float scale;
};

// The CTA's views of the dynamic shared memory.
struct Smem {
  int8_t* r0;
  float* r1;
  float* r2;
  float* r3;
  float* r4;
  float* qf;
  int8_t* qi;
  int* pid;
  int* pos;      // tokens each row of the tile attends
  int* ua;       // A (or W) items a stream of each row of the tile
  int* ub;       // B items a stream of each row of the tile
  size_t* brow;
  float* bm;     // kSlots: block maxima
  float* m;      // kSlots: running maxima
  float* al;     // kSlots: alphas
  float* tot;    // kSlots: sums of p
  float* sc;     // kSlots: i8 code scales
  float* mprev;  // kMaxG: the running max before a window
  float* qs;     // kMaxG: q's code scales
  float* fm;     // kMaxG x 4: finish's max, sum, alpha, p
  int* ticket;

  __device__ explicit Smem(unsigned char* s) {
    r0 = reinterpret_cast<int8_t*>(s + kR0);
    r1 = reinterpret_cast<float*>(s + kR1);
    r2 = reinterpret_cast<float*>(s + kR2);
    r3 = reinterpret_cast<float*>(s + kR3);
    r4 = reinterpret_cast<float*>(s + kR4);
    qf = reinterpret_cast<float*>(s + kQF);
    qi = reinterpret_cast<int8_t*>(s + kQI);
    pid = reinterpret_cast<int*>(s + kPID);
    pos = reinterpret_cast<int*>(s + kPOS);
    ua = reinterpret_cast<int*>(s + kUA);
    ub = reinterpret_cast<int*>(s + kUB);
    brow = reinterpret_cast<size_t*>(s + kBROW);
    float* f = reinterpret_cast<float*>(s + kSMALL);
    bm = f;
    m = bm + kSlots;
    al = m + kSlots;
    tot = al + kSlots;
    sc = tot + kSlots;
    mprev = sc + kSlots;
    qs = mprev + kMaxG;
    fm = qs + kMaxG;
    ticket = reinterpret_cast<int*>(fm + 4 * kMaxG);
  }
};

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

// wait for all but the `N` newest commit groups of this thread
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// An item's results written by every thread are published: one more item
// done in *count.
__device__ __forceinline__ void publish(int* count) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(count, 1);
}

__device__ __forceinline__ int load_acquire(const int* count) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(count)
               : "memory");
  return v;
}

// Wait until *count reaches target (items of smaller tickets, held by
// running CTAs), then read their results through L2; seen: thread 0's
// earlier read of *count. A wait far beyond any item's time traps instead
// of hanging the card.
__device__ __forceinline__ void wait_count(const int* count, int target,
                                           int seen) {
  if (threadIdx.x == 0) {
    long long spins = 0;
    while (seen < target) {
      __nanosleep(64);
      if (++spins > (1ll << 26)) __trap();
      seen = load_acquire(count);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ int live_blocks(const Split& a, int n) {
  return n > 0 ? (n - 1) / a.bt + 1 : 0;
}

__device__ __forceinline__ int seg_start(const Split& a, int s) {
  const int t = s / a.spb;
  return t * a.bt + (s - t * a.spb) * a.seg;
}

__device__ __forceinline__ int seg_end(const Split& a, int s) {
  const int t = s / a.spb;
  return min(seg_start(a, s) + a.seg, (t + 1) * a.bt);
}

// live segments of a row attending n > 0 tokens
__device__ __forceinline__ int live_segs(const Split& a, int n) {
  const int nb = live_blocks(a, n);
  return (nb - 1) * a.spb + (n - (nb - 1) * a.bt + a.seg - 1) / a.seg;
}

// cache tokens a row with position p attends: < p (staged) or <= p (inline)
__device__ __forceinline__ int attended(const Split& a, int p) {
  return min(p + a.incl, a.T);
}

// A row attending no cache token, or whose live tokens fit one chunk, one
// window and kWholeBytes of K: W items attend its streams whole.
__device__ __forceinline__ bool whole_row(const Split& a, int n) {
  return n == 0 || (a.bt <= kChunk && n * a.D <= kWholeBytes &&
                    live_blocks(a, n) <= a.nbw);
}

// the walk's step 1 for token i of a chunk whose K rows are in kt (packed
// and swizzled) and K scale in ks: its logit for each head g into lg[g *
// kChunk + i] (and, when gl is not null, gl[g * T + i])
template <int DOTS>
__device__ __forceinline__ void token_logits(const Split& a, const Smem& sm,
                                             const int8_t* kt,
                                             const float* ks, int i,
                                             float* lg, float* gl) {
  constexpr bool I8 = DOTS == kDotsI8;
  const int G = a.G, D = a.D, pieces = D / 16, dw = D / 4;
  const int* qi32 = reinterpret_cast<const int*>(sm.qi);
  uint4 kv[kMaxD / 16];
#pragma unroll
  for (int j = 0; j < kMaxD / 16; ++j) {
    if (j < pieces) {
      const int c = i * pieces + j;
      kv[j] =
          *reinterpret_cast<const uint4*>(kt + ((c ^ ((c >> 3) & 7)) << 4));
    }
  }
  const float kscale = ks[i] * a.scale;
  for (int g = 0; g < G; ++g) {
    float logit;
    if (I8) {
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
      logit = ((float)isum * sm.qs[g]) * kscale;
    } else {
      // f32, or bf16 q: each product with an int8 code is exact
      float fsum = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxD / 16; ++j) {
        if (j < pieces) {
          const unsigned w4[4] = {kv[j].x, kv[j].y, kv[j].z, kv[j].w};
#pragma unroll
          for (int cc = 0; cc < 16; ++cc)
            fsum += sm.qf[g * D + 16 * j + cc] *
                    (float)(int8_t)((w4[cc / 4] >> (8 * (cc % 4))) & 0xFFu);
        }
      }
      logit = fsum * kscale;
    }
    lg[g * kChunk + i] = logit;
    if (gl != nullptr) gl[(size_t)g * a.T + i] = logit;
  }
}

// q of stream bh into qf, unrounded, with cp.async; the caller waits and
// syncs
__device__ __forceinline__ void load_q(const Split& a, const Smem& sm,
                                       int bh) {
  const float* qb = a.q + (size_t)bh * a.G * a.D;
  for (int i = threadIdx.x; i < a.G * a.D / 4; i += kThreads)
    cp_async16(sm.qf + 4 * i, qb + 4 * i);
  cp_async_commit();
}

// the staged current token's K and V columns of this thread and, with Q
// (where qf holds q rounded to bf16), the unrounded q of its dot with K
// (heads warp + 4 k), loaded at an item's start so that finish does not
// wait for them
template <bool Q>
struct Current {
  float kn[kMaxD / 32];  // column lane + 32 i
  float vn;              // column threadIdx.x
  float q[Q ? kMaxG / kWarps : 1][kMaxD / 32];
};

template <bool Q>
__device__ __forceinline__ Current<Q> load_current(const Split& a, int bh) {
  Current<Q> cur;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kMaxD / 32; ++i) {
    const int d = lane + 32 * i;
    cur.kn[i] = !a.incl && d < a.D ? a.kn[(size_t)bh * a.D + d] : 0.f;
    if (Q) {
#pragma unroll
      for (int k = 0; k < kMaxG / kWarps; ++k) {
        const int g = warp + kWarps * k;
        cur.q[k][i] = !a.incl && g < a.G && d < a.D
                          ? a.q[((size_t)bh * a.G + g) * a.D + d]
                          : 0.f;
      }
    }
  }
  cur.vn = !a.incl && threadIdx.x < a.D
               ? a.vn[(size_t)bh * a.D + threadIdx.x]
               : 0.f;
  return cur;
}

// q as the cache dots take it, after load_q, its wait and a sync: i8 its
// codes per head over D, bf16 rounded in place
template <int DOTS>
__device__ __forceinline__ void quantize_q(const Split& a, const Smem& sm) {
  if (DOTS == kDotsBF16)
    for (int i = threadIdx.x; i < a.G * a.D; i += kThreads)
      sm.qf[i] = bf16_round(sm.qf[i]);
  if (DOTS != kDotsI8) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = a.D;
  for (int g = warp; g < a.G; g += kWarps) {
    float m = 0.f;
    for (int d = lane; d < D; d += 32) m = fmaxf(m, fabsf(sm.qf[g * D + d]));
    m = warp_max(m);
    const float sc = fmaxf(m, 1e-12f) * (1.0f / 127.0f);
    for (int d = lane; d < D; d += 32)
      sm.qi[g * D + d] = (int8_t)rintf(sm.qf[g * D + d] / sc);
    if (lane == 0) sm.qs[g] = sc;
  }
}

// page ids of the nbk blocks from t_first of row b into sm.pid (paged)
__device__ __forceinline__ void load_pids(const Split& a, const Smem& sm,
                                          int b, int t_first, int nbk) {
  if (a.pt == nullptr) return;
  for (int i = threadIdx.x; i < nbk; i += kThreads)
    sm.pid[i] = a.pt[(size_t)b * a.max_pages + t_first + i];
}

// The K rows of tokens [tok0, tok0 + ntok) of stream (b, h) into kt, packed
// and swizzled (16-byte piece j of token i is flat piece c = i * D / 16 + j,
// at c ^ ((c >> 3) & 7): the eight tokens of a quarter warp read eight bank
// groups), their scales into ks, and, when vt is not null, their V rows into
// vt (packed, D bytes apart) and scales into vs. Each block's run is
// contiguous in the cache: one warp a block, 16 bytes a lane. sm.pid holds
// the page ids of blocks t_first... (paged).
__device__ __forceinline__ void copy_rows(const Split& a, const Smem& sm,
                                          int bh, int h, int tok0, int ntok,
                                          int8_t* kt, float* ks, int8_t* vt,
                                          float* vs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = a.D, pieces = D / 16, bt = a.bt;
  const int t_first = tok0 / bt;
  const int nbk = ntok > 0 ? (tok0 + ntok - 1) / bt - t_first + 1 : 0;
  for (int jb = warp; jb < nbk; jb += kWarps) {
    const int t = t_first + jb;
    const int lo = max(tok0, t * bt), hi = min(tok0 + ntok, (t + 1) * bt);
    const size_t row =
        (a.pt != nullptr ? ((size_t)sm.pid[jb] * a.KVH + h) * bt
                         : (size_t)bh * a.T + (size_t)t * bt) +
        (lo - t * bt);
    const int c0 = (lo - tok0) * pieces;
    for (int r = lane; r < (hi - lo) * pieces; r += 32) {
      const int c = c0 + r;
      cp_async16(kt + ((c ^ ((c >> 3) & 7)) << 4), a.k + row * D + 16 * r);
      if (vt != nullptr) cp_async16(vt + 16 * c, a.v + row * D + 16 * r);
    }
    for (int r = lane; r < hi - lo; r += 32) {
      cp_async4(ks + lo - tok0 + r, a.ks + row + r);
      if (vt != nullptr) cp_async4(vs + lo - tok0 + r, a.vs + row + r);
    }
  }
  cp_async_commit();
}

// The walk's step 5 for stream bh and the normalization: thread tid < D
// holds acc[g] of column tid, sm.fm[g] and sm.fm[kMaxG + g] the running max
// and sum of head g, cur the current token's columns and, unless Q,
// sm.qf the unrounded q. Every thread calls it.
template <bool Q>
__device__ void finish(const Split& a, const Smem& sm, int bh,
                       const float (&acc)[kMaxG], const Current<Q>& cur) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = a.G, D = a.D;
  float* m_s = sm.fm;
  float* s_s = sm.fm + kMaxG;
  float* alpha_s = sm.fm + 2 * kMaxG;
  float* pcur_s = sm.fm + 3 * kMaxG;
  if (a.incl) {
    // inline: every row attends at least token 0, so s > 0
    if (tid < D) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) a.out[((size_t)bh * G + g) * D + tid] = acc[g] / s_s[g];
    }
    return;
  }
  // staged: the current token (f32 dots on the unrounded q), then
  // normalize
#pragma unroll
  for (int k = 0; k < kMaxG / kWarps; ++k) {
    const int g = warp + kWarps * k;
    if (g >= G) break;
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i) {
      if (lane + 32 * i < D) {
        const float qv = Q ? cur.q[Q ? k : 0][i] : sm.qf[g * D + lane + 32 * i];
        part += qv * cur.kn[i];
      }
    }
    const float logit = warp_sum(part) * a.scale;
    const float m_prev = m_s[g];
    const float s_prev = s_s[g];
    const float m_new = fmaxf(m_prev, logit);
    const float alpha = expf(m_prev - m_new);
    const float p = expf(logit - m_new);
    if (lane == 0) {
      s_s[g] = s_prev * alpha + p;
      alpha_s[g] = alpha;
      pcur_s[g] = p;
    }
  }
  __syncthreads();
  if (tid < D) {
    const float vcur = cur.vn;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float o = (acc[g] * alpha_s[g] + pcur_s[g] * vcur) / s_s[g];
        a.out[((size_t)bh * G + g) * D + tid] = o;
      }
    }
  }
}

// acc = acc * alpha + contrib and s = s * alpha + tot for block state st
// (m, alpha, tot, i8 code scale) and contribution c (the i8 integer sum's
// bits), rounded as the walk rounds them (its i8 contribution is
// (float)tot * pvs)
template <bool I8>
__device__ __forceinline__ void chain(float& acc, float& s, float4 st,
                                      float c) {
  if (I8)
    acc = __fmaf_rn((float)__float_as_int(c), st.w, __fmul_rn(acc, st.y));
  else
    acc = __fmaf_rn(acc, st.y, c);
  s = __fmaf_rn(s, st.y, st.z);
}

// -------------------------------------------------------------------------
// A. a chunk's logits and block maxima
// -------------------------------------------------------------------------

template <int DOTS>
__device__ void item_chunk(const Split& a, const Smem& sm, int b, int h,
                           int c, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = a.G, bh = b * a.KVH + h;
  const int s0 = c * a.asegs;
  const int s1 = min(s0 + a.asegs, live_segs(a, n));
  const int tok0 = seg_start(a, s0);
  const int ntok = min(seg_end(a, s1 - 1), n) - tok0;
  const int t_first = tok0 / a.bt;
  load_q(a, sm, bh);
  load_pids(a, sm, b, t_first, (tok0 + ntok - 1) / a.bt - t_first + 1);
  __syncthreads();
  copy_rows(a, sm, bh, h, tok0, ntok, sm.r0, sm.r3, nullptr, nullptr);
  if (DOTS != kDotsF32) {
    cp_async_wait<1>();  // q
    __syncthreads();
    quantize_q<DOTS>(a, sm);
  }
  cp_async_wait<0>();
  __syncthreads();
  // one thread per token
  for (int i = threadIdx.x; i < ntok; i += kThreads)
    token_logits<DOTS>(a, sm, sm.r0, sm.r3, i, sm.r2,
                       a.logits + (size_t)bh * G * a.T + tok0);
  __syncthreads();
  // each live segment's max, one warp per (segment, head)
  for (int e = warp; e < (s1 - s0) * G; e += kWarps) {
    const int s = s0 + e / G, g = e % G;
    const int lo = seg_start(a, s) - tok0;
    const int hi = min(seg_end(a, s), n) - tok0;
    float m = kNegInf;
    for (int i = lo + lane; i < hi; i += 32)
      m = fmaxf(m, sm.r2[g * kChunk + i]);
    m = warp_max(m);
    if (lane == 0) a.smax[((size_t)bh * G + g) * a.nseg + s] = m;
  }
}

// -------------------------------------------------------------------------
// B. a window: each block's softmax state and p @ V
// -------------------------------------------------------------------------

template <int DOTS>
__device__ void item_window(const Split& a, const Smem& sm, int b, int h,
                            int c, int n, const int* a_done, int a_items) {
  constexpr bool I8 = DOTS == kDotsI8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = a.G, D = a.D, bt = a.bt, pieces = D / 16;
  const int bh = b * a.KVH + h;
  const bool long_block = bt > kChunk;
  const int t0 = c * a.nbw;  // the window's first block
  const int nb = min(a.nbw, live_blocks(a, n) - t0);
  const int base = t0 * bt;  // its first token
  const int ntok = min(nb * bt, n - base);
  const int nwin = long_block ? (ntok + kChunk - 1) / kChunk : 1;
  const int ntask = nb * G;  // (block, head) pairs, k = j * G + g
  // the window's live segments a head: one a block, or a long block's
  const int nsw = long_block ? (ntok + a.seg - 1) / a.seg : nb;
  int8_t* v_s = sm.r0;
  float* part_s = sm.r1;
  float* segm_s = sm.r1;  // read before part_s is written
  float* pv_s = sm.r2;
  float* vs_s = sm.r3;

  // the stream's chunks done, read while the window's rows are found
  const int seen = tid == 0 ? load_acquire(a_done) : 0;
  if (tid < nb)
    sm.brow[tid] = a.pt != nullptr
                       ? ((size_t)a.pt[(size_t)b * a.max_pages + t0 + tid] *
                              a.KVH + h) * bt
                       : (size_t)bh * a.T + (size_t)(t0 + tid) * bt;
  __syncthreads();
  // V rows and scales of the window's tokens [w0, w0 + wn) (each block's
  // run is contiguous, one warp a block), then their logits
  auto copy_v = [&](int w0, int wn) {
    for (int j = warp; j < nb; j += kWarps) {
      const int lo = max(w0, j * bt);
      const int hi = min(w0 + wn, min((j + 1) * bt, ntok));
      if (lo >= hi) continue;
      const size_t row = sm.brow[j] + (lo - j * bt);
      const int8_t* src = a.v + row * D;
      int8_t* dst = v_s + (size_t)(lo - w0) * D;
      for (int r = lane; r < (hi - lo) * pieces; r += 32)
        cp_async16(dst + 16 * r, src + 16 * r);
      for (int r = lane; r < hi - lo; r += 32)
        cp_async4(vs_s + lo - w0 + r, a.vs + row + r);
    }
    cp_async_commit();
  };
  // the chunks' outputs, written in this launch: read through L2
  auto load_logits = [&](int w0, int wn) {
    for (int g = warp; g < G; g += kWarps) {
      const float* src = a.logits + ((size_t)bh * G + g) * a.T + base + w0;
#pragma unroll 4
      for (int r = lane; r < wn; r += 32)
        pv_s[g * kChunk + r] = __ldcg(src + r);
    }
  };
  copy_v(0, min(ntok, kChunk));
  wait_count(a_done, a_items, seen);  // the stream's chunks
  load_logits(0, min(ntok, kChunk));
  for (int e = tid; e < G * nsw; e += kThreads) {
    const int g = e / nsw, s = e - g * nsw;
    segm_s[e] =
        __ldcg(a.smax + ((size_t)bh * G + g) * a.nseg + t0 * a.spb + s);
  }
  // the running max before the window, from the segment maxima
  for (int g = warp; g < G; g += kWarps) {
    const float* smx = a.smax + ((size_t)bh * G + g) * a.nseg;
    float m = kNegInf;
    for (int s = lane; s < t0 * a.spb; s += 32) m = fmaxf(m, __ldcg(smx + s));
    m = warp_max(m);
    if (lane == 0) sm.mprev[g] = m;
  }
  cp_async_wait<0>();
  __syncthreads();
  // each block's running max m_t and alpha_t = expf(m_{t-1} - m_t), one
  // warp a head: a long block's max over its segments, or the blocks' (one
  // a lane, at most kSlots) prefix max (a max is exact in any order)
  for (int g = warp; g < G; g += kWarps) {
    const float* sg = segm_s + g * nsw;
    const float m0 = sm.mprev[g];
    if (long_block) {
      float bmx = kNegInf;
      for (int s = lane; s < nsw; s += 32) bmx = fmaxf(bmx, sg[s]);
      bmx = warp_max(bmx);
      if (lane == 0) {
        const float m_new = fmaxf(m0, bmx);
        sm.m[g] = m_new;
        sm.al[g] = expf(m0 - m_new);
      }
    } else {
      float m_new = lane < nb ? sg[lane] : kNegInf;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, m_new, off);
        if (lane >= off) m_new = fmaxf(m_new, o);
      }
      m_new = fmaxf(m0, m_new);
      float m_prev = __shfl_up_sync(0xffffffffu, m_new, 1);
      if (lane == 0) m_prev = m0;
      if (lane < nb) {
        sm.m[lane * G + g] = m_new;
        sm.al[lane * G + g] = expf(m_prev - m_new);
      }
    }
  }
  __syncthreads();

  // this warp's (block, head) tasks k = warp + jj * kWarps: lane partials
  // of the sum of p and the absmax of p * vs; the i8 code scale
  float ps[kTaskSlots], pvm[kTaskSlots], sc[kTaskSlots];
#pragma unroll
  for (int jj = 0; jj < kTaskSlots; ++jj) {
    ps[jj] = 0.f;
    pvm[jj] = 0.f;
    sc[jj] = 0.f;
  }
  if (I8 && long_block) {
    // the walk's pass over every sub-tile for the sum and the absmax
#pragma unroll
    for (int jj = 0; jj < kTaskSlots; ++jj) {
      const int g = warp + jj * kWarps;  // one block: k == g
      if (g >= ntask) continue;
      const float m = sm.m[g];
      const float* lgg = a.logits + ((size_t)bh * G + g) * a.T + base;
      const float* vsb = a.vs + sm.brow[0];
      for (int i = lane; i < ntok; i += 32) {
        const float p = expf(__ldcg(lgg + i) - m);
        const float pv = p * vsb[i];
        ps[jj] += p;
        pvm[jj] = fmaxf(pvm[jj], pv);
      }
      sc[jj] = fmaxf(warp_max(pvm[jj]), 1e-30f) * (1.0f / 127.0f);
    }
  }

  const int d0 = 4 * lane;
  for (int win = 0; win < nwin; ++win) {
    const int w0 = win * kChunk, wn = min(kChunk, ntok - w0);
    if (win > 0) {
      copy_v(w0, wn);
      load_logits(w0, wn);
      cp_async_wait<0>();
      __syncthreads();
    }

    // 2. the probabilities of each task's block tokens in this window
#pragma unroll
    for (int jj = 0; jj < kTaskSlots; ++jj) {
      const int k = warp + jj * kWarps;
      if (k >= ntask) continue;
      const int j = k / G, g = k - j * G;
      const int bs = j * bt;                   // block start, window-local
      const int nv = min(bt, ntok - bs);       // its live tokens
      const int i0 = max(0, w0 - bs), i1 = min(nv, w0 + wn - bs);
      const float m = sm.m[k];
      float* pvg = pv_s + g * kChunk + bs - w0;  // block-local index
      const float* vsg = vs_s + bs - w0;
      for (int i = i0 + lane; i < i1; i += 32) {
        const float p = expf(pvg[i] - m);
        const float pv = p * vsg[i];
        if (I8 && long_block) {
          pvg[i] = (float)(int8_t)rintf(pv / sc[jj]);
        } else {
          ps[jj] += p;
          pvm[jj] = fmaxf(pvm[jj], pv);
          pvg[i] = DOTS == kDotsBF16 ? bf16_round(pv) : pv;
        }
      }
      if (I8 && !long_block) {
        // every p * vs of the block has been seen by now
        sc[jj] = fmaxf(warp_max(pvm[jj]), 1e-30f) * (1.0f / 127.0f);
        for (int i = i0 + lane; i < i1; i += 32)
          pvg[i] = (float)(int8_t)rintf(pvg[i] / sc[jj]);
      }
    }
    __syncthreads();

    // 3. (p * vs) @ v: chain `warp` of each block sums its tokens i = warp
    //    (mod 4) in order, each lane four head_dim columns, head by head; a
    //    block that goes on in the next window keeps its sums in part_s
    if (d0 < D && !long_block) {
      // a window of whole blocks: head by head, block by block, chain
      // `warp` of block j sums its tokens lo + warp, lo + warp + 4, ...
      const int step = kWarps * G * D;  // from block j's sums to j + 1's
      for (int g = 0; g < G; ++g) {
        const float* pvg = pv_s + g * kChunk;
        float* pp = part_s + (warp * G + g) * D + d0;
        for (int lo = 0; lo < ntok; lo += bt, pp += step) {
          const int hi = min(lo + bt, ntok);
          if (I8) {
            int4 acc = make_int4(0, 0, 0, 0);
#pragma unroll 4
            for (int il = lo + warp; il < hi; il += kWarps) {
              const unsigned vw =
                  *reinterpret_cast<const unsigned*>(v_s + (size_t)il * D + d0);
              const int cd = (int)pvg[il];
              acc.x += cd * (int)(int8_t)(vw & 0xFFu);
              acc.y += cd * (int)(int8_t)((vw >> 8) & 0xFFu);
              acc.z += cd * (int)(int8_t)((vw >> 16) & 0xFFu);
              acc.w += cd * (int)(int8_t)((vw >> 24) & 0xFFu);
            }
            // each chain's integer sum through an f32, as the walk adds it
            *reinterpret_cast<float4*>(pp) = make_float4(
                (float)acc.x, (float)acc.y, (float)acc.z, (float)acc.w);
          } else {
            float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
            for (int il = lo + warp; il < hi; il += kWarps) {
              const unsigned vw =
                  *reinterpret_cast<const unsigned*>(v_s + (size_t)il * D + d0);
              const float p = pvg[il];
              acc.x += p * (float)(int8_t)(vw & 0xFFu);
              acc.y += p * (float)(int8_t)((vw >> 8) & 0xFFu);
              acc.z += p * (float)(int8_t)((vw >> 16) & 0xFFu);
              acc.w += p * (float)(int8_t)((vw >> 24) & 0xFFu);
            }
            *reinterpret_cast<float4*>(pp) = acc;
          }
        }
      }
    } else if (d0 < D) {
      for (int k = 0; k < ntask; ++k) {
        const int j = k / G, g = k - j * G;
        const int bs = j * bt;
        const int nv = min(bt, ntok - bs);
        const int i0 = max(0, w0 - bs), i1 = min(nv, w0 + wn - bs);
        if (i0 >= i1) continue;
        const bool ends = bs + nv <= w0 + wn;
        float* pp = part_s + ((j * kWarps + warp) * G + g) * D + d0;
        const float* pvg = pv_s + g * kChunk + bs - w0;
        const int8_t* vb = v_s + (ptrdiff_t)(bs - w0) * D + d0;
        if (I8) {
          int4 acc = i0 > 0 ? *reinterpret_cast<const int4*>(pp)
                            : make_int4(0, 0, 0, 0);
#pragma unroll 4
          for (int i = i0 + warp; i < i1; i += kWarps) {
            const unsigned vw =
                *reinterpret_cast<const unsigned*>(vb + (ptrdiff_t)i * D);
            const int cd = (int)pvg[i];
            acc.x += cd * (int)(int8_t)(vw & 0xFFu);
            acc.y += cd * (int)(int8_t)((vw >> 8) & 0xFFu);
            acc.z += cd * (int)(int8_t)((vw >> 16) & 0xFFu);
            acc.w += cd * (int)(int8_t)((vw >> 24) & 0xFFu);
          }
          // a finished chain goes through an f32, as the walk adds it
          if (ends)
            *reinterpret_cast<float4*>(pp) = make_float4(
                (float)acc.x, (float)acc.y, (float)acc.z, (float)acc.w);
          else
            *reinterpret_cast<int4*>(pp) = acc;
        } else {
          float4 acc = i0 > 0 ? *reinterpret_cast<const float4*>(pp)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
          for (int i = i0 + warp; i < i1; i += kWarps) {
            const unsigned vw =
                *reinterpret_cast<const unsigned*>(vb + (ptrdiff_t)i * D);
            const float p = pvg[i];
            acc.x += p * (float)(int8_t)(vw & 0xFFu);
            acc.y += p * (float)(int8_t)((vw >> 8) & 0xFFu);
            acc.z += p * (float)(int8_t)((vw >> 16) & 0xFFu);
            acc.w += p * (float)(int8_t)((vw >> 24) & 0xFFu);
          }
          *reinterpret_cast<float4*>(pp) = acc;
        }
      }
    }
    __syncthreads();
  }

  // 4. each block's state, and its contribution with the four chains added
  //    in a fixed order
#pragma unroll
  for (int jj = 0; jj < kTaskSlots; ++jj) {
    const int k = warp + jj * kWarps;
    if (k >= ntask) continue;
    const int j = k / G, g = k - j * G;
    const float tot = warp_sum(ps[jj]);
    if (lane == 0)
      a.state[((size_t)bh * a.nblk + t0 + j) * G + g] =
          make_float4(sm.m[k], sm.al[k], tot, sc[jj]);
    const float* pp = part_s + (j * kWarps * G + g) * D;
    const size_t o = (((size_t)bh * a.nblk + t0 + j) * G + g) * D;
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i) {
      const int d = lane + 32 * i;
      if (d >= D) break;
      if (I8) {
        int tot_i = 0;
        for (int w = 0; w < kWarps; ++w) tot_i += (int)pp[w * G * D + d];
        reinterpret_cast<int*>(a.contrib)[o + d] = tot_i;
      } else {
        float contrib = 0.f;
        for (int w = 0; w < kWarps; ++w) contrib += pp[w * G * D + d];
        a.contrib[o + d] = contrib;
      }
    }
  }
}

// -------------------------------------------------------------------------
// C. a stream's ordered combine and its current token
// -------------------------------------------------------------------------

template <int DOTS>
__device__ void item_combine(const Split& a, const Smem& sm, int bh, int n,
                             const int* b_done, int b_items) {
  constexpr bool I8 = DOTS == kDotsI8;
  const int tid = threadIdx.x;
  const int G = a.G, D = a.D, per = G * D;
  const int nbl = live_blocks(a, n);
  const int cb = kCStage / (per + 4 * G);  // blocks a stage
  const int nch = (nbl + cb - 1) / cb;
  const float* src = a.contrib + (size_t)bh * a.nblk * per;
  const float4* sst = a.state + (size_t)bh * a.nblk * G;
  // the stream's window outputs, written in this launch: cp.async.cg
  // reads them through L2
  auto load = [&](int ch) {
    const int t0 = ch * cb, nt = min(cb, nbl - t0);
    float* d = (ch & 1) ? sm.r1 : reinterpret_cast<float*>(sm.r0);
    const float* s = src + (size_t)t0 * per;
    for (int e = tid; e < nt * per / 4; e += kThreads)
      cp_async16(d + 4 * e, s + 4 * e);
    for (int e = tid; e < nt * G; e += kThreads)
      cp_async16(d + cb * per + 4 * e, sst + (size_t)t0 * G + e);
    cp_async_commit();
  };
  float acc[kMaxG], s[kMaxG], m[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    acc[g] = 0.f;
    s[g] = 0.f;
    m[g] = kNegInf;
  }
  const int seen = tid == 0 ? load_acquire(b_done) : 0;
  const Current<false> cur = load_current<false>(a, bh);
  if (!a.incl) load_q(a, sm, bh);  // for the current token's dot
  wait_count(b_done, b_items, seen);  // the stream's windows
  if (nch > 0) load(0);
  if (nch > 1) load(1);
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (tid < D) {
      const float* cbuf = (ch & 1) ? sm.r1 : reinterpret_cast<float*>(sm.r0);
      const float4* sbuf = reinterpret_cast<const float4*>(cbuf + cb * per);
      const int nt = min(cb, nbl - ch * cb);
      for (int t = 0; t < nt; ++t) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float4 st = sbuf[t * G + g];
            chain<I8>(acc[g], s[g], st, cbuf[(t * G + g) * D + tid]);
            m[g] = st.x;
          }
        }
      }
    }
    __syncthreads();  // before the stage is filled again
    if (ch + 2 < nch) load(ch + 2);
  }
  cp_async_wait<0>();  // q
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        sm.fm[g] = m[g];
        sm.fm[kMaxG + g] = s[g];
      }
    }
  }
  __syncthreads();
  finish(a, sm, bh, acc, cur);
}

// -------------------------------------------------------------------------
// W. a whole stream of at most one chunk and one window
// -------------------------------------------------------------------------

template <int DOTS>
__device__ void item_whole(const Split& a, const Smem& sm, int b, int h,
                           int n) {
  constexpr bool I8 = DOTS == kDotsI8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = a.G, D = a.D, bt = a.bt, bh = b * a.KVH + h;
  const int nbk = live_blocks(a, n);
  const int ntask = nbk * G;  // (block, head) k = j * G + g
  int8_t* kt = reinterpret_cast<int8_t*>(sm.r1);
  int8_t* vt = sm.r0;
  float* lg = sm.r2;
  float* vs = sm.r3;
  float* ks = sm.r4;
  // qf holds q as the cache dots take it: bf16 keeps the unrounded q here
  constexpr bool kQ = DOTS == kDotsBF16;
  const Current<kQ> cur = load_current<kQ>(a, bh);
  load_q(a, sm, bh);
  load_pids(a, sm, b, 0, nbk);
  __syncthreads();
  copy_rows(a, sm, bh, h, 0, n, kt, ks, vt, vs);
  if (DOTS != kDotsF32) {
    cp_async_wait<1>();  // q
    __syncthreads();
    quantize_q<DOTS>(a, sm);
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < n; i += kThreads)
    token_logits<DOTS>(a, sm, kt, ks, i, lg, nullptr);
  __syncthreads();
  // each block's max, then its running max and alpha (from -1e30)
  for (int k = warp; k < ntask; k += kWarps) {
    const int j = k / G, g = k - j * G;
    const int lo = j * bt, hi = min(n, lo + bt);
    float m = kNegInf;
    for (int i = lo + lane; i < hi; i += 32) m = fmaxf(m, lg[g * kChunk + i]);
    m = warp_max(m);
    if (lane == 0) sm.bm[k] = m;
  }
  __syncthreads();
  if (tid < G) {
    float m = kNegInf;
    for (int j = 0; j < nbk; ++j) {
      const float m_new = fmaxf(m, sm.bm[j * G + tid]);
      sm.m[j * G + tid] = m_new;
      sm.al[j * G + tid] = expf(m - m_new);
      m = m_new;
    }
    sm.fm[tid] = m;  // the running max after the last block
  }
  __syncthreads();
  // 2. each block's probabilities, sum, absmax and i8 codes
  for (int k = warp; k < ntask; k += kWarps) {
    const int j = k / G, g = k - j * G;
    const int lo = j * bt, nv = min(n, lo + bt) - lo;
    const float m = sm.m[k];
    float* pvg = lg + g * kChunk + lo;
    const float* vsg = vs + lo;
    float ps = 0.f, pvm = 0.f;
    for (int i = lane; i < nv; i += 32) {
      const float p = expf(pvg[i] - m);
      const float pv = p * vsg[i];
      ps += p;
      pvm = fmaxf(pvm, pv);
      pvg[i] = DOTS == kDotsBF16 ? bf16_round(pv) : pv;
    }
    float sc = 0.f;
    if (I8) {
      sc = fmaxf(warp_max(pvm), 1e-30f) * (1.0f / 127.0f);
      for (int i = lane; i < nv; i += 32)
        pvg[i] = (float)(int8_t)rintf(pvg[i] / sc);
    }
    const float tot = warp_sum(ps);
    if (lane == 0) {
      sm.tot[k] = tot;
      sm.sc[k] = sc;
    }
  }
  __syncthreads();
  // 3. (p * vs) @ v: chain `warp` of each block and head into part_s (R1:
  //    K is done with), laid out as a window's
  float* part_s = sm.r1;
  const int d0 = 4 * lane;
  if (d0 < D) {
    for (int k = 0; k < ntask; ++k) {
      const int j = k / G, g = k - j * G;
      const int lo = j * bt, nv = min(n, lo + bt) - lo;
      const float* pvg = lg + g * kChunk + lo;
      const int8_t* vb = vt + (size_t)lo * D + d0;
      float* pp = part_s + ((j * kWarps + warp) * G + g) * D + d0;
      if (I8) {
        int4 is = make_int4(0, 0, 0, 0);
#pragma unroll 4
        for (int i = warp; i < nv; i += kWarps) {
          const unsigned vw =
              *reinterpret_cast<const unsigned*>(vb + (size_t)i * D);
          const int cd = (int)pvg[i];
          is.x += cd * (int)(int8_t)(vw & 0xFFu);
          is.y += cd * (int)(int8_t)((vw >> 8) & 0xFFu);
          is.z += cd * (int)(int8_t)((vw >> 16) & 0xFFu);
          is.w += cd * (int)(int8_t)((vw >> 24) & 0xFFu);
        }
        // each chain's integer sum through an f32, as the walk adds it
        *reinterpret_cast<float4*>(pp) =
            make_float4((float)is.x, (float)is.y, (float)is.z, (float)is.w);
      } else {
        float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int i = warp; i < nv; i += kWarps) {
          const unsigned vw =
              *reinterpret_cast<const unsigned*>(vb + (size_t)i * D);
          const float p = pvg[i];
          f.x += p * (float)(int8_t)(vw & 0xFFu);
          f.y += p * (float)(int8_t)((vw >> 8) & 0xFFu);
          f.z += p * (float)(int8_t)((vw >> 16) & 0xFFu);
          f.w += p * (float)(int8_t)((vw >> 24) & 0xFFu);
        }
        *reinterpret_cast<float4*>(pp) = f;
      }
    }
  }
  __syncthreads();
  // 4. block by block, each block's chains added in a fixed order, then
  //    the ordered combine
  float acc[kMaxG], ssum[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    acc[g] = 0.f;
    ssum[g] = 0.f;
  }
  if (tid < D) {
    for (int j = 0; j < nbk; ++j) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) continue;
        const int k = j * G + g;
        const float* pp = part_s + (j * kWarps * G + g) * D + tid;
        float c;
        if (I8) {
          int tot_i = 0;
          for (int w = 0; w < kWarps; ++w) tot_i += (int)pp[w * G * D];
          c = __int_as_float(tot_i);
        } else {
          c = 0.f;
          for (int w = 0; w < kWarps; ++w) c += pp[w * G * D];
        }
        chain<I8>(acc[g], ssum[g],
                  make_float4(sm.m[k], sm.al[k], sm.tot[k], sm.sc[k]), c);
      }
    }
  }
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        if (nbk == 0) sm.fm[g] = kNegInf;
        sm.fm[kMaxG + g] = ssum[g];
      }
    }
  }
  __syncthreads();
  finish(a, sm, bh, acc, cur);
}

// -------------------------------------------------------------------------
// the launch: persistent CTAs taking tickets
// -------------------------------------------------------------------------

template <int DOTS>
__global__ void __launch_bounds__(kThreads, 3) split_attend(const Split a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm(smem);
  const int tid = threadIdx.x;
  const int streams = a.B * a.KVH;
  int* ticket = a.counters;
  int* a_done = a.counters + 1;
  int* b_done = a_done + streams;
  int* exits = b_done + streams;
  // the rows in tiles of kMaxRows: a tile's rows' A (or W) and B items a
  // stream in shared memory, its tickets [lo, hi) after the tiles before it
  int row0 = 0, rows = 0, lo = 0, hi = 0;
  auto stage = [&]() {
    rows = min(kMaxRows, a.B - row0);
    for (int i = tid; i < rows; i += kThreads) {
      const int n = attended(a, a.pos[row0 + i]);
      sm.pos[i] = n;
      const bool whole = whole_row(a, n);
      sm.ua[i] = whole ? 1 : (live_segs(a, n) + a.asegs - 1) / a.asegs;
      sm.ub[i] = whole ? 0 : (live_blocks(a, n) + a.nbw - 1) / a.nbw;
    }
    __syncthreads();
    int items = 0;  // the C items are the rows' with B items
    for (int i = 0; i < rows; ++i)
      items += sm.ua[i] + sm.ub[i] + (sm.ub[i] > 0 ? 1 : 0);
    lo = hi;
    hi += items * a.KVH;
  };
  // the first ticket, in flight while the first tile is staged
  int first = 0;
  if (tid == 0) first = atomicAdd(ticket, 1);
  stage();
  if (tid == 0) *sm.ticket = first;
  __syncthreads();
  for (int r = *sm.ticket;;) {
    while (r >= hi && row0 + rows < a.B) {
      __syncthreads();  // every thread is done with the tile's rows
      row0 += rows;
      stage();
    }
    if (r >= hi) break;
    // the next ticket, fetched while this item runs (its items depend only
    // on smaller tickets, so holding it cannot deadlock)
    int next = 0;
    if (tid == 0) next = atomicAdd(ticket, 1);
    // ticket r -> region (0: A and W, 1: B, 2: C), row row0 + i, head h,
    // unit c
    r -= lo;
    int region = 0, i = 0, units = 0;
    for (; region < 3; ++region) {
      for (i = 0; i < rows; ++i) {
        units = region == 0 ? sm.ua[i]
              : region == 1 ? sm.ub[i]
                            : (sm.ub[i] > 0 ? 1 : 0);
        if (r < units * a.KVH) break;
        r -= units * a.KVH;
      }
      if (i < rows) break;
    }
    const int b = row0 + i, h = r / units, c = r - h * units;
    const int n = sm.pos[i], bh = b * a.KVH + h;
    if (region == 0) {
      if (sm.ub[i] == 0) {
        item_whole<DOTS>(a, sm, b, h, n);
      } else {
        item_chunk<DOTS>(a, sm, b, h, c, n);
        publish(a_done + bh);
      }
    } else if (region == 1) {
      item_window<DOTS>(a, sm, b, h, c, n, a_done + bh, sm.ua[i]);
      publish(b_done + bh);
    } else {
      item_combine<DOTS>(a, sm, bh, n, b_done + bh, sm.ub[i]);
    }
    __syncthreads();
    if (tid == 0) *sm.ticket = next;
    __syncthreads();
    r = *sm.ticket;
  }
  // the last CTA out leaves the counters zeroed for the next launch on
  // this stream (every item is done by then)
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    *sm.ticket = atomicAdd(exits, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (*sm.ticket) {
    for (int i = tid; i <= 2 * streams; i += kThreads) a.counters[i] = 0;
    if (tid == 0) *exits = 0;
    __threadfence();
  }
}

// the kernel's dynamic shared memory over 48 KB, allowed once per device
template <int DOTS>
cudaError_t allow_smem() {
  static unsigned long long done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(split_attend<DOTS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err == cudaSuccess) done |= bit;
  return err;
}

template <int DOTS>
int launch(const Split& a, int grid, cudaStream_t st) {
  const cudaError_t err = allow_smem<DOTS>();
  if (err != cudaSuccess) return (int)err;
  split_attend<DOTS><<<grid, kThreads, kSmem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, KVH, G, D) f32; k, v: one layer of the cache (B, KVH, T, D) int8,
// or with page_tables (B, max_pages) int32 one layer of the pool (NP, KVH,
// block_t, D) and T = max_pages * block_t; ks, vs the matching f32 scales;
// k_new, v_new (B, KVH, D) f32 when staged (else null); pos (B) int32; out
// (B, KVH, G, D) f32; logits, smax, state, contrib: f32 scratch of
// _decode_split_plan's sizes, each 16-byte aligned; counters: 2 + 2 B KVH
// int32, zero at the launch and left zero. seg, spb, nseg, asegs, nbw and
// the grid come from that plan; every page id must be < NP (the wrapper
// checks).
extern "C" int flash_decode_split_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* k_new, const void* v_new, const void* pos,
    const void* page_tables, void* out, void* logits, void* smax,
    void* state, void* contrib, void* counters, int B, int KVH, int G, int D,
    int T, int block_t, int max_pages, int seg, int spb, int nseg, int asegs,
    int nbw, int grid, float scale, int dots, int staged, void* stream) {
  const int nblk = block_t > 0 ? T / block_t : 0;
  if (B < 1 || KVH < 1 || G < 1 || G > kMaxG || D < 16 ||
      D > kMaxD || D % 16 != 0 || block_t < 1 || T % block_t != 0 ||
      dots < kDotsF32 || dots > kDotsI8 || grid < 1 ||
      seg != (block_t < kChunk ? block_t : kChunk) ||
      spb != (block_t + seg - 1) / seg || nseg != nblk * spb ||
      spb * G > kMaxSegs || asegs < 1 || asegs * seg > kChunk ||
      (block_t > kChunk && (asegs != 1 || nbw != 1)) || nbw < 1 ||
      (block_t <= kChunk && (nbw * block_t > kChunk || nbw * G > kSlots)) ||
      (page_tables != nullptr && (max_pages < 1 || T != max_pages * block_t)) ||
      (staged && (k_new == nullptr || v_new == nullptr)) ||
      (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
       reinterpret_cast<uintptr_t>(state) |
       reinterpret_cast<uintptr_t>(contrib)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Split a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const int8_t*>(k);
  a.v = static_cast<const int8_t*>(v);
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.kn = static_cast<const float*>(k_new);
  a.vn = static_cast<const float*>(v_new);
  a.pos = static_cast<const int*>(pos);
  a.pt = static_cast<const int*>(page_tables);
  a.out = static_cast<float*>(out);
  a.logits = static_cast<float*>(logits);
  a.smax = static_cast<float*>(smax);
  a.state = static_cast<float4*>(state);
  a.contrib = static_cast<float*>(contrib);
  a.counters = static_cast<int*>(counters);
  a.B = B;
  a.KVH = KVH;
  a.G = G;
  a.D = D;
  a.T = T;
  a.bt = block_t;
  a.nblk = nblk;
  a.max_pages = max_pages;
  a.seg = seg;
  a.spb = spb;
  a.nseg = nseg;
  a.asegs = asegs;
  a.nbw = nbw;
  a.incl = staged ? 0 : 1;
  a.scale = scale;
  const auto st = static_cast<cudaStream_t>(stream);
  if (dots == kDotsI8) return launch<kDotsI8>(a, grid, st);
  if (dots == kDotsBF16) return launch<kDotsBF16>(a, grid, st);
  return launch<kDotsF32>(a, grid, st);
}
