// Flash-decode attention over a head-major int8 KV cache: one query token
// per (b, kv-head) with G grouped query heads, online softmax over the live
// token blocks of one layer (int8 codes, per-(token, head) f32 scales).
//
// One kernel template, four entry points, each replacing one TPU kernel of
// ee274_convexcaldera_llm_quantization_tpu/ops/attention.py:
// - flash_decode_staged_launch: flash_decode_q8_staged
//   (_flash_decode_q8_staged_kernel). The cache holds the tokens < pos[b];
//   the staged f32 K/V of the current token add one online-softmax update
//   at the end (pos 0 attends the current token alone).
// - flash_decode_inline_launch: flash_decode_q8 (_flash_decode_q8_kernel).
//   The current token is already in the cache: the tokens <= pos[b] are
//   attended (pos 0 attends token 0), the live blocks are t <= pos / bt,
//   and there is no current-token update.
// - flash_decode_ab_launch: flash_decode_q8_ab (_flash_decode_q8_ab_kernel),
//   staged or inline. The TPU kernel attends a (Bb, KVH) slab of rows per
//   program with a per-slab compute guard (a block runs while any row of
//   the slab is live). A block that is past a row's last live block is
//   fully masked for that row and leaves its softmax state exactly as it
//   was (alpha = 1, p = 0, and in i8 the quantized p is 0), so the slab
//   guard does not change the result: this per-(b, kv-head) CTA over the
//   row's own live blocks, walking ab's block partition (the caller passes
//   _ab_blocks' block_t, which in dots="i8" is part of the result), computes
//   the ab kernel's function. The slab exists on the TPU to make fewer,
//   larger DMAs; on the GPU every (b, head) stream is already one CTA.
// - flash_decode_paged_launch: flash_decode_q8_paged (the staged kernel on a
//   grid whose block t of row b is pool page page_tables[b, t]: block ==
//   page). The cache is one layer of a paged pool (NP, KVH, P, D) int8 with
//   (NP, KVH, P) scales; block t of (b, h) starts at ((pt[b, t] * KVH + h) *
//   P) * D. The same body runs with the page table as a pointer (null for
//   the contiguous entries), so the staged and paged functions are one code
//   path. Only the live pages t < ceil(pos[b] / P) are read: the TPU's
//   clamped re-reads of the last page for dead blocks never contribute.
//
// Bound on an H100: the live K/V codes and scales (2 * live * (D + 4) bytes
// per (b, head)); the operations are 4 * G * D per live token, far below
// the card's rate. Design:
// - one CTA per (b, kv-head); a loop inside the CTA walks the live token
//   blocks, which takes the place of the TPU's sequential grid axis, and
//   skips the masked tokens of the last block (their probabilities are
//   exactly 0, so nothing is read for them);
// - one thread per live token computes its logits from its K row (16-byte
//   loads, all in flight together); the four warps split the block's tokens
//   for p @ V (4-byte loads, 128 B per warp and token) and add their
//   partial sums; logits and probabilities stay in shared memory, the f32
//   output accumulator in registers (one head_dim column per thread);
// - I8 = true is the reference's dots="i8": q quantizes per g over D
//   (qs = max(|q|, 1e-12) * (1/127)), p * vs quantizes per g over each
//   block_t block (pvs = max(pv, 1e-30) * (1/127)) and both dots run as
//   exact integer sums (__dp4a for QK). The block partition is therefore
//   part of the result, and the blocks here are the reference's blocks.
//   I8 = false is dots="f32", the exactness twin.
// - block_t is at most 256 (logits of a whole block sit in shared memory);
//   the wrappers raise on a larger block rather than re-partition it.
#include "flash_decode.cuh"

namespace {

using flash_decode::kMaxBT;
using flash_decode::kMaxD;
constexpr int kThreads = 128;
constexpr int kMaxG = 8;

template <bool I8, bool STAGED>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const float* __restrict__ q,
                    const int8_t* __restrict__ k,
                    const int8_t* __restrict__ v,
                    const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const float* __restrict__ kn,
                    const float* __restrict__ vn,
                    const int* __restrict__ pos,
                    const int* __restrict__ pt, int max_pages,
                    float* __restrict__ out, int KVH, int G, int D, int T,
                    int bt, float scale) {
  flash_decode::decode_attend<kThreads, kMaxG, I8, STAGED>(
      blockIdx.x, q, k, v, ks, vs, kn, vn, pos, pt, max_pages, out, KVH, G,
      D, T, bt, scale);
}

int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* k_new, const void* v_new,
           const void* pos, const void* page_tables, int max_pages,
           void* out, int B, int KVH, int G, int D, int T, int block_t,
           float scale, int i8, bool staged, void* stream) {
  if (B < 1 || KVH < 1 || G < 1 || G > kMaxG || D < 16 || D > kMaxD ||
      D % 16 != 0 || block_t < 1 || block_t > kMaxBT || T % block_t != 0 ||
      (page_tables != nullptr && (max_pages < 1 || T != max_pages * block_t)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * KVH);
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const int8_t*>(k);
  const auto* vp = static_cast<const int8_t*>(v);
  const auto* ksp = static_cast<const float*>(ks);
  const auto* vsp = static_cast<const float*>(vs);
  const auto* knp = static_cast<const float*>(k_new);
  const auto* vnp = static_cast<const float*>(v_new);
  const auto* pp = static_cast<const int*>(pos);
  const auto* ptp = static_cast<const int*>(page_tables);
  auto* op = static_cast<float*>(out);
  if (i8 && staged)
    flash_decode_kernel<true, true><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, ksp, vsp, knp, vnp, pp, ptp, max_pages, op, KVH, G, D, T,
        block_t, scale);
  else if (i8)
    flash_decode_kernel<true, false><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, ksp, vsp, knp, vnp, pp, ptp, max_pages, op, KVH, G, D, T,
        block_t, scale);
  else if (staged)
    flash_decode_kernel<false, true><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, ksp, vsp, knp, vnp, pp, ptp, max_pages, op, KVH, G, D, T,
        block_t, scale);
  else
    flash_decode_kernel<false, false><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, ksp, vsp, knp, vnp, pp, ptp, max_pages, op, KVH, G, D, T,
        block_t, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_decode_staged_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* k_new, const void* v_new, const void* pos,
    void* out, int B, int KVH, int G, int D, int T, int block_t, float scale,
    int i8, void* stream) {
  return launch(q, k, v, ks, vs, k_new, v_new, pos, nullptr, 0, out, B, KVH,
                G, D, T, block_t, scale, i8, true, stream);
}

extern "C" int flash_decode_inline_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* pos, void* out, int B, int KVH, int G, int D,
    int T, int block_t, float scale, int i8, void* stream) {
  return launch(q, k, v, ks, vs, nullptr, nullptr, pos, nullptr, 0, out, B,
                KVH, G, D, T, block_t, scale, i8, false, stream);
}

extern "C" int flash_decode_ab_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* k_new, const void* v_new, const void* pos,
    void* out, int B, int KVH, int G, int D, int T, int block_t, float scale,
    int i8, int staged, void* stream) {
  if (staged && (k_new == nullptr || v_new == nullptr))
    return (int)cudaErrorInvalidValue;
  return launch(q, k, v, ks, vs, k_new, v_new, pos, nullptr, 0, out, B, KVH,
                G, D, T, block_t, scale, i8, staged != 0, stream);
}

// k, v: one layer of the pool (NP, KVH, page_size, D) int8; ks, vs (NP, KVH,
// page_size) f32; page_tables (B, max_pages) int32, every id < NP (the
// wrapper checks); the staged current token's k_new, v_new (B, KVH, D) f32.
extern "C" int flash_decode_paged_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* k_new, const void* v_new, const void* pos,
    const void* page_tables, void* out, int B, int KVH, int G, int D,
    int max_pages, int page_size, float scale, int i8, void* stream) {
  if (k_new == nullptr || v_new == nullptr || page_tables == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch(q, k, v, ks, vs, k_new, v_new, pos, page_tables, max_pages,
                out, B, KVH, G, D, max_pages * page_size, page_size, scale, i8,
                true, stream);
}
