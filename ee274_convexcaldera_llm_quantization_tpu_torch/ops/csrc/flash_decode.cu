// Flash-decode attention over a head-major int8 KV cache: one query token
// per (b, kv-head) with G grouped query heads, online softmax over the live
// token blocks of one layer (int8 codes, per-(token, head) f32 scales).
//
// One kernel template, two entry points, each replacing one TPU kernel of
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
// compute this walk's function block-parallel in flash_decode_split.cu.
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
// - three dot modes of the cache blocks (the entries' `dots`): kDotsI8 is
//   the reference's dots="i8": q quantizes per g over D (qs = max(|q|,
//   1e-12) * (1/127)), p * vs quantizes per g over each block_t block
//   (pvs = max(pv, 1e-30) * (1/127)) and both dots run as exact integer
//   sums (__dp4a for QK). The block partition is therefore part of the
//   result, and the blocks here are the reference's blocks. kDotsBF16 is
//   dots="bf16": q and p * vs round to bf16 (round to nearest even) before
//   their dots with the int8 codes, which bf16 holds exactly; a bf16 x int8
//   product is exact in f32, so the f32 FMA loops of kDotsF32 (the
//   exactness twin) compute it on the rounded operands. The staged current
//   token keeps f32 dots in every mode, as in the reference.
// - a block may hold any number of tokens: see decode_attend in
//   flash_decode.cuh for the sub-tile walks of a block over 256 tokens.
#include "flash_decode.cuh"

namespace {

using flash_decode::kMaxD;
constexpr int kThreads = 128;
constexpr int kMaxG = 8;

template <int DOTS, bool STAGED>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const float* __restrict__ q,
                    const int8_t* __restrict__ k,
                    const int8_t* __restrict__ v,
                    const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const float* __restrict__ kn,
                    const float* __restrict__ vn,
                    const int* __restrict__ pos,
                    float* __restrict__ out, int KVH, int G, int D, int T,
                    int bt, float scale) {
  flash_decode::decode_attend<kThreads, kMaxG, DOTS, STAGED>(
      blockIdx.x, q, k, v, ks, vs, kn, vn, pos, nullptr, 0, out, KVH, G, D,
      T, bt, scale);
}

template <int DOTS, bool STAGED>
void launch_one(dim3 grid, cudaStream_t st, const float* qp,
                const int8_t* kp, const int8_t* vp, const float* ksp,
                const float* vsp, const float* knp, const float* vnp,
                const int* pp, float* op, int KVH, int G, int D, int T,
                int block_t, float scale) {
  flash_decode_kernel<DOTS, STAGED><<<grid, kThreads, 0, st>>>(
      qp, kp, vp, ksp, vsp, knp, vnp, pp, op, KVH, G, D, T, block_t, scale);
}

int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* k_new, const void* v_new,
           const void* pos, void* out, int B, int KVH, int G, int D, int T,
           int block_t, float scale, int dots, bool staged, void* stream) {
  if (B < 1 || KVH < 1 || G < 1 || G > kMaxG || D < 16 || D > kMaxD ||
      D % 16 != 0 || block_t < 1 || T % block_t != 0 ||
      dots < flash_decode::kDotsF32 || dots > flash_decode::kDotsI8)
    return (int)cudaErrorInvalidValue;
  const auto fn =
      dots == flash_decode::kDotsI8
          ? (staged ? launch_one<flash_decode::kDotsI8, true>
                    : launch_one<flash_decode::kDotsI8, false>)
      : dots == flash_decode::kDotsBF16
          ? (staged ? launch_one<flash_decode::kDotsBF16, true>
                    : launch_one<flash_decode::kDotsBF16, false>)
          : (staged ? launch_one<flash_decode::kDotsF32, true>
                    : launch_one<flash_decode::kDotsF32, false>);
  fn(dim3(B * KVH), static_cast<cudaStream_t>(stream),
     static_cast<const float*>(q), static_cast<const int8_t*>(k),
     static_cast<const int8_t*>(v), static_cast<const float*>(ks),
     static_cast<const float*>(vs), static_cast<const float*>(k_new),
     static_cast<const float*>(v_new), static_cast<const int*>(pos),
     static_cast<float*>(out), KVH, G, D, T, block_t, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_decode_staged_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* k_new, const void* v_new, const void* pos,
    void* out, int B, int KVH, int G, int D, int T, int block_t, float scale,
    int dots, void* stream) {
  return launch(q, k, v, ks, vs, k_new, v_new, pos, out, B, KVH, G, D, T,
                block_t, scale, dots, true, stream);
}

extern "C" int flash_decode_inline_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* pos, void* out, int B, int KVH, int G, int D,
    int T, int block_t, float scale, int dots, void* stream) {
  return launch(q, k, v, ks, vs, nullptr, nullptr, pos, out, B, KVH, G, D, T,
                block_t, scale, dots, false, stream);
}
