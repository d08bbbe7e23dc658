// W8A8 matmul: int8 weights times per-row int8 activations, i32 sums, then
// the rank-1 rescale y[m, n] = (acc[m, n] * s[n]) * sx[m].
//
// Replaces the TPU kernel ee274_convexcaldera_llm_quantization_tpu/ops/
// kernels.py::int8_matmul (_qmm_int8_kernel), which the port runs as the
// int8 lm_head of every decode step.
//
// Bound on an H100: the weight bytes (N * K; 131 MB for the Llama-2-7B head
// at N = 32000, K = 4096). Same design as the W4A8 kernel (rowdot.cuh) with
// signed codes fed straight to __dp4a and no offset term.
#include "rowdot.cuh"

extern "C" int int8_matmul_launch(const void* xq, const void* sx,
                                  const void* w8, const void* scales,
                                  void* out, int M, int N, int K,
                                  void* stream) {
  return (int)rowdot::launch<8, rowdot::kSigned8>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<const uint8_t*>(w8), static_cast<const float*>(scales),
      static_cast<float*>(out), M, N, K, static_cast<cudaStream_t>(stream));
}
