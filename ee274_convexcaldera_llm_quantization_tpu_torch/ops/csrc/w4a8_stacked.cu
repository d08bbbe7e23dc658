// W4A8 matmul against one layer of a stacked packed weight tensor.
//
// Replaces the TPU kernel ee274_convexcaldera_llm_quantization_tpu/ops/
// kernels.py::quantized_matmul_w4a8_stacked (_qmm_w4a8_stacked_kernel):
//   y[m, n] = sx[m] * s[n] * (sum_k xq[m, k] * u[n, k] - maxq * sum_k xq[m, k])
// with u the offset-binary 2/4/8-bit codes of layer `layer`.
//
// Bound on an H100: the packed weight bytes (N * K / F per call; about 101 MB
// per Llama-2-7B layer at 4 bits), since M <= 32 rows make it a skinny GEMM
// at a few int8 operations per byte. See rowdot.cuh for how the design reads
// each weight byte once. The layer is a pointer offset into the stacked
// tensor: no layer slice is ever copied.
#include "rowdot.cuh"

extern "C" int w4a8_stacked_launch(const void* xq, const void* sx,
                                   const void* packed, const void* scales,
                                   void* out, int M, int N, int K, int bits,
                                   int layer, void* stream) {
  if (bits != 2 && bits != 4 && bits != 8) return (int)cudaErrorInvalidValue;
  const int f = 8 / bits;
  const uint8_t* w = static_cast<const uint8_t*>(packed) +
                     (size_t)layer * (size_t)N * (size_t)(K / f);
  const float* ws = static_cast<const float*>(scales) + (size_t)layer * N;
  const int8_t* x = static_cast<const int8_t*>(xq);
  const float* s = static_cast<const float*>(sx);
  float* y = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bits == 2)
    err = rowdot::launch<2, rowdot::kOffsetPacked>(x, s, w, ws, y, M, N, K, st);
  else if (bits == 4)
    err = rowdot::launch<4, rowdot::kOffsetPacked>(x, s, w, ws, y, M, N, K, st);
  else
    err = rowdot::launch<8, rowdot::kOffset8>(x, s, w, ws, y, M, N, K, st);
  return (int)err;
}
