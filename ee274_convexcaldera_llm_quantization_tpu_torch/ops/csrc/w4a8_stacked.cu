// W4A8 matmul against one layer of a stacked packed weight tensor, and
// against a flat one.
//
// Replaces the TPU kernels ee274_convexcaldera_llm_quantization_tpu/ops/
// kernels.py::quantized_matmul_w4a8_stacked (_qmm_w4a8_stacked_kernel),
// quantized_matmul_w4a8_stacked_persistent (_qmm_w4a8_persistent_kernel:
// the same function, one program per M tile walking every output block
// with hand double-buffered weight DMAs; here w4a8_stacked_persistent_launch,
// w4a8_stream.cuh's weight stream cut over every SM at decode M, and above
// it the tile path, whose CTAs are persistent too) and quantized_matmul_w4a8
// (_qmm_w4a8_kernel), the same function without the layer axis:
//   y[m, n] = sx[m] * s[n] * (sum_k xq[m, k] * u[n, k] - maxq * sum_k xq[m, k])
// with u the offset-binary 2/4/8-bit codes of layer `layer`.
//
// Three designs, picked by M on the host (ops/kernels.py::_w4a8_plan):
//
// - rowdot (M at or below the threshold, decode, the grid launch): bound by
//   the packed weight bytes (N * K / F per call; about 101 MB per
//   Llama-2-7B layer at 4 bits), since a few activation rows make it a
//   skinny GEMM at a few int8 operations per byte. See rowdot.cuh for how
//   it reads each weight byte once with __dp4a on the SMs' integer pipes.
// - stream (the persistent launch at decode M, w4a8_stream.cuh): the same
//   bound; mma.sync on the tensor cores, fed by a per-warp cp.async weight
//   stream over every SM, split groups summed exactly by their last warp.
// - tile (above it, prefill): bound by the int8 operations (2 M N K at 1979
//   TOP/s), so the products go to the tensor cores: wgmma m64n144k32 with the
//   int8 activations as A (s8) and the unpacked codes as B (u8), both K-major
//   in 128-byte swizzled shared memory (w4a8_tile.cuh, shared with the
//   L-fused kernel's tile path).
//
// The layer is a pointer offset into the stacked tensor: no layer slice is
// ever copied. Every design computes the exact i32 sum and the epilogue
// ((float)(acc - maxq * rowsum) * s[n]) * sx[m], so their outputs are equal
// bit for bit.
#include "rowdot.cuh"
#include "w4a8_stream.cuh"
#include "w4a8_tile.cuh"

namespace {

// The layer's weights and scales: pointer offsets into the stacked tensors.
struct Layer {
  const uint8_t* w;
  const float* ws;
};

Layer layer_of(const void* packed, const void* scales, int N, int K,
               int bits, int layer) {
  const int f = 8 / bits;
  return {static_cast<const uint8_t*>(packed) +
              (size_t)layer * (size_t)N * (size_t)(K / f),
          static_cast<const float*>(scales) + (size_t)layer * N};
}

}  // namespace

extern "C" int w4a8_stacked_launch(const void* xq, const void* sx,
                                   const void* packed, const void* scales,
                                   void* out, int M, int N, int K, int bits,
                                   int layer, void* stream) {
  if (bits != 2 && bits != 4 && bits != 8) return (int)cudaErrorInvalidValue;
  const Layer l = layer_of(packed, scales, N, K, bits, layer);
  const int8_t* x = static_cast<const int8_t*>(xq);
  const float* s = static_cast<const float*>(sx);
  float* y = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bits == 2)
    err = rowdot::launch<2, rowdot::kOffsetPacked>(x, s, l.w, l.ws, y, M, N,
                                                   K, st);
  else if (bits == 4)
    err = rowdot::launch<4, rowdot::kOffsetPacked>(x, s, l.w, l.ws, y, M, N,
                                                   K, st);
  else
    err = rowdot::launch<8, rowdot::kOffset8>(x, s, l.w, l.ws, y, M, N, K,
                                              st);
  return (int)err;
}

// The same function at 1 <= M <= 8 as w4a8_stream.cuh's weight stream:
// `ctas` CTAs of `warps` warps (ops/kernels.py::_w4a8_stream_plan); cnt
// ceil(N / 32) x (1 + 256) zeroed int32s (a counter a group of 32 rows,
// then each group's 256 split sums), left zeroed. Bit-equal output.
extern "C" int w4a8_stacked_persistent_launch(
    const void* xq, const void* sx, const void* packed, const void* scales,
    void* out, void* cnt, int M, int N, int K, int bits, int layer, int ctas,
    int warps, void* stream) {
  if ((bits != 2 && bits != 4 && bits != 8) || layer < 0)
    return (int)cudaErrorInvalidValue;
  const Layer l = layer_of(packed, scales, N, K, bits, layer);
  const int P = K / (8 / bits), nk = (P + wstream::kKC - 1) / wstream::kKC;
  const int groups = (N + 31) / 32;
  int* c = static_cast<int*>(cnt);
  const wstream::Plan pl{l.w, l.ws, static_cast<const int8_t*>(xq),
                         static_cast<const float*>(sx),
                         static_cast<float*>(out), c, c + groups, M, N, K, P,
                         nk, groups * nk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 2) return (int)wstream::launch<2>(pl, ctas, warps, st);
  if (bits == 4) return (int)wstream::launch<4>(pl, ctas, warps, st);
  return (int)wstream::launch<8>(pl, ctas, warps, st);
}

// The flat kernel: layer 0 of a one-layer stack.
extern "C" int w4a8_launch(const void* xq, const void* sx, const void* packed,
                           const void* scales, void* out, int M, int N, int K,
                           int bits, void* stream) {
  return w4a8_stacked_launch(xq, sx, packed, scales, out, M, N, K, bits, 0,
                             stream);
}

// The tile path on layer `layer`: `rows` (64 or 128) activation rows and 128
// weight rows a tile, ceil(M / rows) x ceil(N / 128) tiles walked by `ctas`
// persistent CTAs. K % (16 F) == 0 and K <= 2^31 / (127 * 255); xq and the
// layer's packed bytes 16-byte aligned (P % 16 == 0 keeps every layer so when
// the stack is). Its output equals w4a8_stacked_launch's bit for bit.
extern "C" int w4a8_tile_launch(const void* xq, const void* sx,
                                const void* packed, const void* scales,
                                void* out, int M, int N, int K, int bits,
                                int layer, int rows, int ctas, void* stream) {
  if ((bits != 2 && bits != 4 && bits != 8) || layer < 0)
    return (int)cudaErrorInvalidValue;
  const Layer l = layer_of(packed, scales, N, K, bits, layer);
  return (int)tile::launch_bits<false>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx), l.w,
      l.ws, static_cast<float*>(out), M, N, K, bits, rows, ctas,
      tile::LSrc{}, static_cast<cudaStream_t>(stream));
}
