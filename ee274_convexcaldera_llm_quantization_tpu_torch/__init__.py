"""PyTorch / CUDA port of the CALDERA W4A8 serving path for NVIDIA Hopper.

The JAX package ``ee274_convexcaldera_llm_quantization_tpu`` is the
reference; this package mirrors its layout (``ops/``, ``models/``) so each
module here has one counterpart there, and keeps its serving bytes
unchanged (uint8 row-global planes, MSB first, offset-binary codes; int8
factors and KV with f32 per-row / per-(token, head) scales).

- ``ops.kernels``   — W4A8 stacked matmul and int8 matmul wrappers (CUDA
                      kernels on the card, plain torch on the CPU), packing
                      and activation quantization.
- ``ops.attention`` — flash-decode attention over the head-major int8 KV
                      cache (staged, inline, all-batch) and causal flash
                      prefill.
- ``ops._build``    — builds ``ops/csrc/*.cu`` with ``nvcc`` at first use
                      and binds them with ``ctypes``.
- ``models``        — config presets, the Llama pieces (caches, plain
                      attention, head), compressed linears, and the fused
                      prefill and decode steps.
- ``serve``         — sampling, the continuous-batching scheduler and the
                      fused-path ``FastServingEngine``.
- ``interop``       — load fused params handed over as numpy arrays.
- ``bench_params``  — seeded synthetic packed weights built on the device.

It imports ``torch`` and numpy, never JAX.
"""

__version__ = "0.1.0"
