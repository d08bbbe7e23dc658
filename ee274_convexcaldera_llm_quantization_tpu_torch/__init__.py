"""PyTorch / CUDA port of the CALDERA serving paths for NVIDIA Hopper.

The JAX package ``ee274_convexcaldera_llm_quantization_tpu`` is the
reference; this package mirrors its layout (``ops/``, ``models/``) so each
module here has one counterpart there, and keeps its serving bytes
unchanged (uint8 row-global planes, MSB first, offset-binary codes; int8
factors and KV with f32 per-row / per-(token, head) scales).

- ``ops.kernels``   — grouped bf16, flat and stacked W4A8, the stacked
                      W4A8 with the low-rank factors fused in (L, LR, the
                      whole MLP), and int8 matmul wrappers (CUDA kernels on
                      the card, plain torch on the CPU), packing and
                      activation quantization.
- ``ops.attention`` — flash-decode attention over the head-major int8 KV
                      cache (staged, inline, all-batch, fused with o_proj)
                      or a paged pool, and causal flash prefill.
- ``ops.megastep``  — the whole-step decode megakernel: every layer of an
                      MHA decode step in one cooperative CUDA launch.
- ``ops._build``    — builds ``ops/csrc/*.cu`` with ``nvcc`` at first use
                      and binds them with ``ctypes``.
- ``models``        — config presets, the Llama model (caches, plain
                      attention, head, the unrolled model functions),
                      compressed linears, the stacked scan and W4A8 paths,
                      the fused prefill and decode steps, and the
                      megakernel's decode step (``persistent``).
- ``serve``         — sampling, ``ServingEngine`` (its own unfused path),
                      ``FastServingEngine`` (fused or stacked W4A8), paged
                      serving (``runtime``: the native page allocator and
                      scheduler; ``paged``: the paged pools and steps;
                      ``PagedServingEngine``) and the HTTP front end.
- ``evalm``         — the perplexity harness.
- compression       — ``ops.packing``, ``ops.blockquant``,
                      ``quant.quantizers`` and ``ops.lattice`` (the block
                      quantizers and the E8P lattice), ``decomp`` (CALDERA
                      with LPLR and LDLQ), ``calibrate`` (Hessians),
                      ``models.surgery`` (compress a model),
                      ``utils.checkpoint`` and ``cli`` (``compress``,
                      ``calibrate``, ``eval``, ``serve``); plain torch on
                      the tensors' device, no kernel of their own.
- ``interop``       — load params handed over as numpy arrays.
- ``bench_params``  — seeded synthetic packed weights built on the device.

It imports ``torch`` and numpy, never JAX.
"""

__version__ = "0.1.0"
