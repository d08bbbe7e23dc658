#!/usr/bin/env python3
"""Drive the PyTorch port (W4A8 decode and its options, prefill, the serving
engines, the unfused compressed-model path, the compression pipeline, the
offline quality pipeline, mixed-width serving and speculative decoding,
tensor- and pipeline-parallel serving) on one NVIDIA GPU.

Run from the repository root on a machine with a card:

    python3 chip_smoke.py

Every run runs every phase (any failure raises and exits non-zero; none is
caught):

1. Device and build: the card's name and power limit, then every CUDA kernel
   of ``ee274_convexcaldera_llm_quantization_tpu_torch/ops/csrc`` built with
   nvcc (one process per source, all at once).
2. Each kernel against its plain PyTorch version on the card, at the main
   paths' shapes, with its median device time (launches captured in a
   CUDA graph, timed with CUDA events, weights and caches rotated so they
   come from device memory), the plain version's time and the bound time
   (bytes over 3.35 TB/s, or operations over 1979 TOP/s int8 or 67 TFLOP/s
   f32, the larger): the W4A8 matmul at decode's M = 8 (the rowdot
   kernel) and, at prefill's M = 512 and 2048, its int8 wgmma tile path on
   the four Llama-2-7B projections, each bit-equal to the plain version and
   to a rowdot launch, beside one torch._int_mm on the codes unpacked to
   int8 beforehand plus the rescale (the yardstick of every int8 kernel
   here, where _int_mm takes the M; the head also at M 32 where it refuses
   M 8); flash prefill at S = 512, 2048, a ragged 300 and a GQA
   shape, beside one SDPA call (bound: its 3xTF32 operations at 495
   TFLOP/s; two launches bit-equal), and on sharp logits (q, k x 3) within
   1.25x the plain version's error against a float64 attention; the
   all-batch decode kernel (the block-parallel kernel), staged and inline,
   over a 4096-token cache at ragged positions, each output equal bit for
   bit to the staged or inline row kernel's at the same block; the staged
   row decode kernel (``flash_decode.cu``'s cluster-split ``row_kernel``)
   at the bench shape, mixed positions, Llama-2-7B and Llama-3-8B GQA over
   2048 tokens and Qwen2-0.5B's heads, and the inline one at the bench
   shape and over 2048 tokens (Llama-2-7B and GQA), each with its plan
   (cluster, grid), equal bit for bit to the block-parallel
   kernel on the same operands and block, whose time is printed beside
   it; the int8 head (32000 x 4096) on its int8 wgmma tile path, swapped
   at M 8 and 32 and in 128 x 256 tiles at M 1024 and 2048, each bit-equal
   to the plain version, timed beside torch._int_mm plus the rescale and
   the bound (the kernel table's ``at_m``); the
   grouped bf16 matmul (bound: 989 TFLOP/s bf16 or bytes; beside one bf16
   torch.matmul on its weights dequantized beforehand; its plan printed and
   a second launch equal bit for bit, also at M 16 and 17 and on a plane of
   160 bytes) and the flat W4A8
   matmul at Llama-2-7B's three projection shapes, M = 8 and 512; the paged
   decode kernel at Llama-2-7B's heads, batch 8, over a randomly permuted
   page table of about 2048 tokens per row at ragged positions, pages of 16
   and 256 tokens, each output equal bit for bit to the staged kernel's over
   the gathered pages at the same block, beside the staged kernel over the
   same context; the
   fused-factor kernels at Llama-2-7B's shapes, rank 128, batch 8: the
   L-fused kernel on the four projections at M = 8, 512 and 2048 (l_kernel
   at 8, the int8 wgmma tile path with its L epilogue above), the LR-fused
   kernel on qkv and gate/up at M = 8, 512 and 2048 (its plan; its
   tensor-core xr kernel alone, with its bound; the cooperative kernel by
   override at M 8; xr within rtol 1e-5 of the plain thin dot, the output
   on the kernel's own xr, a second launch bit-equal), the whole-MLP kernel and
   the attention + o_proj kernel (staged and inline; the flipped int8 codes
   of their inner requantization counted against the plain version's; each
   with its plan, a second launch bit-equal, and beside the unfused
   yardstick timed in the same run: row 6's gate/up plus down, and the row
   decode kernel in f32 plus row 6's o_proj); the
   decode kernels in dots bf16 beside f32 and i8; the W4A8 kernel's
   persistent launch on o and down at M 8 (the tensor-core weight stream of
   ``w4a8_stream.cuh``, with its plan) and 512 (the tile path), bit-equal
   to kernel 1 and timed beside it and, at M 8, beside kernel 1's tile
   path; ``bf16_matmul_stacked`` (TMA + wgmma, split-K at
   M <= 16) at rank-128 factor shapes and 4096 x 4096 beside one bf16
   torch.matmul, with its plan, the M 16/17 edge and a repeated split-K
   launch equal bit for bit; decode blocks over 256
   tokens (the all-batch kernel on one 2000-token block, 512-token pages, a
   7-head GQA block of 7000 tokens) in i8, f32 and bf16, each equal bit for
   bit to the staged row kernel at the same block.
3. One Llama-2-7B-width, 2-layer model, the same weights on the card and
   the CPU: 40 steps from position 0, each step on the card against the
   plain step on the CPU (from the CPU's cache, and from the card's own)
   and against the plain versions on the card; one step at position 700 of
   a 1024-token cache through the staged, inline and all-batch paths; and a
   300-token prompt prefilled in its 512-token bucket, card against CPU
   (logits and K/V) and kernels against plain versions on the card.
4. Llama-2-7B, 32 layers, batch 8, context 256: eight seeded 12-token
   prompts fed from position 0, then 20 greedy tokens each, with the launch
   count of every kernel checked per step; then the bench shape, 32 steps
   from position 128, and the median ms/step, beside the device time of
   one step replayed as a CUDA graph. (b) ``phase_gqa``: the same fused
   step at Llama-3-8B widths (32 layers, GQA), batch 8, a 2048-token cache
   from position 1024, staged "uniform", dots i8: the first step against
   the plain versions on the card, exact launches over 9 steps, one step's
   device time as a CUDA graph beside its 32 attention launches alone.
5. Serving, Llama-2-7B, 32 layers, on ``FastServingEngine(flash_attn=True,
   max_slots=8)``: 16 seeded requests (16 to 1500 prompt tokens, 32 new
   tokens, greedy and sampled rows) at max_seq_len 4096, which decodes with
   the all-batch kernel; then 8 requests on the inline path at 512, which
   decodes with the inline row kernel. Every prefill and decode tick is
   checked for its exact launches, and the first prefill against the plain
   versions on the card; prints the prefill ms per bucket, the median
   decode tick, the device time of the busiest tick (its decode step
   replayed as a CUDA graph) and of that tick's attention launches alone,
   tokens/s and wall time.
6. The unfused path, Llama-2-7B, 32 layers (``phase_unfused``): first (e)
   the grouped path at 2 layers, the same weights on the card and the CPU:
   a 300-token prefill and a batch-8 decode step from the CPU's cache,
   logits within 5e-3 rel-Frobenius; (a) the
   grouped ``stacked.decode_step_batched`` at batch 8, context 256, 32
   steps (224 grouped launches each); (d) ``evaluate_perplexity`` on one
   1024-token window; (b) ``ServingEngine`` on w4a8 params (224 flat W4A8
   launches and the head per prefill and tick); (c) the unfused
   ``FastServingEngine`` on the same params, bf16 cache (greedy tokens
   equal to (b)'s) and int8 cache; (f) ``evaluate_perplexity`` on (b)'s
   w4a8 views, one 1024-token window: 224 flat W4A8 launches and the int8
   head, all at M = 1024, the head's device time in the window, and the
   perplexity equal to the plain versions' on the card.
7. Paged serving, Llama-2-7B, 32 layers, on phase 4's params (run before
   phase 6, which builds its own): (a) the paged fused step with identity
   page tables and 256-token pages against the staged fused step, batch 8
   from eight prefilled prompts: identical logits and K/V codes; (b)
   ``PagedServingEngine(flash_attn=True, max_slots=8, page_size=16)`` on 24
   seeded requests (prompts of 64-256 tokens, 16-48 new tokens, some
   sampled) over a pool too small for all of them at once (sized by a dry
   run of the native scheduler), every prefill and tick checked for its
   exact launches, the first prefill and tick against the plain versions,
   the device time of the busiest tick (replayed as a CUDA graph) and of
   its attention launches alone;
   (c) the same engine with the prefix cache, 8 requests sharing a
   256-token prefix; (d) ``ServingHTTPServer`` over the paged engine on
   127.0.0.1: 8 concurrent completions, one streamed, and the health and
   stats endpoints.
8. The fused step's options, Llama-2-7B, 32 layers (``phase_options``, run
   before phase 6): factor paths "xla", "l" and "lr" quantized from one
   bf16 param set (``L_cat`` asserted), a cache of eight 128-token
   prompts, then (a) "l" and (b) "lr" at dots i8 staged "uniform", (c) "l"
   with the whole-MLP and attention + o_proj kernels at dots f32, staged and
   inline: each step against the "xla" step and the plain versions from the
   same cache, exact launches, ms/step and the device time of one step as a
   CUDA graph; (d) ``FastServingEngine(mlp_kernel=True)`` on "l", 8
   requests, prefill ms per bucket; (e) the "l" and "lr" prefills of a
   2048-token prompt ("l": 4L L-fused tile launches; "lr": 2L LR-fused
   launches, each the tensor-core xr kernel and the L-fused tile kernel,
   and 2L W4A8 launches for o and down; each with L flash prefill and the
   head) against the plain versions and the "xla" prefill, with their ms.
9. The persistent projection launch and bf16 dots, Llama-2-7B, 32 layers,
   on phase 4's params (``phase_proj_dots``, run before phase 8): batch 8,
   a cache of eight 128-token prompts, from position 128: (a)
   ``proj_kernel="persistent"`` against the grid step (identical logits and
   K/V codes, 64 persistent and 64 kernel-1 launches per step; both steps'
   device times side by side); (b)
   ``attn_dots="bf16"`` staged, inline and all-batch against the f32 step
   and the plain versions; each with ms/step and the device time of one
   step as a CUDA graph; (c) the paged step at dots bf16 against the staged
   step; (d) ``FastServingEngine(max_seq_len=2000)``, decoding on one
   2000-token all-batch block, 8 requests.
10. The whole-step megakernel, Llama-2-7B, 32 layers (``phase_mega``, inside
   phase 8 on its "l" params and cache, before (d)): the interleaved
   gate/up set built once; (a) ``decode_step_persistent`` against the same
   step through the plain versions, (b) against the fused "l" step (staged,
   f32 dots), (c) 32 greedy steps of exactly one megastep and one int8 head
   launch each, eager ms/step and one step as a CUDA graph beside phase 4's
   and phase 8's steps, the kernel's own time and bound; (d) ragged
   positions with the per-row commit against the plain versions. The
   megastep's entry of the kernel table adds its cooperative grid (``ctas``,
   ``ctas_per_sm``) and the ``-Xptxas -v`` lines of both builds
   (``ptxas``).
11. The compression pipeline (``phase_compress``, after phase 6): a dense
   Llama-2-7B-width, 2-layer model from ``llama.init_params(0)``, full
   Hessians over 4 x 2 x 512 tokens, ``compress_model`` of layer 0 (LDLQ)
   and layer 1 (RTN) at 4 bits with rank-128 factors in w4a8 mode, every
   stage timed per projection (eigh, LPLR update, LDLQ sweep and its
   launches) and every error held under the gate and to the solver's
   Q-only error; layer 0's o_proj on the card against the CPU; one
   projection on the E8 lattice through the flat W4A8 kernel; a
   checkpoint round trip; 8 steps of the main path on the compressed
   model (each launch against its plain version) and a perplexity window.
12. The offline quality pipeline (``phase_pipeline``, after phase 11): (a)
   ``examples/cli_pipeline_2bit.py`` through the port's ``train_step``,
   HF export and ``cli.main`` (calibrate, compress at 4-bit, 2-bit and
   2-bit e8p, eval) on TINY, beside the JAX package's rows, and the
   trained dense and 2-bit e8p models on the card against the CPU; (b) an
   HF round trip and two training steps at Llama-2-7B widths; (c) budgeted
   bit allocation of a layer and one decode step of it; (d) Convex-CALDERA
   in f64 on one Qwen2-0.5B layer; (e) QAT; (f) the servable Hadamard
   basis; (g) the SCL baselines. Every flat W4A8 and head launch of it is
   held to its plain version.
13. Mixed-width serving and speculative decoding (``phase_mixed``, last):
   the reference's flagship composition (``scripts/exp_13b_mixed.py
   --segmented --fused-segments --speculative``) at Llama-2-13B widths, 40
   layers, an int8 head: (a) the budgeted allocation (2.5 grid bits from
   {2, 3, 4, 8}, the script's sensitivity model), synthetic packed weights
   and rank-128 int8 factors bucketed by ``stack_layers_mixed``, its
   segments and ``prepare_fused_segments``' fused groups; (c) a 128-token
   ``prefill_into_slot_mixed`` into each of 8 slots; (b)
   ``decode_step_mixed_segmented`` at B 8 (staged, i8 dots, fused
   segments): every launch against its plain version (rows 3 and 9
   bit-equal, row 6 within ``L_RTOL``, row 11 to phase 2's bound), exact
   launches, the step against the plain versions' step, the switch path
   against the inline segmented path (bit-equal), eager and CUDA-graph
   times, the weight-byte bound; (d) ``verify_step_mixed`` at S 5 against
   five segmented steps (``VERIFY_REL``) and at S 2, every launch checked
   (row 3 at M 40 and 16, row 9 at M 40 and 16), row 3 on the 8-bit
   container; (e) 16 greedy ``spec_decode_round`` rounds with a 10-layer
   ``truncate_mixed`` draft, gamma 4: committed tokens, acceptance, eager
   and profiled device time per round, launches, and the plain greedy
   stream beside it; (f) at Llama-2-7B widths, 8 layers, int8 token-major
   caches: ``generate_speculative`` against plain greedy decode, a perfect
   draft's acceptance, ``SpeculativeServingEngine`` against
   ``FastServingEngine`` on 8 requests; each first divergence with its
   margin (``MARGIN_REL``, ROADMAP R6 and R16).
14. Tensor- and pipeline-parallel serving (``phase_parallel``, last; the
   ranks are spawned after the build by ``parallel.bootstrap.launch``):
   (q) Qwen2-0.5B's whole fused step at full widths (qkv bias, tied int8
   head, K 896, vocab 151936) against the plain versions; (a) tp=1 over
   NCCL, a world of one in this process: ``decode_step_fused_tp`` bit-equal
   to ``decode_step_fused`` on phase 4's step; (b) tp=2, two gloo ranks
   sharing the card (NCCL refuses two ranks on one device), Llama-2-7B,
   32 layers, each rank its shard of phase 4's weights: one TP step from
   the single-device step's cache (``KERN_REL``, the differing K/V codes
   counted), then a prefill of one 128-token prompt a row and 16 greedy
   steps against single-device decode (each first divergence with its
   margin under ``MARGIN_REL``), every launch of rows 3, 9, 11 and 13
   against its plain version; (c) pp=2 and pp=2 x tp=2, four gloo ranks on
   the card, depth cut to 8 layers, checked the same way; (d) tp=2
   ``TPServingEngine`` on 8 requests of 16-200 prompt tokens against
   ``FastServingEngine``, then one ``paged_decode_step_fused_tp`` tick over
   16-token pages (row 14); (e) (b) over NCCL, one rank a card, where the
   machine has two cards. Per-rank eager and device step times: ranks that
   share one card time-share its SMs, so they are no scaling figure.

Before the last line it prints the kernel table as one JSON object, each
number measured in this run: ``launches`` counts the main path of the
kernel's slice, with every count set to 0 just before it (phase 4's decode
run for the W4A8, staged attention and int8 head kernels; phase 5 (a) for
flash prefill and the all-batch kernel, 5 (b) for the inline kernel; phase
6 (a) for the grouped kernel, 6 (b) for the flat W4A8 kernel, 7 (b) for
the paged kernel, 8 (a) for the L-fused kernel, 8 (b) for the LR-fused
kernel, 8 (c) for the whole-MLP and attention + o_proj kernels, 9 (a) for
the persistent launch, 10 (c) for the megastep; ``bf16_matmul_stacked`` has
no caller in either package, and its launches are phase 2's checks;
``launches_per_step`` per decode step or prefill, ``steps`` of them);
``ms``, ``plain_ms`` and ``bound_ms`` are per launch at the main path's
shapes (for the W4A8 kernels, the mean over one layer's decode
projections; for the persistent launch, o and down; for the megastep, one
whole step).
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12        # H100 SXM dense int8 tensor-core peak
BF16_OPS_PER_S = 989e12         # H100 SXM dense bf16 tensor-core peak
TF32_OPS_PER_S = 495e12         # H100 SXM dense TF32 tensor-core peak
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores


# (median eager ms/step, device ms of one step as a CUDA graph) of the
# steps that phase 10 prints beside its own
_STEP_MS = {}


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _bound_ms(nbytes: float, ops: float, ops_per_s: float = INT8_OPS_PER_S):
    """(least ms for the work, "bytes" or "operations", whichever binds)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# the decode kernels' dot products by mode: int8, bf16 operands (exact
# products, f32 sums) or f32
_DOTS_RATE = {"i8": INT8_OPS_PER_S, "bf16": BF16_OPS_PER_S,
              "f32": F32_OPS_PER_S}


def _attn_ok(torch, out, ref, dots):
    """A decode kernel's output against its plain version: f32 dots within
    rtol 2e-5 / atol 2e-6 (sums in another order); i8 and bf16 within
    1e-4 rel-Frobenius (expf and sum order can flip one int8 code, or round
    one p * v_scale to its other bf16 neighbour). Returns (ok, text)."""
    if dots == "f32":
        return (torch.allclose(out, ref, rtol=2e-5, atol=2e-6),
                "rtol 2e-5, atol 2e-6")
    rel = float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref))
    return rel <= 1e-4, f"rel-Frobenius {rel:.3e} <= 1e-4"


def _time_ms(torch, fn, iters: int, reps: int = 5) -> float:
    """Device time per call: ``iters`` calls ``fn(i)`` captured in one CUDA
    graph, replayed ``reps`` times between CUDA events; the median replay
    over ``iters``. The graph keeps host launch overhead out of the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(2):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(times)


def _mean_or_none(values):
    """The mean, or None if any value is None."""
    return (None if any(v is None for v in values)
            else statistics.fmean(values))


def _map_tensors(obj, fn):
    """Apply ``fn`` to every tensor of a params tree of dataclasses."""
    import torch
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _map_tensors(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(_map_tensors(o, fn) for o in obj)
    return obj


def _row_beside_split(torch, AT, args, Lk, p, T, dots, staged, out):
    """The row decode kernel's plan for a case, and the block-parallel
    kernel (``AT._launch_split``) on the same operands and block: its
    median time, and whether ``out`` (the row kernel's output on layer 1)
    equals its output bit for bit (raises if not). ``args``: q, k, v, ks,
    vs, k_new, v_new."""
    q, k = args[0], args[1]
    B, KVH, G, D = q.shape
    bt = AT.resolve_block_t(256, T)
    plan = AT._row_decode_plan(B, KVH, G, D, T, bt,
                               torch.cuda.get_device_properties(
                                   q.device).multi_processor_count)
    split = AT._launch_split(*args, 1, p, bt, dots, staged)
    if not torch.equal(out, split):
        raise AssertionError(f"row kernel (B={B} KVH={KVH} G={G} D={D} "
                             f"T={T} {dots} staged={staged}): not equal to "
                             f"the split kernel at block {bt}")
    split_ms = _time_ms(torch, lambda i: AT._launch_split(
        q, k, *args[2:], i % Lk, p, bt, dots, staged), 50)
    txt = (f"plan {plan['route']} cluster {plan['cluster']} grid "
           f"{plan['grid']}; "
           f"equal to the split kernel at block {bt}, which takes "
           f"{split_ms:.4f} ms")
    return txt, split_ms


def phase_kernels(torch, dev, record):
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        attention as AT, kernels as K)

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    M = 8
    # the yardstick of the int8 kernels at decode's M, where _int_mm takes it
    refusal = _int_mm_refusal(torch, dev, M, 4096, 4096)
    if refusal is not None:
        print(f"torch._int_mm refuses M={M}: {refusal}; the int8 kernels' "
              f"library_ms stays null at M {M}", flush=True)
    # --- W4A8 stacked matmul: the four Llama-2-7B projections and 2-bit
    w4 = record["w4a8_stacked"]
    main_times = []
    for name, N, Kd, bits, main in [
            ("qkv", 12288, 4096, 4, True), ("o_proj", 4096, 4096, 4, True),
            ("gate_up", 22016, 4096, 4, True),
            ("down_proj", 4096, 11008, 4, True),
            ("down_proj 2-bit", 4096, 11008, 2, False)]:
        f = 8 // bits
        layer_bytes = N * Kd // f
        Lk = max(2, math.ceil(200e6 / layer_bytes))
        packed = torch.randint(0, 256, (Lk, N, Kd // f), generator=gen,
                               dtype=torch.uint8, device=dev)
        scales = torch.rand((Lk, N, 1), generator=gen, device=dev) * 0.01
        x = torch.randn((M, Kd), generator=gen, device=dev)
        y = K.quantized_matmul_w4a8_stacked(x, packed, scales, 1, bits)
        ref = K.quantized_matmul_w4a8_stacked_plain(x, packed, scales, 1,
                                                    bits)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        tol = 1e-6 * float(ref.abs().max())
        ok = torch.allclose(y, ref, rtol=1e-6, atol=tol)
        xq, sx = K.quantize_activations_int8(x)
        ms = _time_ms(torch, lambda i: K._launch_w4a8_stacked(
            xq, sx, packed, scales, i % Lk, bits), 50)
        plain_ms = _time_ms(torch, lambda i: K.quantized_matmul_w4a8_stacked_plain(
            x, packed, scales, i % Lk, bits), 3, reps=3)
        lib_ms = None
        if main and refusal is None:
            lib_ms = _int_mm_ms(
                torch, xq, _unpacked_int8(torch, K, packed, bits),
                [scales[i].reshape(1, -1) for i in range(Lk)], sx, 50)
        nbytes = M * Kd + M * 4 + layer_bytes + N * 4 + M * N * 4
        bound, by = _bound_ms(nbytes, 2 * M * N * Kd)
        print(f"w4a8_stacked {name} M={M} N={N} K={Kd} {bits}-bit: max diff "
              f"{err:.3e} (bound rtol 1e-6, atol {tol:.3e}) kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch._int_mm "
              f"{_ms_txt(lib_ms, ms)}, bound {bound:.4f} ms "
              f"({bound / ms:.1%} of bound)", flush=True)
        if not ok:
            raise AssertionError(f"w4a8_stacked {name} disagrees with plain")
        w4["max_abs_err"] = max(w4["max_abs_err"] or 0.0, err)
        if main:
            main_times.append((ms, plain_ms, nbytes, 2 * M * N * Kd, lib_ms))
        del packed
    torch.cuda.empty_cache()
    # one launch per projection per layer: the mean is the time per launch
    mean = [statistics.fmean(t[j] for t in main_times) for j in range(4)]
    bound, by = _bound_ms(mean[2], mean[3])
    w4.update(ms=mean[0], plain_ms=mean[1], bound_ms=bound, bound_by=by,
              library_ms=_mean_or_none([t[4] for t in main_times]))

    # --- staged flash-decode attention
    fa = record["flash_decode_q8_staged"]
    for name, B, KVH, G, D, T, pos, dots, main in [
            ("7b mixed pos", 8, 32, 1, 128, 256,
             [0, 1, 100, 128, 129, 200, 255, 256], "i8", False),
            ("7b mixed pos", 8, 32, 1, 128, 256,
             [0, 1, 100, 128, 129, 200, 255, 256], "f32", False),
            ("7b bench pos 128", 8, 32, 1, 128, 256, [128] * 8, "i8", True),
            ("7b bench pos 128", 8, 32, 1, 128, 256, [128] * 8, "f32", False),
            ("7b bench pos 128", 8, 32, 1, 128, 256, [128] * 8, "bf16",
             False),
            ("7b T=2048", 8, 32, 1, 128, 2048,
             [0, 255, 256, 700, 1024, 1500, 2047, 2048], "i8", False),
            ("llama3-8b GQA", 8, 8, 4, 128, 2048,
             [0, 1, 300, 511, 512, 1999, 2047, 2048], "i8", False),
            ("llama3-8b GQA", 8, 8, 4, 128, 2048,
             [0, 1, 300, 511, 512, 1999, 2047, 2048], "f32", False),
            ("qwen2-0.5b heads", 8, 2, 7, 64, 2048,
             [0, 255, 256, 700, 1024, 1500, 2047, 2048], "i8", False)]:
        layer_bytes = B * KVH * T * (2 * D + 8)
        Lk = max(2, math.ceil(200e6 / layer_bytes))
        q = torch.randn((B, KVH, G, D), generator=gen, device=dev)
        k = torch.randint(-127, 128, (Lk, B, KVH, T, D), generator=gen,
                          dtype=torch.int8, device=dev)
        v = torch.randint(-127, 128, (Lk, B, KVH, T, D), generator=gen,
                          dtype=torch.int8, device=dev)
        ks = torch.rand((Lk, B, KVH, T), generator=gen, device=dev) * 0.02
        vs = torch.rand((Lk, B, KVH, T), generator=gen, device=dev) * 0.02
        kn = torch.randn((B, KVH, D), generator=gen, device=dev)
        vn = torch.randn((B, KVH, D), generator=gen, device=dev)
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        out = AT.flash_decode_q8_staged(q, k, v, ks, vs, kn, vn, 1, p,
                                        dots=dots)
        ref = AT.flash_decode_q8_staged_plain(q, k, v, ks, vs, kn, vn, 1, p,
                                              dots=dots)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        ok, bound_txt = _attn_ok(torch, out, ref, dots)
        ms = _time_ms(torch, lambda i: AT.flash_decode_q8_staged(
            q, k, v, ks, vs, kn, vn, i % Lk, p, dots=dots), 50)
        split_txt, _ = _row_beside_split(torch, AT, (q, k, v, ks, vs, kn, vn),
                                         Lk, p, T, dots, True, out)
        plain_ms = _time_ms(torch, lambda i: AT.flash_decode_q8_staged_plain(
            q, k, v, ks, vs, kn, vn, i % Lk, p, dots=dots), 3, reps=3)
        live = sum(min(x, T) for x in pos)
        nbytes = (KVH * live * (2 * D + 8) + 2 * B * KVH * G * D * 4
                  + 2 * B * KVH * D * 4 + B * 4)
        bound, by = _bound_ms(nbytes, 4 * KVH * G * live * D,
                              _DOTS_RATE[dots])
        print(f"flash_decode_q8_staged {name} dots={dots} B={B} KVH={KVH} "
              f"G={G} D={D} T={T}: max diff {err:.3e} ({bound_txt}) kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
              f"({bound / ms:.1%} of bound); {split_txt}", flush=True)
        if not ok:
            raise AssertionError(f"flash_decode_q8_staged {name} {dots} "
                                 "disagrees with plain")
        fa["max_abs_err"] = max(fa["max_abs_err"] or 0.0, err)
        if main:
            fa.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
        del k, v
    torch.cuda.empty_cache()

    # --- int8 matmul: the Llama-2-7B lm_head at decode's M 8, batch
    # decode's M 32 (swapped tiles) and the perplexity window's M 1024 and
    # 2048 (128 x 256 tiles), each bit-equal to the plain version on the
    # card, beside torch._int_mm plus the rescale and the bound
    i8 = record["int8_matmul"]
    N, Kd = 32000, 4096
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    w8 = [torch.randint(-127, 128, (N, Kd), generator=gen, dtype=torch.int8,
                        device=dev) for _ in range(2)]
    s = [torch.rand((N, 1), generator=gen, device=dev) * 0.01
         for _ in range(2)]
    srow = [t.reshape(1, -1) for t in s]
    i8["at_m"] = []
    for Mh in (8, 32, 1024, 2048):
        x = torch.randn((Mh, Kd), generator=gen, device=dev)
        y = K.int8_matmul(x, w8[1], s[1])
        ref = K.int8_matmul_plain(x, w8[1], s[1])
        xq, sx = K.quantize_activations_int8(x)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        if not torch.equal(y, ref):
            raise AssertionError(f"int8_matmul M={Mh}: not the plain "
                                 f"version's bits (max diff {err:.3e})")
        plan = K._int8_plan(Mh, N, Kd, sms)
        iters = 50 if Mh <= 32 else 10
        ms = _time_ms(torch, lambda i: K._launch_int8_matmul(
            xq, sx, w8[i % 2], s[i % 2]), iters)
        lib_ms = None
        if _int_mm_refusal(torch, dev, Mh, Kd, N) is None:
            lib_ms = _int_mm_ms(torch, xq, w8, srow, sx, iters)
        bound, by = _bound_ms(Mh * Kd + Mh * 4 + N * Kd + N * 4 + Mh * N * 4,
                              2 * Mh * N * Kd)
        tile = (f"tile {plan['rows']} x {plan['cols']}"
                f"{' swapped' if plan['swap'] else ''}")
        print(f"int8_matmul lm_head M={Mh} N={N} K={Kd}: {tile}; max diff "
              f"0 against the plain version (bit-equal); kernel {ms:.4f} "
              f"ms, torch._int_mm + rescale {_ms_txt(lib_ms, ms)}, bound "
              f"{bound:.4f} ms ({by}; {bound / ms:.1%} of bound)", flush=True)
        i8["at_m"].append(dict(M=Mh, tile=tile, ms=ms, library_ms=lib_ms,
                               bound_ms=bound, bound_by=by))
        if Mh == M:
            plain_ms = _time_ms(torch, lambda i: K.int8_matmul_plain(
                x, w8[i % 2], s[i % 2]), 3, reps=3)
            i8.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                      bound_ms=bound, bound_by=by, library_ms=lib_ms)
        del x, y, ref
    del w8
    _phase_kernels_prefill(torch, dev, gen, record)
    _phase_kernels_decode(torch, dev, gen, record)
    _phase_kernels_packed(torch, dev, gen, record)
    _phase_kernels_paged(torch, dev, gen, record)
    _phase_kernels_lowrank(torch, dev, gen, record)
    _phase_kernels_proj(torch, dev, gen, record)
    _phase_kernels_long_blocks(torch, dev, gen)


def _phase_kernels_proj(torch, dev, gen, record):
    """The W4A8 kernel's persistent launch against kernel 1 (its grid
    launch, bit for bit) and the plain version: Llama-2-7B's o (4096 x
    4096) and down (4096 x 11008), 4-bit, at M 8 and 512, each timed beside
    kernel 1 in this run (at M 8 beside kernel 1's tile path too, forced);
    M 1, 7 and 33 and bits 2 and 8 checked too; at M <= 8 each case prints
    its stream plan (CTAs, warps, slabs a warp, the most warps sharing a
    group). The record takes M 8, the mean of o and down (a layer's two
    launches of it).
    Then ``bf16_matmul_stacked`` at the rank-128 factor shapes (R: 128 x
    4096, L: 4096 x 128) and 4096 x 4096, M 8 and 512, beside one bf16
    ``torch.matmul`` on the same operands, against the last layer of the
    stack, each with the plan it ran (path, splits, grid); R and 4096 x
    4096 also at M 16 and 17 (the two paths' edge), untimed; every split-K
    case launched twice and held equal bit for bit. It has no caller in
    either package, so its launches are this phase's checks, and the
    record takes the mean of the two factor shapes at M 8."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        kernels as K)

    rec = record["quantized_matmul_w4a8_stacked_persistent"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    main = []
    cases = [("o", 4096, 4096, 4, M, True) for M in (8, 512)]
    cases += [("down", 4096, 11008, 4, M, True) for M in (8, 512)]
    cases += [("o", 4096, 4096, 4, M, False) for M in (1, 7, 33)]
    cases += [("o", 4096, 4096, 8, 8, False),
              ("down", 4096, 11008, 2, 8, False)]
    for name, N, Kd, bits, M, timed in cases:
        f = 8 // bits
        layer_bytes = N * Kd // f
        Lk = max(2, math.ceil(200e6 / layer_bytes)) if timed else 2
        packed = torch.randint(0, 256, (Lk, N, Kd // f), generator=gen,
                               dtype=torch.uint8, device=dev)
        scales = torch.rand((Lk, N, 1), generator=gen, device=dev) * 0.01
        x = torch.randn((M, Kd), generator=gen, device=dev)
        y = K.quantized_matmul_w4a8_stacked_persistent(x, packed, scales, 1,
                                                       bits)
        y1 = K.quantized_matmul_w4a8_stacked(x, packed, scales, 1, bits)
        ref = K.quantized_matmul_w4a8_stacked_plain(x, packed, scales, 1,
                                                    bits)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        tol = 1e-6 * float(ref.abs().max())
        if not (torch.equal(y, y1)
                and torch.allclose(y, ref, rtol=1e-6, atol=tol)):
            raise AssertionError(f"persistent {name} M={M} {bits}-bit: not "
                                 "kernel 1's output bit for bit, or not "
                                 "the plain version's")
        rec["max_abs_err"] = max(rec["max_abs_err"] or 0.0, err)
        line = (f"w4a8 persistent {name} M={M} N={N} K={Kd} {bits}-bit: "
                f"equal to kernel 1 bit for bit, max diff vs plain "
                f"{err:.3e} (bound rtol 1e-6, atol {tol:.3e})")
        if M <= 8:
            sp = K._w4a8_stream_plan(M, N, Kd, bits, sms)
            line += (f"; stream plan {sp['ctas']} CTAs x {sp['warps']} "
                     f"warps, {sp['slabs']} slabs, {sp['per_warp'][0]}-"
                     f"{sp['per_warp'][1]} a warp, up to "
                     f"{sp['contributors']} warps a group")
        if timed:
            xq, sx = K.quantize_activations_int8(x)
            iters = 50 if M == 8 else 5
            ms = _time_ms(torch, lambda i: K._launch_w4a8_stacked(
                xq, sx, packed, scales, i % Lk, bits, persistent=True),
                iters)
            ms1 = _time_ms(torch, lambda i: K._launch_w4a8_stacked(
                xq, sx, packed, scales, i % Lk, bits), iters)
            tile_ms = None
            if M == 8:
                tile_ms = _time_ms(torch, lambda i: K._launch_w4a8_stacked(
                    xq, sx, packed, scales, i % Lk, bits, path="tile"),
                    iters)
            plain_ms = _time_ms(
                torch, lambda i: K.quantized_matmul_w4a8_stacked_plain(
                    x, packed, scales, i % Lk, bits), 2, reps=3)
            nbytes = M * Kd + M * 4 + layer_bytes + N * 4 + M * N * 4
            ops = 2 * M * N * Kd
            bound, by = _bound_ms(nbytes, ops)
            lib_ms = None
            if _int_mm_refusal(torch, dev, M, Kd, N) is None:
                lib_ms = _int_mm_ms(
                    torch, xq, _unpacked_int8(torch, K, packed, bits),
                    [scales[i].reshape(1, -1) for i in range(Lk)], sx, iters)
            if tile_ms is not None:
                line += (f"; kernel 1's tile path {tile_ms:.4f} ms "
                         f"({ms / tile_ms:.2f}x)")
            line += (f"; persistent {ms:.4f} ms, kernel 1 {ms1:.4f} ms "
                     f"({ms / ms1:.2f}x), plain {plain_ms:.4f} ms, "
                     f"torch._int_mm {_ms_txt(lib_ms, ms)}, bound "
                     f"{bound:.4f} ms ({by}; {bound / ms:.1%} of bound)")
            if M == 8:
                main.append((ms, plain_ms, nbytes, ops, ms1, tile_ms,
                             lib_ms))
        print(line, flush=True)
        del packed
    torch.cuda.empty_cache()
    mean = [statistics.fmean(t[j] for t in main) for j in range(6)]
    bound, by = _bound_ms(mean[2], mean[3])
    print(f"w4a8 persistent M=8: mean of o and down {mean[0]:.4f} ms, "
          f"kernel 1 {mean[4]:.4f} ms, kernel 1's tile path {mean[5]:.4f} "
          f"ms, bound {bound:.4f} ms ({bound / mean[0]:.1%} of it)",
          flush=True)
    rec.update(ms=mean[0], plain_ms=mean[1], bound_ms=bound, bound_by=by,
               library_ms=_mean_or_none([t[6] for t in main]))

    rec = record["bf16_matmul_stacked"]
    K.bf16_matmul_stacked.launches = 0
    main = []
    cases = [(name, N, Kd, M, True) for name, N, Kd in (
        ("R", 128, 4096), ("L", 4096, 128), ("4096^2", 4096, 4096))
        for M in (8, 512)]
    cases += [(name, N, Kd, M, False) for name, N, Kd in (
        ("R", 128, 4096), ("4096^2", 4096, 4096)) for M in (16, 17)]
    for name, N, Kd, M, timed in cases:
        layer_bytes = N * Kd * 2
        Lk = max(2, math.ceil(200e6 / layer_bytes)) if timed else 3
        W = (torch.randn((Lk, N, Kd), generator=gen, device=dev)
             * 0.05).to(torch.bfloat16)
        x = torch.randn((M, Kd), generator=gen, device=dev)
        y = K.bf16_matmul_stacked(x, W, Lk - 1)
        ref = K.bf16_matmul_stacked_plain(x, W, Lk - 1)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        tol = 1e-5 * float(ref.abs().max())
        # exact bf16 products on both sides, f32 sums in another order
        if not torch.allclose(y, ref, rtol=1e-5, atol=tol):
            raise AssertionError(f"bf16_matmul_stacked {name} M={M} "
                                 "disagrees with plain")
        plan = K._bf16_stacked_plan(M, N, Kd, sms)
        line = (f"bf16_matmul_stacked {name} M={M} N={N} K={Kd}: plan "
                f"{plan['path']}, {plan['splits']} split(s) of "
                f"{plan['split_steps']} steps, grid {plan['grid']}; max diff "
                f"{err:.3e} (bound rtol 1e-5, atol {tol:.3e})")
        if plan["splits"] > 1:
            # the partials are summed in split order: the same bits again
            if not torch.equal(y, K.bf16_matmul_stacked(x, W, Lk - 1)):
                raise AssertionError(f"bf16_matmul_stacked {name} M={M}: "
                                     "two launches differ")
            line += "; a second launch equal bit for bit"
        rec["max_abs_err"] = max(rec["max_abs_err"] or 0.0, err)
        if timed:
            xb = x.to(torch.bfloat16)
            iters = 50 if M == 8 else 20
            ms = _time_ms(torch, lambda i: K._launch_bf16_stacked(
                xb, W, i % Lk), iters)
            plain_ms = _time_ms(torch, lambda i: K.bf16_matmul_stacked_plain(
                x, W, i % Lk), 3, reps=3)
            lib_ms = _time_ms(torch, lambda i: torch.matmul(
                xb, W[i % Lk].T), iters)
            nbytes = M * Kd * 2 + layer_bytes + M * N * 4
            ops = 2 * M * N * Kd
            bound, by = _bound_ms(nbytes, ops, BF16_OPS_PER_S)
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bf16 "
                     f"torch.matmul {lib_ms:.4f} ms ({ms / lib_ms:.2f}x), "
                     f"bound {bound:.4f} ms ({by}; {bound / ms:.1%} of "
                     f"bound)")
            if M == 8 and name != "4096^2":
                main.append((ms, plain_ms, nbytes, ops, lib_ms))
        print(line, flush=True)
        del W
    torch.cuda.empty_cache()
    mean = [statistics.fmean(t[j] for t in main) for j in range(5)]
    bound, by = _bound_ms(mean[2], mean[3], BF16_OPS_PER_S)
    n = K.bf16_matmul_stacked.launches
    print(f"bf16_matmul_stacked M=8: mean of R and L {mean[0]:.4f} ms, bf16 "
          f"torch.matmul {mean[4]:.4f} ms ({mean[0] / mean[4]:.2f}x)",
          flush=True)
    rec.update(ms=mean[0], plain_ms=mean[1], bound_ms=bound, bound_by=by,
               library_ms=mean[4], launches=n, launches_per_step=1, steps=n)


def _phase_kernels_long_blocks(torch, dev, gen):
    """Decode blocks longer than the kernel's 256-token sub-tile, in dots
    i8, f32 and bf16 against the plain versions, with their times: the
    all-batch kernel at T 2000 (one block, since 2000 % 128 != 0) on
    Llama-2-7B heads at batch 8, beside the same context in 250-token
    blocks of the row kernel; the paged kernel on 512-token pages (ctx
    2048); and a GQA block of 7 query heads per kv head at D 64 (Qwen2-0.5B's
    heads) over T 7000, B 1, KVH 2: 7 x 7000 logits, far over shared
    memory."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        attention as AT)

    def inputs(L, B, KVH, G, D, T):
        return dict(
            q=torch.randn((B, KVH, G, D), generator=gen, device=dev),
            k=torch.randint(-127, 128, (L, B, KVH, T, D), generator=gen,
                            dtype=torch.int8, device=dev),
            v=torch.randint(-127, 128, (L, B, KVH, T, D), generator=gen,
                            dtype=torch.int8, device=dev),
            ks=torch.rand((L, B, KVH, T), generator=gen, device=dev) * 0.02,
            vs=torch.rand((L, B, KVH, T), generator=gen, device=dev) * 0.02,
            kn=torch.randn((B, KVH, D), generator=gen, device=dev),
            vn=torch.randn((B, KVH, D), generator=gen, device=dev))

    for name, B, KVH, G, D, T, pos in (
            ("7b T=2000", 8, 32, 1, 128, 2000,
             [0, 250, 700, 999, 1000, 1500, 1999, 2000]),
            ("G7 D64 T=7000", 1, 2, 7, 64, 7000, [6999])):
        Lk = 2 if T == 2000 else 4
        t = inputs(Lk, B, KVH, G, D, T)
        args = [t[n] for n in ("q", "k", "v", "ks", "vs", "kn", "vn")]
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        if AT._ab_blocks(B, KVH, D, T, 64)[1] != T:
            raise AssertionError(f"{name}: expected one block of {T}")
        live = sum(min(x, T) for x in pos)
        nbytes = (KVH * live * (2 * D + 8) + 2 * B * KVH * G * D * 4
                  + 2 * B * KVH * D * 4 + B * 4)
        for dots in ("i8", "f32", "bf16"):
            out = AT.flash_decode_q8_ab(*args, 1, p, staged=True, dots=dots)
            ref = AT.flash_decode_q8_ab_plain(*args, 1, p, staged=True,
                                              dots=dots)
            if not torch.equal(out, AT.flash_decode_q8_staged(
                    *args, 1, p, block_t=T, dots=dots)):
                raise AssertionError(f"long block {name} {dots}: not equal "
                                     "to the staged row kernel")
            torch.cuda.synchronize()
            ok, bound_txt = _attn_ok(torch, out, ref, dots)
            ms = _time_ms(torch, lambda i: AT.flash_decode_q8_ab(
                *args, i % Lk, p, staged=True, dots=dots), 20)
            bound, by = _bound_ms(nbytes, 4 * KVH * G * live * D,
                                  _DOTS_RATE[dots])
            line = (f"long block: flash_decode_q8_ab {name} B={B} KVH={KVH} "
                    f"G={G} D={D}, one block of {T} tokens, staged, "
                    f"dots={dots}: equal to the staged row kernel; "
                    f"{bound_txt}; kernel {ms:.4f} ms, bound "
                    f"{bound:.4f} ms ({by}; {bound / ms:.1%} of bound)")
            if T == 2000:
                # the same context in 250-token blocks of the row kernel:
                # one walk per block, no recomputed logits
                ms_row = _time_ms(torch, lambda i: AT._launch_decode(
                    "flash_decode_staged_launch", *args, i % Lk, p, 250,
                    dots), 20)
                line += f"; row kernel, 250-token blocks {ms_row:.4f} ms"
            print(line, flush=True)
            if not ok:
                raise AssertionError(f"long block {name} {dots} disagrees "
                                     "with plain")
        del t, args
    torch.cuda.empty_cache()

    # the paged kernel on 512-token pages: block == page
    B, KVH, G, D, P, ctx = 8, 32, 1, 128, 512, 2048
    max_pages = ctx // P
    NP = B * max_pages + 4
    pos = [0, 300, 511, 512, 1024, 1500, 2047, 2048]
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    t = inputs(2, NP, KVH, G, D, P)
    t["q"] = torch.randn((B, KVH, G, D), generator=gen, device=dev)
    t["kn"] = torch.randn((B, KVH, D), generator=gen, device=dev)
    t["vn"] = torch.randn((B, KVH, D), generator=gen, device=dev)
    args = [t[n] for n in ("q", "k", "v", "ks", "vs", "kn", "vn")]
    perm = torch.randperm(NP, generator=torch.Generator().manual_seed(P))
    tables = perm[:B * max_pages].reshape(B, max_pages).to(
        device=dev, dtype=torch.int32)
    live = sum(pos)
    nbytes = (KVH * live * (2 * D + 8) + 2 * B * KVH * G * D * 4
              + 2 * B * KVH * D * 4 + B * 4)
    for dots in ("i8", "f32", "bf16"):
        out = AT.flash_decode_q8_paged(*args, 1, tables, p, dots=dots)
        ref = AT.flash_decode_q8_paged_plain(*args, 1, tables, p, dots=dots)
        gathered = [AT._gather_pages(x, 1, tables) for x in args[1:5]]
        if not torch.equal(out, AT.flash_decode_q8_staged(
                args[0], *gathered, *args[5:], 0, p, block_t=P, dots=dots)):
            raise AssertionError(f"long pages {dots}: not equal to the "
                                 "staged kernel at the same block")
        del gathered
        torch.cuda.synchronize()
        ok, bound_txt = _attn_ok(torch, out, ref, dots)
        ms = _time_ms(torch, lambda i: AT._flash_decode_q8_paged(
            *args, i % 2, tables, p, dots=dots), 20)
        bound, by = _bound_ms(nbytes, 4 * KVH * G * live * D,
                              _DOTS_RATE[dots])
        print(f"long block: flash_decode_q8_paged 7b {P}-token pages, ctx "
              f"{ctx}, pos {pos}, dots={dots}: equal to the staged kernel "
              f"at the same block; {bound_txt}; kernel "
              f"{ms:.4f} ms, bound {bound:.4f} ms ({by}; {bound / ms:.1%} "
              f"of bound)", flush=True)
        if not ok:
            raise AssertionError(f"long pages {dots} disagree with plain")
    del t, args
    torch.cuda.empty_cache()


def _phase_kernels_packed(torch, dev, gen, record):
    """The grouped bf16 matmul and the flat W4A8 matmul at Llama-2-7B's
    three projection shapes (q/k/v/o 4096 x 4096, gate/up 11008 x 4096,
    down 4096 x 11008; 4-bit), at decode's M = 8 and prefill's M = 512,
    after the grouped kernel's edges (M 16 and 17 at 4096 x 4096, a plane of
    160 bytes at M 8 and 40). Every grouped case prints its plan and is
    held to its plain version and to a second launch, bit for bit; the
    timed ones print cuBLAS's time beside the kernel's. The record takes
    M = 8, the mean time per launch over one layer's seven launches (the
    unfused path's decode)."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        kernels as K)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # the grouped kernel's edges: both sides of the M 16 / 17 cut at 4096^2
    # and a plane of 160 bytes (32 past a multiple of the kernel's 64-byte
    # step, so TMA zero-fills x past the end of each plane), each against
    # the plain version and a second launch, bit for bit
    for M, N, Kd in ((16, 4096, 4096), (17, 4096, 4096), (8, 200, 320),
                     (40, 200, 320)):
        G = K.resolve_group(4, Kd, None)
        packed = torch.randint(0, 256, (N, Kd // 2), generator=gen,
                               dtype=torch.uint8, device=dev)
        sg = torch.rand((N, Kd // G), generator=gen, device=dev) * 0.01
        x = torch.randn((M, Kd), generator=gen, device=dev)
        y = K.quantized_matmul(x, packed, sg, 4)
        y2 = K.quantized_matmul(x, packed, sg, 4)
        ref = K.quantized_matmul_plain(x, packed, sg, 4)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        tol = 1e-5 * float(ref.abs().max())
        plan = K._grouped_plan(M, N, Kd, 4, sms)
        print(f"quantized_matmul edge M={M} N={N} K={Kd} 4-bit G={G}: max "
              f"diff {err:.3e} (bound rtol 1e-5, atol {tol:.3e}), two "
              f"launches {'equal' if torch.equal(y, y2) else 'DIFFER'}; "
              f"plan {plan['path']} {plan['rows']} x {plan['cols']}, grid "
              f"{plan['grid']}, {plan['split_steps']} steps a split",
              flush=True)
        if not (torch.allclose(y, ref, rtol=1e-5, atol=tol)
                and torch.equal(y, y2)):
            raise AssertionError(f"quantized_matmul edge M={M} N={N} "
                                 f"K={Kd} disagrees with plain or itself")
        record["quantized_matmul"]["max_abs_err"] = max(
            record["quantized_matmul"]["max_abs_err"] or 0.0, err)

    shapes = [("q/k/v/o", 4096, 4096, 4), ("gate/up", 11008, 4096, 2),
              ("down", 4096, 11008, 1)]
    for M in (8, 512):
        # launch-weighted sums over one layer: ms, plain ms, bytes, ops,
        # library ms (grouped only)
        sums = {"quantized_matmul": [0.0] * 5,
                "quantized_matmul_w4a8": [0.0] * 5}
        for name, N, Kd, count in shapes:
            P = Kd // 2
            G = K.resolve_group(4, Kd, None)
            Lk = max(2, math.ceil(200e6 / (N * P)))
            packed = torch.randint(0, 256, (Lk, N, P), generator=gen,
                                   dtype=torch.uint8, device=dev)
            sg = torch.rand((Lk, N, Kd // G), generator=gen, device=dev) * 0.01
            sw = torch.rand((Lk, N, 1), generator=gen, device=dev) * 0.01
            x = torch.randn((M, Kd), generator=gen, device=dev)
            iters = 50 if M == 8 else 10

            # grouped: f32 sums in another order than the plain version's
            # cuBLAS f32 matmul of the same bf16 values; a second launch
            # gives the same bits (split-K partials summed in split order)
            y = K.quantized_matmul(x, packed[1], sg[1], 4)
            y2 = K.quantized_matmul(x, packed[1], sg[1], 4)
            ref = K.quantized_matmul_plain(x, packed[1], sg[1], 4)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            tol = 1e-5 * float(ref.abs().max())
            if not (torch.allclose(y, ref, rtol=1e-5, atol=tol)
                    and torch.equal(y, y2)):
                raise AssertionError(f"quantized_matmul {name} M={M} "
                                     "disagrees with plain or itself")
            plan = K._grouped_plan(M, N, Kd, 4, sms)
            xb = x.to(torch.bfloat16)
            ms = _time_ms(torch, lambda i: K._launch_grouped(
                xb, packed[i % Lk], sg[i % Lk], 4, G), iters)
            plain_ms = _time_ms(torch, lambda i: K.quantized_matmul_plain(
                x, packed[i % Lk], sg[i % Lk], 4), 2, reps=3)
            # the yardstick: one bf16 torch.matmul on the same weights,
            # dequantized to bf16 beforehand (not timed)
            W = [K.dequant_serving_xla(packed[i], sg[i], 4)
                 for i in range(Lk)]
            lib_err = float((torch.matmul(xb, W[1].T).float() - ref)
                            .abs().max())
            lib_ms = _time_ms(torch, lambda i: torch.matmul(
                xb, W[i % Lk].T), iters)
            del W
            nbytes = M * Kd * 2 + N * P + N * (Kd // G) * 4 + M * N * 4
            ops = 2 * M * N * Kd
            bound, by = _bound_ms(nbytes, ops, BF16_OPS_PER_S)
            print(f"quantized_matmul {name} M={M} N={N} K={Kd} 4-bit G={G}: "
                  f"max diff {err:.3e} (bound rtol 1e-5, atol {tol:.3e}), "
                  f"two launches equal; plan {plan['path']} {plan['rows']} x "
                  f"{plan['cols']}, grid {plan['grid']}, "
                  f"{plan['split_steps']} steps a split; kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bf16 torch.matmul {lib_ms:.4f} "
                  f"ms (max diff {lib_err:.3e}; kernel / cuBLAS "
                  f"{ms / lib_ms:.2f}), bound {bound:.4f} ms ({by}; "
                  f"{bound / ms:.1%} of bound)", flush=True)
            rec = record["quantized_matmul"]
            rec["max_abs_err"] = max(rec["max_abs_err"] or 0.0, err)
            for j, v in enumerate((ms, plain_ms, nbytes, ops, lib_ms)):
                sums["quantized_matmul"][j] += count * v

            # flat W4A8: exact integer sums, f32 epilogue
            y = K.quantized_matmul_w4a8(x, packed[1], sw[1], 4)
            ref = K.quantized_matmul_w4a8_plain(x, packed[1], sw[1], 4)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            tol = 1e-6 * float(ref.abs().max())
            if not torch.allclose(y, ref, rtol=1e-6, atol=tol):
                raise AssertionError(f"quantized_matmul_w4a8 {name} M={M} "
                                     "disagrees with plain")
            xq, sx = K.quantize_activations_int8(x)
            ms = _time_ms(torch, lambda i: K._launch_w4a8_stacked(
                xq, sx, packed[i % Lk], sw[i % Lk], None, 4), iters)
            plain_ms = _time_ms(
                torch, lambda i: K.quantized_matmul_w4a8_plain(
                    x, packed[i % Lk], sw[i % Lk], 4), 2, reps=3)
            lib_ms = None
            if _int_mm_refusal(torch, dev, M, Kd, N) is None:
                lib_ms = _int_mm_ms(
                    torch, xq, _unpacked_int8(torch, K, packed, 4),
                    [sw[i].reshape(1, -1) for i in range(Lk)], sx, iters)
            nbytes = M * Kd + M * 4 + N * P + N * 4 + M * N * 4
            bound, by = _bound_ms(nbytes, ops)
            print(f"quantized_matmul_w4a8 {name} M={M} N={N} K={Kd} 4-bit: "
                  f"max diff {err:.3e} (bound rtol 1e-6, atol {tol:.3e}) "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"torch._int_mm {_ms_txt(lib_ms, ms)}, bound "
                  f"{bound:.4f} ms ({by}; {bound / ms:.1%} of bound)",
                  flush=True)
            rec = record["quantized_matmul_w4a8"]
            rec["max_abs_err"] = max(rec["max_abs_err"] or 0.0, err)
            for j, v in enumerate((ms, plain_ms, nbytes, ops)):
                sums["quantized_matmul_w4a8"][j] += count * v
            # None poisons the library sum: _int_mm refused a shape
            lib_sum = sums["quantized_matmul_w4a8"][4]
            sums["quantized_matmul_w4a8"][4] = (
                None if lib_ms is None or lib_sum is None
                else lib_sum + count * lib_ms)
            del packed, sg, sw
        torch.cuda.empty_cache()
        for name, tot in sums.items():
            mean = [None if t is None else t / 7 for t in tot]
            bound, by = _bound_ms(mean[2], mean[3], BF16_OPS_PER_S
                                  if name == "quantized_matmul"
                                  else INT8_OPS_PER_S)
            lib = ("bf16 torch.matmul" if name == "quantized_matmul"
                   else "torch._int_mm")
            print(f"{name} M={M}: one layer's 7 launches, mean per launch "
                  f"{mean[0]:.4f} ms (plain {mean[1]:.4f}, bound {bound:.4f}"
                  f" {by}, {lib} {_ms_txt(mean[4], mean[0])})", flush=True)
            if M == 8:
                record[name].update(
                    ms=mean[0], plain_ms=mean[1], bound_ms=bound,
                    bound_by=by, library_ms=mean[4])


def _int_mm_call(torch, xq, w8, srow, sx):
    """The int8 kernels' yardstick: one ``torch._int_mm`` (cuBLASLt int8
    with i32 sums) against int8 weights (the W4A8 codes unpacked to ``u -
    maxq`` beforehand, untimed), then the kernels' rescale ``(acc * s_n) *
    sx_m``."""
    return (torch._int_mm(xq, w8.t()).float() * srow) * sx


def _int_mm_ms(torch, xq, w8s, srows, sx, iters):
    """Device ms of :func:`_int_mm_call` over the rotated layers ``w8s``."""
    return _time_ms(torch, lambda i: _int_mm_call(
        torch, xq, w8s[i % len(w8s)], srows[i % len(w8s)], sx), iters)


def _int_mm_refusal(torch, dev, M, Kd, N):
    """None if ``torch._int_mm`` takes an (M, K) x (K, N) product on the
    card (it has taken only M > 16 there), else the first line of its
    error."""
    try:
        torch._int_mm(torch.zeros((M, Kd), dtype=torch.int8, device=dev),
                      torch.zeros((N, Kd), dtype=torch.int8, device=dev).t())
        torch.cuda.synchronize()
    except RuntimeError as exc:
        return str(exc).splitlines()[0]
    return None


def _ms_txt(lib_ms, ms):
    """A yardstick's ms and the kernel's ratio to it, or "refused"."""
    if lib_ms is None:
        return "refused"
    return f"{lib_ms:.4f} ms (kernel / it {ms / lib_ms:.2f})"


def _unpacked_int8(torch, K, packed, bits):
    """Layer by layer, the int8 weights ``u - maxq`` of packed codes."""
    maxq = 2 ** (bits - 1) - 1
    return [(K.unpack_codes(p, bits).to(torch.int16) - maxq).to(torch.int8)
            for p in packed]


def _phase_kernels_prefill(torch, dev, gen, record):
    """The W4A8 kernel at prefill's M (its tile path), and the flash prefill
    kernel."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        attention as AT, kernels as K)

    # W4A8 at M = S (the prefill's rows), the four Llama-2-7B projections
    # at 4 bits on the tile path (int8 wgmma): bit-equal to the plain
    # version and to a launch of the rowdot kernel (the decode design, forced
    # here); beside one torch._int_mm on the codes unpacked to int8. The
    # packed weights rotate over enough layers to come from device memory.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for M in (512, 2048):
        for name, N, Kd in [("qkv", 12288, 4096), ("o", 4096, 4096),
                            ("gate_up", 22016, 4096),
                            ("down", 4096, 11008)]:
            Lk = max(2, math.ceil(200e6 / (N * Kd // 2)))
            packed = torch.randint(0, 256, (Lk, N, Kd // 2), generator=gen,
                                   dtype=torch.uint8, device=dev)
            scales = torch.rand((Lk, N, 1), generator=gen, device=dev) * 0.01
            x = torch.randn((M, Kd), generator=gen, device=dev)
            y = K.quantized_matmul_w4a8_stacked(x, packed, scales, 1, 4)
            ref = K.quantized_matmul_w4a8_stacked_plain(x, packed, scales, 1,
                                                        4)
            xq, sx = K.quantize_activations_int8(x)
            row = K._launch_w4a8_stacked(xq, sx, packed, scales, 1, 4,
                                         path="rowdot")
            torch.cuda.synchronize()
            plan = K._w4a8_plan(M, N, Kd, 4, sms)
            if not (plan["path"] == "tile" and torch.equal(y, ref)
                    and torch.equal(y, row)):
                raise AssertionError(f"w4a8_stacked {name} M={M}: the tile "
                                     "path is not bit-equal to the plain "
                                     "version and the rowdot launch")
            ms = _time_ms(torch, lambda i: K._launch_w4a8_stacked(
                xq, sx, packed, scales, i % Lk, 4), 10)
            plain_ms = _time_ms(
                torch, lambda i: K.quantized_matmul_w4a8_stacked_plain(
                    x, packed, scales, i % Lk, 4), 2, reps=3)
            w8 = _unpacked_int8(torch, K, packed, 4)
            srows = [scales[i].reshape(1, -1) for i in range(Lk)]
            lib_ms = _int_mm_ms(torch, xq, w8, srows, sx, 10)
            lib_eq = torch.equal(_int_mm_call(torch, xq, w8[1], srows[1], sx),
                                 ref)
            del w8
            nbytes = M * Kd + M * 4 + N * Kd // 2 + N * 4 + M * N * 4
            bound, by = _bound_ms(nbytes, 2 * M * N * Kd)
            print(f"w4a8_stacked prefill {name} M={M} N={N} K={Kd} 4-bit: "
                  f"tiles of {plan['rows']} x {plan['cols']}, "
                  f"{plan['tiles']} on {plan['grid'][0]} persistent CTAs; "
                  f"bit-equal to the plain version and to "
                  f"the rowdot launch; kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, torch._int_mm {_ms_txt(lib_ms, ms)} "
                  f"({'equal' if lib_eq else 'not equal'} to plain), bound "
                  f"{bound:.4f} ms ({by}; {bound / ms:.1%} of bound)",
                  flush=True)
            del packed
    torch.cuda.empty_cache()

    # flash prefill: Llama-2-7B heads at S = 512 and 2048, a ragged S, and
    # Llama-3-8B's GQA (8 kv heads, 4 query heads each); two launches give
    # the same bits
    fp = record["flash_prefill"]
    for name, S, KVH, G, main in [("7b", 512, 32, 1, False),
                                  ("7b", 2048, 32, 1, True),
                                  ("7b ragged", 300, 32, 1, False),
                                  ("llama3-8b GQA", 2048, 8, 4, False)]:
        D, H = 128, KVH * G
        q = torch.randn((1, S, H, D), generator=gen, device=dev)
        k = torch.randn((1, S, KVH, D), generator=gen, device=dev)
        v = torch.randn((1, S, KVH, D), generator=gen, device=dev)
        out = AT.flash_prefill(q, k, v)
        ref = AT.flash_prefill_plain(q, k, v)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not torch.allclose(out, ref, rtol=2e-5, atol=2e-6):
            raise AssertionError(f"flash_prefill {name} S={S} disagrees "
                                 "with plain")
        if not torch.equal(out, AT.flash_prefill(q, k, v)):
            raise AssertionError(f"flash_prefill {name} S={S}: two "
                                 "launches differ")
        ms = _time_ms(torch, lambda i: AT.flash_prefill(q, k, v), 10)
        plain_ms = _time_ms(torch, lambda i: AT.flash_prefill_plain(q, k, v),
                            2, reps=3)
        # the yardstick: one SDPA call on the same (B, H, S, D) inputs, k/v
        # expanded to the query heads beforehand
        qt = q.transpose(1, 2).contiguous()
        kt = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        vt = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        lib = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True).transpose(1, 2)
        lib_err = float((lib - ref).abs().max())
        lib_ms = _time_ms(torch, lambda i: torch.nn.functional.
                          scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True), 10)
        bound, by, fma_bound = _prefill_bounds(S, H, KVH, D)
        print(f"flash_prefill {name} S={S} H={H} KVH={KVH} D={D}: max diff "
              f"{err:.3e} (bound rtol 2e-5, atol 2e-6) kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms (max diff "
              f"{lib_err:.3e}), bound {bound:.4f} ms ({by}, 3xTF32; "
              f"{bound / ms:.1%} of bound; f32-FMA bound {fma_bound:.4f} ms)",
              flush=True)
        fp["max_abs_err"] = max(fp["max_abs_err"] or 0.0, err)
        if main:
            fp.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                      library_ms=lib_ms)
        del q, k, v, qt, kt, vt
    # sharp logits (q and k times 3, logits up to ~40), where the rtol/atol
    # gate measures summation order: the kernel's max-abs error against a
    # float64 attention within 1.25x the plain f32 version's
    for name, S, KVH, G in [("7b sharp", 512, 32, 1),
                            ("7b sharp", 2048, 32, 1),
                            ("llama3-8b GQA sharp", 2048, 8, 4)]:
        D, H = 128, KVH * G
        q = 3 * torch.randn((1, S, H, D), generator=gen, device=dev)
        k = 3 * torch.randn((1, S, KVH, D), generator=gen, device=dev)
        v = torch.randn((1, S, KVH, D), generator=gen, device=dev)
        err, plain_err = _prefill_sharp_errors(torch, AT, q, k, v)
        print(f"flash_prefill {name} S={S} H={H} KVH={KVH}: max diff "
              f"against float64 {err:.3e}, plain f32 {plain_err:.3e} "
              f"(bound 1.25x: {1.25 * plain_err:.3e})", flush=True)
        if err > 1.25 * plain_err:
            raise AssertionError(f"flash_prefill {name} S={S}: {err:.3e} "
                                 f"from float64, over 1.25x the plain "
                                 f"version's {plain_err:.3e}")
        del q, k, v
    torch.cuda.empty_cache()


def _prefill_bounds(S, H, KVH, D):
    """(bound ms, what binds, f32-FMA bound ms) of one causal prefill
    attention: q, k, v and out once each against the 3xTF32 route's
    operations (three tf32 products for each of the 4 H D S (S + 1) / 2
    causal ones, at the TF32 peak); beside it the same operations as f32
    FMAs outside the tensor cores."""
    nbytes = 4 * (2 * S * H * D + 2 * S * KVH * D)
    ops = 4 * H * D * S * (S + 1) / 2
    bound, by = _bound_ms(nbytes, 3 * ops, TF32_OPS_PER_S)
    return bound, by, _bound_ms(nbytes, ops, F32_OPS_PER_S)[0]


def _prefill_truth_f64(torch, q, k, v, scale, chunk=4):
    """Causal softmax attention of q (B, S, H, D) and k/v (B, S, KVH, D)
    in float64, with the f32 ``scale`` the kernels multiply by; ``chunk``
    heads at a time, so that S 4096 fits."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    out = torch.empty((B, S, H, D), dtype=torch.float64, device=q.device)
    for h0 in range(0, H, chunk):
        kv = [h // G for h in range(h0, min(h0 + chunk, H))]
        logits = torch.einsum("bshd,bthd->bhst", q[:, :, h0:h0 + chunk]
                              .double(), k[:, :, kv].double()) * scale
        logits.masked_fill_(~mask, float("-inf"))
        out[:, :, h0:h0 + chunk] = torch.einsum(
            "bhst,bthd->bshd", torch.softmax(logits, dim=-1),
            v[:, :, kv].double())
    return out


def _prefill_sharp_errors(torch, AT, q, k, v):
    """(the kernel's, the plain f32 version's) max-abs error against
    :func:`_prefill_truth_f64` on the same inputs."""
    truth = _prefill_truth_f64(torch, q, k, v, AT._scale_f32(q.shape[3]))
    err = float((AT.flash_prefill(q, k, v).double() - truth).abs().max())
    plain = AT.flash_prefill_plain(q, k, v)
    return err, float((plain.double() - truth).abs().max())


def _phase_kernels_decode(torch, dev, gen, record):
    """The all-batch (staged and inline) and inline row decode kernels."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        attention as AT)

    ab, inl = record["flash_decode_q8_ab"], record["flash_decode_q8"]
    # Llama-2-7B at B 8 over a 4096-token cache, ragged rows (mean 2049)
    ragged = [0, 700, 1300, 1900, 2300, 2700, 3400, 4095]
    cases = [("ab", "7b T=4096 ragged", 4096, ragged, st, dots,
              st and dots == "f32")
             for st in (True, False) for dots in ("f32", "i8", "bf16")]
    cases += [("row", "7b bench pos 128", 256, [128] * 8, False, dots,
               dots == "i8") for dots in ("i8", "f32", "bf16")]
    # the inline row kernel at T 2048: Llama-2-7B's and Llama-3-8B's heads
    mixed = [0, 1, 300, 511, 512, 1999, 2047, 2048]
    cases += [("row", "7b T=2048 mixed", 2048, mixed, False, "i8", False),
              ("row", "llama3-8b GQA T=2048", 2048, mixed, False, "i8",
               False),
              ("row", "llama3-8b GQA T=2048", 2048, mixed, False, "f32",
               False)]
    for kind, name, T, pos, staged, dots, main in cases:
        B, KVH, G, D = (8, 8, 4, 128) if "GQA" in name else (8, 32, 1, 128)
        layer_bytes = B * KVH * T * (2 * D + 8)
        Lk = max(2, math.ceil(200e6 / layer_bytes))
        q = torch.randn((B, KVH, G, D), generator=gen, device=dev)
        k = torch.randint(-127, 128, (Lk, B, KVH, T, D), generator=gen,
                          dtype=torch.int8, device=dev)
        v = torch.randint(-127, 128, (Lk, B, KVH, T, D), generator=gen,
                          dtype=torch.int8, device=dev)
        ks = torch.rand((Lk, B, KVH, T), generator=gen, device=dev) * 0.02
        vs = torch.rand((Lk, B, KVH, T), generator=gen, device=dev) * 0.02
        kn = torch.randn((B, KVH, D), generator=gen, device=dev)
        vn = torch.randn((B, KVH, D), generator=gen, device=dev)
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        if kind == "ab":
            def fn(i, plain=False):
                f = AT.flash_decode_q8_ab_plain if plain else \
                    AT.flash_decode_q8_ab
                return f(q, k, v, ks, vs, kn, vn, i % Lk, p, staged=staged,
                         dots=dots)
            rec, label = ab, f"flash_decode_q8_ab staged={staged}"
        else:
            def fn(i, plain=False):
                f = AT.flash_decode_q8_plain if plain else AT.flash_decode_q8
                return f(q, k, v, ks, vs, i % Lk, p, dots=dots)
            rec, label = inl, "flash_decode_q8 inline"
        out, ref = fn(1), fn(1, plain=True)
        same = ""
        if kind == "ab":
            # the row kernel at the same block: the same walk, bit for bit
            bt = AT._ab_blocks(B, KVH, D, T, 64)[1]
            row = (AT.flash_decode_q8_staged(q, k, v, ks, vs, kn, vn, 1, p,
                                             block_t=bt, dots=dots)
                   if staged else AT.flash_decode_q8(q, k, v, ks, vs, 1, p,
                                                     block_t=bt, dots=dots))
            if not torch.equal(out, row):
                raise AssertionError(f"{label} {name} {dots}: not equal to "
                                     f"the row kernel at block {bt}")
            same = (f"equal to the {'staged' if staged else 'inline'} row "
                    f"kernel at block {bt}; ")
        else:
            txt, _ = _row_beside_split(torch, AT, (q, k, v, ks, vs, kn, vn),
                                       Lk, p, T, dots, False, out)
            same = f"{txt}; "
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        ok, bound_txt = _attn_ok(torch, out, ref, dots)
        ms = _time_ms(torch, fn, 50)
        plain_ms = _time_ms(torch, lambda i: fn(i, plain=True), 2, reps=3)
        # tokens attended per row: < pos (staged) or <= pos (inline)
        live = sum(min(x if staged else x + 1, T) for x in pos)
        nbytes = (KVH * live * (2 * D + 8) + 2 * B * KVH * G * D * 4
                  + (2 * B * KVH * D * 4 if staged else 0) + B * 4)
        ops = 4 * KVH * G * live * D
        bound, by = _bound_ms(nbytes, ops, _DOTS_RATE[dots])
        print(f"{label} {name} dots={dots} B={B} KVH={KVH} G={G} D={D} "
              f"T={T}: {same}max diff {err:.3e} ({bound_txt}) kernel "
              f"{ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}; "
              f"{bound / ms:.1%} of bound)", flush=True)
        if not ok:
            raise AssertionError(f"{label} {name} {dots} disagrees with "
                                 "plain")
        rec["max_abs_err"] = max(rec["max_abs_err"] or 0.0, err)
        if main:
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
        del k, v
    torch.cuda.empty_cache()


def _phase_kernels_paged(torch, dev, gen, record):
    """The paged decode kernel (``flash_decode_q8_paged``) at Llama-2-7B's
    heads, batch 8, over about 2048 tokens of context per row: a randomly
    permuted page table, ragged positions (0 and non-multiples of the
    page), pages of 16 tokens (the paged engine's default, the record's
    row) and of 256 (the staged kernel's block), dots i8, f32 and bf16;
    each output equal bit for bit to the staged kernel's over the rows'
    pages gathered into a contiguous cache, in blocks of the page; timed
    beside the staged kernel over the same context in 256-token blocks.
    The kernel is timed through ``_flash_decode_q8_paged``: the wrapper's
    page-id check reads the table back to the host, which a CUDA graph
    cannot capture."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        attention as AT)

    rec = record["flash_decode_q8_paged"]
    B, KVH, G, D, ctx, Lk = 8, 32, 1, 128, 2048, 2
    pos = [0, 300, 777, 1024, 1500, 1801, 2047, 2048]
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    live = sum(pos)
    q = torch.randn((B, KVH, G, D), generator=gen, device=dev)
    kn = torch.randn((B, KVH, D), generator=gen, device=dev)
    vn = torch.randn((B, KVH, D), generator=gen, device=dev)
    nbytes = (KVH * live * (2 * D + 8) + 2 * B * KVH * G * D * 4
              + 2 * B * KVH * D * 4 + B * 4)
    staged_ms = {}
    for dots in ("i8", "f32", "bf16"):
        # the staged kernel's block (256) over the same context
        kc, vc = (torch.randint(-127, 128, (Lk, B, KVH, ctx, D),
                                generator=gen, dtype=torch.int8, device=dev)
                  for _ in range(2))
        ksc, vsc = (torch.rand((Lk, B, KVH, ctx), generator=gen,
                               device=dev) * 0.02 for _ in range(2))
        staged_ms[dots] = _time_ms(torch, lambda i: AT._launch_decode(
            "flash_decode_staged_launch", q, kc, vc, ksc, vsc, kn, vn,
            i % Lk, p, 256, dots), 50)
        del kc, vc, ksc, vsc
    for P in (16, 256):
        max_pages = ctx // P
        NP = B * max_pages + 8
        k = torch.randint(-127, 128, (Lk, NP, KVH, P, D), generator=gen,
                          dtype=torch.int8, device=dev)
        v = torch.randint(-127, 128, (Lk, NP, KVH, P, D), generator=gen,
                          dtype=torch.int8, device=dev)
        ks = torch.rand((Lk, NP, KVH, P), generator=gen, device=dev) * 0.02
        vs = torch.rand((Lk, NP, KVH, P), generator=gen, device=dev) * 0.02
        perm = torch.randperm(NP, generator=torch.Generator().manual_seed(P))
        tables = perm[:B * max_pages].reshape(B, max_pages).to(
            device=dev, dtype=torch.int32)
        args = (q, k, v, ks, vs, kn, vn)
        gathered = [AT._gather_pages(t, 1, tables) for t in (k, v, ks, vs)]
        for dots in ("i8", "f32", "bf16"):
            out = AT.flash_decode_q8_paged(*args, 1, tables, p, dots=dots)
            ref = AT.flash_decode_q8_paged_plain(*args, 1, tables, p,
                                                 dots=dots)
            row = AT.flash_decode_q8_staged(q, *gathered, kn, vn, 0, p,
                                            block_t=P, dots=dots)
            if not torch.equal(out, row):
                raise AssertionError(f"flash_decode_q8_paged page {P} {dots}"
                                     ": not equal to the staged kernel at "
                                     "the same block")
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            ok, bound_txt = _attn_ok(torch, out, ref, dots)
            ms = _time_ms(torch, lambda i: AT._flash_decode_q8_paged(
                *args, i % Lk, tables, p, dots=dots), 50)
            plain_ms = _time_ms(
                torch, lambda i: AT.flash_decode_q8_paged_plain(
                    *args, i % Lk, tables, p, dots=dots), 2, reps=3)
            bound, by = _bound_ms(nbytes, 4 * KVH * G * live * D,
                                  _DOTS_RATE[dots])
            print(f"flash_decode_q8_paged 7b page {P} dots={dots} B={B} "
                  f"KVH={KVH} G={G} D={D} ctx {ctx} pos {pos}: equal to the "
                  f"staged kernel at block {P} over the gathered pages; "
                  f"max diff "
                  f"{err:.3e} ({bound_txt}) kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}; "
                  f"{bound / ms:.1%} of bound); staged kernel over the same "
                  f"context {staged_ms[dots]:.4f} ms "
                  f"({ms / staged_ms[dots]:.2f}x)", flush=True)
            if not ok:
                raise AssertionError(f"flash_decode_q8_paged page {P} {dots} "
                                     "disagrees with plain")
            rec["max_abs_err"] = max(rec["max_abs_err"] or 0.0, err)
            if P == 16 and dots == "f32":
                rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                           bound_by=by)
        del k, v, ks, vs, gathered
    torch.cuda.empty_cache()


def _lowrank_weights(torch, dev, gen, Lk, N, Kd, n_proj, rank=128):
    """Stacked 4-bit packed codes with row scales and int8 R / L factor
    codes with their scales, as ``quantize_factors_int8_fused`` stores
    them for a group of ``n_proj`` projections."""
    return dict(
        packed=torch.randint(0, 256, (Lk, N, Kd // 2), generator=gen,
                             dtype=torch.uint8, device=dev),
        scales=torch.rand((Lk, N, 1), generator=gen, device=dev) * 0.01,
        R=torch.randint(-127, 128, (Lk, n_proj * rank, Kd), generator=gen,
                        dtype=torch.int8, device=dev),
        Rs=torch.rand((Lk, n_proj * rank, 1), generator=gen,
                      device=dev) * 1e-3,
        L=torch.randint(-127, 128, (Lk, N, rank), generator=gen,
                        dtype=torch.int8, device=dev),
        Ls=torch.rand((Lk, N, 1), generator=gen, device=dev) * 1e-3)


def _ops_int8_units(i8=0.0, bf16=0.0, f32=0.0):
    """Operations of mixed types as int8 operations of the same time at
    the card's peaks (the factor dots run on bf16 values, the attention in
    f32)."""
    return (i8 + bf16 * INT8_OPS_PER_S / BF16_OPS_PER_S
            + f32 * INT8_OPS_PER_S / F32_OPS_PER_S)


def _phase_kernels_lowrank(torch, dev, gen, record):
    """The four fused-factor kernels against their plain versions at
    Llama-2-7B's shapes, batch M = 8, rank 128, 4-bit: the L-fused kernel
    on qkv, o, gate/up and down, also at prefill's M = 512 and 2048 (its
    tile path), each with its bound; the LR-fused kernel on qkv and gate/up,
    also at M = 512 and 2048 (the tensor-core xr kernel and the L-fused tile
    kernel at every M at rank 128; the cooperative kernel, which the plan
    keeps for a rank over 320 or K over 66311, by override); the whole-MLP
    kernel; the fused attention + o_proj kernel over a 256-token cache at
    position 128, staged and inline. Weights rotate over enough layers to
    come from device memory. The integer sums are exact on both sides; the
    factor dots sum in another f32 order; xr inside the LR kernel can round
    to the other bf16 neighbour; the two megakernels requantize inside
    (their flipped int8 codes are counted against the plain version's)."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        attention as AT, kernels as K)

    rank, M = 128, 8
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # --- A: the L-fused kernel, the four projections of a layer, at decode's
    # M (l_kernel) and at prefill's M = 512 and 2048 (the int8 wgmma tile
    # path with the L epilogue on bf16 wgmma)
    la = record["quantized_matmul_w4a8_l_stacked"]
    main = []
    for name, splits, Kd in [("qkv", (4096,) * 3, 4096),
                             ("o_proj", (4096,), 4096),
                             ("gate_up", (11008,) * 2, 4096),
                             ("down_proj", (4096,), 11008)]:
        N, n_proj = sum(splits), len(splits)
        Lk = max(2, math.ceil(200e6 / (N * Kd // 2 + N * rank)))
        w = _lowrank_weights(torch, dev, gen, Lk, N, Kd, n_proj)
        for m in (8, 512, 2048):
            x = torch.randn((m, Kd), generator=gen, device=dev)
            xr = K.thin_xr(x, w["R"][1], w["Rs"][1])
            args = (w["packed"], w["scales"], 1, xr, w["L"], w["Ls"], 4, rank,
                    splits)
            y = K.quantized_matmul_w4a8_l_stacked(x, *args)
            ref = K.quantized_matmul_w4a8_l_stacked_plain(x, *args)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            tol = 1e-5 * float(ref.abs().max())
            ok = torch.allclose(y, ref, rtol=1e-5, atol=tol)
            xq, sx = K.quantize_activations_int8(x)
            plan = K._w4a8_l_plan(m, N, Kd, 4, rank, splits, sms)
            ms = _time_ms(torch, lambda i: K._launch_l(
                xq, sx, w["packed"], w["scales"], i % Lk, xr, w["L"],
                w["Ls"], 4, rank, splits), 50 if m == 8 else 10)
            plain_ms = _time_ms(
                torch, lambda i: K.quantized_matmul_w4a8_l_stacked_plain(
                    x, w["packed"], w["scales"], i % Lk, xr, w["L"], w["Ls"],
                    4, rank, splits), 2, reps=3)
            nbytes = (m * Kd + m * 4 + N * Kd // 2 + N * 4
                      + m * n_proj * rank * 4 + N * rank + N * 4 + m * N * 4)
            ops = _ops_int8_units(i8=2 * m * N * Kd, bf16=2 * m * N * rank)
            bound, by = _bound_ms(nbytes, ops)
            how = ("l_kernel" if plan["path"] == "rowdot" else
                   f"tile path, tiles of {plan['rows']} x {plan['cols']}, "
                   f"{plan['tiles']} on {plan['grid'][0]} persistent CTAs")
            print(f"w4a8_l_stacked {name} M={m} N={N} K={Kd} rank {rank} "
                  f"4-bit ({how}): max diff {err:.3e} (bound rtol 1e-5, atol "
                  f"{tol:.3e}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {bound:.4f} ms ({by}; {bound / ms:.1%} of bound)",
                  flush=True)
            if not ok:
                raise AssertionError(f"w4a8_l_stacked {name} M={m} disagrees "
                                     "with plain")
            la["max_abs_err"] = max(la["max_abs_err"] or 0.0, err)
            if m == 8:
                main.append((ms, plain_ms, nbytes, ops))
        del w
    torch.cuda.empty_cache()
    mean = [statistics.fmean(t[j] for t in main) for j in range(4)]
    bound, by = _bound_ms(mean[2], mean[3])
    la.update(ms=mean[0], plain_ms=mean[1], bound_ms=bound, bound_by=by)

    # --- B: the LR-fused kernel on qkv and gate/up (o and down keep kernel
    # 1 and the torch factor dots on factor path "lr"), at decode's M and at
    # prefill's M = 512 and 2048, on the plan's design (K._w4a8_lr_plan: the
    # tensor-core xr kernel and then the L-fused tile kernel); at M 8 also
    # the cooperative lr_kernel by override
    lr = record["quantized_matmul_w4a8_lr_stacked"]
    main = []
    for name, splits in (("qkv", (4096,) * 3), ("gate_up", (11008,) * 2)):
        N, n_proj, Kd = sum(splits), len(splits), 4096
        nR = n_proj * rank
        Lk = max(2, math.ceil(200e6 / (N * Kd // 2 + N * rank + nR * Kd)))
        w = _lowrank_weights(torch, dev, gen, Lk, N, Kd, n_proj)
        for m in (8, 512, 2048):
            x = torch.randn((m, Kd), generator=gen, device=dev)
            xq, sx = K.quantize_activations_int8(x)
            plan = K._w4a8_lr_plan(m, N, Kd, 4, rank, splits, sms)
            paths = [None] + (["coop" if plan["path"] == "tile" else "tile"]
                              if m == M else [])
            for path in paths:
                largs = (x, xq, sx, w["packed"], w["scales"], 1, w["R"],
                         w["Rs"], w["L"], w["Ls"], 4, rank, splits)
                design = path or plan["path"]
                # the output against the plain version on the kernel's own
                # xr (an xr element may round to the other bf16 neighbour),
                # that xr against the plain thin dot, a second launch bit
                # for bit
                if path is None:
                    y = K.quantized_matmul_w4a8_lr_stacked(
                        x, *largs[3:5], 1, *largs[6:])
                    y1, xr = K._launch_lr(*largs)
                    same = bool(torch.equal(y, y1))
                else:
                    y, xr = K._launch_lr(*largs, path=path)
                    same = True
                y2, xr2 = K._launch_lr(*largs, path=path)
                ref = K.quantized_matmul_w4a8_l_stacked_plain(
                    x, w["packed"], w["scales"], 1, xr, w["L"], w["Ls"], 4,
                    rank, splits)
                xr_ref = K.thin_xr(x, w["R"][1], w["Rs"][1])
                torch.cuda.synchronize()
                err = float((y - ref).abs().max())
                xr_err = float((xr - xr_ref).abs().max())
                tol = 1e-5 * float(ref.abs().max())
                xr_tol = 1e-5 * float(xr_ref.abs().max())
                ok = (same and torch.equal(y, y2) and torch.equal(xr, xr2)
                      and torch.allclose(y, ref, rtol=1e-5, atol=tol)
                      and torch.allclose(xr, xr_ref, rtol=1e-5,
                                         atol=xr_tol))
                e_plain = _rel(
                    torch, y, K.quantized_matmul_w4a8_lr_stacked_plain(
                        x, w["packed"], w["scales"], 1, w["R"], w["Rs"],
                        w["L"], w["Ls"], 4, rank, splits))
                ms = _time_ms(torch, lambda i: K._launch_lr(
                    *largs[:5], i % Lk, *largs[6:], path=path),
                    50 if m == 8 else 10)
                plain_ms = _time_ms(
                    torch, lambda i: K.quantized_matmul_w4a8_lr_stacked_plain(
                        x, w["packed"], w["scales"], i % Lk, w["R"], w["Rs"],
                        w["L"], w["Ls"], 4, rank, splits), 2, reps=3)
                nbytes = (m * Kd * 5 + m * 4 + N * Kd // 2 + N * 4 + nR * Kd
                          + nR * 4 + N * rank + N * 4 + m * N * 4)
                ops = _ops_int8_units(i8=2 * m * N * Kd,
                                      bf16=2 * m * nR * Kd + 2 * m * N * rank)
                bound, by = _bound_ms(nbytes, ops)
                if design == "tile":
                    xp = K._w4a8_lr_plan(m, N, Kd, 4, rank, splits, sms,
                                         path="tile")
                    xb = x.to(torch.bfloat16)
                    xr_ms = _time_ms(torch, lambda i: K._launch_lr_xr(
                        xb, w["R"][i % Lk], w["Rs"][i % Lk], rank,
                        xp["xr"]),
                        50 if m == 8 else 20)
                    # bf16 x and the int8 codes in, f32 xr out
                    xr_bound, _ = _bound_ms(
                        m * Kd * 2 + nR * Kd + nR * 4 + m * nR * 4,
                        2 * m * nR * Kd, BF16_OPS_PER_S)
                    x_plan = xp["xr"]
                    how = (f"tile path: xr kernel, tiles of 128 R rows x "
                           f"{x_plan['cols']}, grid {x_plan['grid']} "
                           f"({x_plan['splits']} K splits of "
                           f"{x_plan['split_steps']} steps), alone "
                           f"{xr_ms:.4f} ms, bound {xr_bound:.4f} ms "
                           f"({xr_bound / xr_ms:.1%} of bound); then the L "
                           f"tile kernel, tiles of {xp['rows']} x "
                           f"{xp['cols']}, {xp['tiles']} on "
                           f"{xp['grid'][0]} persistent CTAs")
                else:
                    how = "cooperative lr_kernel"
                if path is not None:
                    how += ", by override"
                print(f"w4a8_lr_stacked {name} M={m} N={N} K={Kd} rank "
                      f"{rank} 4-bit ({how}): "
                      f"max diff {err:.3e} on its own xr (bound rtol 1e-5, "
                      f"atol {tol:.3e}), xr max diff {xr_err:.3e} (bound "
                      f"rtol 1e-5, atol {xr_tol:.3e}), repeat bit-equal; "
                      f"{e_plain:.3e} rel-Frobenius against the plain "
                      f"version's own xr; call {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}; "
                      f"{bound / ms:.1%} of bound)", flush=True)
                if not ok:
                    raise AssertionError(f"w4a8_lr_stacked {name} M={m} "
                                         f"({design}) disagrees with plain")
                lr["max_abs_err"] = max(lr["max_abs_err"] or 0.0, err)
                if m == M and path is None:
                    main.append((ms, plain_ms, nbytes, ops))
        del w
    torch.cuda.empty_cache()
    mean = [statistics.fmean(t[j] for t in main) for j in range(4)]
    bound, by = _bound_ms(mean[2], mean[3])
    lr.update(ms=mean[0], plain_ms=mean[1], bound_ms=bound, bound_by=by)

    # --- C: the whole-MLP kernel, h 4096, im 11008
    h, im = 4096, 11008
    layer_bytes = 3 * h * im // 2 + 2 * im * rank + rank * im + h * rank
    Lk = max(2, math.ceil(200e6 / layer_bytes))
    gu = _lowrank_weights(torch, dev, gen, Lk, 2 * im, h, 2)
    dn = _lowrank_weights(torch, dev, gen, Lk, h, im, 1)
    gs = 0.5 + 1.5 * torch.rand((Lk, 2), generator=gen, device=dev)
    x = torch.randn((M, h), generator=gen, device=dev)
    xr = K.thin_xr(x, gu["R"][1], gu["Rs"][1])

    def mlp_args(layer):
        return (gu["packed"], gu["scales"], layer, xr, gu["L"], gu["Ls"], gs,
                dn["packed"], dn["scales"], dn["R"], dn["Rs"], dn["L"],
                dn["Ls"], 4, rank)

    y = K.quantized_matmul_w4a8_mlp_stacked(x, *mlp_args(1))
    parts = K._mlp_plain_parts(x, *mlp_args(1))
    xq, sx = K.quantize_activations_int8(x)
    y2, scratch = K._launch_mlp(xq, sx, xr, gu["packed"], gu["scales"], 1,
                                *mlp_args(1)[4:])
    torch.cuda.synchronize()
    same = bool(torch.equal(y, y2))
    flips = int((scratch["m8"] != parts["m8"]).sum())
    rel = _rel(torch, y, parts["out"])
    err = float((y - parts["out"]).abs().max())
    ms = _time_ms(torch, lambda i: K._launch_mlp(
        xq, sx, xr, gu["packed"], gu["scales"], i % Lk, gu["L"], gu["Ls"],
        gs, dn["packed"], dn["scales"], dn["R"], dn["Rs"], dn["L"], dn["Ls"],
        4, rank), 20)
    plain_ms = _time_ms(
        torch, lambda i: K.quantized_matmul_w4a8_mlp_stacked_plain(
            x, *mlp_args(i % Lk)), 2, reps=3)
    # the unfused yardstick, same weights: row 6's gate/up and down (the
    # L-fused kernel at M 8) on the plain version's m, its codes and xrd
    mq, sm = K.quantize_activations_int8(parts["m"])
    xrd = K.thin_xr(parts["m"], dn["R"][1], dn["Rs"][1])
    gu_ms = _time_ms(torch, lambda i: K._launch_l(
        xq, sx, gu["packed"], gu["scales"], i % Lk, xr, gu["L"], gu["Ls"], 4,
        rank, (im, im)), 20)
    dn_ms = _time_ms(torch, lambda i: K._launch_l(
        mq, sm, dn["packed"], dn["scales"], i % Lk, xrd, dn["L"], dn["Ls"],
        4, rank, (h,)), 20)
    gu_st, dn_st = K._mlp_plan(M, h, im, rank, 4)
    grid = K._fused_grid("w4a8_mlp_grid", dev, M, 4)
    plan = (f"{grid} CTAs x {K._MLP_WARPS} warps; gate/up "
            f"{gu_st['groups']} groups of 16 gate + 16 up rows x "
            f"({gu_st['nk']} code + {gu_st['nl']} L slabs), down "
            f"{dn_st['groups']} groups of 32 rows x ({dn_st['nk']} + "
            f"{dn_st['nl']}), {gu_st['mtiles']} tile(s) of {gu_st['MT']} "
            f"rows")
    nbytes = (M * h + M * 4 + M * 2 * rank * 4 + layer_bytes
              + (2 * im + h) * 8 + rank * 4 + 8 + M * h * 4)
    ops = _ops_int8_units(i8=2 * M * 3 * im * h,
                          bf16=2 * M * (2 * im + h) * rank + 2 * M * rank * im)
    bound, by = _bound_ms(nbytes, ops)
    print(f"w4a8_mlp_stacked M={M} h={h} im={im} rank {rank} 4-bit ({plan}):"
          f" rel-Frobenius {rel:.3e} (bound {KERN_REL:g}, max diff "
          f"{err:.3e}), {flips} of {M * im} int8 codes of m differ from the "
          f"plain version's, second launch bit-equal {same}; kernel "
          f"{ms:.4f} ms (cooperative launch), plain {plain_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({by}; {bound / ms:.1%} of bound); unfused "
          f"yardstick (row 6 at M {M}) gate/up {gu_ms:.4f} + down "
          f"{dn_ms:.4f} = {gu_ms + dn_ms:.4f} ms ({ms / (gu_ms + dn_ms):.2f}x"
          f" of it)", flush=True)
    if not (rel <= KERN_REL and _same_argmax(torch, y, parts["out"])
            and same):
        raise AssertionError("w4a8_mlp_stacked disagrees with plain, or a "
                             "second launch with the first")
    record["quantized_matmul_w4a8_mlp_stacked"].update(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=by)
    del gu, dn, scratch, parts, mq, xrd
    torch.cuda.empty_cache()

    # --- D: attention + o_proj, Llama-2-7B heads, batch 8, a 256-token
    # cache at position 128 (the bench flow's step), f32 dots
    B, KVH, D, T, h = 8, 32, 128, 256, 4096
    qdim = KVH * D
    Lk = max(2, math.ceil(200e6 / (B * KVH * T * (2 * D + 8)
                                   + h * qdim // 2 + 2 * h * rank)))
    k, v = (torch.randint(-127, 128, (Lk, B, KVH, T, D), generator=gen,
                          dtype=torch.int8, device=dev) for _ in range(2))
    ks, vs = (torch.rand((Lk, B, KVH, T), generator=gen, device=dev) * 0.02
              for _ in range(2))
    q = torch.randn((B, KVH, 1, D), generator=gen, device=dev)
    kn, vn = (torch.randn((B, KVH, D), generator=gen, device=dev)
              for _ in range(2))
    o = _lowrank_weights(torch, dev, gen, Lk, h, qdim, 1)
    ow = (o["packed"], o["scales"], o["R"], o["Rs"], o["L"], o["Ls"])
    pos = torch.full((B,), 128, dtype=torch.int32, device=dev)
    (o_st,) = AT._attn_o_plan(B, qdim, h, rank, 4)
    for staged in (True, False):
        cache = (q, k, v, ks, vs, kn, vn)
        y = AT.flash_decode_attn_o(*cache, 1, pos, *ow, 4, rank,
                                   staged=staged)
        parts = AT._attn_o_plain_parts(*cache, 1, pos, *ow, 4, rank, staged,
                                       256)
        y2, scratch = AT._launch_attn_o(*cache, 1, pos, *ow, 4, rank, staged,
                                        256)
        torch.cuda.synchronize()
        same = bool(torch.equal(y, y2))
        flips = int((scratch["xq8"] != parts["xq8"]).sum())
        rel = _rel(torch, y, parts["out"])
        err = float((y - parts["out"]).abs().max())
        ms = _time_ms(torch, lambda i: AT._launch_attn_o(
            q, k, v, ks, vs, kn, vn, i % Lk, pos, *ow, 4, rank, staged,
            256), 20)
        plain_ms = _time_ms(torch, lambda i: AT.flash_decode_attn_o_plain(
            q, k, v, ks, vs, kn, vn, i % Lk, pos, *ow, 4, rank, staged),
            2, reps=3)
        # the unfused yardstick, same operands: row 11 (staged) or row 10
        # (inline) with f32 dots, then row 6's o_proj at M B on the plain
        # version's attention, its codes and xro
        entry = ("flash_decode_staged_launch" if staged
                 else "flash_decode_inline_launch")
        attn_ms = _time_ms(torch, lambda i: AT._launch_decode(
            entry, q, k, v, ks, vs, kn if staged else None,
            vn if staged else None, i % Lk, pos, 256, "f32"), 20)
        aq, asx = K.quantize_activations_int8(parts["attn"])
        xro = K.thin_xr(parts["attn"], o["R"][1], o["Rs"][1])
        o_ms = _time_ms(torch, lambda i: K._launch_l(
            aq, asx, o["packed"], o["scales"], i % Lk, xro, o["L"], o["Ls"],
            4, rank, (h,)), 20)
        grid = K._fused_grid("attn_o_grid", dev, B, 4, int(staged))
        plan = (f"{grid} CTAs x {K._ATTN_O_WARPS} warps; o_proj "
                f"{o_st['groups']} groups of 32 rows x ({o_st['nk']} code + "
                f"{o_st['nl']} L slabs), a tile of {o_st['MT']} rows")
        live = B * (128 if staged else 129)
        nbytes = (KVH * live * (2 * D + 8) + B * qdim * 4 + B * 4
                  + (2 * B * qdim * 4 if staged else 0) + h * qdim // 2
                  + h * 4 + rank * qdim + rank * 4 + h * rank + h * 4
                  + B * h * 4)
        ops = _ops_int8_units(i8=2 * B * h * qdim,
                              bf16=2 * B * rank * qdim + 2 * B * h * rank,
                              f32=4 * KVH * live * D)
        bound, by = _bound_ms(nbytes, ops)
        print(f"flash_decode_attn_o {'staged' if staged else 'inline'} B={B}"
              f" KVH={KVH} D={D} T={T} pos 128, o_proj {h} x {qdim} rank "
              f"{rank} 4-bit ({plan}): rel-Frobenius {rel:.3e} (bound "
              f"{KERN_REL:g}, max diff {err:.3e}), {flips} of {B * qdim} int8"
              f" codes of the attention differ from the plain version's, "
              f"second launch bit-equal {same}; kernel {ms:.4f} ms "
              f"(cooperative launch), plain {plain_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({by}; {bound / ms:.1%} of bound); unfused "
              f"yardstick: row {11 if staged else 10} f32 {attn_ms:.4f} + row "
              f"6 o_proj {o_ms:.4f} = {attn_ms + o_ms:.4f} ms "
              f"({ms / (attn_ms + o_ms):.2f}x of it)", flush=True)
        if not (rel <= KERN_REL and _same_argmax(torch, y, parts["out"])
                and same):
            raise AssertionError("flash_decode_attn_o disagrees with plain, "
                                 "or a second launch with the first")
        rec = record["flash_decode_attn_o"]
        rec["max_abs_err"] = max(rec["max_abs_err"] or 0.0, err)
        if staged:
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
    del k, v, ks, vs, o, ow, scratch, parts
    torch.cuda.empty_cache()


def _build_fused(config, dev, seed):
    from ee274_convexcaldera_llm_quantization_tpu_torch import bench_params
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import fused

    params = bench_params.build_compressed_llama_params(
        config, num_bits=4, rank=128, seed=seed, device=dev)
    params = fused.fuse_stacked(params)
    return fused.quantize_factors_int8_fused(params)


def _code_diff(torch, a, b):
    """(differing K/V codes, largest code difference) between two caches."""
    n, worst = 0, 0
    for name in ("k", "v"):
        d = (getattr(a, name).cpu().to(torch.int32)
             - getattr(b, name).cpu().to(torch.int32)).abs()
        n += int((d != 0).sum())
        worst = max(worst, int(d.max()))
    return n, worst


def _kv_rel(torch, a, b, pos):
    """Rel-Frobenius difference of the dequantized K and V (every layer)
    that one step wrote at each row's column ``pos[b]``."""
    rows = torch.arange(pos.shape[0])
    col = pos.long()
    worst = 0.0
    for name in ("k", "v"):
        x, y = (getattr(c, name).cpu()[:, rows, :, col].float()
                * getattr(c, name + "_scale").cpu()[:, rows, :, col][..., None]
                for c in (a, b))
        worst = max(worst, float(torch.linalg.norm(x - y)
                                 / torch.linalg.norm(y)))
    return worst


def _copy_cache(cache, dev):
    """A copy of any of the port's caches or paged pools on ``dev``."""
    return dataclasses.replace(cache, **{
        f.name: getattr(cache, f.name).to(dev, copy=True)
        for f in dataclasses.fields(cache)})


class _PlainKernels:
    """Within this context the port's kernel wrappers are replaced by their
    plain PyTorch versions, so a step on the card runs the same PyTorch glue
    with plain versions in place of the kernels."""

    def __enter__(self):
        from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
            attention as AT, kernels as K, megastep as MS)
        swaps = [(MS, "megastep", MS.megastep_plain),
                 (K, "quantized_matmul_w4a8_stacked",
                  K.quantized_matmul_w4a8_stacked_plain),
                 (K, "quantized_matmul_w4a8_stacked_persistent",
                  K.quantized_matmul_w4a8_stacked_persistent_plain),
                 (K, "bf16_matmul_stacked", K.bf16_matmul_stacked_plain),
                 (K, "quantized_matmul_w4a8_l_stacked",
                  K.quantized_matmul_w4a8_l_stacked_plain),
                 (K, "quantized_matmul_w4a8_lr_stacked",
                  K.quantized_matmul_w4a8_lr_stacked_plain),
                 (K, "quantized_matmul_w4a8_mlp_stacked",
                  K.quantized_matmul_w4a8_mlp_stacked_plain),
                 (AT, "flash_decode_attn_o", AT.flash_decode_attn_o_plain),
                 (K, "quantized_matmul", K.quantized_matmul_plain),
                 (K, "quantized_matmul_w4a8", K.quantized_matmul_w4a8_plain),
                 (K, "int8_matmul", K.int8_matmul_plain),
                 (AT, "flash_decode_q8_staged",
                  AT.flash_decode_q8_staged_plain),
                 (AT, "flash_decode_q8", AT.flash_decode_q8_plain),
                 (AT, "flash_decode_q8_ab", AT.flash_decode_q8_ab_plain),
                 (AT, "flash_decode_q8_paged",
                  AT.flash_decode_q8_paged_plain),
                 (AT, "_flash_decode_q8_paged",
                  AT.flash_decode_q8_paged_plain),
                 (AT, "flash_prefill", AT.flash_prefill_plain)]
        self.saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
        for m, n, plain in swaps:
            setattr(m, n, plain)
        return self

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)
        return False


def _rel(torch, got, ref):
    got, ref = got.cpu(), ref.cpu()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite logits")
    return float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))


def _same_argmax(torch, got, ref):
    return bool(torch.equal(got.cpu().argmax(-1), ref.cpu().argmax(-1)))


# Card step against the CPU step from the same cache. Activations, K/V, q
# and p * v_scale round to int8, so an f32 ulp of the glue (cuBLAS against
# CPU sums) rounds some of the ~10^5 codes of a step the other way, and
# each flip cascades through the later layers. Readings on an H100: 5.5e-4
# to 3.6e-3 over the 40 steps, 1.1e-3 and 1.4e-3 at position 700 (PERF.md).
SYNC_REL = 1e-2
# Kernels against the plain versions on the card, same glue and cache: the
# integer kernels are exact, and an expf ulp of the attention can flip one
# code the same way. Readings: 0 on half the steps, at most 1.7e-3.
KERN_REL = 5e-3


def phase_width(torch, dev):
    """Llama-2-7B width, 2 layers, B = 8, the same weights on the card and
    on the CPU.

    (a) 40 steps from position 0 on seeded prompt tokens. Each step runs
    the plain step on the CPU on its own cache (the reference); the card
    step on its own cache ("free": carries what earlier steps' rounding
    left in the cache); the card step from a copy of the reference's cache
    ("synced": this step's own difference); and the same synced step with
    the plain versions in place of the kernels, on the card (the kernels'
    own share). (b) One step at position 700 of a 1024-token cache (three
    256-token blocks) filled with K/V columns the model wrote in (a),
    drawn with a seed; both sides from the same cache, in lockstep
    ("uniform") and at ragged positions (True), card against CPU and
    kernels against plain versions."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        fused, llama)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
        LLAMA2_7B)

    config = dataclasses.replace(LLAMA2_7B, num_layers=2)
    B, T, steps = 8, 64, 40
    t0 = time.perf_counter()
    cpu_params = _build_fused(config, "cpu", seed=2)
    card_params = _map_tensors(cpu_params, lambda t: t.to(dev))
    gen = torch.Generator().manual_seed(3)
    prompts = torch.randint(0, config.vocab_size, (B, steps), generator=gen)

    def step(params, tok, pos, cache, where, staged_kv="uniform", **kw):
        return fused.decode_step_fused(
            params, tok.to(where), pos.to(where), cache, config,
            staged_kv=staged_kv, attn_dots="i8", **kw)[0]

    cref = llama.HeadMajorQuantKVCache.create(config, B, T, device="cpu")
    cfree = llama.HeadMajorQuantKVCache.create(config, B, T, device=dev)
    worst = dict(sync=0.0, kern=0.0)
    for i in range(steps):
        tok = prompts[:, i]
        pos = torch.full((B,), i, dtype=torch.int32)
        csync = _copy_cache(cref, dev)
        cplain = _copy_cache(cref, dev)
        lsync = step(card_params, tok, pos, csync, dev)
        with _PlainKernels():
            lplain = step(card_params, tok, pos, cplain, dev)
        lfree = step(card_params, tok, pos, cfree, dev)
        lref = step(cpu_params, tok, pos, cref, "cpu")
        e_sync, e_kern = _rel(torch, lsync, lref), _rel(torch, lsync, lplain)
        e_free = _rel(torch, lfree, lref)
        n_free, d_free = _code_diff(torch, cfree, cref)
        n_sync, d_sync = _code_diff(torch, csync, cref)
        kv_sync = _kv_rel(torch, csync, cref, pos)
        print(f"width drift step {i} (pos {i}): logits rel-Frobenius vs "
              f"CPU: synced {e_sync:.3e}, free {e_free:.3e}; kernels vs "
              f"plain on the card {e_kern:.3e}; this step's K/V column vs "
              f"CPU {kv_sync:.3e} rel, {n_sync} codes differ (max "
              f"{d_sync}); the free cache differs from the CPU's in "
              f"{n_free} codes (max {d_free})", flush=True)
        if not (e_sync <= SYNC_REL and _same_argmax(torch, lsync, lref)):
            raise AssertionError(f"step {i}: the synced card step disagrees "
                                 f"with the CPU ({e_sync:.3e} > {SYNC_REL})")
        if not (e_kern <= KERN_REL and _same_argmax(torch, lsync, lplain)):
            raise AssertionError(f"step {i}: the kernels disagree with the "
                                 f"plain versions ({e_kern:.3e} > "
                                 f"{KERN_REL})")
        if not kv_sync <= SYNC_REL:
            raise AssertionError(f"step {i}: the synced card step wrote K/V "
                                 f"{kv_sync:.3e} away from the CPU's")
        worst.update(sync=max(worst["sync"], e_sync, kv_sync),
                     kern=max(worst["kern"], e_kern))
    print(f"width drift: worst synced {worst['sync']:.3e} (bound "
          f"{SYNC_REL:g}), kernels vs plain {worst['kern']:.3e} (bound "
          f"{KERN_REL:g}); free after {steps} steps {e_free:.3e}",
          flush=True)

    # (b) a 1024-token cache holding 700 tokens: K/V columns the model
    # wrote in (a), drawn with a seed
    T, P = 1024, 700
    full = llama.HeadMajorQuantKVCache.create(config, B, T, device="cpu")
    src = torch.randint(0, steps, (P,),
                        generator=torch.Generator().manual_seed(5))
    for name in ("k", "v", "k_scale", "v_scale"):
        getattr(full, name)[:, :, :, :P] = getattr(cref, name)[:, :, :, src]
    tok = prompts[:, 0]
    ragged = [300, 511, 512, 513, 700, 900, 1000, 1023]
    for staged, kernel, pos in (("uniform", "row", [P] * B),
                                (True, "row", ragged),
                                (False, "row", ragged),
                                (True, "ab", ragged),
                                (False, "ab", ragged)):
        pos = torch.tensor(pos, dtype=torch.int32)
        ccard, cplain = _copy_cache(full, dev), _copy_cache(full, dev)
        ccpu = _copy_cache(full, "cpu")
        kw = dict(staged_kv=staged, attn_kernel=kernel)
        lcard = step(card_params, tok, pos, ccard, dev, **kw)
        with _PlainKernels():
            lplain = step(card_params, tok, pos, cplain, dev, **kw)
        lcpu = step(cpu_params, tok, pos, ccpu, "cpu", **kw)
        e, e_kern = _rel(torch, lcard, lcpu), _rel(torch, lcard, lplain)
        kv = _kv_rel(torch, ccard, ccpu, pos)
        n, d = _code_diff(torch, ccard, ccpu)
        print(f"width multi-block step, staged_kv={staged!r}, attn_kernel="
              f"{kernel!r}, T={T}, pos "
              f"{pos.tolist()}: card vs CPU logits rel-Frobenius {e:.3e}, "
              f"K/V column {kv:.3e} (bound {SYNC_REL:g}), {n} K/V codes "
              f"differ (max {d}); kernels vs plain on the card {e_kern:.3e} "
              f"(bound {KERN_REL:g})", flush=True)
        if not (e <= SYNC_REL and kv <= SYNC_REL
                and _same_argmax(torch, lcard, lcpu)):
            raise AssertionError(f"multi-block step {kw}: the card step "
                                 "disagrees with the CPU")
        if not (e_kern <= KERN_REL and _same_argmax(torch, lcard, lplain)):
            raise AssertionError(f"multi-block step {kw}: the kernels "
                                 "disagree with the plain versions")

    # (c) a seeded 300-token prompt prefilled in its 512-token bucket (two
    # 256-token k-blocks of the reference's flash kernel), card against CPU
    # and kernels against plain versions on the card
    n, S = 300, 512
    prompt = torch.zeros((1, S), dtype=torch.int64)
    prompt[0, :n] = torch.randint(0, config.vocab_size, (n,),
                                  generator=torch.Generator().manual_seed(6))
    caches = {}
    for where, params, plain in (("card", card_params, False),
                                 ("plain", card_params, True),
                                 ("cpu", cpu_params, False)):
        d = "cpu" if where == "cpu" else dev
        caches[where] = llama.HeadMajorQuantKVCache.create(config, 1, S,
                                                           device=d)
        ctx = _PlainKernels() if plain else contextlib.nullcontext()
        with ctx:
            logits, _ = fused.prefill_into_slot_fused(
                params, prompt.to(d), 0, caches[where], config,
                last_pos=n - 1, flash=True)
        caches[where + "_logits"] = logits[None]
    lcard, lplain, lcpu = (caches[w + "_logits"]
                           for w in ("card", "plain", "cpu"))
    e, e_kern = _rel(torch, lcard, lcpu), _rel(torch, lcard, lplain)
    nd, dmax = _code_diff(torch, caches["card"], caches["cpu"])
    kv = max(_prefill_kv_rel(torch, caches["card"], caches["cpu"], n),
             _prefill_kv_rel(torch, caches["card"], caches["cpu"], S))
    print(f"width prefill, {n}-token prompt in a {S}-token bucket: card vs "
          f"CPU logits rel-Frobenius {e:.3e}, K/V (prompt and pads) "
          f"{kv:.3e} (bound {SYNC_REL:g}), {nd} of "
          f"{2 * caches['cpu'].k.numel()} K/V codes differ (max {dmax}); "
          f"kernels vs plain on the card {e_kern:.3e} (bound "
          f"{KERN_REL:g})", flush=True)
    if not (e <= SYNC_REL and kv <= SYNC_REL
            and _same_argmax(torch, lcard, lcpu)):
        raise AssertionError("width prefill: the card disagrees with the "
                             "CPU")
    if not (e_kern <= KERN_REL and _same_argmax(torch, lcard, lplain)):
        raise AssertionError("width prefill: the kernels disagree with the "
                             "plain versions")
    print(f"width check: Llama-2-7B width, 2 layers, B={B}: card agrees "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def _prefill_kv_rel(torch, a, b, upto):
    """Rel-Frobenius difference of the dequantized K and V of columns
    ``< upto`` of slot 0 (every layer)."""
    worst = 0.0
    for name in ("k", "v"):
        x, y = (getattr(c, name).cpu()[:, 0, :, :upto].float()
                * getattr(c, name + "_scale").cpu()[:, 0, :, :upto, None]
                for c in (a, b))
        worst = max(worst, float(torch.linalg.norm(x - y)
                                 / torch.linalg.norm(y)))
    return worst


def phase_full(torch, dev, record):
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        fused, llama)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
        LLAMA2_7B)
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        attention as AT, kernels as K)

    config = LLAMA2_7B
    B, T, prompt_len, new_tokens = 8, 256, 12, 20
    t0 = time.perf_counter()
    params = _build_fused(config, dev, seed=0)
    torch.cuda.synchronize()
    print(f"llama2-7b params built on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cache = llama.HeadMajorQuantKVCache.create(config, B, T, device=dev)
    gen = torch.Generator().manual_seed(4)
    prompts = torch.randint(0, config.vocab_size, (B, prompt_len),
                            generator=gen).to(dev)
    counters = (K.quantized_matmul_w4a8_stacked, AT.flash_decode_q8_staged,
                K.int8_matmul)
    per_step = (4 * config.num_layers, config.num_layers, 1)
    for fn in counters:
        fn.launches = 0
    out_tokens = []
    tok = prompts[:, 0]
    for step in range(prompt_len + new_tokens - 1):
        before = [fn.launches for fn in counters]
        pos = torch.full((B,), step, dtype=torch.int32, device=dev)
        logits, cache = fused.decode_step_fused(
            params, tok, pos, cache, config, staged_kv="uniform",
            attn_dots="i8")
        delta = tuple(fn.launches - b for fn, b in zip(counters, before))
        if delta != per_step:
            raise AssertionError(f"step {step}: launches {delta}, expected "
                                 f"{per_step}")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"step {step}: non-finite logits")
        nxt = logits.argmax(-1)
        if step + 1 < prompt_len:
            tok = prompts[:, step + 1]
        else:
            tok = nxt
            out_tokens.append(nxt)
    steps = prompt_len + new_tokens - 1
    for fn, n, name in zip(counters, per_step, (
            "w4a8_stacked", "flash_decode_q8_staged", "int8_matmul")):
        record[name].update(launches=fn.launches, launches_per_step=n,
                            steps=steps)
    gen_tokens = torch.stack(out_tokens, dim=1).cpu()
    for b in range(B):
        print(f"request {b}: prompt {prompts[b].tolist()} -> "
              f"{gen_tokens[b].tolist()}", flush=True)
    print(f"served {B} requests: {steps} steps, launches per step "
          f"w4a8 {per_step[0]}, attention {per_step[1]}, int8 head "
          f"{per_step[2]} (totals {[fn.launches for fn in counters]})",
          flush=True)

    times = []
    for i in range(32 + 3):
        pos = torch.full((B,), 128 + i, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, cache = fused.decode_step_fused(
            params, tok, pos, cache, config, staged_kv="uniform",
            attn_dots="i8")
        tok = logits.argmax(-1)
        torch.cuda.synchronize()
        if i >= 3:
            times.append(1e3 * (time.perf_counter() - t1))
    med = statistics.median(times)
    print(f"bench shape llama2-7b B={B} ctx={T} from pos 128: median "
          f"{med:.3f} ms/step over {len(times)} steps (min {min(times):.3f},"
          f" max {max(times):.3f}); {1e3 * B / med:.1f} tok/s", flush=True)

    # The device's share: the same step (pos 160) captured once in a CUDA
    # graph and replayed, which removes the host's per-operation dispatch.
    pos = torch.full((B,), 160, dtype=torch.int32, device=dev)
    dev_ms = _time_ms(torch, lambda i: fused.decode_step_fused(
        params, tok, pos, cache, config, staged_kv="uniform",
        attn_dots="i8"), 1, reps=9)
    print(f"device time of one step (CUDA graph replay): {dev_ms:.3f} ms; "
          f"the eager step is {med / dev_ms:.1f}x that, so the card is idle "
          f"{1 - dev_ms / med:.1%} of the eager step", flush=True)
    _STEP_MS["phase 4, fused 'xla' step (i8 dots)"] = (med, dev_ms)
    return params


def phase_gqa(torch, dev):
    """Phase 4 (b): the fused W4A8 step at Llama-3-8B widths (GQA: 8 kv
    heads of 4 query heads, 128k vocab; 32 layers, synthetic 4-bit weights
    from ``bench_params``, seed 0), batch 8, a 2048-token cache whose
    positions < 1024 hold seeded K/V codes and scales, from position 1024,
    staged "uniform", dots i8. The first step against the same step through
    the plain versions on the card (from copies of the cache), then 8 steps
    with exact launches per step; the device time of one step as a CUDA
    graph, and of its 32 attention launches (the row kernel on the step's
    own arguments) alone, with the attention's plan."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        fused, llama)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
        LLAMA3_8B)
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        attention as AT, kernels as K)

    t_phase = time.perf_counter()
    config = LLAMA3_8B
    L = config.num_layers
    B, T, P0, steps = 8, 2048, 1024, 8
    params = _build_fused(config, dev, seed=0)
    cache = llama.HeadMajorQuantKVCache.create(config, B, T, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    for name in ("k", "v"):
        t = getattr(cache, name)
        t[:, :, :, :P0] = torch.randint(-127, 128, t[:, :, :, :P0].shape,
                                        generator=gen, dtype=torch.int8,
                                        device=dev)
        sc = getattr(cache, name + "_scale")
        sc[:, :, :, :P0] = torch.rand(sc[:, :, :, :P0].shape, generator=gen,
                                      device=dev) * 0.02 + 1e-3
    tok0 = torch.randint(0, config.vocab_size, (B,), generator=gen,
                         device=dev)
    pos0 = torch.full((B,), P0, dtype=torch.int32, device=dev)
    kw = dict(staged_kv="uniform", attn_dots="i8")
    torch.cuda.synchronize()
    print(f"llama3-8b (GQA {config.num_heads} / {config.num_kv_heads} heads, "
          f"vocab {config.vocab_size}): params and a {T}-token cache filled "
          f"to {P0} on the card in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    counters = (K.quantized_matmul_w4a8_stacked, AT.flash_decode_q8_staged,
                K.int8_matmul)
    per_step = (4 * L, L, 1)
    cplain, crun = (_copy_cache(cache, dev) for _ in range(2))
    del cache
    with _PlainKernels():
        lplain, _ = fused.decode_step_fused(params, tok0, pos0, cplain,
                                            config, **kw)
    del cplain
    times = []
    tok, pos = tok0, pos0
    for i in range(1 + steps):
        before = [c.launches for c in counters]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, _ = fused.decode_step_fused(params, tok, pos, crun, config,
                                            **kw)
        torch.cuda.synchronize()
        if i:
            times.append(1e3 * (time.perf_counter() - t1))
        delta = tuple(c.launches - b for c, b in zip(counters, before))
        if delta != per_step:
            raise AssertionError(f"llama3-8b step {i}: launches {delta}, "
                                 f"expected {per_step}")
        if i == 0:
            e_p = _rel(torch, logits, lplain)
            print(f"llama3-8b first step against the plain versions on the "
                  f"card: logits rel-Frobenius {e_p:.3e} (bound "
                  f"{KERN_REL:g}), argmax equal "
                  f"{_same_argmax(torch, logits, lplain)}", flush=True)
            if not (e_p <= KERN_REL and _same_argmax(torch, logits, lplain)):
                raise AssertionError("llama3-8b: the step disagrees with "
                                     "the plain versions")
        tok = logits.argmax(-1)
        pos = pos + 1
    med = statistics.median(times)
    dev_ms = _time_ms(torch, lambda i: fused.decode_step_fused(
        params, tok, pos, crun, config, **kw), 1, reps=5)
    # the step's attention launches, recorded from one more step and
    # replayed alone on their own arguments
    fn, calls = AT.flash_decode_q8_staged, []

    def record(*a, **k):
        calls.append((a, k))
        return fn(*a, **k)

    record.launches = 0
    AT.flash_decode_q8_staged = record
    try:
        fused.decode_step_fused(params, tok, pos, crun, config, **kw)
    finally:
        AT.flash_decode_q8_staged = fn
    attn_ms = _time_ms(torch, lambda i: [fn(*a, **k) for a, k in calls], 1,
                       reps=5)
    q = calls[0][0][0]
    bt = AT.resolve_block_t(256, T)
    plan = AT._row_decode_plan(B, config.num_kv_heads, q.shape[2],
                               config.head_dim, T, bt,
                               torch.cuda.get_device_properties(
                                   dev).multi_processor_count)
    _STEP_MS["phase 4 (b), llama3-8b fused step at 1024 of 2048"] = (med,
                                                                     dev_ms)
    print(f"llama3-8b B={B} ctx {T} from pos {P0 + 1}: {steps} steps, exact "
          f"launches per step w4a8 {per_step[0]}, attention {per_step[1]}, "
          f"int8 head {per_step[2]}; median {med:.3f} ms/step eager (min "
          f"{min(times):.3f}, max {max(times):.3f}); device time of one "
          f"step as a CUDA graph {dev_ms:.3f} ms (card idle "
          f"{1 - dev_ms / med:.1%} of the eager step), its {len(calls)} "
          f"attention launches alone {attn_ms:.3f} ms "
          f"({attn_ms / len(calls):.4f} a launch; plan {plan})", flush=True)
    del params, crun
    torch.cuda.empty_cache()


class _Watch:
    """While active, every prefill and decode call the engine makes
    (``module.<names[0]>`` / ``module.<names[1]>``; the fused path's by
    default) is checked: the launches of each kernel in the call equal
    ``per_prefill`` / ``per_tick`` exactly, and the logits are finite. Each
    call is timed on the host clock up to a ``torch.cuda.synchronize()``;
    prefill times are kept per bucket, and ``counted`` sums the launches of
    the watched calls. ``first_prefill(prefill, tokens, last_pos, logits)``
    runs once, after the first prefill, and ``first_tick(decode, args,
    kw)`` once, before the first tick, both outside the counts and the
    times, with the unwatched functions. ``busiest`` keeps the arguments of
    the tick whose rows sum to the most positions (:func:`_tick_device_ms`
    replays it)."""

    def __init__(self, torch, counters, per_prefill, per_tick,
                 first_prefill=None, first_tick=None, module=None,
                 names=("prefill_into_slot_fused", "decode_step_fused"),
                 extra=None):
        self.torch, self.counters = torch, counters
        self.per_prefill, self.per_tick = per_prefill, per_tick
        self.first_prefill, self.first_tick = first_prefill, first_tick
        self.module, self.names = module, names
        self.prefill_ms, self.tick_ms = {}, []
        self.busiest, self.busiest_load = None, -1
        self.counted = [0] * len(counters)
        # more prefill-like functions of the module: name -> (launches per
        # call, first(fn, args, kw, logits) run once after the first call)
        self.extra, self.extra_ms = extra or {}, {}

    def _wrap(self, fn, expected, on_done, before_call=None):
        def wrapped(*args, **kw):
            torch = self.torch
            if before_call is not None:
                before_call(args, kw)
            torch.cuda.synchronize()
            before = [c.launches for c in self.counters]
            t0 = time.perf_counter()
            logits, cache = fn(*args, **kw)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            delta = tuple(c.launches - b
                          for c, b in zip(self.counters, before))
            if delta != expected:
                raise AssertionError(f"{fn.__name__}: launches {delta}, "
                                     f"expected {expected}")
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{fn.__name__}: non-finite logits")
            self.counted = [c + d for c, d in zip(self.counted, delta)]
            on_done(ms, args, kw, logits)
            return logits, cache
        return wrapped

    def _tick_done(self, ms, args, kw, logits):
        self.tick_ms.append(ms)
        if not self.torch.is_tensor(args[2]):
            return
        load = int(args[2].sum())          # the rows' positions
        if load > self.busiest_load:
            self.busiest, self.busiest_load = (args, kw), load

    def _tick_check(self, args, kw):
        if self.first_tick is not None:
            first, self.first_tick = self.first_tick, None
            first(self.saved[1], args, kw)

    def _prefill_done(self, ms, args, kw, logits):
        tokens = args[1]
        self.prefill_ms.setdefault(tokens.shape[1], []).append(ms)
        if self.first_prefill is not None:
            first, self.first_prefill = self.first_prefill, None
            first(self.saved[0], tokens, kw.get("last_pos"), logits)

    def __enter__(self):
        if self.module is None:
            from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
                fused)
            self.module = fused
        m, (pre, dec) = self.module, self.names
        self.saved = (getattr(m, pre), getattr(m, dec))
        setattr(m, pre, self._wrap(self.saved[0], self.per_prefill,
                                   self._prefill_done))
        setattr(m, dec, self._wrap(self.saved[1], self.per_tick,
                                   self._tick_done, self._tick_check))
        self.saved_extra = {}
        for name, (expected, first) in self.extra.items():
            fn = self.saved_extra[name] = getattr(m, name)
            setattr(m, name, self._wrap(fn, expected,
                                        self._extra_done(name, fn, first)))
        return self

    def _extra_done(self, name, fn, first):
        pending = [first]

        def done(ms, args, kw, logits):
            self.extra_ms.setdefault(name, {}).setdefault(
                args[1].shape[1], []).append(ms)
            if pending[0] is not None:
                check, pending[0] = pending[0], None
                check(fn, args, kw, logits)
        return done

    def __exit__(self, *exc):
        for name, fn in zip(self.names, self.saved):
            setattr(self.module, name, fn)
        for name, fn in self.saved_extra.items():
            setattr(self.module, name, fn)
        return False


def _tick_device_ms(torch, watch, attn):
    """Device time of the busiest tick ``watch`` saw, its decode call
    captured once in a CUDA graph and replayed (the median of 5); the
    device time of that tick's attention launches alone (``attn``: the
    function of ``ops/attention.py`` the step calls once a layer), recorded
    from one more run of the tick and replayed the same way with the
    tick's own arguments; their number; and the positions of the tick's
    rows. The paged step's page-id check reads the table back to the host,
    which a capture cannot hold: the eager tick checked these tables, and
    the replays skip the check."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        attention as AT)
    args, kw = watch.busiest
    decode = watch.saved[1]
    fn, calls = getattr(AT, attn), []

    def record(*a, **k):
        calls.append((a, k))
        return fn(*a, **k)

    # a wrapper counts its launches on its module name, which is `record`
    # while it records: those launches are not the main path's
    record.launches = 0
    check, AT._check_pages = AT._check_pages, lambda *a: None
    try:
        ms = _time_ms(torch, lambda i: decode(*args, **kw), 1, reps=5)
        setattr(AT, attn, record)
        try:
            decode(*args, **kw)
        finally:
            setattr(AT, attn, fn)
        attn_ms = _time_ms(torch, lambda i: [fn(*a, **k) for a, k in calls],
                           1, reps=5)
    finally:
        AT._check_pages = check
    return ms, attn_ms, len(calls), args[2].tolist()


def _serve(torch, engine, watch, reqs, new_tokens=None, done_out=None):
    """Submit ``reqs`` (each with ``new_tokens`` new tokens, or its own
    ``max_new_tokens``), run the engine to the end under ``watch``, check
    every completion; returns (wall seconds, tokens generated). The
    completions are appended to ``done_out`` when given."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.serve.engine import (
        Request)
    want = {}
    for r in reqs:
        if new_tokens is not None:
            r = dict(r, max_new_tokens=new_tokens)
        want[r["uid"]] = r["max_new_tokens"]
        engine.submit(Request(**r))
    t0 = time.perf_counter()
    with watch:
        done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if sorted(c.uid for c in done) != [r["uid"] for r in reqs]:
        raise AssertionError("not every request completed")
    for c in done:
        if c.finished_reason != "length" or len(c.tokens) != want[c.uid]:
            raise AssertionError(f"request {c.uid}: {c.finished_reason}, "
                                 f"{len(c.tokens)} tokens")
    if done_out is not None:
        done_out.extend(done)
    return wall, sum(len(c.tokens) for c in done)


def phase_serving(torch, dev, params, record):
    """Llama-2-7B, 32 layers, on ``FastServingEngine(flash_attn=True)``:

    (a) the config's max_seq_len 4096 (so decode takes the all-batch
    kernel's partition), 8 slots: 16 seeded requests of 16 to 1500 prompt
    tokens, 32 new tokens each, every fourth at temperature 0.8 with top-k
    50 / top-p 0.9, the rest greedy; the first prefill's logits are held to
    the same prefill with the plain versions on the card;
    (b) the inline path (staged_kv=False) at max_seq_len 512, which decodes
    with the row kernel: 8 requests of 16 to 200 tokens, 8 new tokens.

    Each prefill and decode tick is checked for its exact launches."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama
    from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
        LLAMA2_7B)
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        attention as AT, kernels as K)
    from ee274_convexcaldera_llm_quantization_tpu_torch.serve.fast_engine \
        import FastServingEngine

    config = LLAMA2_7B
    L = config.num_layers
    names = ("w4a8_stacked", "flash_prefill", "flash_decode_q8_ab",
             "flash_decode_q8", "flash_decode_q8_staged", "int8_matmul")
    counters = (K.quantized_matmul_w4a8_stacked, AT.flash_prefill,
                AT.flash_decode_q8_ab, AT.flash_decode_q8,
                AT.flash_decode_q8_staged, K.int8_matmul)
    per_prefill = (4 * L, L, 0, 0, 0, 1)
    gen = torch.Generator().manual_seed(7)

    def requests(n, lo, hi):
        lens = torch.randint(lo, hi + 1, (n,), generator=gen).tolist()
        return [dict(uid=i, prompt=torch.randint(
            0, config.vocab_size, (m,), generator=gen).numpy(),
            **(dict(temperature=0.8, top_k=50, top_p=0.9) if i % 4 == 3
               else {})) for i, m in enumerate(lens)]

    def check_first(prefill, tokens, last_pos, logits):
        cache = llama.HeadMajorQuantKVCache.create(config, 1,
                                                   tokens.shape[1],
                                                   device=dev)
        with _PlainKernels():
            plain, _ = prefill(params, tokens, 0, cache, config,
                               last_pos=last_pos, flash=True)
        e = _rel(torch, logits[None], plain[None])
        print(f"serving: first prefill ({last_pos + 1} tokens, bucket "
              f"{tokens.shape[1]}) kernels vs plain versions on the card: "
              f"logits rel-Frobenius {e:.3e} (bound {KERN_REL:g})",
              flush=True)
        if not (e <= KERN_REL and _same_argmax(torch, logits[None],
                                               plain[None])):
            raise AssertionError("serving: the first prefill's kernels "
                                 "disagree with the plain versions")

    for run, kw, reqs, new_tokens, per_tick in [
            ("a", dict(max_slots=8), requests(16, 16, 1500), 32,
             (4 * L, 0, L, 0, 0, 1)),
            ("b", dict(max_slots=8, max_seq_len=512, staged_kv=False),
             requests(8, 16, 200), 8, (4 * L, 0, 0, L, 0, 1))]:
        engine = FastServingEngine(params, config, flash_attn=True,
                                   device=dev, **kw)
        watch = _Watch(torch, counters, per_prefill, per_tick,
                       check_first if run == "a" else None)
        for c in counters:
            c.launches = 0
        wall, ntok = _serve(torch, engine, watch, reqs, new_tokens)
        totals = dict(zip(names, (c.launches for c in counters)))
        n_pre = sum(len(v) for v in watch.prefill_ms.values())
        n_tick = len(watch.tick_ms)
        print(f"serving ({run}) llama2-7b, {len(reqs)} requests, "
              f"max_seq_len {engine.max_seq_len}, attn_kernel "
              f"{engine._attn_kernel!r}, staged_kv {engine._staged!r}: "
              f"{n_pre} prefills, {n_tick} decode ticks, each with its "
              f"exact launches; totals {totals}", flush=True)
        for bucket, ms in sorted(watch.prefill_ms.items()):
            print(f"  prefill bucket {bucket}: {len(ms)} x, median "
                  f"{statistics.median(ms):.1f} ms "
                  f"({', '.join(f'{m:.1f}' for m in ms)})", flush=True)
        print(f"  decode tick: median {statistics.median(watch.tick_ms):.2f}"
              f" ms (min {min(watch.tick_ms):.2f}, max "
              f"{max(watch.tick_ms):.2f}); {ntok} tokens in {wall:.2f} s "
              f"wall: {ntok / wall:.1f} tokens/s", flush=True)
        dev_ms, attn_ms, n_attn, at = _tick_device_ms(
            torch, watch, "flash_decode_q8_ab" if run == "a"
            else "flash_decode_q8")
        print(f"  device time of the busiest decode tick (positions {at}; "
              f"CUDA graph replay): {dev_ms:.3f} ms; its {n_attn} attention "
              f"launches alone {attn_ms:.3f} ms", flush=True)
        if run == "a":
            for name in ("flash_prefill", "flash_decode_q8_ab"):
                record[name].update(
                    launches=totals[name], launches_per_step=L,
                    steps=n_pre if name == "flash_prefill" else n_tick)
        else:
            record["flash_decode_q8"].update(
                launches=totals["flash_decode_q8"], launches_per_step=L,
                steps=n_tick)
        del engine
        torch.cuda.empty_cache()


def _page_plan(lens, news, slots, num_pages, page):
    """Serve a trace (prompt lengths ``lens``, new tokens ``news``) on the
    native allocator and scheduler alone, in the paged engine's order of
    calls: each tick admits, reserves one position per live request
    (``record_token``) and then retires the finished ones. Returns (ticks
    in which a slot was free but the queue's head waited for pages, peak
    pages in use, whether some page table was not one run of consecutive
    pages), or None when a request can never be admitted or the pool runs
    dry inside a tick (the admission check counts a decode page per request
    but does not hold it back; ROADMAP R8)."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.serve.runtime import (
        NativeScheduler, PageAllocator)
    alloc = PageAllocator(num_pages, page)
    sched = NativeScheduler(slots, alloc)
    for uid, (n, m) in enumerate(zip(lens, news)):
        sched.submit(uid, int(n), int(m))
    made, waits, peak, scattered = {}, 0, 0, False
    while sched.queue_len or sched.active_count:
        admitted = sched.admit()
        if not admitted and not made:
            return None
        for uid, _ in admitted:
            made[uid] = 1
        waits += bool(sched.queue_len and sched.active_count < slots)
        try:
            finished = {uid: sched.record_token(uid) for uid in made}
        except MemoryError:
            return None
        peak = max(peak, num_pages - alloc.free_pages)
        for uid in list(made):
            pages = alloc.page_table(uid)
            scattered |= bool((pages[1:] != pages[:-1] + 1).any())
            made[uid] += 1
            if finished[uid] or made[uid] >= news[uid]:
                sched.finish(uid)
                del made[uid]
    return waits, peak, scattered


def phase_paged(torch, dev, params, record):
    """Paged serving, Llama-2-7B, 32 layers, on the fused W4A8 params with
    int8 factors of phases 4-5:

    (a) identity page tables and 256-token pages (the staged kernel's
    block): eight seeded prompts prefilled into a contiguous cache and into
    a pool, then 4 steps of ``paged_decode_step_fused`` against
    ``decode_step_fused(staged_kv=True)``, dots i8: identical logits and
    K/V codes (the same kernels over the same blocks);
    (b) ``PagedServingEngine(flash_attn=True, max_slots=8, page_size=16)``:
    24 seeded requests (prompts of 64, 128, 192 or 256 tokens, 16-48 new
    tokens, every fourth sampled) over the largest pool below the 8 slots'
    demand on which a dry run of the native scheduler makes admission wait
    for pages and never runs dry; every prefill and tick checked for its
    exact launches, the first prefill and tick against the plain versions;
    (c) the same engine with the prefix cache: 8 requests sharing a
    256-token prefix, then 16-64 tokens of their own; the first suffix
    prefill against the plain versions;
    (d) ``ServingHTTPServer`` over a paged engine on 127.0.0.1: 8 concurrent
    completions (one streamed), ``/health`` and ``/v1/stats``."""
    import threading
    import urllib.request

    import numpy as np

    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        fused, llama)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
        LLAMA2_7B)
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        attention as AT, kernels as K)
    from ee274_convexcaldera_llm_quantization_tpu_torch.serve import paged
    from ee274_convexcaldera_llm_quantization_tpu_torch.serve.http_server \
        import ServingHTTPServer
    from ee274_convexcaldera_llm_quantization_tpu_torch.serve.paged_engine \
        import PagedServingEngine

    config = LLAMA2_7B
    L, KVH, V = config.num_layers, config.num_kv_heads, config.vocab_size
    t_phase = time.perf_counter()

    # (a) the paged step is the staged step
    B, P, n = 8, 256, 2
    rng = np.random.default_rng(71)
    lens = rng.integers(16, 300, B)
    cache = llama.HeadMajorQuantKVCache.create(config, B, n * P, device=dev)
    pool = paged.PagedQuantKVPool.create(config, B * n, P, device=dev)
    tables = torch.arange(B * n, dtype=torch.int32, device=dev).reshape(B, n)
    for b, S in enumerate(lens):
        prompt = torch.from_numpy(rng.integers(0, V, (1, int(S)))).to(dev)
        lc, _ = fused.prefill_into_slot_fused(params, prompt, b, cache,
                                              config, flash=True)
        lp, _ = paged.paged_prefill_fused(params, prompt, pool, tables[b],
                                          config, flash=True)
        if not torch.equal(lc, lp):
            raise AssertionError(f"paged (a): prefill {b} logits differ")
    pos = torch.from_numpy(lens.astype(np.int32)).to(dev)
    tok = torch.from_numpy(rng.integers(0, V, B)).to(dev)
    for step in range(4):
        lc, _ = fused.decode_step_fused(params, tok, pos, cache, config,
                                        staged_kv=True, attn_dots="i8")
        lp, _ = paged.paged_decode_step_fused(params, tok, pos, pool, tables,
                                              config, attn_dots="i8")
        if not torch.equal(lc, lp):
            raise AssertionError(f"paged (a): step {step} logits differ")
        tok, pos = lc.argmax(-1), pos + 1
    for name in ("k", "v", "k_scale", "v_scale"):
        c = getattr(cache, name)                  # (L, B, KVH, n * P[, D])
        pg = getattr(pool, name).reshape(L, B, n, KVH, P, *c.shape[4:])
        if not torch.equal(c, pg.transpose(2, 3).reshape(c.shape)):
            raise AssertionError(f"paged (a): pool {name} differs from the "
                                 "staged cache")
    print(f"paged (a): identity tables, {P}-token pages, B={B}, prompts "
          f"{lens.tolist()} (flash prefill), 4 steps at dots i8: logits and "
          f"K/V codes of paged_decode_step_fused identical to "
          f"decode_step_fused(staged_kv=True)", flush=True)
    del cache, pool
    torch.cuda.empty_cache()

    names = ("w4a8_stacked", "flash_prefill", "flash_decode_q8_paged",
             "flash_decode_q8_staged", "flash_decode_q8_ab",
             "flash_decode_q8", "int8_matmul")
    counters = (K.quantized_matmul_w4a8_stacked, AT.flash_prefill,
                AT.flash_decode_q8_paged, AT.flash_decode_q8_staged,
                AT.flash_decode_q8_ab, AT.flash_decode_q8, K.int8_matmul)
    per_prefill = (4 * L, L, 0, 0, 0, 0, 1)
    per_suffix = (4 * L, 0, 0, 0, 0, 0, 1)
    per_tick = (4 * L, 0, L, 0, 0, 0, 1)
    page = 16

    def check_prefill(prefill, tokens, _, logits):
        S = tokens.shape[1]
        fresh = paged.PagedQuantKVPool.create(config, -(-S // page), page,
                                              device=dev)
        table = torch.arange(fresh.num_pages, dtype=torch.int32, device=dev)
        with _PlainKernels():
            plain, _ = prefill(params, tokens, fresh, table, config,
                               flash=True)
        e = _rel(torch, logits[None], plain[None])
        print(f"paged: first prefill ({S} tokens) kernels vs plain versions "
              f"on the card: logits rel-Frobenius {e:.3e} (bound "
              f"{KERN_REL:g})", flush=True)
        if not (e <= KERN_REL and _same_argmax(torch, logits[None],
                                               plain[None])):
            raise AssertionError("paged: the first prefill's kernels "
                                 "disagree with the plain versions")

    def check_tick(decode, args, kw):
        params_, tokens, pos_, pool_, tables_, cfg = args
        rows = kw["active"].nonzero()[:, 0]
        kern, _ = decode(params_, tokens, pos_, _copy_cache(pool_, dev),
                         tables_, cfg, **kw)
        with _PlainKernels():
            plain, _ = decode(params_, tokens, pos_, _copy_cache(pool_, dev),
                              tables_, cfg, **kw)
        e = _rel(torch, kern[rows], plain[rows])
        print(f"paged: first tick (positions {pos_.tolist()}) kernels vs "
              f"plain versions on the card: logits rel-Frobenius {e:.3e} "
              f"(bound {KERN_REL:g})", flush=True)
        if not (e <= KERN_REL and _same_argmax(torch, kern[rows],
                                               plain[rows])):
            raise AssertionError("paged: the first tick's kernels disagree "
                                 "with the plain versions")

    def check_suffix(prefill, args, kw, logits):
        params_, tokens, cached, pool_, table, cfg = args
        with _PlainKernels():
            plain, _ = prefill(params_, tokens, cached,
                               _copy_cache(pool_, dev), table, cfg)
        e = _rel(torch, logits[None], plain[None])
        print(f"paged (c): first suffix prefill ({tokens.shape[1]} tokens "
              f"after {cached} cached) kernels vs plain versions on the "
              f"card: logits rel-Frobenius {e:.3e} (bound {KERN_REL:g})",
              flush=True)
        if not (e <= KERN_REL and _same_argmax(torch, logits[None],
                                               plain[None])):
            raise AssertionError("paged (c): the first suffix prefill's "
                                 "kernels disagree with the plain versions")

    def report(run, engine, watch, reqs, wall, ntok):
        totals = dict(zip(names, watch.counted))
        n_pre = sum(len(v) for v in watch.prefill_ms.values())
        n_suf = sum(len(v) for d in watch.extra_ms.values()
                    for v in d.values())
        print(f"paged ({run}) llama2-7b, {len(reqs)} requests, page_size "
              f"{engine.page_size}, {engine.allocator.num_pages} pages: "
              f"{n_pre} prefills, {n_suf} suffix prefills, "
              f"{len(watch.tick_ms)} decode ticks, each with its exact "
              f"launches; totals {totals}", flush=True)
        for label, table in (("prefill", watch.prefill_ms),
                             ("suffix prefill", watch.extra_ms.get(
                                 "paged_prefill_suffix_fused", {}))):
            for S, ms in sorted(table.items()):
                print(f"  {label} {S} tokens: {len(ms)} x, median "
                      f"{statistics.median(ms):.1f} ms "
                      f"({', '.join(f'{m:.1f}' for m in ms)})", flush=True)
        print(f"  decode tick: median {statistics.median(watch.tick_ms):.2f}"
              f" ms (min {min(watch.tick_ms):.2f}, max "
              f"{max(watch.tick_ms):.2f}); {ntok} tokens in {wall:.2f} s "
              f"wall: {ntok / wall:.1f} tokens/s", flush=True)
        return totals

    # (b) the paged engine over a pool too small for every request at once
    rng = np.random.default_rng(70)
    lens = rng.choice([64, 128, 192, 256], 24)
    news = rng.integers(16, 49, 24)
    reqs = [dict(uid=i, prompt=rng.integers(0, V, int(m)).astype(np.int32),
                 max_new_tokens=int(news[i]),
                 **(dict(temperature=0.8, top_k=50, top_p=0.9) if i % 4 == 3
                    else {})) for i, m in enumerate(lens)]
    need = sorted(-(-(int(a) + int(b)) // page) for a, b in zip(lens, news))
    for num_pages in range(sum(need[-8:]), need[-1], -1):
        plan = _page_plan(lens, news, 8, num_pages, page)
        if plan is not None and plan[0] > 0:
            break
    else:
        raise AssertionError("paged (b): no pool size makes admission wait")
    waits, plan_peak, scattered = plan
    print(f"paged (b): pool of {num_pages} pages of {page} tokens (the 8 "
          f"largest requests need {sum(need[-8:])}, all 24 {sum(need)}); "
          f"the scheduler's dry run: admission waits for pages in {waits} "
          f"ticks, peak {plan_peak} pages, scattered page tables "
          f"{scattered}", flush=True)
    if not scattered:
        raise AssertionError("paged (b): every page table is contiguous")
    engine = PagedServingEngine(params, config, max_slots=8,
                                num_pages=num_pages, page_size=page,
                                flash_attn=True, device=dev)
    peak = [0]
    step = engine.step

    def counted_step():
        step()
        peak[0] = max(peak[0], num_pages - engine.allocator.free_pages)

    engine.step = counted_step
    watch = _Watch(torch, counters, per_prefill, per_tick, check_prefill,
                   check_tick, module=paged,
                   names=("paged_prefill_fused", "paged_decode_step_fused"))
    for c in counters:
        c.launches = 0
    wall, ntok = _serve(torch, engine, watch, reqs)
    totals = report("b", engine, watch, reqs, wall, ntok)
    dev_ms, attn_ms, n_attn, at = _tick_device_ms(torch, watch,
                                                  "_flash_decode_q8_paged")
    print(f"  device time of the busiest decode tick (positions {at}; CUDA "
          f"graph replay without the page-id check): {dev_ms:.3f} ms; its "
          f"{n_attn} attention launches alone {attn_ms:.3f} ms", flush=True)
    print(f"  peak pages in use {peak[0]} of {num_pages} (dry run "
          f"{plan_peak}); all returned: {engine.allocator.free_pages}",
          flush=True)
    if peak[0] != plan_peak or engine.allocator.free_pages != num_pages:
        raise AssertionError("paged (b): the engine's page use differs "
                             "from the scheduler's dry run")
    record["flash_decode_q8_paged"].update(
        launches=totals["flash_decode_q8_paged"], launches_per_step=L,
        steps=len(watch.tick_ms))
    del engine
    torch.cuda.empty_cache()

    # (c) the prefix cache: 8 requests sharing a 256-token prefix
    rng = np.random.default_rng(72)
    prefix = rng.integers(0, V, 256)
    reqs = [dict(uid=i, prompt=np.concatenate(
        [prefix, rng.integers(0, V, int(rng.integers(16, 65)))]).astype(
            np.int32), max_new_tokens=16) for i in range(8)]
    engine = PagedServingEngine(params, config, max_slots=8, page_size=page,
                                flash_attn=True, prefix_cache=True,
                                device=dev)
    watch = _Watch(torch, counters, per_prefill, per_tick, module=paged,
                   names=("paged_prefill_fused", "paged_decode_step_fused"),
                   extra={"paged_prefill_suffix_fused": (per_suffix,
                                                         check_suffix)})
    wall, ntok = _serve(torch, engine, watch, reqs)
    report("c", engine, watch, reqs, wall, ntok)
    hits, lookups = engine.allocator.cache_stats
    cold = statistics.median(v for d in watch.prefill_ms.values() for v in d)
    warm = statistics.median(v for d in watch.extra_ms[
        "paged_prefill_suffix_fused"].values() for v in d)
    print(f"  cache_stats: {hits} of {lookups} prompt tokens served from the "
          f"prefix cache; suffix prefill median {warm:.1f} ms against the "
          f"cold prefill's {cold:.1f} ms", flush=True)
    if hits != 7 * 256:
        raise AssertionError(f"paged (c): {hits} cached tokens, expected "
                             f"{7 * 256}")
    del engine
    torch.cuda.empty_cache()

    # (d) the HTTP front end over a paged engine
    engine = PagedServingEngine(params, config, max_slots=8, page_size=page,
                                flash_attn=True, device=dev)
    streamed_len = 100
    final = {}
    finish = engine._finish

    def keep(uid, reason):
        finish(uid, reason)
        final[engine.completions[-1].prompt_len] = engine.completions[-1]

    engine._finish = keep
    srv = ServingHTTPServer(engine, port=0, request_timeout_s=300).start()
    base = f"http://{srv.host}:{srv.port}"
    rng = np.random.default_rng(73)
    bodies = [dict(prompt=rng.integers(0, V, 64 + i).tolist(),
                   max_tokens=8 + 2 * i) for i in range(7)]
    bodies.append(dict(prompt=rng.integers(0, V, streamed_len).tolist(),
                       max_tokens=12, stream=True))
    answers, errors = {}, []

    def client(i):
        req = urllib.request.Request(
            base + "/v1/completions", data=json.dumps(bodies[i]).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                if not bodies[i].get("stream"):
                    answers[i] = json.loads(r.read())
                    return
                chunks = []
                for raw in r:
                    line = raw.decode().strip()
                    if line == "data: [DONE]":
                        break
                    if line.startswith("data: "):
                        chunks.append(json.loads(line[len("data: "):]))
                answers[i] = chunks
        except Exception as e:        # reported and raised below
            errors.append(f"request {i}: {e!r}")

    t1 = time.perf_counter()
    try:
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        with urllib.request.urlopen(base + "/v1/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        srv.stop()
    wall = time.perf_counter() - t1
    if errors or srv.runner.error is not None:
        raise AssertionError(f"paged (d): {errors} {srv.runner.error!r}")
    if health != {"status": "ok"}:
        raise AssertionError(f"paged (d): /health answered {health}")
    for i, body in enumerate(bodies[:-1]):
        a = answers[i]
        if a["finished_reason"] != "length" or len(a["tokens"]) != \
                body["max_tokens"]:
            raise AssertionError(f"paged (d): request {i} answered {a}")
    chunks = answers[len(bodies) - 1]
    streamed = [t for c in chunks for t in c.get("tokens", [])]
    if (chunks[-1].get("finished_reason") != "length"
            or streamed != final[streamed_len].tokens
            or len(streamed) != bodies[-1]["max_tokens"]):
        raise AssertionError(f"paged (d): the stream {chunks} does not "
                             "concatenate to the completion's tokens")
    print(f"paged (d): ServingHTTPServer on 127.0.0.1, {len(bodies)} "
          f"concurrent completions ({len(chunks) - 1} streamed chunks "
          f"concatenating to the final {len(streamed)} tokens), each with its "
          f"max_tokens, in {wall:.2f} s; /health {health}; /v1/stats "
          f"{stats}", flush=True)
    del engine, srv
    torch.cuda.empty_cache()
    print(f"paged phase: {time.perf_counter() - t_phase:.1f} s", flush=True)

def phase_proj_dots(torch, dev, params, record):
    """Phase 9, on phase 4's Llama-2-7B params (32 layers, factor path
    "xla"), batch 8, context 256, from position 128: eight seeded 128-token
    prompts prefilled with flash prefill, then, from copies of that cache,
    (a) ``decode_step_fused(proj_kernel="persistent")`` at dots i8, staged
    "uniform": logits and K/V codes identical to the grid step's, exactly 64
    persistent and 64 kernel-1 launches per step, eager ms/step and the
    device time of one step as a CUDA graph beside the grid step's; (b)
    ``attn_dots="bf16"`` staged "uniform", inline and all-batch: the first
    step within ``KERN_REL`` of the f32 step and of the plain versions,
    argmax equal, then the same timings; (c) ``paged_decode_step_fused(
    attn_dots="bf16")`` over a pool holding the same cache (identity tables,
    256-token pages) against the staged bf16 step: identical logits and
    pool; (d) ``FastServingEngine(flash_attn=True, max_slots=8,
    max_seq_len=2000)``, whose "auto" decode takes the all-batch kernel on
    one 2000-token block: 8 seeded requests of 16-1500 prompt tokens, 16
    new tokens each, every prefill and tick with its exact launches, the
    first tick against the plain versions, tokens/s."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        fused, llama)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
        LLAMA2_7B)
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        attention as AT, kernels as K)
    from ee274_convexcaldera_llm_quantization_tpu_torch.serve import paged
    from ee274_convexcaldera_llm_quantization_tpu_torch.serve.fast_engine \
        import FastServingEngine

    t_phase = time.perf_counter()
    config = LLAMA2_7B
    L = config.num_layers
    B, T, P0, steps = 8, 256, 128, 8
    cache = llama.HeadMajorQuantKVCache.create(config, B, T, device=dev)
    gen = torch.Generator().manual_seed(13)
    prompts = torch.randint(0, config.vocab_size, (B, P0), generator=gen)
    first = []
    for b in range(B):
        logits, _ = fused.prefill_into_slot_fused(
            params, prompts[b:b + 1].to(dev), b, cache, config, flash=True)
        first.append(logits.argmax())
    tok0 = torch.stack(first)
    pos0 = torch.full((B,), P0, dtype=torch.int32, device=dev)

    # (a) the persistent launch gives the grid step's bits
    cg, cp = _copy_cache(cache, dev), _copy_cache(cache, dev)
    lg, _ = fused.decode_step_fused(params, tok0, pos0, cg, config,
                                    staged_kv="uniform", attn_dots="i8")
    lp, _ = fused.decode_step_fused(params, tok0, pos0, cp, config,
                                    staged_kv="uniform", attn_dots="i8",
                                    proj_kernel="persistent")
    if not (torch.equal(lg, lp) and all(
            torch.equal(getattr(cg, f), getattr(cp, f))
            for f in ("k", "v", "k_scale", "v_scale"))):
        raise AssertionError("proj (a): the persistent step is not the grid "
                             "step bit for bit")
    print("proj (a): proj_kernel='persistent' step from the cache at "
          f"position {P0}: logits and K/V codes identical to the grid "
          "step's", flush=True)
    del cg, cp

    names = ("w4a8_stacked", "persistent", "staged", "inline", "ab",
             "int8_matmul")
    counters = (K.quantized_matmul_w4a8_stacked,
                K.quantized_matmul_w4a8_stacked_persistent,
                AT.flash_decode_q8_staged, AT.flash_decode_q8,
                AT.flash_decode_q8_ab, K.int8_matmul)
    runs = [("a persistent", dict(staged_kv="uniform", attn_dots="i8",
                                  proj_kernel="persistent"),
             (2 * L, 2 * L, L, 0, 0, 1)),
            ("a grid", dict(staged_kv="uniform", attn_dots="i8"),
             (4 * L, 0, L, 0, 0, 1)),
            ("b staged bf16", dict(staged_kv="uniform", attn_dots="bf16"),
             (4 * L, 0, L, 0, 0, 1)),
            ("b inline bf16", dict(staged_kv=False, attn_dots="bf16"),
             (4 * L, 0, 0, L, 0, 1)),
            ("b ab bf16", dict(staged_kv=True, attn_kernel="ab",
                               attn_dots="bf16"),
             (4 * L, 0, 0, 0, L, 1))]
    counts, step_ms = {}, {}
    for run, kw, per_step in runs:
        if kw["attn_dots"] == "bf16":
            f32_kw = dict(kw, attn_dots="f32")
            lf, _ = fused.decode_step_fused(params, tok0, pos0,
                                            _copy_cache(cache, dev), config,
                                            **f32_kw)
            lb, _ = fused.decode_step_fused(params, tok0, pos0,
                                            _copy_cache(cache, dev), config,
                                            **kw)
            with _PlainKernels():
                lpl, _ = fused.decode_step_fused(
                    params, tok0, pos0, _copy_cache(cache, dev), config, **kw)
            e_f, e_p = _rel(torch, lb, lf), _rel(torch, lb, lpl)
            print(f"proj ({run}) {kw}: first step against the f32 step "
                  f"{e_f:.3e}, against the plain versions {e_p:.3e} (logits "
                  f"rel-Frobenius, bound {KERN_REL:g})", flush=True)
            if not (e_f <= KERN_REL and e_p <= KERN_REL
                    and _same_argmax(torch, lb, lf)
                    and _same_argmax(torch, lb, lpl)):
                raise AssertionError(f"proj ({run}): the step disagrees")
        crun = _copy_cache(cache, dev)
        for c in counters:
            c.launches = 0
        times = []
        tok, pos = tok0, pos0
        for i in range(1 + steps):
            before = [c.launches for c in counters]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, _ = fused.decode_step_fused(params, tok, pos, crun,
                                                config, **kw)
            torch.cuda.synchronize()
            if i:
                times.append(1e3 * (time.perf_counter() - t1))
            delta = tuple(c.launches - b for c, b in zip(counters, before))
            if delta != per_step:
                raise AssertionError(f"proj ({run}) step {i}: launches "
                                     f"{dict(zip(names, delta))}, expected "
                                     f"{dict(zip(names, per_step))}")
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"proj ({run}): non-finite logits")
            tok = logits.argmax(-1)
            pos = pos + 1
        counts[run] = dict(zip(names, (c.launches for c in counters)))
        med = statistics.median(times)
        dev_ms = _time_ms(torch, lambda i: fused.decode_step_fused(
            params, tok, pos, crun, config, **kw), 1, reps=5)
        step_ms[run] = dev_ms
        print(f"proj ({run}): {steps} steps from position {P0 + 1}, exact "
              f"launches per step {dict(zip(names, per_step))}; median "
              f"{med:.3f} ms/step eager (min {min(times):.3f}, max "
              f"{max(times):.3f}), {1e3 * B / med:.1f} tok/s; device time of "
              f"one step as a CUDA graph {dev_ms:.3f} ms (card idle "
              f"{1 - dev_ms / med:.1%} of the eager step)", flush=True)
        del crun
    print(f"proj (a): device time of one step as a CUDA graph, "
          f"proj_kernel='persistent' {step_ms['a persistent']:.3f} ms, the "
          f"grid step {step_ms['a grid']:.3f} ms (persistent - grid "
          f"{step_ms['a persistent'] - step_ms['a grid']:+.3f} ms over "
          f"{2 * L} launches of each)", flush=True)
    record["quantized_matmul_w4a8_stacked_persistent"].update(
        launches=counts["a persistent"]["persistent"],
        launches_per_step=2 * L, steps=1 + steps)

    # (c) the paged bf16 step is the staged bf16 step: one 256-token page
    # per row holding the same cache
    pool = paged.PagedQuantKVPool.create(config, B, T, device=dev)
    cstaged = _copy_cache(cache, dev)
    for f in ("k", "v", "k_scale", "v_scale"):
        getattr(pool, f).copy_(getattr(cache, f))
    tables = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    tok, pos = tok0, pos0
    for step in range(4):
        lc, _ = fused.decode_step_fused(params, tok, pos, cstaged, config,
                                        staged_kv=True, attn_dots="bf16")
        lpg, _ = paged.paged_decode_step_fused(params, tok, pos, pool,
                                               tables, config,
                                               attn_dots="bf16")
        if not torch.equal(lc, lpg):
            raise AssertionError(f"proj (c): step {step} logits differ")
        tok, pos = lc.argmax(-1), pos + 1
    if not all(torch.equal(getattr(pool, f), getattr(cstaged, f))
               for f in ("k", "v", "k_scale", "v_scale")):
        raise AssertionError("proj (c): the pool differs from the cache")
    print("proj (c): paged_decode_step_fused(attn_dots='bf16'), identity "
          "tables, 256-token pages: 4 steps with logits and K/V codes "
          "identical to decode_step_fused(staged_kv=True, attn_dots='bf16')",
          flush=True)
    del pool, cstaged, cache
    torch.cuda.empty_cache()

    # (d) serving at max_seq_len 2000: one 2000-token all-batch block
    counters = (K.quantized_matmul_w4a8_stacked, AT.flash_prefill,
                AT.flash_decode_q8_ab, K.int8_matmul)
    names = ("w4a8_stacked", "flash_prefill", "flash_decode_q8_ab",
             "int8_matmul")
    per_prefill = (4 * L, L, 0, 1)
    per_tick = (4 * L, 0, L, 1)

    def check_tick(decode, args, kw):
        params_, tokens, pos_, cache_, cfg = args
        kern, _ = decode(params_, tokens, pos_, _copy_cache(cache_, dev), cfg,
                         **kw)
        with _PlainKernels():
            plain, _ = decode(params_, tokens, pos_,
                              _copy_cache(cache_, dev), cfg, **kw)
        e = _rel(torch, kern, plain)
        print(f"proj (d): first tick (positions {pos_.tolist()}) kernels vs "
              f"plain versions on the card: {e:.3e} (bound {KERN_REL:g})",
              flush=True)
        if not (e <= KERN_REL and _same_argmax(torch, kern, plain)):
            raise AssertionError("proj (d): the first tick disagrees with "
                                 "the plain versions")

    gen = torch.Generator().manual_seed(14)
    lens = torch.randint(16, 1501, (8,), generator=gen).tolist()
    reqs = [dict(uid=i, prompt=torch.randint(0, config.vocab_size, (n,),
                                             generator=gen).numpy(),
                 max_new_tokens=16) for i, n in enumerate(lens)]
    engine = FastServingEngine(params, config, flash_attn=True, max_slots=8,
                               max_seq_len=2000, device=dev)
    bt = AT._ab_blocks(8, config.num_kv_heads, config.head_dim, 2000, 64)[1]
    if engine._attn_kernel != "ab" or bt != 2000:
        raise AssertionError(f"proj (d): expected the all-batch kernel on "
                             f"one 2000-token block, got "
                             f"{engine._attn_kernel!r}, block {bt}")
    watch = _Watch(torch, counters, per_prefill, per_tick, None, check_tick)
    wall, ntok = _serve(torch, engine, watch, reqs)
    print(f"proj (d) FastServingEngine(max_seq_len=2000), decode on one "
          f"{bt}-token all-batch block, 8 requests of {min(lens)}-"
          f"{max(lens)} prompt tokens: "
          f"{sum(len(v) for v in watch.prefill_ms.values())} prefills and "
          f"{len(watch.tick_ms)} ticks with their exact launches (totals "
          f"{dict(zip(names, watch.counted))}); decode tick median "
          f"{statistics.median(watch.tick_ms):.2f} ms; {ntok} tokens in "
          f"{wall:.2f} s: {ntok / wall:.1f} tokens/s", flush=True)
    del engine
    torch.cuda.empty_cache()
    print(f"proj phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


def phase_options(torch, dev, record):
    """The fused step's options, Llama-2-7B, 32 layers, batch 8, context
    256, from position 128 (phase 8). One bf16 fused param set (seed 0, rank
    128) is int8-quantized three ways: factor paths "xla", "l" and "lr"
    (same weights); "l" and "lr" must have built ``L_cat``. Eight seeded
    128-token prompts are prefilled on "xla"; then, from that cache, (a)
    "l" and (b) "lr" at dots i8 with the staged "uniform" commit, and (c)
    "l" with ``mlp_kernel`` and ``attn_o_kernel`` at dots f32, staged True
    and inline. The first step of each is held to the "xla" step with the
    same staging and dots, and to itself on the plain versions, from copies
    of the same cache (``KERN_REL`` and argmax); then 8 eager steps with
    exact launches per step, their median ms, and the device time of one
    step replayed as a CUDA graph. (d) ``FastServingEngine(flash_attn=True,
    max_slots=8, mlp_kernel=True, max_seq_len=512)`` on "l": 8 seeded
    requests of 16-256 prompt tokens, 16 new tokens each, every prefill and
    tick with its exact launches, the first prefill and tick against the
    plain versions, prefill ms per bucket. (e) :func:`_prefill_2048`: the
    "l" and "lr" prefills of a 2048-token prompt."""
    from ee274_convexcaldera_llm_quantization_tpu_torch import bench_params
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        fused, llama)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
        LLAMA2_7B)
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        attention as AT, kernels as K)
    from ee274_convexcaldera_llm_quantization_tpu_torch.serve.fast_engine \
        import FastServingEngine

    t_phase = time.perf_counter()
    config = LLAMA2_7B
    L = config.num_layers
    B, T, P0, steps = 8, 256, 128, 8
    base = fused.fuse_stacked(bench_params.build_compressed_llama_params(
        config, num_bits=4, rank=128, seed=0, device=dev))
    sets = {fk: fused.quantize_factors_int8_fused(base, fuse_factor_kernel=fk)
            for fk in ("xla", "l", "lr")}
    del base
    for fk in ("l", "lr"):
        for name in ("qkv", "gateup"):
            g = getattr(sets[fk].layers, name)
            if g.L_cat is None or g.factor_kernel != fk:
                raise AssertionError(f"factor path {fk!r}: {name} did not "
                                     "build L_cat")
    torch.cuda.synchronize()
    print(f"options: xla / l / lr params quantized from one bf16 set, L_cat "
          f"built ({time.perf_counter() - t_phase:.1f} s)", flush=True)

    cache = llama.HeadMajorQuantKVCache.create(config, B, T, device=dev)
    gen = torch.Generator().manual_seed(11)
    prompts = torch.randint(0, config.vocab_size, (B, P0), generator=gen)
    first = []
    for b in range(B):
        logits, _ = fused.prefill_into_slot_fused(
            sets["xla"], prompts[b:b + 1].to(dev), b, cache, config,
            flash=True)
        first.append(logits.argmax())
    tok0 = torch.stack(first)
    pos0 = torch.full((B,), P0, dtype=torch.int32, device=dev)

    names = ("l", "lr", "mlp", "attn_o", "w4a8_stacked", "staged", "inline",
             "int8_matmul")
    counters = (K.quantized_matmul_w4a8_l_stacked,
                K.quantized_matmul_w4a8_lr_stacked,
                K.quantized_matmul_w4a8_mlp_stacked, AT.flash_decode_attn_o,
                K.quantized_matmul_w4a8_stacked, AT.flash_decode_q8_staged,
                AT.flash_decode_q8, K.int8_matmul)
    mega = (L, 0, L, L, 0, 0, 0, 1)
    runs = [("a", "l", dict(staged_kv="uniform", attn_dots="i8"),
             (4 * L, 0, 0, 0, 0, L, 0, 1)),
            ("b", "lr", dict(staged_kv="uniform", attn_dots="i8"),
             (0, 2 * L, 0, 0, 2 * L, L, 0, 1)),
            ("c staged", "l", dict(staged_kv=True, attn_dots="f32",
                                   mlp_kernel=True, attn_o_kernel=True),
             mega),
            ("c inline", "l", dict(staged_kv=False, attn_dots="f32",
                                   mlp_kernel=True, attn_o_kernel=True),
             mega)]
    counts, step_dev = {}, {}
    for run, fk, kw, per_step in runs:
        params = sets[fk]
        ref_kw = dict(staged_kv=kw["staged_kv"], attn_dots=kw["attn_dots"])
        cx, cplain, crun = (_copy_cache(cache, dev) for _ in range(3))
        lx, _ = fused.decode_step_fused(sets["xla"], tok0, pos0, cx, config,
                                        **ref_kw)
        with _PlainKernels():
            lplain, _ = fused.decode_step_fused(params, tok0, pos0, cplain,
                                                config, **kw)
        for c in counters:
            c.launches = 0
        times = []
        tok, pos = tok0, pos0
        for i in range(1 + steps):
            before = [c.launches for c in counters]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, _ = fused.decode_step_fused(params, tok, pos, crun,
                                                config, **kw)
            torch.cuda.synchronize()
            if i:
                times.append(1e3 * (time.perf_counter() - t1))
            delta = tuple(c.launches - b for c, b in zip(counters, before))
            if delta != per_step:
                raise AssertionError(f"options ({run}) step {i}: launches "
                                     f"{dict(zip(names, delta))}, expected "
                                     f"{dict(zip(names, per_step))}")
            if i == 0:
                e_x, e_p = _rel(torch, logits, lx), _rel(torch, logits,
                                                         lplain)
                print(f"options ({run}) factor path {fk!r} {kw}: first step "
                      f"against the 'xla' step {e_x:.3e}, against the plain"
                      f" versions {e_p:.3e} (logits rel-Frobenius, bound "
                      f"{KERN_REL:g})", flush=True)
                if not (e_x <= KERN_REL and e_p <= KERN_REL
                        and _same_argmax(torch, logits, lx)
                        and _same_argmax(torch, logits, lplain)):
                    raise AssertionError(f"options ({run}): the step "
                                         "disagrees")
            tok = logits.argmax(-1)
            pos = pos + 1
        counts[run] = dict(zip(names, (c.launches for c in counters)))
        med = statistics.median(times)
        dev_ms = _time_ms(torch, lambda i: fused.decode_step_fused(
            params, tok, pos, crun, config, **kw), 1, reps=5)
        _STEP_MS[f"phase 8 ({run}), fused {fk!r} step {kw}"] = (med, dev_ms)
        step_dev[run] = dev_ms
        beside = (f"; the 'l' step (a) {step_dev['a']:.3f} ms, "
                  f"{dev_ms / step_dev['a']:.3f}x of it"
                  if run.startswith("c") else "")
        print(f"options ({run}): {steps} steps from position {P0 + 1}, exact "
              f"launches per step {dict(zip(names, per_step))}; median "
              f"{med:.3f} ms/step eager (min {min(times):.3f}, max "
              f"{max(times):.3f}), {1e3 * B / med:.1f} tok/s; device time of "
              f"one step as a CUDA graph {dev_ms:.3f} ms (card idle "
              f"{1 - dev_ms / med:.1%} of the eager step){beside}",
              flush=True)
        del cx, cplain, crun
    # each kernel's main path: A on (a), B on (b), C and D on both (c)
    n = 1 + steps
    record["quantized_matmul_w4a8_l_stacked"].update(
        launches=counts["a"]["l"], launches_per_step=4 * L, steps=n)
    record["quantized_matmul_w4a8_lr_stacked"].update(
        launches=counts["b"]["lr"], launches_per_step=2 * L, steps=n)
    for rec_name, name in (("quantized_matmul_w4a8_mlp_stacked", "mlp"),
                           ("flash_decode_attn_o", "attn_o")):
        record[rec_name].update(
            launches=counts["c staged"][name] + counts["c inline"][name],
            launches_per_step=L, steps=2 * n)
    phase_mega(torch, dev, record, sets["l"], cache, tok0, pos0)
    del cache
    torch.cuda.empty_cache()

    # (d) the engine on "l" with the whole-MLP kernel
    params, xla, lr = sets["l"], sets["xla"], sets["lr"]
    del sets
    counters = (K.quantized_matmul_w4a8_l_stacked,
                K.quantized_matmul_w4a8_mlp_stacked,
                K.quantized_matmul_w4a8_stacked, AT.flash_prefill,
                AT.flash_decode_q8_staged, K.int8_matmul)
    per_prefill = (4 * L, 0, 0, L, 0, 1)
    per_tick = (2 * L, L, 0, 0, L, 1)

    def check_first(prefill, tokens, last_pos, logits):
        c = llama.HeadMajorQuantKVCache.create(config, 1, tokens.shape[1],
                                               device=dev)
        with _PlainKernels():
            plain, _ = prefill(params, tokens, 0, c, config,
                               last_pos=last_pos, flash=True)
        e = _rel(torch, logits[None], plain[None])
        print(f"options (d): first prefill ({last_pos + 1} tokens) kernels "
              f"vs plain versions on the card: {e:.3e} (bound "
              f"{KERN_REL:g})", flush=True)
        if not (e <= KERN_REL and _same_argmax(torch, logits[None],
                                               plain[None])):
            raise AssertionError("options (d): the first prefill disagrees "
                                 "with the plain versions")

    def check_tick(decode, args, kw):
        params_, tokens, pos_, cache_, cfg = args
        kern, _ = decode(params_, tokens, pos_, _copy_cache(cache_, dev), cfg,
                         **kw)
        with _PlainKernels():
            plain, _ = decode(params_, tokens, pos_,
                              _copy_cache(cache_, dev), cfg, **kw)
        e = _rel(torch, kern, plain)
        print(f"options (d): first tick (positions {pos_.tolist()}) kernels "
              f"vs plain versions on the card: {e:.3e} (bound "
              f"{KERN_REL:g})", flush=True)
        if not (e <= KERN_REL and _same_argmax(torch, kern, plain)):
            raise AssertionError("options (d): the first tick disagrees "
                                 "with the plain versions")

    gen = torch.Generator().manual_seed(12)
    lens = torch.randint(16, 257, (8,), generator=gen).tolist()
    reqs = [dict(uid=i, prompt=torch.randint(0, config.vocab_size, (n,),
                                             generator=gen).numpy(),
                 max_new_tokens=16) for i, n in enumerate(lens)]
    engine = FastServingEngine(params, config, flash_attn=True, max_slots=8,
                               mlp_kernel=True, max_seq_len=512, device=dev)
    watch = _Watch(torch, counters, per_prefill, per_tick, check_first,
                   check_tick)
    wall, ntok = _serve(torch, engine, watch, reqs)
    print(f"options (d) FastServingEngine(mlp_kernel=True) on 'l', 8 "
          f"requests of {min(lens)}-{max(lens)} prompt tokens: "
          f"{sum(len(v) for v in watch.prefill_ms.values())} prefills and "
          f"{len(watch.tick_ms)} ticks with their exact launches (totals "
          f"{watch.counted}); decode tick median "
          f"{statistics.median(watch.tick_ms):.2f} ms; {ntok} tokens in "
          f"{wall:.2f} s: {ntok / wall:.1f} tokens/s", flush=True)
    for bucket, ms in sorted(watch.prefill_ms.items()):
        print(f"  options (d) prefill bucket {bucket}: {len(ms)} x, median "
              f"{statistics.median(ms):.1f} ms "
              f"({', '.join(f'{m:.1f}' for m in ms)})", flush=True)
    del engine
    torch.cuda.empty_cache()
    _prefill_2048(torch, dev, config, params, xla, lr)
    del params, xla, lr
    print(f"options phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


def _prefill_2048(torch, dev, config, params, xla, lr):
    """Phase 8 (e): factor paths "l" and "lr" prefill one seeded 2048-token
    prompt (``prefill_into_slot_fused``, flash prefill): "l" with each
    projection on the L-fused kernel's tile path (4L launches), "lr" with
    qkv and gate/up on the LR-fused kernel's tile path (2L launches: the
    tensor-core xr kernel, then the L-fused tile kernel) and o and down on
    the W4A8 kernel (2L), each with L flash prefill launches and the int8
    head, exactly; the logits of each held to the same prefill through the
    plain versions on the card and to the "xla" prefill of the prompt
    (``KERN_REL`` and argmax); host ms of two runs each, to a
    synchronize."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        fused, llama)
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        attention as AT, kernels as K)

    S, L = 2048, config.num_layers
    gen = torch.Generator().manual_seed(14)
    tokens = torch.randint(0, config.vocab_size, (1, S), generator=gen).to(dev)
    counters = (K.quantized_matmul_w4a8_l_stacked,
                K.quantized_matmul_w4a8_lr_stacked, AT.flash_prefill,
                K.int8_matmul, K.quantized_matmul_w4a8_stacked)
    names = ("l", "lr", "flash_prefill", "int8_matmul", "w4a8_stacked")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for g in (lr.layers.qkv, lr.layers.gateup):
        N, Kd = g.packed.shape[1], g.packed.shape[2] * (8 // g.num_bits)
        plan = K._w4a8_lr_plan(S, N, Kd, g.num_bits, g.ranks[0], g.splits,
                               sms)
        if plan["path"] != "tile":
            raise AssertionError(f"options (e): the LR-fused plan at M {S} "
                                 f"is {plan['path']!r}, not the tile path")
    runs = {"l": (params, (4 * L, 0, L, 1, 0)),
            "lr": (lr, (0, 2 * L, L, 1, 2 * L)),
            "xla": (xla, (0, 0, L, 1, 4 * L))}
    out, ms = {}, {}
    for fk, (p, expected) in runs.items():
        cache = llama.HeadMajorQuantKVCache.create(config, 1, S, device=dev)
        ms[fk] = []
        for _ in range(2):
            before = [c.launches for c in counters]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = fused.prefill_into_slot_fused(p, tokens, 0, cache,
                                                      config, flash=True)
            torch.cuda.synchronize()
            ms[fk].append(1e3 * (time.perf_counter() - t0))
            delta = tuple(c.launches - b for c, b in zip(counters, before))
            if delta != expected:
                raise AssertionError(f"options (e) {fk!r} prefill: launches "
                                     f"{dict(zip(names, delta))}, expected "
                                     f"{dict(zip(names, expected))}")
        out[fk] = logits
        del cache
    for fk in ("l", "lr"):
        cache = llama.HeadMajorQuantKVCache.create(config, 1, S, device=dev)
        with _PlainKernels():
            plain, _ = fused.prefill_into_slot_fused(runs[fk][0], tokens, 0,
                                                     cache, config,
                                                     flash=True)
        del cache
        e_p = _rel(torch, out[fk][None], plain[None])
        e_x = _rel(torch, out[fk][None], out["xla"][None])
        print(f"options (e) {fk!r} prefill of {S} tokens (flash): exact "
              f"launches {dict(zip(names, runs[fk][1]))}; {ms[fk][0]:.1f}, "
              f"{ms[fk][1]:.1f} ms (the 'xla' prefill {ms['xla'][0]:.1f}, "
              f"{ms['xla'][1]:.1f} ms); logits against the plain versions "
              f"{e_p:.3e}, against the 'xla' prefill {e_x:.3e} "
              f"(rel-Frobenius, bound {KERN_REL:g})", flush=True)
        if not (e_p <= KERN_REL and e_x <= KERN_REL
                and _same_argmax(torch, out[fk][None], plain[None])
                and _same_argmax(torch, out[fk][None], out["xla"][None])):
            raise AssertionError(f"options (e): the {fk!r} prefill disagrees "
                                 "with the plain versions or the 'xla' "
                                 "prefill")


def _megastep_ptxas():
    """nvcc's -Xptxas -v lines of the megastep kernels of both builds, one
    string each: "<bits>-bit MT <rows>: <registers>, <spills>"."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import _build
    out = []
    for name in ("megastep", "megastep_2bit"):
        lines = _build.build_log(name).splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" not in line \
                    or "megastep_kernelILi" not in line:
                continue
            tag = line.split("megastep_kernelILi")[1]
            bits, mt = tag.split("ELi")[0], tag.split("ELi")[1].split("E")[0]
            used = next((ln for ln in lines[i + 1:i + 4] if "Used" in ln), "")
            spill = next((ln for ln in lines[i + 1:i + 4] if "spill" in ln),
                         "")
            regs = used.split("Used ")[1].split(",")[0] if used else "?"
            out.append(f"{bits}-bit MT {mt}: {regs}, "
                       f"{spill.split(', ', 1)[-1].strip() or '?'}")
    return out


def phase_mega(torch, dev, record, params, cache, tok0, pos0):
    """Phase 10, the whole-step megakernel: ``decode_step_persistent``,
    Llama-2-7B, 32 layers, batch 8, on phase 8's "l" params and cache (eight
    seeded 128-token prompts, context 256) from position 128, the reference's
    ``bench.py --decode-path mega`` flow. The interleaved gate/up set is
    built once. (a) The first step against the same step through the plain
    versions (``megastep_plain``, the plain int8 head) from copies of one
    cache: logits, x_out, the staged K/V codes and scales, the flipped codes
    counted. (b) The same step against the fused "l" step (staged, f32
    dots), which differs on purpose in the bf16 staging of m: logits, argmax
    agreement, layer-0 K/V codes. (c) 32 greedy steps with exactly one
    megastep and one int8 head launch each and no other kernel: median
    eager ms/step and the device time of one step as a CUDA graph, beside
    phase 4's and phase 8's steps; the kernel's own time, its plain
    version's and its bound. (d) A step at ragged positions (one row at 0)
    with the per-row commit against the plain versions."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        fused, persistent)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
        LLAMA2_7B)
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        attention as AT, kernels as K, megastep as MS)

    t_phase = time.perf_counter()
    config = LLAMA2_7B
    L, B, T = config.num_layers, 8, cache.k.shape[3]
    prep = persistent.prepare_gateup_interleaved(params.layers.gateup,
                                                 config.intermediate_size)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in prep)
    print(f"mega: interleaved gate/up set built once in "
          f"{time.perf_counter() - t_phase:.2f} s ({nbytes / 1e9:.3f} GB)",
          flush=True)

    def step(tok, pos, c, **kw):
        return persistent.decode_step_persistent(params, tok, pos, c, config,
                                                 prep=prep, **kw)

    args, kw = persistent.megastep_operands(params, tok0, pos0, cache, config,
                                            prep)
    ctas = MS.megastep_ctas(*args, **kw)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ptxas = _megastep_ptxas()
    print(f"mega: cooperative grid of {ctas} CTAs of 256 threads, "
          f"{ctas / sms:g} per SM on {sms} SMs (occupancy query); ptxas: "
          f"{'; '.join(ptxas)}", flush=True)
    record["megastep"].update(ctas=ctas, ctas_per_sm=ctas / sms, ptxas=ptxas)

    # (a) the kernel against its plain version on the card
    ck, cp = _copy_cache(cache, dev), _copy_cache(cache, dev)
    lk, _ = step(tok0, pos0, ck)
    with _PlainKernels():
        lp, _ = step(tok0, pos0, cp)
    got, ref = MS.megastep(*args, **kw), MS.megastep_plain(*args, **kw)
    torch.cuda.synchronize()
    e_l, e_x = _rel(torch, lk, lp), _rel(torch, got[0], ref[0])
    err = float((got[0] - ref[0]).abs().max())
    d = [(g.int() - r.int()).abs() for g, r in ((got[1], ref[1]),
                                                 (got[3], ref[3]))]
    flips = sum(int((t != 0).sum()) for t in d)
    d0 = max(int(t[0].max()) for t in d)
    s_rel = max(float(((g - r).abs() / r).max()) for g, r in (
        (got[2], ref[2]), (got[4], ref[4])))
    print(f"mega (a) first step, kernel against plain versions from one "
          f"cache: logits {e_l:.3e}, x_out {e_x:.3e} rel-Frobenius (bound "
          f"{SYNC_REL:g}: the kernel's RMSNorm, factor and attention sums run "
          f"in another order than torch's, and each int8 code that rounds "
          f"the other way carries through the later layers), x_out max diff "
          f"{err:.3e}; {flips} of {2 * got[1].numel()} staged K/V codes "
          f"differ (layer 0 by at most {d0}), scales within {s_rel:.2e}",
          flush=True)
    if not (e_l <= SYNC_REL and e_x <= SYNC_REL and d0 <= 1
            and _same_argmax(torch, lk, lp)):
        raise AssertionError("mega (a): the kernel disagrees with its plain "
                             "version")

    # (b) against the fused "l" step (staged, f32 dots) from the same cache
    cf = _copy_cache(cache, dev)
    lf, cf = fused.decode_step_fused(params, tok0, pos0, cf, config,
                                     staged_kv=True, attn_dots="f32")
    e_f = _rel(torch, lk, lf)
    agree = float((lk.argmax(-1) == lf.argmax(-1)).float().mean())
    cols = pos0.long()
    rows = torch.arange(B, device=dev)
    n0 = sum(int((getattr(ck, n)[0][rows, :, cols]
                  != getattr(cf, n)[0][rows, :, cols]).sum())
             for n in ("k", "v"))
    m0 = max(int((getattr(ck, n)[0][rows, :, cols].int()
                  - getattr(cf, n)[0][rows, :, cols].int()).abs().max())
             for n in ("k", "v"))
    print(f"mega (b) against the fused 'l' step (staged, f32 dots): logits "
          f"{e_f:.3e} rel-Frobenius (bound 5e-2: the megastep stages m "
          f"through bf16 before its int8 codes), argmax agreement "
          f"{agree:.0%}; layer-0 K/V codes: {n0} of "
          f"{2 * B * config.num_kv_heads * config.head_dim} differ, by at "
          f"most {m0}", flush=True)
    if not (e_f <= 5e-2 and agree >= 0.75 and m0 <= 1):
        raise AssertionError("mega (b): the megastep step disagrees with "
                             "the fused 'l' step")
    del ck, cp, cf

    # (c) greedy steps: launches, eager and device time
    counters = [getattr(m, n) for m, n in (
        (K, "quantized_matmul"), (K, "quantized_matmul_w4a8"),
        (K, "quantized_matmul_w4a8_stacked"),
        (K, "quantized_matmul_w4a8_stacked_persistent"), (K, "int8_matmul"),
        (K, "bf16_matmul_stacked"), (K, "quantized_matmul_w4a8_l_stacked"),
        (K, "quantized_matmul_w4a8_lr_stacked"),
        (K, "quantized_matmul_w4a8_mlp_stacked"),
        (AT, "flash_decode_q8_staged"), (AT, "flash_decode_q8"),
        (AT, "flash_decode_q8_ab"), (AT, "flash_decode_q8_paged"),
        (AT, "flash_decode_attn_o"), (AT, "flash_prefill"),
        (MS, "megastep"))]
    per_step = [1 if c in (MS.megastep, K.int8_matmul) else 0
                for c in counters]
    crun = _copy_cache(cache, dev)
    steps = 32
    for c in counters:
        c.launches = 0
    times, tok, pos = [], tok0, pos0
    for i in range(steps):
        before = [c.launches for c in counters]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, crun = step(tok, pos, crun)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t1))
        delta = [c.launches - b for c, b in zip(counters, before)]
        if delta != per_step:
            raise AssertionError(f"mega (c) step {i}: launches {delta}, "
                                 f"expected {per_step}")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"mega (c) step {i}: non-finite logits")
        tok, pos = logits.argmax(-1), pos + 1
    launches = MS.megastep.launches
    med = statistics.median(times[1:])
    dev_ms = _time_ms(torch, lambda i: step(tok, pos, crun), 1, reps=9)
    a = MS._named(args, **kw)
    ms = _time_ms(torch, lambda i: MS._launch(a), 10)
    plain_ms = _time_ms(torch, lambda i: MS.megastep_plain(*args, **kw), 1,
                        reps=3)
    print(f"mega (c) {steps} greedy steps from position {int(pos0[0])}, "
          f"exactly 1 megastep and 1 int8 head launch each and no other "
          f"kernel (megastep launches {launches}); median {med:.3f} ms/step "
          f"eager (min {min(times[1:]):.3f}, max {max(times[1:]):.3f}), "
          f"{1e3 * B / med:.1f} tok/s; device time of one step as a CUDA "
          f"graph {dev_ms:.3f} ms (card idle {1 - dev_ms / med:.1%} of the "
          f"eager step); the megastep launch alone {ms:.3f} ms, its plain "
          f"version {plain_ms:.1f} ms", flush=True)
    for name, (m_eager, m_dev) in _STEP_MS.items():
        print(f"  beside {name}: median {m_eager:.3f} ms/step eager, "
              f"{m_dev:.3f} ms device", flush=True)

    # bound: each byte of the step read once (every layer's weights, the
    # live K/V of the cache: pos tokens of each row) and each output written
    # once; the operations: int8 W4A8 dots, bf16 factor dots, f32 attention
    lp_ = params.layers
    weights = [lp_.attn_norm, lp_.mlp_norm, *args[4:29]]
    w_bytes = sum(t.numel() * t.element_size() for t in weights)
    KVH, D, h = config.num_kv_heads, config.head_dim, config.hidden_size
    live = int(pos0.sum())
    kv_bytes = L * KVH * live * (2 * D + 8)
    io_bytes = (B * h * 4 * 2 + B * 4 + 2 * B * (D // 2) * 4
                + 2 * L * B * KVH * (D + 4))
    rank = kw["rank"]
    im, qdim = config.intermediate_size, KVH * D
    mac = qdim * 3 * h + h * qdim + 2 * im * h + h * im
    lr_mac = rank * (3 * h + 3 * qdim + qdim + h + 2 * h + 2 * im + im + h)
    ops = _ops_int8_units(i8=2 * B * L * mac, bf16=2 * B * L * lr_mac,
                          f32=4 * L * KVH * (live + B) * D)
    bound, by = _bound_ms(w_bytes + kv_bytes + io_bytes, ops)
    print(f"mega: bound {bound:.3f} ms per step ({by}: "
          f"{(w_bytes + kv_bytes + io_bytes) / 1e9:.3f} GB, of which weights "
          f"{w_bytes / 1e9:.3f} GB and live K/V {kv_bytes / 1e9:.3f} GB); the "
          f"launch runs at {bound / ms:.1%} of it", flush=True)
    record["megastep"].update(launches=launches, launches_per_step=1,
                              steps=steps, max_abs_err=err, ms=ms,
                              plain_ms=plain_ms, bound_ms=bound, bound_by=by)
    del crun

    # (d) ragged positions, per-row commit, against the plain versions
    pos_r = torch.tensor([128, 64, 1, 0, 127, 100, 17, T - 1],
                         dtype=torch.int32, device=dev)
    ck, cp = _copy_cache(cache, dev), _copy_cache(cache, dev)
    lk, ck = step(tok0, pos_r, ck, staged_kv="on")
    with _PlainKernels():
        lp, cp = step(tok0, pos_r, cp, staged_kv="on")
    e_r = _rel(torch, lk, lp)
    rows, cols = torch.arange(B, device=dev), pos_r.long()
    m0 = max(int((getattr(ck, n)[0][rows, :, cols].int()
                  - getattr(cp, n)[0][rows, :, cols].int()).abs().max())
             for n in ("k", "v"))
    print(f"mega (d) ragged positions {pos_r.tolist()}, per-row commit: "
          f"logits against the plain versions {e_r:.3e} rel-Frobenius (bound "
          f"{SYNC_REL:g}); layer-0 K/V codes committed at each row's "
          f"position differ by at most {m0}", flush=True)
    if not (e_r <= SYNC_REL and m0 <= 1 and _same_argmax(torch, lk, lp)):
        raise AssertionError("mega (d): the ragged step disagrees with the "
                             "plain versions")
    del ck, cp, prep
    torch.cuda.empty_cache()
    print(f"mega phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


def _views(params, config):
    """Per-layer ``llama.ModelParams`` over stacked params: every tensor of
    layer ``l`` indexed (a view, no copy)."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        llama, stacked)
    return llama.ModelParams(
        params.embed,
        [stacked.layer_view(params.layers, l)
         for l in range(config.num_layers)],
        params.final_norm, params.lm_head)


def _grouped_width(torch, dev):
    """The grouped path at Llama-2-7B width, 2 layers, the same weights
    (seed 0, 4-bit, rank 128) on the card and on the CPU: a seeded
    300-token prompt prefilled (the grouped kernel at M = 300), then one
    batch-8 decode step at position 300 from copies of the CPU's cache (M
    = 8). Each card result against the CPU's, logits rel-Frobenius within
    phase 6 (a)'s bound and the same argmax."""
    from ee274_convexcaldera_llm_quantization_tpu_torch import bench_params
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        llama, stacked)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
        LLAMA2_7B)

    config = dataclasses.replace(LLAMA2_7B, num_layers=2)
    t0 = time.perf_counter()
    cpu_params = bench_params.build_compressed_llama_params(
        config, num_bits=4, rank=128, seed=0, mode="grouped", device="cpu")
    card_params = _map_tensors(cpu_params, lambda t: t.to(dev))
    n, B, T = 300, 8, 512
    gen = torch.Generator().manual_seed(11)
    prompt = torch.randint(0, config.vocab_size, (1, n), generator=gen)
    logits, caches = {}, {}
    for where, params in (("cpu", cpu_params), ("card", card_params)):
        d = "cpu" if where == "cpu" else dev
        cache = llama.KVCache.create(config, 1, T, device=d)
        logits[where], caches[where] = stacked.prefill(
            params, prompt.to(d), cache, config)
    e_pre = _rel(torch, logits["card"], logits["cpu"])
    # a batch-8 cache whose rows all hold the CPU's prefilled prompt
    one = caches["cpu"]
    batch = llama.KVCache.create(config, B, T, device="cpu")
    batch.k[:] = one.k[:, :1]
    batch.v[:] = one.v[:, :1]
    tok = torch.randint(0, config.vocab_size, (B,), generator=gen)
    pos = torch.full((B,), n, dtype=torch.int32)
    step = {}
    for where, params in (("cpu", cpu_params), ("card", card_params)):
        d = "cpu" if where == "cpu" else dev
        step[where], _ = stacked.decode_step_batched(
            params, tok.to(d), pos.to(d), _copy_cache(batch, d), config)
    e_dec = _rel(torch, step["card"], step["cpu"])
    print(f"unfused (e) grouped path, Llama-2-7B width, 2 layers: card vs "
          f"CPU logits rel-Frobenius, {n}-token prefill {e_pre:.3e}, batch-"
          f"{B} decode step at position {n} from the CPU's cache "
          f"{e_dec:.3e} (bound {KERN_REL:g}; "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    if not (e_pre <= KERN_REL and e_dec <= KERN_REL
            and _same_argmax(torch, logits["card"], logits["cpu"])
            and _same_argmax(torch, step["card"], step["cpu"])):
        raise AssertionError("unfused (e): the grouped path on the card "
                             "disagrees with the CPU")


def phase_unfused(torch, dev, record):
    """The unfused compressed-model path, Llama-2-7B, 32 layers, synthetic
    weights (seed 0, 4-bit, rank 128):

    (a) ``bench.py --mode grouped``'s flow: grouped stacked params, bf16
    factors and head, a bf16 cache, batch 8, context 256;
    ``stacked.decode_step_batched`` 32 steps from position 128 (224
    grouped launches per step), one step against the plain versions;
    (d) ``evaluate_perplexity`` on per-layer views of the same params, one
    seeded 1024-token window (the grouped kernel at M = 1024);
    (b) ``ServingEngine`` on per-layer views of w4a8 params with int8
    factors and head (max_slots 8, max_seq_len 1024): 8 seeded requests of
    16-500 prompt tokens, 16 new tokens, every other one sampled (T 0.8,
    top-k 50, top-p 0.9); 224 flat W4A8 launches and the head per prefill
    and tick; the first prefill and the first tick against the plain
    versions;
    (c) ``FastServingEngine`` on the same stacked w4a8 params, unfused:
    the same requests on a bf16 cache (greedy completions equal to (b)'s),
    then on an int8 cache (reported);
    (f) :func:`_perplexity_w4a8` on (b)'s views;
    (e), run first: :func:`_grouped_width`, the grouped path at 2 layers,
    card against CPU."""
    from ee274_convexcaldera_llm_quantization_tpu_torch import bench_params
    from ee274_convexcaldera_llm_quantization_tpu_torch.evalm import (
        perplexity)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        llama, stacked)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
        LLAMA2_7B)
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        kernels as K)
    from ee274_convexcaldera_llm_quantization_tpu_torch.serve.engine import (
        ServingEngine)
    from ee274_convexcaldera_llm_quantization_tpu_torch.serve.fast_engine \
        import FastServingEngine

    config = LLAMA2_7B
    L = config.num_layers
    t_phase = time.perf_counter()
    _grouped_width(torch, dev)
    counters = (K.quantized_matmul, K.quantized_matmul_w4a8,
                K.quantized_matmul_w4a8_stacked, K.int8_matmul)
    names = ("quantized_matmul", "quantized_matmul_w4a8", "w4a8_stacked",
             "int8_matmul")

    # (a) the grouped bench flow
    B, T, steps = 8, 256, 32
    params = bench_params.build_compressed_llama_params(
        config, num_bits=4, rank=128, seed=0, mode="grouped", device=dev)
    cache = llama.KVCache.create(config, B, T, device=dev)
    gen = torch.Generator().manual_seed(8)
    tok = torch.randint(0, config.vocab_size, (B,), generator=gen).to(dev)

    def step(i, cache, tok):
        pos = torch.full((B,), 128 + i, dtype=torch.int32, device=dev)
        return stacked.decode_step_batched(params, tok, pos, cache, config)

    # one step against the plain versions, from copies of the cache
    lkern, _ = step(0, _copy_cache(cache, dev), tok)
    with _PlainKernels():
        lplain, _ = step(0, _copy_cache(cache, dev), tok)
    e = _rel(torch, lkern, lplain)
    print(f"unfused (a) grouped step, kernels vs plain versions on the card: "
          f"logits rel-Frobenius {e:.3e} (bound {KERN_REL:g})", flush=True)
    if not (e <= KERN_REL and _same_argmax(torch, lkern, lplain)):
        raise AssertionError("unfused (a): the grouped kernel disagrees with "
                             "the plain version")
    for c in counters:
        c.launches = 0
    times = []
    for i in range(steps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, cache = step(i, cache, tok)
        tok = logits.argmax(-1)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t1))
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"unfused (a) step {i}: non-finite logits")
    got = tuple(c.launches for c in counters)
    if got != (7 * L * steps, 0, 0, 0):
        raise AssertionError(f"unfused (a): launches {got}, expected "
                             f"{(7 * L * steps, 0, 0, 0)}")
    record["quantized_matmul"].update(launches=got[0],
                                      launches_per_step=7 * L, steps=steps)
    med = statistics.median(times[3:])
    dev_ms = _time_ms(torch, lambda i: step(32, cache, tok), 1, reps=9)
    print(f"unfused (a) llama2-7b grouped, stacked.decode_step_batched B={B} "
          f"ctx={T} from pos 128: {steps} steps, {7 * L} quantized_matmul "
          f"launches each (total {got[0]}); median {med:.3f} ms/step over "
          f"{len(times) - 3} (min {min(times[3:]):.3f}, max "
          f"{max(times[3:]):.3f}); {1e3 * B / med:.1f} tok/s; one step as a "
          f"CUDA graph {dev_ms:.3f} ms of device time (the card idle "
          f"{1 - dev_ms / med:.1%} of the eager step)", flush=True)
    del cache

    # (d) perplexity on per-layer views of the grouped params
    stream = torch.randint(0, config.vocab_size, (1024,),
                           generator=torch.Generator().manual_seed(9))
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ppl = perplexity.evaluate_perplexity(_views(params, config),
                                         stream.numpy(), config, window=1024,
                                         batch_size=1, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    got = tuple(c.launches for c in counters)
    if not math.isfinite(ppl) or got != (7 * L, 0, 0, 0):
        raise AssertionError(f"unfused (d): perplexity {ppl}, launches {got}")
    print(f"unfused (d) evaluate_perplexity, one 1024-token window, batch 1: "
          f"perplexity {ppl:.4f} (random weights), {wall:.2f} s wall, "
          f"{got[0]} quantized_matmul launches at M = 1024", flush=True)
    del params
    torch.cuda.empty_cache()

    # (b) ServingEngine on per-layer views of w4a8 params
    w = stacked.quantize_model_factors_int8(
        bench_params.build_compressed_llama_params(
            config, num_bits=4, rank=128, seed=0, mode="w4a8", device=dev))
    views = _views(w, config)
    gen = torch.Generator().manual_seed(10)
    lens = torch.randint(16, 501, (8,), generator=gen).tolist()
    reqs = [dict(uid=i, prompt=torch.randint(
        0, config.vocab_size, (n,), generator=gen).numpy(),
        **(dict(temperature=0.8, top_k=50, top_p=0.9) if i % 2 else {}))
        for i, n in enumerate(lens)]
    new_tokens = 16

    def check_first(prefill, tokens, last_pos, logits):
        cache = llama.KVCache.create(config, 1, tokens.shape[1], device=dev)
        with _PlainKernels():
            plain, _ = prefill(views, tokens, 0, cache, config,
                               last_pos=last_pos)
        e = _rel(torch, logits[None], plain[None])
        print(f"unfused (b): first prefill ({last_pos + 1} tokens, bucket "
              f"{tokens.shape[1]}) kernels vs plain versions on the card: "
              f"logits rel-Frobenius {e:.3e} (bound {KERN_REL:g})",
              flush=True)
        if not (e <= KERN_REL and _same_argmax(torch, logits[None],
                                               plain[None])):
            raise AssertionError("unfused (b): the first prefill's kernels "
                                 "disagree with the plain versions")

    def check_tick(decode, args, kw):
        params_, tokens, pos, cache, cfg = args
        kern, _ = decode(params_, tokens, pos, _copy_cache(cache, dev), cfg)
        with _PlainKernels():
            plain, _ = decode(params_, tokens, pos, _copy_cache(cache, dev),
                              cfg)
        e = _rel(torch, kern, plain)
        print(f"unfused (b): first tick (positions {pos.tolist()}) kernels "
              f"vs plain versions on the card: logits rel-Frobenius {e:.3e} "
              f"(bound {KERN_REL:g})", flush=True)
        if not (e <= KERN_REL and _same_argmax(torch, kern, plain)):
            raise AssertionError("unfused (b): the first tick's kernels "
                                 "disagree with the plain versions")

    runs = {}
    for run, make, module, fn_names, per_call, checks in [
            ("b", lambda: ServingEngine(views, config, max_slots=8,
                                        max_seq_len=1024, device=dev),
             llama, ("prefill_into_slot", "decode_step_batched"),
             (0, 7 * L, 0, 1), (check_first, check_tick)),
            ("c bf16", lambda: FastServingEngine(w, config, max_slots=8,
                                                 max_seq_len=1024,
                                                 device=dev),
             stacked, ("prefill_into_slot_w4a8", "decode_step_w4a8"),
             (0, 0, 7 * L, 1), (None, None)),
            ("c int8", lambda: FastServingEngine(w, config, max_slots=8,
                                                 max_seq_len=1024,
                                                 kv_int8=True, device=dev),
             stacked, ("prefill_into_slot_w4a8", "decode_step_w4a8"),
             (0, 0, 7 * L, 1), (None, None))]:
        engine = make()
        watch = _Watch(torch, counters, per_call, per_call, *checks,
                       module=module, names=fn_names)
        done = []
        wall, ntok = _serve(torch, engine, watch, reqs, new_tokens, done)
        runs[run] = {c.uid: c.tokens for c in done}
        totals = dict(zip(names, watch.counted))
        n_pre = sum(len(v) for v in watch.prefill_ms.values())
        n_tick = len(watch.tick_ms)
        print(f"unfused ({run}) {type(engine).__name__}, "
              f"{type(engine.cache).__name__}, {len(reqs)} requests, "
              f"max_seq_len 1024: {n_pre} prefills, {n_tick} decode ticks, "
              f"each with its exact launches {dict(zip(names, per_call))}; "
              f"totals {totals}", flush=True)
        for bucket, ms in sorted(watch.prefill_ms.items()):
            print(f"  prefill bucket {bucket}: {len(ms)} x, median "
                  f"{statistics.median(ms):.1f} ms "
                  f"({', '.join(f'{m:.1f}' for m in ms)})", flush=True)
        print(f"  decode tick: median {statistics.median(watch.tick_ms):.2f}"
              f" ms (min {min(watch.tick_ms):.2f}, max "
              f"{max(watch.tick_ms):.2f}); {ntok} tokens in {wall:.2f} s "
              f"wall: {ntok / wall:.1f} tokens/s", flush=True)
        if run == "b":
            record["quantized_matmul_w4a8"].update(
                launches=totals["quantized_matmul_w4a8"],
                launches_per_step=7 * L, steps=n_pre + n_tick)
        del engine
        torch.cuda.empty_cache()
    greedy = [r["uid"] for r in reqs if "temperature" not in r]
    for uid in greedy:
        if runs["c bf16"][uid] != runs["b"][uid]:
            raise AssertionError(
                f"unfused (c): request {uid}'s greedy completion "
                f"{runs['c bf16'][uid]} differs from ServingEngine's "
                f"{runs['b'][uid]}")
    sampled_equal = all(runs["c bf16"][r["uid"]] == runs["b"][r["uid"]]
                        for r in reqs)
    print(f"unfused (c): the {len(greedy)} greedy completions of the stacked "
          f"W4A8 engine (bf16 cache) equal ServingEngine's token for token; "
          f"the sampled ones {'too' if sampled_equal else 'differ'}; "
          f"the int8 cache's greedy completions "
          f"{'equal' if all(runs['c int8'][u] == runs['b'][u] for u in greedy) else 'differ from'}"
          f" them", flush=True)
    _perplexity_w4a8(torch, dev, views, config, counters, names)
    print(f"unfused phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


class _RecordCalls:
    """Within this context ``models/compressed.py`` sees the kernels module
    through a proxy: each named wrapper there records the M of every call
    (``calls``: (name, M)) and, for ``timed``, the device time of the call
    between CUDA events (``events``), then calls the wrapper itself (whose
    launch counter stays its own)."""

    def __init__(self, torch, names, timed):
        self.torch, self.names, self.timed = torch, names, timed
        self.calls, self.events = [], []

    def __enter__(self):
        from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
            compressed)
        rec, kernels = self, compressed.K

        class Proxy:
            def __getattr__(self, name):
                fn = getattr(kernels, name)
                if name not in rec.names:
                    return fn

                def wrapper(x, *args, **kw):
                    rec.calls.append((name, x.shape[0]))
                    if name != rec.timed:
                        return fn(x, *args, **kw)
                    ev = [rec.torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                    ev[0].record()
                    out = fn(x, *args, **kw)
                    ev[1].record()
                    rec.events.append(ev)
                    return out
                return wrapper

        self.module, self.saved = compressed, kernels
        compressed.K = Proxy()
        return self

    def __exit__(self, *exc):
        self.module.K = self.saved
        return False


def _perplexity_w4a8(torch, dev, views, config, counters, names):
    """Phase 6 (f): ``evaluate_perplexity`` on the w4a8 per-layer views of
    (b) (int8 factors and head), one seeded 1024-token window, batch 1:
    exactly 224 flat W4A8 launches and one int8 head launch, all at M =
    1024 (the head on its tile path); the window's wall time and the head's
    device time in it (activation quantization and kernel, CUDA events);
    the perplexity equal to the same window's through the plain versions on
    the card."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.evalm import (
        perplexity)
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        kernels as K)

    L, window = config.num_layers, 1024
    stream = torch.randint(0, config.vocab_size, (window,),
                           generator=torch.Generator().manual_seed(12))
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with _RecordCalls(torch, ("quantized_matmul_w4a8", "int8_matmul"),
                      "int8_matmul") as rec:
        ppl = perplexity.evaluate_perplexity(views, stream.numpy(), config,
                                             window=window, batch_size=1,
                                             device=dev)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    got = tuple(c.launches for c in counters)
    want = (0, 7 * L, 0, 1)
    Ms = sorted({m for _, m in rec.calls})
    head_ms = sum(a.elapsed_time(b) for a, b in rec.events)
    plan = K._int8_plan(window, config.vocab_size, config.hidden_size,
                        torch.cuda.get_device_properties(dev)
                        .multi_processor_count)
    with _PlainKernels():
        ppl_plain = perplexity.evaluate_perplexity(
            views, stream.numpy(), config, window=window, batch_size=1,
            device=dev)
    rel = abs(ppl - ppl_plain) / ppl_plain
    print(f"unfused (f) evaluate_perplexity on the w4a8 views, one "
          f"{window}-token window, batch 1: perplexity {ppl:.6f} (random "
          f"weights), through the plain versions on the card {ppl_plain:.6f}"
          f" (rel diff {rel:.3e}; must be 0); launches "
          f"{dict(zip(names, got))} at M {Ms}; {wall:.3f} s wall, the head "
          f"(tile {plan['rows']} x {plan['cols']}) {head_ms:.3f} ms of "
          f"device time in it", flush=True)
    # one glue runs both sides, and the W4A8 and int8 kernels equal their
    # plain versions bit for bit: the perplexities are equal
    if (got != want or Ms != [window] or len(rec.events) != 1
            or not math.isfinite(ppl) or ppl != ppl_plain):
        raise AssertionError(f"unfused (f): perplexity {ppl} against "
                             f"{ppl_plain}, launches {got} (expected "
                             f"{want}) at M {Ms}")


# The compression phase's settings (phase 11). The alternation runs
# COMPRESS_ITERS iterations (Q, then L and R from the residual): the fewest
# that keep the phase near two minutes on the card. 4 x 2 x 512 calibration
# tokens leave the full Hessians singular at n = 11008 (and nearly so at
# 4096), and the un-whitening of R divides by the square roots of their
# eigenvalues: COMPRESS_SIGMA_REG lifts the smallest to it.
COMPRESS_ITERS = 1
COMPRESS_SIGMA_REG = 1e-2
# o_proj of layer 0 solved on the card and on the CPU from the same W and
# H: cuSOLVER against LAPACK and sums in another order, and an LDLQ code on
# a rounding edge that rounds the other way and is carried along its row.
# Bound on the difference of the activation-aware errors, relative.
COMPRESS_CPU_RTOL = 1e-2
# The RTN layer's served form is the per-row 4-bit RTN of W - L @ R, with
# L @ R fitted to the rounding of the solver's global grid: on random
# weights it moves the per-row RTN error of W by a fraction of a percent
# either way (read on an H100 over the 7 projections: from 0.13% better to
# 0.38% worse), so the served errors are held within 1% of the serving
# grid's rank-0 form, the per-row RTN of W. The factors' work is held on
# the LDLQ layer, whose served Q keeps the sweep's codes.
COMPRESS_ROW_RTOL = 1e-2
# The compressed model's decode step against the plain step from the same
# cache. Every launch is held to its plain version on the same operands
# (W4A8 and head bit-equal, attention within 1e-4). The attention's expf
# ulps (6e-8 rel) reach the residual stream through the o_proj input's
# row scale (its codes stay equal) and round later int8 activation codes
# the other way, and the flips cascade. The phase shows the cause: the
# plain step fed the kernels' attention outputs agrees within KERN_REL
# (read on an H100: 0 at every step), a step where no activation code
# flipped agrees within KERN_REL (read: 0), and the flipped codes are
# counted per call. Reading of the plain comparison on an H100: 1.152e-2
# at worst over 8 steps (4428 flips in the head's input); bound about
# twice that.
COMPRESS_DRIFT_REL = 2.5e-2


class _CompressWatch:
    """Within this context the compression stages are timed on the host
    clock between synchronisations (``ms[stage]``: (key, ms) per call):
    ``lowrank.regularized_eigh`` ("eigh", by n), ``caldera._update_LR``
    (one LPLR update) and ``caldera.ldlq_quantize`` (one LDLQ sweep). Each
    ``caldera.caldera_core`` first keeps the solver's Q-only reconstruction
    of its W at the same bits (its Q rule on W alone: the global-scale RTN,
    or LDLQ through the same U), the rank-0 error the projection is held
    to (``q_only``; its time apart, "q_only")."""

    def __init__(self, torch):
        self.torch = torch
        self.ms = {"eigh": [], "lplr": [], "ldlq": [], "q_only": []}
        self.q_only = []

    def _timed(self, stage, fn, key):
        torch = self.torch

        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.ms[stage].append((key(*args),
                                   1e3 * (time.perf_counter() - t0)))
            return out
        return wrapper

    def __enter__(self):
        from ee274_convexcaldera_llm_quantization_tpu_torch.decomp import (
            caldera as C, lowrank as LR)
        self.saved = [(LR, "regularized_eigh", LR.regularized_eigh),
                      (C, "_update_LR", C._update_LR),
                      (C, "ldlq_quantize", C.ldlq_quantize),
                      (C, "caldera_core", C.caldera_core)]
        ldlq, core = C.ldlq_quantize, C.caldera_core
        LR.regularized_eigh = self._timed("eigh", LR.regularized_eigh,
                                          lambda H, *_: H.shape[0])
        C._update_LR = self._timed("lplr", C._update_LR,
                                   lambda p, res, *_: tuple(res.shape))
        C.ldlq_quantize = self._timed("ldlq", ldlq,
                                      lambda A, *_: tuple(A.shape))

        def core_keeping_q_only(params, W, H, H_sqrt, eigH, U, *rest):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            if params.q_update == "ldlq":
                q = ldlq(W, U, params.Q_bits)     # not the solve's sweep
            else:
                q = C._quantize_qd(W, params.Q_bits, params.quant_factory_Q)
            self.q_only.append(q)
            self.torch.cuda.synchronize()
            self.ms["q_only"].append((tuple(W.shape),
                                      1e3 * (time.perf_counter() - t0)))
            return core(params, W, H, H_sqrt, eigH, U, *rest)

        C.caldera_core = core_keeping_q_only
        return self

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)
        return False


class _TapCalls:
    """Within this context the modules in ``holders`` see their kernels
    module through a proxy: each wrapper named in ``taps`` (``{name:
    tap}``; under ``_PlainKernels`` the plain version) is called as
    ``tap(fn, *args, **kw)``."""

    def __init__(self, holders, taps):
        self.holders, self.taps = holders, taps

    def __enter__(self):
        taps = self.taps

        class Proxy:
            def __init__(self, module):
                self._module = module

            def __getattr__(self, name):
                fn = getattr(self._module, name)
                if name not in taps:
                    return fn
                return lambda *args, **kw: taps[name](fn, *args, **kw)

        self.saved = [(m, a, getattr(m, a)) for m, a in self.holders]
        for m, a, real in self.saved:
            setattr(m, a, Proxy(real))
        return self

    def __exit__(self, *exc):
        for m, a, real in self.saved:
            setattr(m, a, real)
        return False


class _CheckCalls(_TapCalls):
    """Within this context the modules in ``holders`` (``(module, alias)``:
    ``fused.K`` and so on) see their kernels module through a proxy
    (``_TapCalls``): each wrapper named in ``checks`` (``{name: (plain,
    how)}``) runs as it is (its launch counter stays its own), then its
    plain version runs on the same operands: "exact" holds the two
    outputs equal bit for bit, "attn" to phase 2's bound for a decode
    kernel (``_attn_ok``), "rel" within ``L_RTOL`` (the L-fused kernel:
    exact integer sums, its factor dots and f32 epilogue in another order),
    "scaled" to phase 2's f32 bound with its atol times the output's
    largest value (flash prefill on a model's activations).
    Keeps ``calls`` and the largest rel-Frobenius
    difference (``worst``) per name, every failure (``bad``), and each
    call's first operand and output in order (``inputs``, ``outputs``)."""

    def __init__(self, torch, holders, checks):
        super().__init__(holders, {name: self._checked(name)
                                   for name in checks})
        self.torch, self.checks = torch, checks
        self.calls = dict.fromkeys(checks, 0)
        self.worst = dict.fromkeys(checks, 0.0)
        self.bad = []
        self.inputs = {name: [] for name in checks}
        self.outputs = {name: [] for name in checks}

    def _checked(self, name):
        def checked(fn, *args, **kw):
            torch = self.torch
            plain, how = self.checks[name]
            out = fn(*args, **kw)
            ref = plain(*args, **kw)
            rel = float(torch.linalg.norm(out - ref)
                        / torch.linalg.norm(ref))
            if how == "exact":
                ok, text = bool(torch.equal(out, ref)), "bit-equal"
            elif how == "rel":
                ok = torch.allclose(out, ref, rtol=L_RTOL, atol=L_RTOL * float(
                    ref.abs().max()))
                text = f"rtol {L_RTOL:g}"
            elif how == "scaled":
                # phase 2's f32 bound, its atol scaled to the output's
                # largest value (an f32 sum's error grows with its terms)
                tol = 2e-6 * max(1.0, float(ref.abs().max()))
                ok = torch.allclose(out, ref, rtol=2e-5, atol=tol)
                text = f"rtol 2e-5, atol {tol:.2e}"
            else:
                ok, text = _attn_ok(torch, out, ref, kw.get("dots", "f32"))
            self.calls[name] += 1
            self.worst[name] = max(self.worst[name], rel)
            self.inputs[name].append(args[0])
            self.outputs[name].append(out)
            if not ok:
                self.bad.append(f"{name}: {text} (rel {rel:.3e})")
            return out
        return checked


def _aa_error(torch, W, W_hat, H) -> float:
    """``sqrt(tr(E H E^T) / tr(W H W^T))``, E = W_hat - W (the solver's
    activation-aware error), in f32 on the tensors' device."""
    E = W_hat - W
    return float(torch.sqrt(((E @ H) * E).sum() / ((W @ H) * W).sum()))


def _fro_error(torch, W, W_hat) -> float:
    return float(torch.linalg.norm(W_hat - W) / torch.linalg.norm(W))


def _leaves(obj, prefix="", out=None):
    """Every field of nested dataclasses, lists and tuples, keyed by
    path."""
    out = {} if out is None else out
    if isinstance(obj, (list, tuple)):
        for i, o in enumerate(obj):
            _leaves(o, f"{prefix}.{i}", out)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            _leaves(getattr(obj, f.name), f"{prefix}.{f.name}", out)
    else:
        out[prefix] = obj
    return out


def phase_compress(torch, dev, config):
    """The compression pipeline on the card (phase 11), at ``config``'s
    widths (Llama-2-7B, 2 layers):

    (a) dense params from ``llama.init_params(0)``; full Hessians of every
    projection (``collect_hessians(diag=False)``) over 4 seeded batches of
    2 x 512 tokens;
    (b) ``compress_model`` of layer 0 with LDLQ and layer 1 with RTN (4-bit
    Q, 16-bit rank-128 factors, w4a8 serving), per projection: the eigh at
    its n, one LPLR update, one LDLQ sweep, the total, the relative
    Frobenius and activation-aware errors, each held finite and under the
    0.99 gate; the LDLQ layer's activation-aware error held no worse than
    the same sweep without factors (Q-only) and than the serving grid's
    per-row 4-bit RTN of W, the RTN layer's two errors within
    ``COMPRESS_ROW_RTOL`` of that per-row RTN; the launches of one LDLQ
    sweep at n 4096 as ``torch.profiler`` counts them;
    (c) layer 0's o_proj solved on the card and on the CPU from the same W
    and H, activation-aware errors within ``COMPRESS_CPU_RTOL``;
    (d) layer 1's o_proj with ``serving_quant="e8p"`` (2-bit E8 lattice,
    served as int4 plus a rank-1 offset) through ``apply_linear`` at M 8 and
    1024: the flat W4A8 kernel (row 2) against its plain version;
    (e) ``save_params`` -> ``load_params`` of the compressed model (with
    (d)'s e8p o_proj in layer 1) through a temporary directory, every array
    equal;
    (f) the main path: ``stack_layers`` -> ``fuse_stacked`` ->
    ``quantize_factors_int8_fused`` (the head by ``quantize_linear_int8``),
    8 steps of ``decode_step_fused(staged_kv="uniform", attn_dots="i8",
    attn_kernel="row", proj_kernel="grid")`` at B 8, each with its exact
    launches (rows 3, 11, 9) and every launch against its plain version on
    the same operands (``_CheckCalls``: W4A8 and head bit for bit, the
    attention within phase 2's bound); the logits held within
    ``KERN_REL`` of the plain step fed the kernels' attention outputs,
    within ``COMPRESS_DRIFT_REL`` of the plain step from the same cache
    (``KERN_REL`` where no int8 activation code flipped), the flipped codes
    counted per call;
    (g) one 1024-token ``evaluate_perplexity`` window of the compressed
    unfused model (int8 head): 14 flat W4A8 launches and one int8 head
    launch (rows 2, 9), equal to the plain versions' perplexity; the dense
    model's beside it."""
    import tempfile

    from ee274_convexcaldera_llm_quantization_tpu_torch.calibrate import (
        hessian)
    from ee274_convexcaldera_llm_quantization_tpu_torch.decomp.caldera import (
        CalderaParams, caldera, ldlq_precompute, ldlq_quantize)
    from ee274_convexcaldera_llm_quantization_tpu_torch.evalm import (
        perplexity)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        compressed as CM, fused, llama, stacked, surgery)
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        attention as AT, kernels as K)
    from ee274_convexcaldera_llm_quantization_tpu_torch.quant.quantizers \
        import QuantizerFactory
    from ee274_convexcaldera_llm_quantization_tpu_torch.utils import (
        checkpoint)

    card = _card_line()
    L = config.num_layers
    t_phase = time.perf_counter()

    # (a) the dense model and its Hessians
    t0 = time.perf_counter()
    dense = llama.init_params(0, config, device=dev)
    gen = torch.Generator().manual_seed(13)
    batches = [torch.randint(0, config.vocab_size, (2, 512), generator=gen)
               for _ in range(4)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    hessians = hessian.collect_hessians(dense, batches, config, diag=False)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"compress (a) Llama-2-7B width, {L} layers: dense params in "
          f"{t1 - t0:.2f} s; {len(hessians)} full Hessians (f64) over 4 "
          f"batches of 2 x 512 tokens in {t2 - t1:.2f} s (on {card})",
          flush=True)

    # (b) compress each layer, all 7 projections
    base = dict(Q_bits=4, L_bits=16, R_bits=16, rank=128,
                iters=COMPRESS_ITERS, lplr_iters=1,
                sigma_reg=COMPRESS_SIGMA_REG)
    print(f"compress (b) settings: {base}", flush=True)
    model = dense
    for layer, q_update in ((0, "ldlq"), (1, "rtn")):
        cp = CalderaParams(q_update=q_update, **base)
        ends = []

        def done(name, err):
            torch.cuda.synchronize()
            ends.append(time.perf_counter())

        with _CompressWatch(torch) as watch:
            t0 = time.perf_counter()
            model, report = surgery.compress_model(
                model, cp, hessians=hessians, layer_range=(layer, layer),
                serving_mode="w4a8", progress=done)
        names = list(report.errors)
        if report.skipped or len(report.compressed) != 7:
            raise AssertionError(f"compress (b) layer {layer}: skipped "
                                 f"{report.skipped}")
        prev = t0
        for j, name in enumerate(names):
            proj = name.split(".")[-1]
            W = getattr(dense.layers[layer], proj).w.float()
            H = hessians[name].float()
            W_hat = getattr(model.layers[layer], proj).materialize()
            Wq = watch.q_only[j]
            packed, scales = K.pack_rowscale(W, 4)
            Wrow = (K.unpack_codes(packed, 4).float() - 7) * scales
            lin = getattr(model.layers[layer], proj)
            Lf, Rf = lin.factors()
            LR = lin.global_scale * (Lf.float() @ Rf.float())
            errs = dict(fro=report.errors[name],
                        aa=_aa_error(torch, W, W_hat, H),
                        fro_q=_fro_error(torch, W, Wq),
                        aa_q=_aa_error(torch, W, Wq, H),
                        fro_row=_fro_error(torch, W, Wrow),
                        aa_row=_aa_error(torch, W, Wrow, H))
            lr_share = float(torch.linalg.norm(LR) / torch.linalg.norm(W))
            n_eigh, eigh_ms = watch.ms["eigh"][j]
            lplr_ms = watch.ms["lplr"][j][1]
            ldlq = (f", one LDLQ sweep {watch.ms['ldlq'][j][1]:.1f} ms"
                    if q_update == "ldlq" else "")
            extra = watch.ms["q_only"][j][1] / 1e3
            print(f"compress (b) {name} {tuple(W.shape)} {q_update}: eigh "
                  f"at n {n_eigh} {eigh_ms:.1f} ms, one LPLR update "
                  f"{lplr_ms:.1f} ms{ldlq}; total "
                  f"{ends[j] - prev - extra:.2f} s (and {extra:.2f} s for "
                  f"the Q-only comparison); "
                  f"rel-Frobenius {errs['fro']:.4f} (Q-only "
                  f"{errs['fro_q']:.4f}, per-row RTN {errs['fro_row']:.4f}),"
                  f" activation-aware {errs['aa']:.4f} (Q-only "
                  f"{errs['aa_q']:.4f}, per-row RTN {errs['aa_row']:.4f}); "
                  f"served / per-row RTN: rel-Frobenius "
                  f"{errs['fro'] / errs['fro_row']:.4f}, activation-aware "
                  f"{errs['aa'] / errs['aa_row']:.4f}; |gs L R| / |W| "
                  f"{lr_share:.4f}", flush=True)
            prev = ends[j]
            if q_update == "ldlq":
                # the factors' work: the same sweep and U without them
                # (Q-only, the same per-row grid), and the serving grid's
                # per-row RTN of W, in the error the sweep minimises
                held = (errs["aa"] <= errs["aa_q"]
                        and errs["aa"] <= errs["aa_row"])
            else:
                # the per-row RTN of W - L @ R against that of W
                bound = 1 + COMPRESS_ROW_RTOL
                held = (errs["fro"] <= bound * errs["fro_row"]
                        and errs["aa"] <= bound * errs["aa_row"])
            if not (all(math.isfinite(e) for e in errs.values())
                    and errs["fro"] <= 0.99 and errs["aa"] <= 0.99
                    and held):
                raise AssertionError(f"compress (b) {name}: errors {errs}")
        extra = sum(ms for _, ms in watch.ms["q_only"]) / 1e3
        print(f"compress (b) layer {layer} ({q_update}): "
              f"{ends[-1] - t0 - extra:.1f} s for its 7 projections (and "
              f"{extra:.1f} s for the Q-only comparisons), "
              f"{report.avg_bits_per_param:.4f} bits per parameter (on "
              f"{card})", flush=True)
        del watch, W, H, W_hat, Wq, Wrow, lin, LR
    # the launches of one LDLQ sweep at n 4096 (o_proj of layer 0)
    W = dense.layers[0].o_proj.w.float()
    H = hessians["layers.0.o_proj"].float()
    U = ldlq_precompute(H + COMPRESS_SIGMA_REG * torch.eye(
        H.shape[0], device=dev))
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        ldlq_quantize(W, U, 4)
        torch.cuda.synchronize()
    kernels = sum(1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"compress (b) one LDLQ sweep of layers.0.o_proj "
          f"{tuple(W.shape)} (panels of 256): {kernels} kernel launches "
          f"seen by torch.profiler", flush=True)
    del U

    # (c) layer 0's o_proj on the card and on the CPU
    cp = CalderaParams(q_update="ldlq", **base)
    t0 = time.perf_counter()
    d_card = caldera(cp, W, H, scale_W=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    Wc, Hc = W.cpu(), H.cpu()
    d_cpu = caldera(cp, Wc, Hc, scale_W=False)
    t2 = time.perf_counter()
    e_card = _aa_error(torch, W, d_card.reconstruct(), H)
    e_cpu = _aa_error(torch, Wc, d_cpu.reconstruct(), Hc)
    f_card = _fro_error(torch, W, d_card.reconstruct())
    f_cpu = _fro_error(torch, Wc, d_cpu.reconstruct())
    print(f"compress (c) layers.0.o_proj {tuple(W.shape)} (LDLQ, iters "
          f"{COMPRESS_ITERS}) through caldera: card {t1 - t0:.2f} s, CPU "
          f"({torch.get_num_threads()} threads) {t2 - t1:.2f} s; "
          f"activation-aware error card {e_card:.6f}, CPU {e_cpu:.6f} (rel "
          f"diff {abs(e_card - e_cpu) / e_cpu:.2e}, bound "
          f"{COMPRESS_CPU_RTOL:g}); rel-Frobenius card {f_card:.6f}, CPU "
          f"{f_cpu:.6f}", flush=True)
    if not abs(e_card - e_cpu) <= COMPRESS_CPU_RTOL * e_cpu:
        raise AssertionError("compress (c): the card's solve disagrees "
                             "with the CPU's")
    del d_card, d_cpu, Wc, Hc

    # (d) one projection on the E8 lattice, served by the flat W4A8 kernel
    cp8 = CalderaParams(q_update="rtn", quant_factory_Q=QuantizerFactory(
        method="e8p", block_size="global"), **dict(base, Q_bits=2))
    t0 = time.perf_counter()
    e8, rep8 = surgery.compress_model(
        dense, cp8, hessians=hessians, layer_range=(1, 1),
        proj_filter=("o_proj",), serving_mode="w4a8", serving_quant="e8p")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    lin8 = e8.layers[1].o_proj
    if not (isinstance(lin8, CM.CalderaLinear) and lin8.q_method == "e8p"
            and lin8.L.shape[1] == base["rank"] + 1):
        raise AssertionError(f"compress (d): not an e8p linear: {lin8}")
    W = dense.layers[1].o_proj.w.float()
    H = hessians["layers.1.o_proj"].float()
    aa8 = _aa_error(torch, W, lin8.materialize(), H)
    gen = torch.Generator().manual_seed(14)
    for M in (8, 1024):
        x = torch.randn((M, config.hidden_size), generator=gen).to(dev)
        K.quantized_matmul_w4a8.launches = 0
        y = CM.apply_linear(lin8, x)
        launched = K.quantized_matmul_w4a8.launches
        with _PlainKernels():
            yp = CM.apply_linear(lin8, x)
        e = _rel(torch, y, yp)
        print(f"compress (d) layers.1.o_proj on the E8 lattice (2 bits a "
              f"weight, {rep8.avg_bits_per_param:.4f} bits per parameter "
              f"with the factors): compressed in {t1 - t0:.2f} s, "
              f"rel-Frobenius {rep8.errors['layers.1.o_proj']:.4f}, "
              f"activation-aware {aa8:.4f}; apply_linear at M {M}: "
              f"{launched} flat W4A8 launch, against the plain version on "
              f"the card rel-Frobenius {e:.3e} (bound {KERN_REL:g})",
              flush=True)
        if launched != 1 or not e <= KERN_REL:
            raise AssertionError("compress (d): the e8p linear's kernel "
                                 "disagrees with its plain version")
    del e8, W, H

    # (e) the checkpoint round trip, with (d)'s e8p o_proj in layer 1
    ck = dataclasses.replace(model, layers=[
        model.layers[0], dataclasses.replace(model.layers[1], o_proj=lin8)])
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        checkpoint.save_params(tmp, ck, config)
        t1 = time.perf_counter()
        back, back_config = checkpoint.load_params(tmp, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        size = os.path.getsize(os.path.join(tmp, "params.npz"))
    a, b = _leaves(ck), _leaves(back)
    bad = [k for k in a if not (
        (torch.equal(a[k], b[k]) and a[k].dtype == b[k].dtype
         and a[k].device == b[k].device)
        if isinstance(a[k], torch.Tensor) else a[k] == b[k])]
    print(f"compress (e) save_params -> load_params: {len(a)} leaves, "
          f"params.npz {size / 1e9:.3f} GB, save {t1 - t0:.2f} s, load "
          f"{t2 - t1:.2f} s; {len(a) - len(bad)} of {len(a)} equal",
          flush=True)
    if bad or a.keys() != b.keys() or back_config != config:
        raise AssertionError(f"compress (e): differing leaves {bad}")
    del ck, back, a, b, lin8

    # (f) the main path on the compressed model
    params = fused.quantize_factors_int8_fused(
        fused.fuse_stacked(stacked.stack_layers(model)))
    if not isinstance(params.lm_head, CM.Int8Linear):
        raise AssertionError("compress (f): the head is not int8")
    B, T, steps = 8, 64, 8
    cache = llama.HeadMajorQuantKVCache.create(config, B, T, device=dev)
    tok = torch.randint(0, config.vocab_size, (B,),
                        generator=torch.Generator().manual_seed(15)).to(dev)
    counters = (K.quantized_matmul_w4a8_stacked, AT.flash_decode_q8_staged,
                K.int8_matmul)
    holders = [(fused, "K"), (fused, "AT"), (stacked, "K"), (CM, "K")]
    checks = {"quantized_matmul_w4a8_stacked":
              (K.quantized_matmul_w4a8_stacked_plain, "exact"),
              "flash_decode_q8_staged":
              (AT.flash_decode_q8_staged_plain, "attn"),
              "int8_matmul": (K.int8_matmul_plain, "exact")}
    per_step = (4 * L, L, 1)
    acts = ("quantized_matmul_w4a8_stacked", "int8_matmul")
    worst, worst_replay, worst_call, argmax_rows = 0.0, 0.0, {}, 0

    def step(cache, tok, pos):
        return fused.decode_step_fused(
            params, tok, pos, cache, config, staged_kv="uniform",
            attn_dots="i8", attn_kernel="row", proj_kernel="grid")[0]

    def recording(store):
        def tap(fn, x, *args, **kw):
            store.append(x)
            return fn(x, *args, **kw)
        return tap

    def codes(xs):
        return [K.quantize_activations_int8(x)[0] for x in xs]

    for i in range(steps):
        pos = torch.full((B,), i, dtype=torch.int32, device=dev)
        c_plain, c_replay = _copy_cache(cache, dev), _copy_cache(cache, dev)
        x_plain = []
        with _PlainKernels(), _TapCalls(holders, dict.fromkeys(
                acts, recording(x_plain))):
            lplain = step(c_plain, tok, pos)
        for c in counters:
            c.launches = 0
        with _CheckCalls(torch, holders, checks) as chk:
            logits = step(cache, tok, pos)
        if tuple(chk.calls.values()) != per_step:
            raise AssertionError(f"compress (f) step {i}: checked calls "
                                 f"{chk.calls}")
        got = tuple(c.launches for c in counters)
        if got != per_step or chk.bad:
            raise AssertionError(f"compress (f) step {i}: launches {got} "
                                 f"(expected {per_step}), calls against "
                                 f"their plain versions {chk.bad}")
        # the plain step again, fed the kernels' attention outputs
        attn = iter(chk.outputs["flash_decode_q8_staged"])
        x_replay = []
        with _PlainKernels(), _TapCalls(holders, dict(
                dict.fromkeys(acts, recording(x_replay)),
                flash_decode_q8_staged=lambda fn, *a, **kw: next(attn))):
            lreplay = step(c_replay, tok, pos)
        del c_plain, c_replay
        # every int8 activation quantization of the step in call order: the
        # 4 W4A8 projections of each layer, then the head
        x_kern = [x for name in acts for x in chk.inputs[name]]
        q_kern, q_plain, q_replay = (codes(x_kern), codes(x_plain),
                                     codes(x_replay))
        flips = [int((a != b).sum()) for a, b in zip(q_kern, q_plain)]
        same_replay = all(torch.equal(a, b)
                          for a, b in zip(q_kern, q_replay))
        e = _rel(torch, logits, lplain)
        e_r = _rel(torch, lreplay, logits)
        rows = int((logits.argmax(-1) != lplain.argmax(-1)).sum())
        print(f"compress (f) step {i}: logits against the plain step "
              f"{e:.3e} ({rows} of {B} rows with another argmax), against "
              f"the plain step fed the kernels' attention outputs {e_r:.3e} "
              f"(bound {KERN_REL:g}; its int8 activation codes equal the "
              f"kernel step's: {same_replay}); int8 activation codes that "
              f"differ from the plain step's, per call (layer 0 qkv, o, "
              f"gate/up, down, layer 1 ..., head; of {B} rows): {flips}",
              flush=True)
        worst, worst_replay = max(worst, e), max(worst_replay, e_r)
        argmax_rows += rows
        for name, w in chk.worst.items():
            worst_call[name] = max(worst_call.get(name, 0.0), w)
        if not (e_r <= KERN_REL and same_replay
                and _same_argmax(torch, lreplay, logits)
                and e <= COMPRESS_DRIFT_REL
                and (sum(flips) > 0 or e <= KERN_REL)):
            raise AssertionError(
                f"compress (f) step {i}: logits against the plain step {e} "
                f"(bound {COMPRESS_DRIFT_REL:g}; {KERN_REL:g} with no "
                f"flipped code, flips {flips}), against the replay {e_r} "
                f"(bound {KERN_REL:g}, codes equal {same_replay})")
        tok = logits.argmax(-1)
    print(f"compress (f) the compressed model on the main path "
          f"(decode_step_fused, staged 'uniform', dots i8, row attention, "
          f"grid projections), B {B}, {steps} steps from position 0: "
          f"launches per step w4a8_stacked {per_step[0]}, attention "
          f"{per_step[1]}, int8 head {per_step[2]}; each launch against its "
          f"plain version on the same operands (W4A8 and head bit-equal, "
          f"attention within phase 2's bound): worst rel-Frobenius "
          f"{worst_call}; logits against the plain step fed the kernels' "
          f"attention outputs: worst {worst_replay:.3e} (bound "
          f"{KERN_REL:g}); against the plain step: worst {worst:.3e} "
          f"(bound {COMPRESS_DRIFT_REL:g}, the flipped int8 activation "
          f"codes above), {argmax_rows} of {B * steps} rows with another "
          f"argmax", flush=True)
    del params, cache

    # (g) one perplexity window of the unfused compressed model
    unfused = llama.ModelParams(
        model.embed, model.layers, model.final_norm,
        CM.quantize_linear_int8(model.lm_head))
    stream = torch.randint(0, config.vocab_size, (1024,),
                           generator=torch.Generator().manual_seed(16))
    counters = (K.quantized_matmul_w4a8, K.int8_matmul)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    ppl = perplexity.evaluate_perplexity(unfused, stream.numpy(), config,
                                         window=1024, device=dev)
    t1 = time.perf_counter()
    got = tuple(c.launches for c in counters)
    with _PlainKernels():
        ppl_plain = perplexity.evaluate_perplexity(
            unfused, stream.numpy(), config, window=1024, device=dev)
    ppl_dense = perplexity.evaluate_perplexity(dense, stream.numpy(),
                                               config, window=1024,
                                               device=dev)
    print(f"compress (g) evaluate_perplexity, one 1024-token window: "
          f"compressed {ppl:.4f} ({t1 - t0:.3f} s; launches flat W4A8 "
          f"{got[0]}, int8 head {got[1]}), through the plain versions on "
          f"the card {ppl_plain:.4f}; the dense model {ppl_dense:.4f} "
          f"(random weights: the values show only that it runs)",
          flush=True)
    if got != (7 * L, 1) or ppl != ppl_plain or not math.isfinite(ppl):
        raise AssertionError(f"compress (g): perplexity {ppl} against "
                             f"{ppl_plain}, launches {got}")
    del unfused, model, dense, hessians
    torch.cuda.empty_cache()
    print(f"compress phase: {time.perf_counter() - t_phase:.1f} s (on "
          f"{card})", flush=True)


# Phase 12 (the offline quality pipeline). (a): examples/cli_pipeline_2bit.py
# on the card: TINY trained on a sticky Markov language, then the CLI.
PIPE_TRAIN = dict(steps=400, batch=16, seq=64, lr=3e-3)
# The reference's rows of that flow, CPU runs of the JAX package
# (PERFORMANCE.md, "End-to-end 2-bit quality through the CLI"): quality
# figures, not speeds. name -> (bits/param, perplexity).
PIPE_JAX_ROWS = {"dense (bf16)": (16.000, 57.00),
                 "4-bit uniform rank-16": (7.556, 57.57),
                 "2-bit uniform rank-16": (5.556, 177.39),
                 "2-bit e8p rank-16": (5.667, 59.15)}
# The trained dense model's logits on the card against the CPU's: bf16
# casts of activations that differ by f32 ulps (cuBLAS against CPU sums)
# round the other way now and then; on tiny random models the CPU tests
# read 1.6e-3 to 2.6e-3 between two summation orders (README, the grouped
# path). Bound 5e-3.
PIPE_DENSE_REL = 5e-3
# (d): Convex-CALDERA on one layer of Qwen2-0.5B, f64 on the card; k_proj
# again on the CPU (at the default mu, and at 1e-3, where L is not zero):
# L and R within 1e-8 of ||W||.
CONVEX_CPU_REL = 1e-8
# (g): the SCL baselines' distortions on a 128-row slice, card against CPU:
# the scalar quantizer exactly up to the f32 mean's order, Lloyd-Max and
# K-means from the same first centroids to f32 rounding of the cell sums.
SCL_CPU_RTOL = 1e-4


def _markov_streams(np, seeds_and_lengths):
    """The sticky Markov language of ``examples/cli_pipeline_2bit.py``
    (transition rows Dirichlet(0.05) from seed 0, mixed 0.85 / 0.15 with
    uniform): each stream from its own seed, token by token as the
    example's ``rng.choice(256, p=P[prev])`` draws it (the same uniforms
    through the same normalised cumulative sums, so the same tokens)."""
    P = np.random.default_rng(0).dirichlet(np.full(256, 0.05), size=256)
    P = 0.85 * P + 0.15 / 256
    cdf = np.cumsum(P, axis=1)
    cdf /= cdf[:, -1:]
    out = []
    for seed, n in seeds_and_lengths:
        r = np.random.default_rng(seed)
        toks = np.empty(n, np.int64)
        toks[0] = r.integers(256)
        u = r.random(n - 1)
        for i in range(1, n):
            toks[i] = np.searchsorted(cdf[toks[i - 1]], u[i - 1],
                                      side="right")
        out.append(toks)
    return out


def _on(train, params, dev):
    """``params`` with every tensor copied to ``dev``."""
    return train.replace_leaves(params, {
        k: t.to(dev) for k, t in train.tensor_leaves(params).items()})


def _cli_json(cli, argv):
    """Run the port's CLI; its last JSON line on stdout."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _checked_forward(torch, holders, checks, fn):
    """``fn()`` with every launch named in ``checks`` held against its plain
    version (``_CheckCalls``); returns (output, the checker)."""
    with _CheckCalls(torch, holders, checks) as chk:
        out = fn()
    if chk.bad:
        raise AssertionError(f"launches against their plain versions: "
                             f"{chk.bad}")
    return out, chk


def _pipeline_e2e(torch, dev, tmp, card):
    """Phase 12 (a); returns (the trained dense params, the 4-bit
    checkpoint's directory, a held-out window, a training batch)."""
    import numpy as np

    from ee274_convexcaldera_llm_quantization_tpu_torch import cli
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        compressed as CM, hf_export, llama, train)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
        TINY)
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        kernels as K)
    from ee274_convexcaldera_llm_quantization_tpu_torch.utils import (
        checkpoint)

    t0 = time.perf_counter()
    train_stream, eval_stream = _markov_streams(np, ((10, 200_000),
                                                     (11, 16_384)))
    t1 = time.perf_counter()
    steps, B, S, lr = (PIPE_TRAIN[k] for k in ("steps", "batch", "seq",
                                               "lr"))
    params = llama.init_params(0, TINY, device=dev)
    opt = train.make_optimizer(lr)
    state = train.init_train_state(params, opt)
    losses = []
    for it in range(steps):
        i0 = (it * B * S) % (len(train_stream) - B * S - 1)
        batch = torch.from_numpy(train_stream[i0:i0 + B * S].reshape(B, S))
        params, state, loss = train.train_step(params, state, batch.to(dev),
                                               TINY, opt)
        losses.append(loss)
    losses = [float(v) for v in losses]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"pipeline (a) TINY on the Markov language ({len(train_stream)} "
          f"training tokens from seed 10, made in {t1 - t0:.2f} s): "
          f"{steps} train_steps at B {B}, S {S}, lr {lr:g} in "
          f"{t2 - t1:.2f} s ({1e3 * (t2 - t1) / steps:.2f} ms a step on "
          f"{card}); loss {losses[0]:.4f} -> {losses[steps // 2]:.4f} -> "
          f"{losses[-1]:.4f}", flush=True)
    if not (all(math.isfinite(v) for v in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"pipeline (a): training did not learn: "
                             f"{losses[::50]}")

    hf = os.path.join(tmp, "hf")
    hf_export.save_hf_checkpoint(hf, params, TINY)
    on = ["--device", str(dev)]
    toks = os.path.join(tmp, "eval.npy")
    np.save(toks, eval_stream)
    hess = os.path.join(tmp, "hess.npz")
    t0 = time.perf_counter()
    _cli_json(cli, ["calibrate", "--model", hf, "--num-batches", "8",
                    "--batch-size", "4", "--window", "64", "--output", hess,
                    *on])
    t1 = time.perf_counter()
    dense = _cli_json(cli, ["eval", "--model", hf, "--tokens", toks,
                            "--window", "256", *on])
    t2 = time.perf_counter()
    print(f"pipeline (a) exported the HF directory; cli calibrate "
          f"{t1 - t0:.2f} s, cli eval (dense, 64 windows of 256) "
          f"{t2 - t1:.2f} s", flush=True)
    rows = {"dense (bf16)": (16.0, dense["perplexity"])}
    cks = {}
    for name, bits, squant in (("4-bit uniform rank-16", "4", "uniform"),
                               ("2-bit uniform rank-16", "2", "uniform"),
                               ("2-bit e8p rank-16", "2", "e8p")):
        ck = os.path.join(tmp, name.replace(" ", "_"))
        t0 = time.perf_counter()
        rep = _cli_json(cli, ["compress", "--model", hf, "--hessians", hess,
                              "--q-bits", bits, "--rank", "16", "--iters",
                              "3", "--lplr-iters", "3", "--serving-mode",
                              "w4a8", "--serving-quant", squant,
                              "--output", ck, *on])
        t1 = time.perf_counter()
        ev = _cli_json(cli, ["eval", "--checkpoint", ck, "--tokens", toks,
                             "--window", "256", *on])
        t2 = time.perf_counter()
        print(f"pipeline (a) cli compress {name}: {t1 - t0:.2f} s "
              f"({rep['compressed']} compressed, {rep['skipped']} "
              f"skipped); cli eval --checkpoint {t2 - t1:.2f} s",
              flush=True)
        if rep["skipped"] or rep["compressed"] != 7 * TINY.num_layers:
            raise AssertionError(f"pipeline (a) {name}: {rep}")
        rows[name] = (rep["avg_bits_per_param"], ev["perplexity"])
        cks[name] = ck
    d_ppl, j_ppl = rows["dense (bf16)"][1], PIPE_JAX_ROWS["dense (bf16)"][1]
    print(f"pipeline (a) held-out perplexity (16384 tokens from seed 11, "
          f"windows of 256), the port on {card} beside the JAX package's "
          f"CPU run (PERFORMANCE.md):", flush=True)
    print(f"  {'config':24s} {'bits/param':>10s} {'ppl':>9s} "
          f"{'dlog-ppl':>9s} | {'JAX bits':>8s} {'JAX ppl':>8s} "
          f"{'JAX dlog':>8s}", flush=True)
    for name, (bits, ppl) in rows.items():
        jb, jppl = PIPE_JAX_ROWS[name]
        print(f"  {name:24s} {bits:10.3f} {ppl:9.3f} "
              f"{math.log(ppl) - math.log(d_ppl):+9.4f} | {jb:8.3f} "
              f"{jppl:8.2f} {math.log(jppl) - math.log(j_ppl):+8.4f}",
              flush=True)
    if not all(math.isfinite(p) and p > 1 for _, p in rows.values()):
        raise AssertionError(f"pipeline (a): perplexities {rows}")

    # the card against the CPU on trained weights
    window = torch.from_numpy(eval_stream[:256][None])
    dense_cpu = _on(train, params, "cpu")
    l_card = llama.forward(params, window.to(dev), TINY)
    l_cpu = llama.forward(dense_cpu, window, TINY)
    e_dense = _rel(torch, l_card, l_cpu)
    e8, _ = checkpoint.load_params(cks["2-bit e8p rank-16"], device=dev)
    e8_cpu, _ = checkpoint.load_params(cks["2-bit e8p rank-16"],
                                       device="cpu")
    holders = [(CM, "K")]
    x_card, x_cpu = [], []

    def recording(store):
        def tap(fn, x, *args, **kw):
            store.append(x)
            return fn(x, *args, **kw)
        return tap
    with _TapCalls(holders, {"quantized_matmul_w4a8":
                             recording(x_card)}):
        c_card = llama.forward(e8, window.to(dev), TINY)
    with _TapCalls(holders, {"quantized_matmul_w4a8": recording(x_cpu)}):
        c_cpu = llama.forward(e8_cpu, window, TINY)
    flips = [int((K.quantize_activations_int8(a.cpu())[0]
                  != K.quantize_activations_int8(b)[0]).sum())
             for a, b in zip(x_card, x_cpu)]
    # the CPU forward again, each W4A8 call fed the card's input for it
    fed = iter(x_card)
    with _TapCalls(holders, {"quantized_matmul_w4a8":
                             lambda fn, x, *a, **kw: fn(next(fed).cpu(), *a,
                                                        **kw)}):
        c_replay = llama.forward(e8_cpu, window, TINY)
    e_c, e_r = _rel(torch, c_card, c_cpu), _rel(torch, c_card, c_replay)
    print(f"pipeline (a) one held-out window of 256 tokens, the card's "
          f"logits against the CPU's: trained dense {e_dense:.3e} (bound "
          f"{PIPE_DENSE_REL:g}); 2-bit e8p checkpoint {e_c:.3e} (bound "
          f"{COMPRESS_DRIFT_REL:g} with flipped codes, {SYNC_REL:g} "
          f"without), the CPU fed the card's W4A8 inputs {e_r:.3e} (bound "
          f"{SYNC_REL:g}); int8 activation codes that differ between the "
          f"card's and the CPU's inputs, per W4A8 call (of "
          f"{x_card[0].numel()}): {flips}", flush=True)
    if not (e_dense <= PIPE_DENSE_REL and e_r <= SYNC_REL
            and e_c <= (COMPRESS_DRIFT_REL if sum(flips) else SYNC_REL)
            and len(x_card) == 7 * TINY.num_layers):
        raise AssertionError("pipeline (a): the card's logits disagree "
                             "with the CPU's")
    batch = torch.from_numpy(train_stream[:B * S].reshape(B, S))
    return params, cks["4-bit uniform rank-16"], window, batch


def _pipeline_convex(torch, dev, card):
    """Phase 12 (d): Convex-CALDERA on one layer of Qwen2-0.5B in f64."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.allocate import (
        convex)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
        QWEN2_0_5B)

    c = QWEN2_0_5B
    h, kv, im = c.hidden_size, c.kv_dim, c.intermediate_size
    shapes = {"q_proj": (h, h), "k_proj": (kv, h), "v_proj": (kv, h),
              "o_proj": (h, h), "gate_proj": (im, h), "up_proj": (im, h),
              "down_proj": (h, im)}
    gen = torch.Generator(device=dev).manual_seed(17)
    params = convex.ConvexCalderaParams()
    W_down = torch.randn((h, im), generator=gen, device=dev,
                         dtype=torch.float64)
    torch.linalg.svd(W_down, full_matrices=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.linalg.svd(W_down, full_matrices=False)
    torch.cuda.synchronize()
    svd_s = time.perf_counter() - t0
    print(f"pipeline (d) Convex-CALDERA at Qwen2-0.5B widths (hidden {h}, "
          f"kv_dim {kv}, intermediate {im}), f64 on the card, default "
          f"ConvexCalderaParams (mu {params.mu}, cap "
          f"{params.max_outer_iters} x {params.fista_iters} FISTA "
          f"iterations, not cut); one thin SVD at {h} x {im}: "
          f"{1e3 * svd_s:.1f} ms (on {card})", flush=True)
    svt = convex._svt
    calls = [0]

    def counted(*a, **kw):
        calls[0] += 1
        return svt(*a, **kw)
    t_all = time.perf_counter()
    k_case = None
    try:
        convex._svt = counted
        for name, (m, n) in shapes.items():
            W = torch.randn((m, n), generator=gen, device=dev,
                            dtype=torch.float64) / math.sqrt(n)
            hd = 0.5 + 1.5 * torch.rand((n,), generator=gen, device=dev,
                                        dtype=torch.float64)
            calls[0] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d = convex.convex_caldera(W, hd, params=params, device=dev)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            ratio = d.duality_gap / d.objective_value
            print(f"pipeline (d) {name} {m} x {n}: {calls[0]} FISTA "
                  f"iterations, status {d.solver_status}, duality_gap / "
                  f"objective {ratio:.3e}, effective_rank "
                  f"{d.effective_rank:g}, avg_bit_width "
                  f"{d.avg_bit_width:g}, {dt:.2f} s", flush=True)
            if not (math.isfinite(d.objective_value)
                    and d.solver_status == "optimal" and ratio <= 1e-6):
                raise AssertionError(f"pipeline (d) {name}: not certified")
            if name == "k_proj":
                k_case = (W, hd, d)
    finally:
        convex._svt = svt
    t_dev = time.perf_counter() - t_all
    print(f"pipeline (d) 7 projections in {t_dev:.2f} s on the card",
          flush=True)
    # k_proj on the CPU, with the same settings and with mu 1e-3, where
    # the thresholding keeps singular values and L is not zero
    W, hd, d = k_case
    for mu in (params.mu, 1e-3):
        p = dataclasses.replace(params, mu=mu)
        if mu != params.mu:
            d = convex.convex_caldera(W, hd, params=p, device=dev)
        t0 = time.perf_counter()
        dc = convex.convex_caldera(W.cpu(), hd.cpu(), params=p,
                                   device="cpu")
        t1 = time.perf_counter()
        scale = float(torch.linalg.norm(W))
        eL = float(torch.linalg.norm(d.L_star.cpu() - dc.L_star)) / scale
        eR = float(torch.linalg.norm(d.R_star.cpu() - dc.R_star)) / scale
        print(f"pipeline (d) k_proj at mu {mu:g} on the CPU "
              f"({torch.get_num_threads()} threads) {t1 - t0:.2f} s: L "
              f"{eL:.2e}, R {eR:.2e} of ||W|| from the card's (bound "
              f"{CONVEX_CPU_REL:g}); status {dc.solver_status}, rank "
              f"{dc.effective_rank:g}, bits {dc.avg_bit_width:g}, "
              f"|L| / |W| {float(torch.linalg.norm(dc.L_star)) / scale:.3f}",
              flush=True)
        if not (eL <= CONVEX_CPU_REL and eR <= CONVEX_CPU_REL
                and (dc.solver_status, dc.effective_rank, dc.avg_bit_width)
                == (d.solver_status, d.effective_rank, d.avg_bit_width)):
            raise AssertionError("pipeline (d): the CPU's k_proj disagrees")


def _pipeline_scl(torch, dev, W, card):
    """Phase 12 (g): the SCL baselines on one 4096 x 4096 weight."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.quant import scl

    cases = [("scalar", 2, 1), ("scalar", 4, 1), ("lloyd_max", 2, 1),
             ("lloyd_max", 4, 1), ("vector", 2, 2), ("vector", 4, 2)]
    slice_ = W[:128].cpu()
    for method, bits, dim in cases:
        p = scl.SCLQuantizationParams(num_bits=bits, method=method,
                                      vector_dim=dim)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = scl.scl_quantize(W, p)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rs = scl.scl_quantize(slice_.to(dev), p)
        t1 = time.perf_counter()
        rc = scl.scl_quantize(slice_, p)
        t2 = time.perf_counter()
        rel = abs(rs.distortion - rc.distortion) / rc.distortion
        print(f"pipeline (g) {method} {bits}-bit (vector_dim {dim}) on "
              f"{tuple(W.shape)}: distortion {r.distortion:.6e}, rate "
              f"{r.rate:g}, {dt:.3f} s on {card}; on a 128-row slice card "
              f"{rs.distortion:.6e}, CPU {rc.distortion:.6e} ({t2 - t1:.2f}"
              f" s), rel {rel:.2e} (bound {SCL_CPU_RTOL:g})", flush=True)
        if not (math.isfinite(r.distortion) and rel <= SCL_CPU_RTOL):
            raise AssertionError(f"pipeline (g) {method} {bits}-bit")


def phase_pipeline(torch, dev, config):
    """The offline quality pipeline on the card (phase 12), after phase 11:

    (a) ``examples/cli_pipeline_2bit.py`` through the port: TINY trained on
    the example's Markov language (``train.train_step``, PIPE_TRAIN),
    exported as an HF directory, then ``cli.main`` calibrate, compress at
    4-bit uniform, 2-bit uniform and 2-bit e8p (rank 16, iters 3, w4a8) and
    eval on the held-out stream, beside the JAX rows of PERFORMANCE.md; the
    trained dense model and the 2-bit e8p checkpoint on the card against
    the CPU on one held-out window (the e8p model's W4A8 inputs recorded on
    both, its flipped int8 codes counted, and the CPU replayed with the
    card's inputs);
    (b) ``config``'s dense model (phase 11's: Llama-2-7B widths, 2 layers,
    ``init_params(0)``) exported and imported again, every array equal,
    bytes and seconds; two ``train_step``s at B 2, S 256, peak memory;
    (c) ``compress_model_with_budget`` of layer 0 (B_tot 3.0, menu (2, 4,
    8), w4a8, iters 1): the bits per projection, the average against the
    budget; one decode step of the result (int8 head) with each flat W4A8
    and head launch held to its plain version;
    (d) Convex-CALDERA (f64) on the seven projections of one Qwen2-0.5B
    layer with seeded diagonal Hessians, k_proj on the CPU as well;
    (e) ``qat_finetune``: 3 steps on (a)'s 4-bit model, one on (c)'s layer;
    every global_scale unchanged; each finalized model's forward with its
    W4A8 launches held to the plain version;
    (f) ``compress_model(use_hadamard="servable")`` of (b)'s layer 1 (4-bit
    RTN): one forward, the rotated layers' W4A8 launches held to the plain
    version;
    (g) the SCL baselines at 2 and 4 bits on (b)'s 4096 x 4096 q_proj, and
    on a 128-row slice on the card and the CPU."""
    import tempfile

    from ee274_convexcaldera_llm_quantization_tpu_torch.decomp.caldera import (
        CalderaParams)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        compressed as CM, hf_export, hf_import, llama, qat, surgery, train)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
        TINY)
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        kernels as K)
    from ee274_convexcaldera_llm_quantization_tpu_torch.utils import (
        checkpoint)

    card = _card_line()
    t_phase = time.perf_counter()
    print(f"pipeline cuts: (a) {PIPE_TRAIN['steps']} training steps (the "
          f"example's), (b) Llama-2-7B widths at {config.num_layers} layers "
          f"(depth cut as in phase 11), (c) iters 1 and lplr_iters 1 (the "
          f"CLI default is 5), (e) 3 and 1 QAT steps", flush=True)
    checks_w = {"quantized_matmul_w4a8": (K.quantized_matmul_w4a8_plain,
                                          "exact")}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        tiny, ck4, window, tiny_batch = _pipeline_e2e(torch, dev, tmp, card)
        print(f"pipeline (a) {time.perf_counter() - t0:.1f} s", flush=True)

        # (e), the TINY half: QAT on (a)'s 4-bit model
        q4, _ = checkpoint.load_params(ck4, device=dev)
        t0 = time.perf_counter()
        fin, losses = qat.qat_finetune(q4, tiny_batch.to(dev), TINY, steps=3)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        same = all(torch.equal(getattr(a, p).global_scale,
                               getattr(b, p).global_scale)
                   for a, b in zip(q4.layers, fin.layers)
                   for p in surgery.PROJ_NAMES)
        _, chk = _checked_forward(torch, [(CM, "K")], checks_w,
                                  lambda: llama.forward(fin,
                                                        window.to(dev), TINY))
        print(f"pipeline (e) qat_finetune of (a)'s 4-bit model, 3 steps at "
              f"lr 1e-5 on B {tiny_batch.shape[0]}, S {tiny_batch.shape[1]}:"
              f" {t1 - t0:.2f} s, losses {[round(v, 4) for v in losses]}; "
              f"global_scale unchanged: {same}; the finalized model's "
              f"forward: {chk.calls['quantized_matmul_w4a8']} flat W4A8 "
              f"launches, each bit-equal to the plain version", flush=True)
        if not (same and chk.calls["quantized_matmul_w4a8"]
                == 7 * TINY.num_layers
                and all(math.isfinite(v) for v in losses)):
            raise AssertionError("pipeline (e): TINY QAT")
        del q4, fin, tiny

        # (b) HF round trip at Llama-2-7B widths
        dense = llama.init_params(0, config, device=dev)
        d = os.path.join(tmp, "hf7b")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hf_export.save_hf_checkpoint(d, dense, config)
        t1 = time.perf_counter()
        back, back_config = hf_import.load_hf_checkpoint(d, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        size = os.path.getsize(os.path.join(d, "model.safetensors"))
        a, b = train.tensor_leaves(dense), train.tensor_leaves(back)
        bad = [k for k in a if not (a[k].dtype == b[k].dtype
                                    and torch.equal(a[k], b[k]))]
        print(f"pipeline (b) Llama-2-7B widths, {config.num_layers} layers: "
              f"save_hf_checkpoint {size / 1e9:.3f} GB of f32 in "
              f"{t1 - t0:.2f} s, load_hf_checkpoint onto the card "
              f"{t2 - t1:.2f} s; {len(a) - len(bad)} of {len(a)} arrays "
              f"equal bit for bit", flush=True)
        if bad or a.keys() != b.keys() or back_config != config:
            raise AssertionError(f"pipeline (b): differing arrays {bad}")
        del back, a, b
    opt = train.make_optimizer(1e-4)
    state = train.init_train_state(dense, opt)
    gen = torch.Generator().manual_seed(18)
    toks = torch.randint(0, config.vocab_size, (2, 2, 256), generator=gen)
    torch.cuda.reset_peak_memory_stats()
    tuned, losses = dense, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in toks:
        tuned, state, loss = train.train_step(tuned, state, batch.to(dev),
                                              config, opt)
        losses.append(float(loss))
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"pipeline (b) two train_steps at B 2, S 256 (two batches of "
          f"random tokens): {t1 - t0:.2f} s, "
          f"losses {[round(v, 4) for v in losses]}, peak device memory "
          f"{peak:.2f} GiB (on {card})", flush=True)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("pipeline (b): non-finite loss")
    del tuned, state

    # (c) budgeted compression of layer 0
    cp = CalderaParams(Q_bits=4, L_bits=16, R_bits=16, rank=128, iters=1,
                       lplr_iters=1)
    t0 = time.perf_counter()
    budget, rep, alloc = surgery.compress_model_with_budget(
        dense, cp, 3.0, menu=(2, 4, 8), layer_range=(0, 0),
        serving_mode="w4a8")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    print(f"pipeline (c) compress_model_with_budget, layer 0, B_tot 3.0, "
          f"menu (2, 4, 8): {t1 - t0:.2f} s; bits "
          f"{ {k.split('.')[-1]: int(v) for k, v in alloc.bits.items()} }, "
          f"average {alloc.avg_bits:.4f} of {3.0} (certificate "
          f"{alloc.duality_gap:.3e}); with the factors "
          f"{rep.avg_bits_per_param:.4f} bits per parameter; errors "
          f"{ {k.split('.')[-1]: round(v, 4) for k, v in rep.errors.items()} }",
          flush=True)
    if not (alloc.avg_bits <= 3.0 + 1e-12 and len(rep.compressed) == 7):
        raise AssertionError(f"pipeline (c): {alloc}, {rep.skipped}")
    groups = {g: {alloc.bits[f"layers.0.{p}"] for p in ps} for g, ps in (
        ("qkv", ("q_proj", "k_proj", "v_proj")),
        ("gate/up", ("gate_proj", "up_proj")))}
    served = llama.ModelParams(budget.embed, budget.layers,
                               budget.final_norm,
                               CM.quantize_linear_int8(budget.lm_head))
    B = 8
    prompt = torch.randint(0, config.vocab_size, (B, 16),
                           generator=gen).to(dev)
    cache = llama.KVCache.create(config, B, 32, device=dev)
    logits, cache = llama.prefill(served, prompt, cache, config)
    checks = dict(checks_w, int8_matmul=(K.int8_matmul_plain, "exact"))
    counters = (K.quantized_matmul_w4a8, K.int8_matmul)
    for c in counters:
        c.launches = 0
    (step, _), chk = _checked_forward(
        torch, [(CM, "K")], checks,
        lambda: llama.decode_step(served, logits.argmax(-1), 16, cache,
                                  config))
    got = tuple(c.launches for c in counters)
    print(f"pipeline (c) the budgeted model (layer 0 mixed, layer 1 dense, "
          f"int8 head) on the unfused path, one decode step at B {B}: "
          f"launches flat W4A8 {got[0]}, int8 head {got[1]}, each bit-equal "
          f"to its plain version (worst rel {max(chk.worst.values()):.1e});"
          f" the fused step needs one width per fused group, and the "
          f"allocation gave {groups}", flush=True)
    if got != (7, 1) or not bool(torch.isfinite(step).all()):
        raise AssertionError(f"pipeline (c): launches {got}")
    del served, cache, step

    # (d) Convex-CALDERA
    t0 = time.perf_counter()
    _pipeline_convex(torch, dev, card)
    print(f"pipeline (d) {time.perf_counter() - t0:.1f} s", flush=True)

    # (e), the full-width half: one QAT step on (c)'s layer
    t0 = time.perf_counter()
    fin, losses = qat.qat_finetune(budget, toks[0, :, :128].to(dev),
                                   config, steps=1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    same = all(torch.equal(getattr(budget.layers[0], p).global_scale,
                           getattr(fin.layers[0], p).global_scale)
               for p in surgery.PROJ_NAMES)
    _, chk = _checked_forward(torch, [(CM, "K")], checks_w,
                              lambda: llama.forward(fin, prompt[:1], config))
    print(f"pipeline (e) qat_finetune of (c)'s layer, 1 step at B 2, S 128: "
          f"{t1 - t0:.2f} s, loss {losses[0]:.4f}; global_scale unchanged: "
          f"{same}; the finalized model's forward: "
          f"{chk.calls['quantized_matmul_w4a8']} flat W4A8 launches, each "
          f"bit-equal to the plain version", flush=True)
    if not (same and chk.calls["quantized_matmul_w4a8"] == 7
            and math.isfinite(losses[0])):
        raise AssertionError("pipeline (e): full-width QAT")
    del fin, budget

    # (f) the servable Hadamard basis on layer 1
    cp4 = CalderaParams(Q_bits=4, L_bits=16, R_bits=16, rank=128, iters=1,
                        lplr_iters=1)
    t0 = time.perf_counter()
    rot, rep = surgery.compress_model(
        dense, cp4, layer_range=(1, 1), serving_mode="w4a8",
        use_hadamard="servable")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    errs = {k.split(".")[-1]: round(v, 4) for k, v in rep.errors.items()}
    sides = {p: (getattr(rot.layers[1], p).rot_in,
                 getattr(rot.layers[1], p).rot_out)
             for p in surgery.PROJ_NAMES}
    (logits, chk) = _checked_forward(
        torch, [(CM, "K")], checks_w,
        lambda: llama.forward(rot, prompt[:1], config))
    print(f"pipeline (f) compress_model(use_hadamard='servable'), layer 1, "
          f"4-bit RTN: {t1 - t0:.2f} s, errors {errs}, rotated sides (in, out) {sides}; one forward: "
          f"{chk.calls['quantized_matmul_w4a8']} flat W4A8 launches between "
          f"FWHTs, each bit-equal to the plain version", flush=True)
    if not (len(rep.compressed) == 7 and chk.calls["quantized_matmul_w4a8"]
            == 7 and bool(torch.isfinite(logits).all())):
        raise AssertionError("pipeline (f)")
    del rot, logits

    # (g) the SCL baselines
    t0 = time.perf_counter()
    _pipeline_scl(torch, dev, dense.layers[0].q_proj.w.float(), card)
    print(f"pipeline (g) {time.perf_counter() - t0:.1f} s", flush=True)
    del dense
    torch.cuda.empty_cache()
    print(f"pipeline phase: {time.perf_counter() - t_phase:.1f} s (on "
          f"{card})", flush=True)


# Phase 13 (mixed-width serving and speculative decoding, Llama-2-13B).
# The allocation of scripts/exp_13b_mixed.py:117-128: one group per (layer,
# projection), D(b) = c 2^(-2b) with c 0.1 and k 2 ln 2, weighted by the
# depth's exp(-2l/L) times the projection's sensitivity, under a budget of
# 2.5 grid bits from the menu {2, 3, 4, 8}; rank-128 int8 factors.
MIXED_PROJ_WEIGHT = {"q_proj": 1.0, "k_proj": 1.0, "v_proj": 1.2,
                     "o_proj": 1.5, "gate_proj": 1.0, "up_proj": 1.0,
                     "down_proj": 2.0}
MIXED_BUDGET, MIXED_MENU, MIXED_RANK = 2.5, (2, 3, 4, 8), 128
# The L-fused kernel against its plain version (phase 2's bound): exact
# integer sums, the 128-term factor dots and the f32 epilogue in another
# order.
L_RTOL = 1e-5
# (d) the S-token verify window against S one-token segmented steps from
# the same cache, logits rel-Frobenius per position. The window attends
# through the plain attention, the steps through the staged row kernel (f32
# dots; sums in another order), and an int8 activation or K/V code that
# rounds the other way cascades through the 40 layers (ROADMAP R6).
# Readings on an H100: 4.7e-4 to 5.7e-4 over the five positions.
VERIFY_REL = 2e-3
# (e), (f): a first divergence between the speculative and the plain greedy
# stream must sit on a knife edge (R6): there the plain step's gap between
# its top logit and the logit of the token the speculative stream took is
# under this share of the top logit's height over the row's mean.
MARGIN_REL = 5e-2


def _mixed_shapes(config):
    h, im = config.hidden_size, config.intermediate_size
    return {"q_proj": (config.q_dim, h), "k_proj": (config.kv_dim, h),
            "v_proj": (config.kv_dim, h), "o_proj": (h, config.q_dim),
            "gate_proj": (im, h), "up_proj": (im, h), "down_proj": (h, im)}


def _mixed_allocation(config):
    """The allocator's result and each layer's {projection: grid bits}."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.allocate import (
        multigroup as MG)
    shapes = _mixed_shapes(config)
    groups = []
    for l in range(config.num_layers):
        depth_w = math.exp(-2.0 * l / config.num_layers)
        for name, (m, n) in shapes.items():
            groups.append(MG.GroupSpec(
                name=f"layers.{l}.{name}", num_params=m * n, c=0.1,
                k=2 * math.log(2), weight=MIXED_PROJ_WEIGHT[name] * depth_w))
    alloc = MG.allocate_bits_discrete(groups, B_tot=MIXED_BUDGET,
                                      menu=MIXED_MENU)
    bits = [{name: int(alloc.bits[f"layers.{l}.{name}"]) for name in shapes}
            for l in range(config.num_layers)]
    return alloc, bits


def _mixed_params(torch, dev, config, bits, seed=0):
    """The allocation as a per-layer model in packed form, from a seeded
    generator on the card (codes of the grid's range in its container: a
    3-bit grid's offset codes 4..10 in the 4-bit container, 8-bit codes
    0..254; row scales 1/sqrt(in)/7; rank-128 int8 factors with scales
    0.02/127; an int8 head), bucketed by the port's ``stack_layers_mixed``.
    """
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        llama, mixed as TM)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models.compressed \
        import CalderaLinear, DenseLinear, quantize_linear_int8
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        kernels as K)

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shapes = _mixed_shapes(config)

    def ints(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=gen, dtype=dtype,
                             device=dev)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    def lin(name, grid):
        m, n = shapes[name]
        cont = K.container_bits(grid)
        if grid == 3:
            packed = (ints(4, 11, (m, n // 2), torch.uint8) << 4) | ints(
                4, 11, (m, n // 2), torch.uint8)
        else:
            packed = ints(0, 255 if cont == 8 else 256,
                          (m, n * cont // 8), torch.uint8)
        r = min(MIXED_RANK, m, n)
        return CalderaLinear(
            packed=packed, scales=full((m, 1), 1.0 / n ** 0.5 / 7),
            L=ints(-127, 128, (m, r), torch.int8),
            R=ints(-127, 128, (r, n), torch.int8),
            global_scale=full((), 1.0), L_scale=full((m, 1), 0.02 / 127),
            R_scale=full((r, 1), 0.02 / 127), num_bits=cont, group_size=n,
            out_features=m, in_features=n, mode="w4a8",
            grid_bits=0 if grid == cont else grid)

    h = config.hidden_size

    def normal(shape):
        return (torch.randn(shape, generator=gen, device=dev)
                * 0.02).to(torch.bfloat16)

    layers = [llama.LayerParams(
        attn_norm=full((h,), 1.0), mlp_norm=full((h,), 1.0),
        **{name: lin(name, bits[l][name]) for name in shapes})
        for l in range(config.num_layers)]
    model = llama.ModelParams(
        embed=normal((config.vocab_size, h)), layers=layers,
        final_norm=full((h,), 1.0),
        lm_head=quantize_linear_int8(DenseLinear(
            w=normal((config.vocab_size, h)))))
    return TM.stack_layers_mixed(model)


def _mixed_counters():
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        attention as AT, kernels as K)
    return {"row 3 (w4a8_stacked)": K.quantized_matmul_w4a8_stacked,
            "row 6 (w4a8_l_stacked)": K.quantized_matmul_w4a8_l_stacked,
            "row 11 (flash_decode_q8_staged)": AT.flash_decode_q8_staged,
            "row 10 (flash_decode_q8)": AT.flash_decode_q8,
            "row 9 (int8_matmul)": K.int8_matmul}


def _launches(counters):
    return {name: fn.launches for name, fn in counters.items()}


def _mixed_checks():
    """(holders, checks) for ``_CheckCalls`` on the mixed and speculative
    paths: rows 3 and 9 bit-equal, row 6 within ``L_RTOL``, rows 10 and 11
    to phase 2's attention bound."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        compressed as CM, fused, mixed as TM)
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        attention as AT, kernels as K)
    holders = [(TM, "K"), (TM, "AT"), (fused, "K"), (CM, "K")]
    checks = {"quantized_matmul_w4a8_stacked":
              (K.quantized_matmul_w4a8_stacked_plain, "exact"),
              "quantized_matmul_w4a8_l_stacked":
              (K.quantized_matmul_w4a8_l_stacked_plain, "rel"),
              "flash_decode_q8_staged":
              (AT.flash_decode_q8_staged_plain, "attn"),
              "flash_decode_q8": (AT.flash_decode_q8_plain, "attn"),
              "int8_matmul": (K.int8_matmul_plain, "exact")}
    return holders, checks


def _checked(torch, what, fn):
    """``fn()`` with every launch held to its plain version on the same
    operands (``_mixed_checks``); raises on any failure. Returns (output,
    {kernel: (calls, worst rel-Frobenius)}, the operands' row counts)."""
    holders, checks = _mixed_checks()
    with _CheckCalls(torch, holders, checks) as chk:
        out = fn()
    if chk.bad:
        raise AssertionError(f"{what}: launches against their plain "
                             f"versions: {chk.bad}")
    rows = {n: sorted({x.shape[0] for x in xs if x.dim() == 2})
            for n, xs in chk.inputs.items() if xs}
    return out, {n: (c, chk.worst[n]) for n, c in chk.calls.items() if c}, \
        rows


def _first_divergence(torch, spec_rows, plain_rows, plain_logits):
    """Tokens that agree, and for each row that differs its first differing
    index and the plain step's margin there: its top logit less the logit
    of the speculative stream's token, over the top logit's height above
    the row's mean (raises above ``MARGIN_REL``: no knife edge)."""
    agree, notes = 0, []
    for b, (s, p) in enumerate(zip(spec_rows, plain_rows)):
        n = min(len(s), len(p))
        i = next((j for j in range(n) if s[j] != p[j]), None)
        agree += n if i is None else i
        if i is None:
            continue
        row = plain_logits[b][i].float()
        top = float(row.max())
        margin = (top - float(row[s[i]])) / max(top - float(row.mean()),
                                                1e-30)
        notes.append(f"row {b} first differs at token {i} (margin "
                     f"{margin:.2e})")
        if margin > MARGIN_REL:
            raise AssertionError(f"row {b}: speculative and plain greedy "
                                 f"streams differ at token {i} where the "
                                 f"margin is {margin:.3e}")
    return agree, notes


def _device_busy_ms(torch, fn):
    """Summed device time of the kernels ``fn()`` runs, as torch.profiler
    sees them (CUPTI), and their number; (None, 0) where it sees none."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None, 0
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e3, \
        len(kernels)


def phase_mixed(torch, dev, card):
    """Phase 13: the reference's flagship serving composition
    (``scripts/exp_13b_mixed.py --segmented --fused-segments
    --speculative``) at Llama-2-13B widths, 40 layers, on the port's
    ``models/mixed.py`` and ``serve/speculative.py``; (f) speculative
    serving at Llama-2-7B widths (``serve/spec_engine.py``)."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        llama, mixed as TM)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
        LLAMA2_13B)
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        kernels as K)
    from ee274_convexcaldera_llm_quantization_tpu_torch.serve import (
        speculative as TSP)

    t_phase = time.perf_counter()
    config = LLAMA2_13B
    L, B, T, S0, gamma = config.num_layers, 8, 256, 128, 4
    shapes = _mixed_shapes(config)

    # (a) the allocation, the buckets, the segments and the fused groups
    alloc, bits = _mixed_allocation(config)
    hist = collections.Counter(b for row in bits for b in row.values())
    n_all = sum(m * n for m, n in shapes.values()) * L
    container = sum(K.container_bits(row[name]) * m * n
                    for row in bits for name, (m, n) in shapes.items()) / n_all
    print(f"mixed (a) llama2-13b allocation, budget {MIXED_BUDGET} grid bits "
          f"from {MIXED_MENU}: (layer, projection) groups per width "
          f"{dict(sorted(hist.items()))}, average grid bits "
          f"{alloc.avg_bits:.4f}, container bits {container:.4f}, allocator "
          f"gap {alloc.duality_gap:.3e}", flush=True)
    for name in shapes:
        print(f"  {name}: {[row[name] for row in bits]}", flush=True)
    t0 = time.perf_counter()
    params = _mixed_params(torch, dev, config, bits)
    torch.cuda.synchronize()
    nbytes_params = sum(t.numel() * t.element_size()
                        for t in _leaves(params).values()
                        if isinstance(t, torch.Tensor))
    print(f"mixed (a) params built and bucketed in "
          f"{time.perf_counter() - t0:.1f} s: {nbytes_params / 1e9:.3f} GB "
          f"on the card", flush=True)
    runs = TM.mixed_segments(params.layers, L)

    def sig_text(sig):
        out = []
        for name in shapes:
            b = getattr(params.layers, name).buckets[sig[name]]
            out.append(f"{name[:-5]} {b.num_bits}"
                       + (f"/{b.grid_bits}" if b.grid_bits else ""))
        return ", ".join(out)

    t0 = time.perf_counter()
    prep = TM.prepare_fused_segments(params, config)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    for (s, e, sig), p in zip(runs, prep):
        for fp in (v for v in p.values() if v is not None):
            for t in (fp.packed, fp.scales, fp.R, fp.R_scale, fp.L_cat,
                      fp.L_scale_cat):
                if not t.is_contiguous():
                    raise AssertionError(f"segment {s}-{e}: a fused stack "
                                         "is not contiguous")
        print(f"  segment layers {s}-{e - 1}: buckets {sig}; containers "
              f"(/grid) {sig_text(sig)}; fused: qkv "
              f"{'yes' if p['qkv'] is not None else 'no'}, gate/up "
              f"{'yes' if p['gateup'] is not None else 'no'}", flush=True)
    n_fused = sum((p["qkv"] is not None) + (p["gateup"] is not None)
                  for p in prep)
    print(f"mixed (a) {len(runs)} segments; prepare_fused_segments fused "
          f"{n_fused} of {2 * len(runs)} groups in {prep_s:.1f} s "
          f"(contiguous stacks)", flush=True)

    counters = _mixed_counters()
    cache = llama.HeadMajorQuantKVCache.create(config, B, T, device=dev)
    prompts = torch.randint(1, config.vocab_size, (B, S0),
                            generator=torch.Generator().manual_seed(13)
                            ).to(dev)

    # (c) prefill of a 128-token prompt into each slot
    first, pre_ms = [], []
    for b in range(B):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if b == 0:
            (lg, cache), calls, rows = _checked(
                torch, "mixed (c) prefill", lambda: TM.prefill_into_slot_mixed(
                    params, prompts[:1], 0, cache, config))
        else:
            lg, cache = TM.prefill_into_slot_mixed(
                params, prompts[b:b + 1], b, cache, config)
        torch.cuda.synchronize()
        pre_ms.append(1e3 * (time.perf_counter() - t0))
        got = _launches(counters)
        want = {"row 3 (w4a8_stacked)": 7 * L, "row 9 (int8_matmul)": 1}
        if {k: v for k, v in got.items() if v} != want:
            raise AssertionError(f"mixed (c) prefill {b}: launches {got}")
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError("mixed (c): non-finite logits")
        first.append(lg)
    print(f"mixed (c) prefill_into_slot_mixed, {S0}-token prompts into 8 "
          f"slots: {[f'{m:.1f}' for m in pre_ms]} ms (the first with every "
          f"launch held to its plain version: {calls}, operand rows "
          f"{rows}); launches per prefill: row 3 {7 * L}, row 9 1 (on "
          f"{card})", flush=True)
    tok = torch.stack(first).argmax(-1)
    pos = torch.full((B,), S0, dtype=torch.int32, device=dev)

    # (b) the flagship step: segmented, fused segments, staged, i8 dots
    def step(c, **kw):
        kw = dict(dict(staged_kv=True, fused_prep=prep, attn_dots="i8"), **kw)
        return TM.decode_step_mixed_segmented(params, tok, pos, c, config,
                                              **kw)

    per_step = {"row 3 (w4a8_stacked)": 0, "row 6 (w4a8_l_stacked)": 0,
                "row 11 (flash_decode_q8_staged)": L,
                "row 9 (int8_matmul)": 1}
    for (s, e, _), p in zip(runs, prep):
        for key, n in (("qkv", 3), ("gateup", 2)):
            if p[key] is None:
                per_step["row 3 (w4a8_stacked)"] += n * (e - s)
            else:
                per_step["row 6 (w4a8_l_stacked)"] += e - s
        per_step["row 3 (w4a8_stacked)"] += 2 * (e - s)      # o, down
    for fn in counters.values():
        fn.launches = 0
    c1 = _copy_cache(cache, dev)
    (lk, c1), calls, rows = _checked(torch, "mixed (b) step",
                                     lambda: step(c1))
    got = {k: v for k, v in _launches(counters).items() if v}
    if got != per_step:
        raise AssertionError(f"mixed (b): launches {got}, expected "
                             f"{per_step}")
    c2 = _copy_cache(cache, dev)
    with _PlainKernels():
        lp, c2 = step(c2)
    if _rel(torch, lk, lp) > KERN_REL:
        raise AssertionError(f"mixed (b): the step against the plain "
                             f"versions' step: {_rel(torch, lk, lp):.3e}")
    codes = sum(int((getattr(c1, n) != getattr(c2, n)).sum())
                for n in ("k", "v"))
    worst_code = max(int((getattr(c1, n).int() - getattr(c2, n).int()
                          ).abs().max()) for n in ("k", "v"))
    print(f"mixed (b) decode_step_mixed_segmented B {B} from a {S0}-token "
          f"cache (staged, i8 dots, fused segments): launches per step "
          f"{per_step}; every launch against its plain version: {calls} "
          f"(calls, worst rel), operand rows {rows}; the step against the "
          f"same step on the plain versions, same cache: logits "
          f"rel-Frobenius {_rel(torch, lk, lp):.3e} (bound {KERN_REL}), "
          f"argmax equal in "
          f"{int((lk.argmax(-1) == lp.argmax(-1)).sum())}/{B} rows, "
          f"{codes} K/V codes differ (by at most {worst_code})",
          flush=True)
    del c1, c2
    # the switch path against the segmented path (inline, f32 dots): the
    # same kernels in the same order, bit for bit
    c3, c4 = _copy_cache(cache, dev), _copy_cache(cache, dev)
    for fn in counters.values():
        fn.launches = 0
    la, c3 = TM.decode_step_mixed(params, tok, pos, c3, config)
    lb, c4 = TM.decode_step_mixed_segmented(params, tok, pos, c4, config,
                                            staged_kv=False)
    inline = {k: v for k, v in _launches(counters).items() if v}
    same = bool(torch.equal(la, lb)) and all(
        torch.equal(getattr(c3, f.name), getattr(c4, f.name))
        for f in dataclasses.fields(c3))
    if not same:
        raise AssertionError("mixed (b): the switch path and the inline "
                             "segmented path differ")
    del c3, c4
    print(f"mixed (b) decode_step_mixed (switch) against "
          f"decode_step_mixed_segmented (inline, f32 dots): logits and cache "
          f"bit-equal; launches of the two steps {inline}", flush=True)
    # times: eager (median of 10 steps, host clock to a synchronize) and
    # one step as a CUDA graph (device time)
    ct = _copy_cache(cache, dev)
    times = []
    for i in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(ct)
        torch.cuda.synchronize()
        if i >= 2:
            times.append(1e3 * (time.perf_counter() - t0))
    eager = statistics.median(times)
    dev_ms = _time_ms(torch, lambda i: step(ct), 1, reps=5)
    unfused_ms = _time_ms(torch, lambda i: step(ct, fused_prep=None), 1,
                          reps=5)
    del ct
    # weight bytes one step reads: every projection's codes, row scales,
    # int8 factors and their scales (the fused stacks are copies: counted
    # once), and the int8 head
    wbytes = sum(
        m * n * K.container_bits(row[name]) // 8 + 4 * m
        + min(MIXED_RANK, m, n) * (m + n + 4) + 4 * m
        for row in bits for name, (m, n) in shapes.items())
    wbytes += config.vocab_size * (config.hidden_size + 4)
    kv = (2 * L * B * config.num_kv_heads * (S0 + 1)
          * (config.head_dim + 4))
    bound = 1e3 * wbytes / HBM_BYTES_PER_S
    print(f"mixed (b) step: eager median {eager:.3f} ms ({1e3 * B / eager:.1f}"
          f" tok/s), device {dev_ms:.3f} ms as a CUDA graph (idle "
          f"{1 - dev_ms / eager:.1%} of the eager step); unfused segments "
          f"{unfused_ms:.3f} ms of device time; weight bytes "
          f"{wbytes / 1e9:.3f} GB a step, bound {bound:.3f} ms at 3.35 TB/s "
          f"({bound / dev_ms:.1%} of it), with the K/V read "
          f"{1e3 * (wbytes + kv) / HBM_BYTES_PER_S:.3f} ms (on {card})",
          flush=True)

    _mixed_kernel_times(torch, dev, params, prep, config, cache, pos, card)

    # (d) the verify window (S 5 = gamma + 1) against five segmented steps
    window = torch.cat([tok[:, None], torch.randint(
        1, config.vocab_size, (B, gamma), generator=torch.Generator(
        ).manual_seed(14)).to(dev)], dim=1)
    cv = _copy_cache(cache, dev)
    for fn in counters.values():
        fn.launches = 0
    (vl, cv), vcalls, vrows = _checked(
        torch, "mixed (d) verify", lambda: TSP.verify_step_mixed(
            params, window, pos, cv, config))
    want = {"row 3 (w4a8_stacked)": 7 * L, "row 9 (int8_matmul)": 1}
    if {k: v for k, v in _launches(counters).items() if v} != want:
        raise AssertionError(f"mixed (d): launches {_launches(counters)}")
    cs = _copy_cache(cache, dev)
    seq = []
    for i in range(gamma + 1):
        lg, cs = TM.decode_step_mixed_segmented(params, window[:, i], pos + i,
                                                cs, config)
        seq.append(lg)
    rels = [_rel(torch, vl[:, i], seq[i]) for i in range(gamma + 1)]
    agree = sum(int((vl[:, i].argmax(-1) == seq[i].argmax(-1)).sum())
                for i in range(gamma + 1))
    cols = pos.long()[:, None] + torch.arange(gamma + 1, device=dev)
    rows_b = torch.arange(B, device=dev)[:, None]
    kv_codes = sum(int((getattr(cv, n)[:, rows_b, :, cols]
                        != getattr(cs, n)[:, rows_b, :, cols]).sum())
                   for n in ("k", "v"))
    print(f"mixed (d) verify_step_mixed, S {gamma + 1}, against "
          f"{gamma + 1} segmented steps (staged, f32 dots) from the same "
          f"cache: logits rel-Frobenius per position "
          f"{[f'{r:.3e}' for r in rels]} (bound {VERIFY_REL}), argmax equal "
          f"{agree}/{B * (gamma + 1)}, {kv_codes} K/V codes of the window "
          f"differ; every launch against its plain version: {vcalls}, "
          f"operand rows {vrows}", flush=True)
    if max(rels) > VERIFY_REL:
        raise AssertionError(f"mixed (d): verify against steps {rels}")
    del cv, cs
    cp = _copy_cache(cache, dev)
    _, pcalls, prows = _checked(
        torch, "mixed (d) probe window", lambda: TSP.verify_step_mixed(
            params, window[:, :2], pos, cp, config))
    del cp
    print(f"mixed (d) the adaptive engine's probe window (S 2): every "
          f"launch against its plain version {pcalls}, operand rows {prows}",
          flush=True)
    # row 3 on the 8-bit container (the allocation gives none) at both K
    gen8 = torch.Generator(device=dev)
    gen8.manual_seed(15)
    for N, Kd in ((config.hidden_size, config.hidden_size),
                  (config.hidden_size, config.intermediate_size)):
        packed = torch.randint(0, 255, (2, N, Kd), generator=gen8,
                               dtype=torch.uint8, device=dev)
        sc = torch.full((2, N, 1), 1.0 / Kd ** 0.5 / 7, device=dev)
        for M in (8, 16, 40):
            x = torch.randn((M, Kd), generator=gen8, device=dev)
            if not torch.equal(K.quantized_matmul_w4a8_stacked(
                    x, packed, sc, 1, 8),
                    K.quantized_matmul_w4a8_stacked_plain(
                        x, packed, sc, 1, 8)):
                raise AssertionError(f"row 3, 8-bit, M {M} K {Kd}: not "
                                     "equal to the plain version")
        del packed
    print(f"mixed (d) row 3 on the 8-bit container, N "
          f"{config.hidden_size}, K {config.hidden_size} and "
          f"{config.intermediate_size}, M 8, 16, 40: bit-equal to the plain "
          f"version", flush=True)

    # (e) speculative rounds: the mixed target, a 10-layer truncate_mixed
    # self-draft, gamma 4, greedy
    draft, dcfg = TSP.truncate_draft(params, config, 10)
    dcache = llama.HeadMajorQuantKVCache.create(dcfg, B, T, device=dev)
    for b in range(B):
        _, dcache = TM.prefill_into_slot_mixed(draft, prompts[b:b + 1], b,
                                               dcache, dcfg)
    tc = _copy_cache(cache, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    zeros = torch.zeros((B,), device=dev)
    samp = (zeros, torch.zeros((B,), dtype=torch.int64, device=dev),
            torch.ones((B,), device=dev))
    toks, p = tok, pos
    spec_rows = [[] for _ in range(B)]
    committed, round_ms = [], []
    for fn in counters.values():
        fn.launches = 0
    for r in range(16):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, n_new, toks, p, tc, dcache = TSP.spec_decode_round(
            params, draft, toks, p, tc, dcache, gen, *samp, config, dcfg,
            gamma=gamma)
        n_h = n_new.tolist()
        torch.cuda.synchronize()
        round_ms.append(1e3 * (time.perf_counter() - t0))
        committed.append(n_h)
        for row, o, n in zip(spec_rows, out.tolist(), n_h):
            row.extend(o[:n])
    spec_launches = {k: v for k, v in _launches(counters).items() if v}
    for name in ("row 3 (w4a8_stacked)", "row 11 (flash_decode_q8_staged)",
                 "row 9 (int8_matmul)"):
        if not spec_launches.get(name):
            raise AssertionError(f"mixed (e): {name} never launched")
    busy, n_kernels = _device_busy_ms(torch, lambda: TSP.spec_decode_round(
        params, draft, toks, p, tc, dcache, gen, *samp, config, dcfg,
        gamma=gamma))
    per_round = [sum(n) for n in committed]
    acc = sum(n - 1 for row in committed for n in row) / (16 * B * gamma)
    med = statistics.median(round_ms[1:])
    # the plain greedy stream of the segmented step on the verify's buckets
    # (staged, f32 dots), as far as the rounds went (R16: over the
    # head-major cache the verify window attends through the plain
    # attention and the step through row 11, so only knife-edge differences
    # are allowed)
    c0 = _copy_cache(cache, dev)
    plain_rows, plain_logits = [[] for _ in range(B)], [[] for _ in range(B)]
    t_tok, t_pos = tok, pos
    for i in range(max(len(row) for row in spec_rows)):
        lg, c0 = TM.decode_step_mixed_segmented(params, t_tok, t_pos, c0,
                                                config)
        t_tok, t_pos = lg.argmax(-1), t_pos + 1
        for b in range(B):
            plain_rows[b].append(int(t_tok[b]))
            plain_logits[b].append(lg[b])
    del c0
    agree, notes = _first_divergence(torch, spec_rows, plain_rows,
                                     plain_logits)
    busy_txt = ("not measured (torch.profiler saw no kernels)"
                if busy is None else
                f"{busy:.3f} ms of kernel time over {n_kernels} kernels "
                f"(idle {1 - busy / med:.1%} of the eager round)")
    print(f"mixed (e) spec_decode_round, mixed target, 10-layer "
          f"truncate_mixed draft, gamma {gamma}, greedy, B {B}, 16 rounds: "
          f"committed tokens per round {per_round} (per row "
          f"{committed[0]} ... {committed[-1]}), acceptance {acc:.3f}, "
          f"{sum(per_round)} tokens in {sum(round_ms) / 1e3:.2f} s; eager "
          f"median {med:.1f} ms a round ({sum(per_round) / 16 / B:.2f} "
          f"tokens a row a round, {1e3 * sum(per_round) / sum(round_ms):.1f} "
          f"tok/s) beside (b)'s eager step {eager:.1f} ms "
          f"({1e3 * B / eager:.1f} tok/s); one more round's device time: "
          f"{busy_txt} beside (b)'s step {dev_ms:.3f} ms; launches "
          f"{spec_launches}; "
          f"against the plain greedy stream: {agree} of "
          f"{sum(len(r) for r in spec_rows)} tokens agree"
          + (f"; {'; '.join(notes)}" if notes else ""), flush=True)
    del tc, dcache, draft, prep, params, cache
    torch.cuda.empty_cache()
    _phase_spec_7b(torch, dev, card)
    print(f"mixed phase ran in {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def _mixed_kernel_times(torch, dev, params, prep, config, cache, pos, card):
    """Phase 13's kernels at its own shapes, each launch alone (a CUDA graph
    of launches, weights from device memory) beside its plain version and
    its bound: row 3 at M 8, 16 and 40 on the allocation's containers (2-bit,
    a 3-bit grid in the 4-bit container) at K 5120 and 13824; row 6 on a
    fused segment's qkv and gate/up at M 8; row 9 at M 8 and 40; row 11
    (i8 dots) and row 10 (f32 and i8) at 40 heads over the 128-token
    cache."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        attention as AT, kernels as K)

    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    lp = params.layers

    def bucket(name, grid):
        mp = getattr(lp, name)
        for b in mp.buckets:
            if (b.grid_bits or b.num_bits) == grid:
                return b
        return None

    lines = []
    for name, grid in (("q_proj", 2), ("q_proj", 3), ("gate_proj", 2),
                       ("gate_proj", 3), ("down_proj", 2), ("down_proj", 3)):
        b = bucket(name, grid)
        if b is None:
            continue
        Lk, N, P = b.packed.shape
        Kd = b.in_features
        for M in (8, 16, 40):
            x = torch.randn((M, Kd), generator=gen, device=dev)
            xq, sx = K.quantize_activations_int8(x)
            ms = _time_ms(torch, lambda i: K._launch_w4a8_stacked(
                xq, sx, b.packed, b.scales, i % Lk, b.num_bits), 50)
            plain_ms = _time_ms(torch, lambda i: (
                K.quantized_matmul_w4a8_stacked_plain(
                    x, b.packed, b.scales, i % Lk, b.num_bits)), 2, reps=3)
            bound, by = _bound_ms(M * Kd + M * 4 + N * P + N * 4 + M * N * 4,
                                  2 * M * N * Kd)
            lines.append(f"row 3 {name} ({N} x {Kd}, grid {grid} in the "
                         f"{b.num_bits}-bit container, {Lk} layers) M {M}: "
                         f"{ms:.4f} ms, plain {plain_ms:.4f}, bound "
                         f"{bound:.4f} ({by}; {bound / ms:.1%})")
    for key in ("qkv", "gateup"):
        fp = next((p[key] for p in prep if p[key] is not None), None)
        if fp is None:
            continue
        Lk, N, P = fp.packed.shape
        Kd = config.hidden_size
        x = torch.randn((8, Kd), generator=gen, device=dev)
        xq, sx = K.quantize_activations_int8(x)
        xr = K.thin_xr(x, fp.R[0], fp.R_scale[0])
        args = (fp.L_cat, fp.L_scale_cat, fp.num_bits, fp.ranks[0],
                fp.splits)
        ms = _time_ms(torch, lambda i: K._launch_l(
            xq, sx, fp.packed, fp.scales, i % Lk, xr, *args), 50)
        plain_ms = _time_ms(torch, lambda i: (
            K.quantized_matmul_w4a8_l_stacked_plain(
                x, fp.packed, fp.scales, i % Lk, xr, *args)), 2, reps=3)
        r = fp.ranks[0]
        bound, by = _bound_ms(
            8 * Kd + 32 + N * P + 8 * N + N * r + 8 * len(fp.splits) * r * 4
            + 8 * N * 4, _ops_int8_units(i8=2 * 8 * N * Kd,
                                         bf16=2 * 8 * N * r))
        lines.append(f"row 6 {key} of a fused segment ({N} x {Kd}, "
                     f"{fp.num_bits}-bit container, {Lk} layers) M 8: "
                     f"{ms:.4f} ms, plain {plain_ms:.4f}, bound {bound:.4f} "
                     f"({by}; {bound / ms:.1%})")
    head = params.lm_head
    V, Kd = head.w8.shape
    for M in (8, 40):
        x = torch.randn((M, Kd), generator=gen, device=dev)
        xq, sx = K.quantize_activations_int8(x)
        ms = _time_ms(torch, lambda i: K._launch_int8_matmul(
            xq, sx, head.w8, head.scales), 50)
        plain_ms = _time_ms(torch, lambda i: K.int8_matmul_plain(
            x, head.w8, head.scales), 2, reps=3)
        bound, by = _bound_ms(V * Kd + V * 4 + M * Kd + M * V * 4,
                              2 * M * V * Kd)
        lines.append(f"row 9 head ({V} x {Kd}) M {M}: {ms:.4f} ms, plain "
                     f"{plain_ms:.4f}, bound {bound:.4f} ({by}; "
                     f"{bound / ms:.1%})")
    B, KVH, D = pos.shape[0], config.num_kv_heads, config.head_dim
    G = config.num_heads // KVH
    q = torch.randn((B, KVH, G, D), generator=gen, device=dev)
    kn = torch.randn((B, KVH, D), generator=gen, device=dev)
    vn = torch.randn((B, KVH, D), generator=gen, device=dev)
    Lk, T = cache.k.shape[0], cache.k.shape[3]
    ms = _time_ms(torch, lambda i: AT.flash_decode_q8_staged(
        q, cache.k, cache.v, cache.k_scale, cache.v_scale, kn, vn, i % Lk,
        pos, dots="i8"), 50)
    plain_ms = _time_ms(torch, lambda i: AT.flash_decode_q8_staged_plain(
        q, cache.k, cache.v, cache.k_scale, cache.v_scale, kn, vn, i % Lk,
        pos, dots="i8"), 2, reps=3)
    ctx = int(pos.sum())
    bound, by = _bound_ms(2 * ctx * KVH * (D + 4) + 4 * B * KVH * D * 4,
                          _ops_int8_units(i8=4 * ctx * KVH * G * D))
    lines.append(f"row 11 staged i8, B {B}, {KVH} heads, D {D}, cache of "
                 f"{T} at position {int(pos[0])}: {ms:.4f} ms, plain "
                 f"{plain_ms:.4f}, bound {bound:.4f} ({by}; "
                 f"{bound / ms:.1%})")
    # inline: the cache holds the current token too
    bound, by = _bound_ms(2 * (ctx + B) * KVH * (D + 4) + 2 * B * KVH * D * 4,
                          _ops_int8_units(i8=4 * (ctx + B) * KVH * G * D))
    for dots in ("f32", "i8"):
        ms = _time_ms(torch, lambda i: AT.flash_decode_q8(
            q, cache.k, cache.v, cache.k_scale, cache.v_scale, i % Lk, pos,
            dots=dots), 50)
        plain_ms = _time_ms(torch, lambda i: AT.flash_decode_q8_plain(
            q, cache.k, cache.v, cache.k_scale, cache.v_scale, i % Lk, pos,
            dots=dots), 2, reps=3)
        lines.append(f"row 10 inline {dots}, the same cache (tokens <= "
                     f"{int(pos[0])}): {ms:.4f} ms, plain {plain_ms:.4f}, "
                     f"bound {bound:.4f} ({by}; {bound / ms:.1%})")
    for line in lines:
        print(f"mixed kernels {line} (on {card})", flush=True)

def _phase_spec_7b(torch, dev, card):
    """Phase 13 (f): Llama-2-7B widths, 8 layers, fused params, int8
    token-major caches: speculative generation and serving against plain
    greedy decode and the fast engine."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        fused, llama)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
        LLAMA2_7B)
    from ee274_convexcaldera_llm_quantization_tpu_torch.serve import (
        engine as TE, fast_engine as TFE, spec_engine as TSE,
        speculative as TSP)

    config = dataclasses.replace(LLAMA2_7B, num_layers=8)
    B, S0, N, gamma = 8, 16, 24, 4
    params = _build_fused(config, dev, seed=1)
    draft, dcfg = TSP.truncate_draft(params, config, 2)
    Q = llama.QuantKVCache
    prompts = torch.randint(1, config.vocab_size, (B, S0),
                            generator=torch.Generator().manual_seed(16)
                            ).to(dev)

    # plain greedy, logits kept
    cache = Q.create(config, B, S0 + N + 2 * (gamma + 1), device=dev)
    first = []
    for b in range(B):
        lg, cache = fused.prefill_into_slot_fused(params, prompts[b:b + 1],
                                                  b, cache, config)
        first.append(lg)
    tok = torch.stack(first).argmax(-1)
    pos = torch.full((B,), S0, dtype=torch.int32, device=dev)
    plain_rows = [[t] for t in tok.tolist()]
    plain_logits = [[l] for l in first]
    for _ in range(N - 1):
        lg, cache = fused.decode_step_fused(params, tok, pos, cache, config)
        tok, pos = lg.argmax(-1), pos + 1
        for b in range(B):
            plain_rows[b].append(int(tok[b]))
            plain_logits[b].append(lg[b])
    del cache
    t0 = time.perf_counter()
    spec_rows = TSP.generate_speculative(
        params, draft, prompts, N, config, dcfg, gamma=gamma,
        cache_factory=Q.create, draft_cache_factory=Q.create)
    gen_s = time.perf_counter() - t0
    agree, notes = _first_divergence(torch, spec_rows, plain_rows,
                                     plain_logits)
    print(f"mixed (f) llama2-7b widths, {config.num_layers} layers, fused "
          f"params, int8 token-major caches: generate_speculative (2-layer "
          f"draft, gamma {gamma}, greedy, {B} x {N} tokens, {gen_s:.2f} s) "
          f"against plain greedy decode: {agree}/{B * N} tokens agree"
          + (f"; {'; '.join(notes)}" if notes else ""), flush=True)

    # a perfect draft: the target drafts for itself
    cache = Q.create(config, B, 64, device=dev)
    dcache = Q.create(config, B, 64, device=dev)
    for b in range(B):
        _, cache = fused.prefill_into_slot_fused(params, prompts[b:b + 1],
                                                 b, cache, config)
        _, dcache = fused.prefill_into_slot_fused(params, prompts[b:b + 1],
                                                  b, dcache, config)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    zeros = torch.zeros((B,), device=dev)
    toks, p = torch.stack(first).argmax(-1), torch.full(
        (B,), S0, dtype=torch.int32, device=dev)
    accepted = 0
    for _ in range(4):
        _, n_new, toks, p, cache, dcache = TSP.spec_decode_round(
            params, params, toks, p, cache, dcache, gen, zeros,
            torch.zeros((B,), dtype=torch.int64, device=dev),
            torch.ones((B,), device=dev), config, config, gamma=gamma)
        accepted += int((n_new - 1).sum())
    print(f"mixed (f) perfect draft (the target drafting for itself), 4 "
          f"rounds: accepted {accepted} of {4 * B * gamma} proposed",
          flush=True)
    if accepted < 0.9 * 4 * B * gamma:
        raise AssertionError("mixed (f): the perfect draft was rejected")
    del cache, dcache

    # the engines: 8 greedy requests
    rng = torch.Generator().manual_seed(17)
    reqs = [dict(uid=i, prompt=torch.randint(
        1, config.vocab_size, (int(torch.randint(16, 49, (1,),
                                                 generator=rng)),),
        generator=rng).numpy(), max_new_tokens=N) for i in range(B)]
    out = {}
    for name, make in (
            ("fast", lambda: TFE.FastServingEngine(
                params, config, max_slots=B, max_seq_len=96, kv_int8=True,
                device=dev)),
            ("spec", lambda: TSE.SpeculativeServingEngine(
                params, draft, config, dcfg, gamma=gamma, max_slots=B,
                max_seq_len=96, kv_int8=True, draft_kv_int8=True,
                device=dev))):
        eng = make()
        for r in reqs:
            eng.submit(TE.Request(**r))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[name] = ({c.uid: c.tokens for c in done}, wall, eng)
    (fast, fast_s, _), (spec, spec_s, eng) = out["fast"], out["spec"]
    rows_s = [spec[i] for i in range(B)]
    rows_f = [fast[i] for i in range(B)]
    # each request alone through the plain fused step gives the logits at
    # its first difference
    logits = []
    for i, (s, f) in enumerate(zip(rows_s, rows_f)):
        if s == f:
            logits.append(None)
            continue
        c = Q.create(config, 1, 96, device=dev)
        pr = torch.from_numpy(reqs[i]["prompt"]).to(dev)[None]
        lg, c = fused.prefill_into_slot_fused(params, pr, 0, c, config)
        row, t_pos = [lg], torch.tensor([pr.shape[1]], dtype=torch.int32,
                                        device=dev)
        for t in f[:-1]:
            lg, c = fused.decode_step_fused(
                params, torch.tensor([t], device=dev), t_pos, c, config)
            row.append(lg[0])
            t_pos = t_pos + 1
        logits.append(row)
    agree, notes = _first_divergence(torch, rows_s, rows_f, logits)
    print(f"mixed (f) SpeculativeServingEngine (2-layer draft, gamma "
          f"{gamma}, adaptive, int8 caches) against FastServingEngine, "
          f"{B} greedy requests of {N} tokens: {agree}/{B * N} tokens "
          f"agree" + (f"; {'; '.join(notes)}" if notes else "")
          + f"; spec_rounds {eng.spec_rounds}, accepted_tokens "
          f"{eng.accepted_tokens}, gamma now {eng.gamma_current}; wall "
          f"{spec_s:.2f} s against {fast_s:.2f} s ({B * N / spec_s:.1f} "
          f"against {B * N / fast_s:.1f} tok/s, on {card})", flush=True)


# ---------------------------------------------------------------------------
# Phase 14: tensor- and pipeline-parallel serving (``parallel/``,
# ``serve/tp_engine.py``) and Qwen2-0.5B's whole step
# ---------------------------------------------------------------------------

# (b): one 128-token prompt a row, 16 greedy steps; (d) 8 requests of
# 16-200 prompt tokens, 8 new tokens each
PAR_B, PAR_T, PAR_PROMPT, PAR_STEPS = 8, 256, 128, 16
PAR_NEW = 8
# (c): the pipeline depth, cut from 32 to 8 layers for the phase's time
PAR_PP_LAYERS = 8
PAR_PP_STEPS = 4


def _par_holders():
    """(holders, checks) for ``_CheckCalls`` on the parallel paths: rows 3
    and 9 bit-equal to their plain versions, row 6 within ``L_RTOL``, rows
    11 and 14 to phase 2's attention bound, row 13 to its f32 bound scaled
    to the output."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        compressed as CM, fused, stacked)
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        attention as AT, kernels as K)
    from ee274_convexcaldera_llm_quantization_tpu_torch.serve import paged
    holders = [(fused, "K"), (fused, "AT"), (stacked, "K"), (CM, "K"),
               (paged, "AT")]
    checks = {"quantized_matmul_w4a8_stacked":
              (K.quantized_matmul_w4a8_stacked_plain, "exact"),
              "quantized_matmul_w4a8_l_stacked":
              (K.quantized_matmul_w4a8_l_stacked_plain, "rel"),
              "int8_matmul": (K.int8_matmul_plain, "exact"),
              "flash_decode_q8_staged":
              (AT.flash_decode_q8_staged_plain, "attn"),
              "flash_prefill": (AT.flash_prefill_plain, "scaled"),
              "_flash_decode_q8_paged":
              (AT.flash_decode_q8_paged_plain, "attn")}
    return holders, checks


class _ParChecks:
    """``_CheckCalls`` over the parallel paths that keeps a running total
    (calls, worst rel-Frobenius, failures) and drops the kept operands after
    each block, so a long run holds no activations."""

    def __init__(self, torch):
        self.torch = torch
        self.calls, self.worst, self.bad = {}, {}, []

    def run(self, fn):
        holders, checks = _par_holders()
        with _CheckCalls(self.torch, holders, checks) as chk:
            out = fn()
        for name, n in chk.calls.items():
            if n:
                self.calls[name] = self.calls.get(name, 0) + n
                self.worst[name] = max(self.worst.get(name, 0.0),
                                       chk.worst[name])
        self.bad.extend(chk.bad)
        return out

    def summary(self):
        return {n: (c, self.worst[n]) for n, c in self.calls.items()}


def _par_counts():
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        attention as AT, kernels as K)
    return {"row 3": K.quantized_matmul_w4a8_stacked,
            "row 6": K.quantized_matmul_w4a8_l_stacked,
            "row 9": K.int8_matmul, "row 11": AT.flash_decode_q8_staged,
            "row 13": AT.flash_prefill, "row 14": AT.flash_decode_q8_paged}


def _par_prompts(torch, config, n, lo, hi, seed):
    rng = torch.Generator().manual_seed(seed)
    return [torch.randint(1, config.vocab_size, (int(torch.randint(
        lo, hi + 1, (1,), generator=rng)),), generator=rng)
        for _ in range(n)]


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _par_spec(config, device="cuda", **kw):
    """The sizes of the spawned worlds' runs (picklable): the module's
    constants unless given."""
    return dict(dict(config=config, device=device, B=PAR_B, T=PAR_T,
                     prompt=PAR_PROMPT, steps=PAR_STEPS, new=PAR_NEW,
                     new_lo=16, new_hi=200, pp_steps=PAR_PP_STEPS), **kw)


def _rank_device(torch, spec):
    if spec["device"] == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(spec["device"])


def _par_greedy(torch, dev, step, prefill, prompts, steps):
    """Prefill each row, then ``steps`` greedy steps of ``step(tokens, pos)``
    (B,) from the prompts' ends; returns ([row tokens], [row logits per
    token])."""
    B = len(prompts)
    first = []
    for b, p in enumerate(prompts):
        first.append(prefill(p.to(dev)[None], b))
    tok = torch.stack([lg.argmax(-1) for lg in first])
    rows = [[int(t)] for t in tok]
    logits = [[first[b].float().cpu()] for b in range(B)]
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                       device=dev)
    for _ in range(steps):
        lg = step(tok, pos)
        tok = lg.argmax(-1)
        lc = lg.float().cpu()
        for b in range(B):
            rows[b].append(int(tok[b]))
            logits[b].append(lc[b])
        pos = pos + 1
    return rows, logits


def _time_steps(torch, dev, step, tok, pos, n=4):
    """Median eager ms of ``n`` greedy steps (no checks), then one more
    step's device time through torch.profiler: (eager ms, device ms,
    kernels); no device time off the card."""
    times = []
    for _ in range(n):
        _sync(torch, dev)
        t0 = time.perf_counter()
        lg = step(tok, pos)
        _sync(torch, dev)
        times.append(1e3 * (time.perf_counter() - t0))
        tok, pos = lg.argmax(-1), pos + 1
    if dev.type != "cuda":
        return statistics.median(times), None, 0
    busy, kernels = _device_busy_ms(torch, lambda: step(tok, pos))
    return statistics.median(times), busy, kernels


def _rank_tp2(rank, backend, spec):
    """(b) and (d) on one rank of a tp=2 world: the single-device
    references first, on the full Llama-2-7B params (phase 4's, seed 0),
    then this rank's shard alone (the rest freed), every launch held to its
    plain version."""
    import torch
    from ee274_convexcaldera_llm_quantization_tpu_torch import bench_params
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        fused, llama)
    from ee274_convexcaldera_llm_quantization_tpu_torch.parallel import (
        comm, mesh as pm, tp_fused as TPF)
    from ee274_convexcaldera_llm_quantization_tpu_torch.serve import (
        engine as TE, fast_engine as TFE, paged, tp_engine as TTE)

    dev = _rank_device(torch, spec)
    config, B, T, S = spec["config"], spec["B"], spec["T"], spec["prompt"]
    mesh = pm.make_mesh(1, 2, device_type=dev.type)
    out = dict(rank=rank, backend=backend, device=str(dev))
    sp = bench_params.build_compressed_llama_params(config, num_bits=4,
                                                    rank=128, seed=0,
                                                    device=dev)
    fp = fused.quantize_factors_int8_fused(fused.fuse_stacked(sp))
    prompts = _par_prompts(torch, config, B, S, S, 41)

    # (b) single-device: prefill, greedy steps; the cache before and after
    # the first step kept for the TP step from the same cache
    cache = llama.HeadMajorQuantKVCache.create(config, B, T, device=dev)
    snap = {}

    def prefill1(p, b):
        return fused.prefill_into_slot_fused(fp, p, b, cache, config,
                                             flash=True)[0]

    def step1(tok, pos):
        first = not snap
        if first:
            snap.update(cache=_copy_cache(cache, dev), tok=tok.clone(),
                        pos=pos.clone())
        lg = fused.decode_step_fused(fp, tok, pos, cache, config,
                                     staged_kv="uniform", attn_dots="i8")[0]
        if first:
            snap["after"] = _copy_cache(cache, dev)
        return lg
    rows1, logits1 = _par_greedy(torch, dev, step1, prefill1, prompts,
                                 spec["steps"])
    del cache

    # (d) single-device: FastServingEngine on the requests (the logits of
    # every token kept for the margins), one paged tick on 16-token pages
    class Recording(TFE.FastServingEngine):
        def _start(self, slot, req, logits):
            self.rec.setdefault(req.uid, []).append(logits.float().cpu())
            super()._start(slot, req, logits)

        def _advance(self, logits):
            lc = logits.float().cpu()
            for s, st in self.slots.items():
                self.rec.setdefault(st.req.uid, []).append(lc[s])
            super()._advance(logits)

    reqs = [dict(uid=i, prompt=p.numpy(), max_new_tokens=spec["new"])
            for i, p in enumerate(_par_prompts(
                torch, config, B, spec["new_lo"], spec["new_hi"], 43))]
    eng = Recording(fp, config, max_slots=B, max_seq_len=T, flash_attn=True,
                    device=dev)
    eng.rec = {}
    for r in reqs:
        eng.submit(TE.Request(**r))
    fast = {c.uid: list(c.tokens) for c in eng.run()}
    fast_logits = eng.rec
    del eng
    pages = T // 16
    tables = torch.arange(B * pages, dtype=torch.int32,
                          device=dev).reshape(B, pages)
    pool = paged.PagedQuantKVPool.create(config, B * pages + 1, 16,
                                         device=dev)
    for b, p in enumerate(prompts):
        paged.paged_prefill_fused(fp, p.to(dev)[None], pool, tables[b],
                                  config, flash=True)
    pool_snap = _copy_cache(pool, dev)
    ptok = torch.tensor([rows1[b][0] for b in range(B)], device=dev)
    ppos = torch.full((B,), S, dtype=torch.int32, device=dev)
    paged_ref, pool = paged.paged_decode_step_fused(fp, ptok, ppos, pool,
                                                    tables, config)

    # (b) factor path "l" (row 6 on every projection: the fused groups
    # column-parallel, o and down row-parallel with the global act_scale
    # and the summed xr): the same weights, one single-device step from
    # the cache before (b)'s first step
    fpl = fused.quantize_factors_int8_fused(fused.fuse_stacked(sp),
                                            fuse_factor_kernel="l")
    cache_l = _copy_cache(snap["cache"], dev)
    ref_l = fused.decode_step_fused(fpl, snap["tok"], snap["pos"], cache_l,
                                    config, staged_kv="uniform",
                                    attn_dots="i8")[0]
    tpl = TPF.shard_fused_model_tp(fpl, mesh)
    del fpl

    # this rank's shard; the full params freed
    tpp = TPF.shard_fused_model_tp(fp, mesh)
    tp_engine = TTE.TPServingEngine(sp, config, mesh, max_slots=B,
                                    max_seq_len=T, flash_attn=True,
                                    device=dev)
    del sp, fp
    torch.cuda.empty_cache()
    out["shard_gb"] = sum(t.numel() * t.element_size()
                          for t in _leaves(tpp).values()
                          if isinstance(t, torch.Tensor)) / 1e9
    group = comm.axis_group(mesh, "tp")
    checks = _ParChecks(torch)
    counts = _par_counts()
    for fn in counts.values():
        fn.launches = 0

    # (b) the "l" TP step from the same cache
    c = TPF.shard_headmajor_cache_tp(snap["cache"], mesh)
    lg = checks.run(lambda: TPF.decode_step_fused_tp(
        tpl, snap["tok"], snap["pos"], c, config, mesh, attn_dots="i8")[0])
    out["l_rel"] = _rel(torch, lg, ref_l)
    out["l_argmax"] = _same_argmax(torch, lg, ref_l)
    out["l_codes"] = _code_diff(torch, c,
                                TPF.shard_headmajor_cache_tp(cache_l, mesh))
    out["l_launches"] = {k: f.launches for k, f in counts.items()}
    del c, tpl, cache_l
    torch.cuda.empty_cache()
    for fn in counts.values():
        fn.launches = 0

    # (b) one TP step from the single-device step's cache
    c = TPF.shard_headmajor_cache_tp(snap["cache"], mesh)
    lg = checks.run(lambda: TPF.decode_step_fused_tp(
        tpp, snap["tok"], snap["pos"], c, config, mesh, attn_dots="i8")[0])
    ref = torch.stack([logits1[b][1] for b in range(B)])
    out["synced_rel"] = _rel(torch, lg, ref)
    out["synced_argmax"] = _same_argmax(torch, lg, ref)
    out["synced_codes"] = _code_diff(
        torch, c, TPF.shard_headmajor_cache_tp(snap["after"], mesh))
    del c

    # (b) the TP run alone: prefill each row, greedy steps
    ct = TPF.shard_headmajor_cache_tp(
        llama.HeadMajorQuantKVCache.create(config, B, T, device=dev), mesh)

    def prefill2(p, b):
        return checks.run(lambda: TPF.prefill_into_slot_fused_tp(
            tpp, p, b, ct, config, mesh, flash=True)[0])

    def step2(tok, pos):
        return TPF.decode_step_fused_tp(tpp, tok, pos, ct, config, mesh,
                                        attn_dots="i8")[0]
    rows2, _ = _par_greedy(torch, dev,
                           lambda t, p: checks.run(lambda: step2(t, p)),
                           prefill2, prompts, spec["steps"])
    out["prompt_codes"] = _code_diff(
        torch, _prompt_cols(ct, S),
        _prompt_cols(TPF.shard_headmajor_cache_tp(snap["cache"], mesh), S))
    agree, notes = _first_divergence(torch, rows2, rows1, logits1)
    out["b_launches"] = {k: f.launches for k, f in counts.items()}
    eager, busy, n = _time_steps(
        torch, dev, step2, torch.tensor([r[-1] for r in rows2], device=dev),
        torch.full((B,), S + spec["steps"], dtype=torch.int32, device=dev))
    out["b"] = dict(agree=agree, total=B * (spec["steps"] + 1), notes=notes,
                    eager_ms=eager, device_ms=busy, kernels=n)
    tok_sum = float(sum(sum(r) for r in rows2))
    out["tokens_equal_on_ranks"] = bool(float(comm.all_max(
        torch.tensor([tok_sum], device=dev), group)[0]) == tok_sum == float(
        -comm.all_max(torch.tensor([-tok_sum], device=dev), group)[0]))
    del ct, snap

    # (d) the TP engine on the same requests, then one paged TP tick from
    # the single-device pool
    for fn in counts.values():
        fn.launches = 0
    for r in reqs:
        tp_engine.submit(TE.Request(**r))
    t0 = time.perf_counter()
    done = checks.run(tp_engine.run)
    _sync(torch, dev)
    wall = time.perf_counter() - t0
    tp_tokens = {c.uid: list(c.tokens) for c in done}
    agree, notes = _first_divergence(
        torch, [tp_tokens[i] for i in range(B)], [fast[i] for i in range(B)],
        [fast_logits[i] for i in range(B)])
    out["d"] = dict(agree=agree, total=B * spec["new"], notes=notes,
                    wall=wall)
    tpool = TPF.shard_paged_pool_tp(pool_snap, mesh)
    lp = checks.run(lambda: TPF.paged_decode_step_fused_tp(
        tpp, ptok, ppos, tpool, tables, config, mesh)[0])
    out["d_launches"] = {k: f.launches for k, f in counts.items()}
    out["paged_rel"] = _rel(torch, lp, paged_ref)
    out["paged_argmax"] = _same_argmax(torch, lp, paged_ref)
    out["paged_codes"] = _code_diff(
        torch, tpool, TPF.shard_paged_pool_tp(pool, mesh))
    out["checks"] = checks.summary()
    out["bad"] = checks.bad
    return out


def _prompt_cols(cache, n):
    """The cache's K/V codes of columns < ``n`` (the prompts')."""
    return dataclasses.replace(cache, k=cache.k[:, :, :, :n],
                               v=cache.v[:, :, :, :n])


def _rank_pp(rank, spec):
    """(c) on one rank of a four-rank world: pp=2 (two replicas, mesh
    ("dp", "pp")) and pp=2 x tp=2 (mesh ("pp", "tp")) on ``spec``'s config
    (Llama-2-7B widths cut to a few layers), each against the single-device
    step."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        fused, llama)
    from ee274_convexcaldera_llm_quantization_tpu_torch.parallel import (
        pp as PP)

    dev = _rank_device(torch, spec)
    config, B, T, S = spec["config"], spec["B"], spec["T"], spec["prompt"]
    fp = _build_fused(config, dev, seed=0)
    prompts = _par_prompts(torch, config, B, S, S, 41)
    cache = llama.HeadMajorQuantKVCache.create(config, B, T, device=dev)
    snap = {}

    def prefill1(p, b):
        return fused.prefill_into_slot_fused(fp, p, b, cache, config,
                                             flash=True)[0]

    def step1(tok, pos):
        if not snap:
            snap["cache"] = _copy_cache(cache, dev)
            snap["tok"], snap["pos"] = tok.clone(), pos.clone()
        return fused.decode_step_fused(fp, tok, pos, cache, config,
                                       staged_kv=True, attn_dots="i8")[0]
    rows1, logits1 = _par_greedy(torch, dev, step1, prefill1, prompts,
                                 spec["pp_steps"])
    ref = torch.stack([logits1[b][1] for b in range(B)])
    meshes = {
        "pp=2": (DeviceMesh(dev.type, torch.arange(4).reshape(2, 2).T
                            .contiguous(), mesh_dim_names=("dp", "pp")),
                 None),
        "pp=2 x tp=2": (DeviceMesh(dev.type, torch.arange(4).reshape(2, 2),
                                   mesh_dim_names=("pp", "tp")), "tp")}
    out = dict(rank=rank)
    counts = _par_counts()
    for name, (mesh, tp_axis) in meshes.items():
        if tp_axis is None:
            params = PP.shard_fused_model_pp(fp, mesh)

            def shard_cache(c):
                return PP.shard_kv_cache_pp(c, mesh)
        else:
            params = PP.shard_fused_model_pp_tp(fp, mesh)

            def shard_cache(c):
                return PP.shard_headmajor_cache_pp_tp(c, mesh)
        checks = _ParChecks(torch)
        for fn in counts.values():
            fn.launches = 0
        c = shard_cache(snap["cache"])

        def step(tok, pos):
            return PP.decode_step_fused_pp(params, tok, pos, c, config, mesh,
                                           tp_axis=tp_axis,
                                           attn_dots="i8")[0]
        lg = checks.run(lambda: step(snap["tok"], snap["pos"]))
        synced = lg
        res = dict(synced_rel=_rel(torch, lg, ref),
                   synced_argmax=_same_argmax(torch, lg, ref))
        # the free run: the prompts' K/V from the single-device prefill,
        # then greedy steps through the pipeline
        c = shard_cache(snap["cache"])
        tok, pos = snap["tok"], snap["pos"]
        rows2 = [[rows1[b][0]] for b in range(B)]
        for _ in range(spec["pp_steps"]):
            lg = checks.run(lambda: step(tok, pos))
            tok = lg.argmax(-1)
            for b in range(B):
                rows2[b].append(int(tok[b]))
            pos = pos + 1
        agree, notes = _first_divergence(torch, rows2, rows1, logits1)
        launches = {k: f.launches for k, f in counts.items()}
        if tp_axis is None:
            # where the pipeline's difference from the full step comes
            # from: the single-device step on each microbatch's rows alone
            # (M = B / 2, the stages' M), from the same cache rows
            micro = []
            for m in range(2):
                rows = slice(m * B // 2, (m + 1) * B // 2)
                cm = dataclasses.replace(snap["cache"], **{
                    f.name: getattr(snap["cache"], f.name)[:, rows].clone()
                    for f in dataclasses.fields(snap["cache"])})
                lm = fused.decode_step_fused(
                    fp, snap["tok"][rows], snap["pos"][rows], cm, config,
                    staged_kv=True, attn_dots="i8")[0]
                micro.append(dict(equal=bool(torch.equal(lm, synced[rows])),
                                  rel=_rel(torch, synced[rows], lm)))
                del cm
            res["micro"] = micro
        eager, busy, n = _time_steps(torch, dev, step, tok, pos)
        res.update(agree=agree, total=B * (spec["pp_steps"] + 1), notes=notes,
                   eager_ms=eager, device_ms=busy, kernels=n,
                   checks=checks.summary(), bad=checks.bad,
                   launches=launches)
        out[name] = res
        del params, c
    return out


def _qwen2_step(torch, dev, config=None, S=128):
    """Qwen2-0.5B's whole fused step at full widths (qkv bias, tied head
    made int8, K 896, vocab 151936, GQA 14 x 2, head_dim 64), B 8 from a
    cache of ``S``-token prompts: every launch against its plain version,
    the step against the plain versions' step from the same cache."""
    from ee274_convexcaldera_llm_quantization_tpu_torch import bench_params
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        fused, llama)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
        QWEN2_0_5B)

    config = config or QWEN2_0_5B
    B, T = 8, 2 * S
    sp = bench_params.build_compressed_llama_params(config, num_bits=4,
                                                    rank=128, seed=0,
                                                    device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    lp = sp.layers
    for name in ("q_proj", "k_proj", "v_proj"):
        lin = getattr(lp, name)
        lin.b = 0.02 * torch.randn(lin.packed.shape[:2], generator=gen,
                                   device=dev)
    sp = dataclasses.replace(sp, lm_head=None)          # tied
    fp = fused.quantize_factors_int8_fused(fused.fuse_stacked(sp))
    del sp
    cache = llama.HeadMajorQuantKVCache.create(config, B, T, device=dev)
    prompts = _par_prompts(torch, config, B, S, S, 47)
    checks = _ParChecks(torch)
    for b, p in enumerate(prompts):
        checks.run(lambda: fused.prefill_into_slot_fused(
            fp, p.to(dev)[None], b, cache, config, flash=True))
    tok = torch.randint(0, config.vocab_size, (B,), generator=gen,
                        device=dev)
    pos = torch.full((B,), S, dtype=torch.int32, device=dev)
    plain_cache = _copy_cache(cache, dev)
    lk = checks.run(lambda: fused.decode_step_fused(
        fp, tok, pos, cache, config, staged_kv="uniform",
        attn_dots="i8")[0])
    with _PlainKernels():
        lpl = fused.decode_step_fused(fp, tok, pos, plain_cache, config,
                                      staged_kv="uniform", attn_dots="i8")[0]
    e = _rel(torch, lk, lpl)
    codes, worst = _code_diff(torch, cache, plain_cache)
    print(f"parallel (q) qwen2-0.5b whole fused step ({config.num_layers} "
          f"layers, hidden {config.hidden_size}, qkv bias, tied int8 head "
          f"{config.vocab_size} x {config.hidden_size}), B {B} from "
          f"{S}-token prompts, staged, dots i8: against the plain versions' "
          f"step rel-Frobenius {e:.3e} (bound {KERN_REL:g}), argmax equal "
          f"{_same_argmax(torch, lk, lpl)}, {codes} K/V codes differ (by up "
          f"to {worst}); launches against their plain versions "
          f"{checks.summary()}", flush=True)
    if checks.bad:
        raise AssertionError(f"parallel (q) qwen2-0.5b: {checks.bad}")
    if not (e <= KERN_REL and _same_argmax(torch, lk, lpl)):
        raise AssertionError("parallel (q) qwen2-0.5b: the step disagrees "
                             "with the plain versions")


def _tp1_nccl(torch, dev):
    """(a) A world of one rank on the card over NCCL: the TP step at tp=1
    against ``decode_step_fused`` on phase 4's params and step, bit for
    bit (logits and every cache tensor)."""
    import tempfile

    import torch.distributed as dist
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        fused, llama)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
        LLAMA2_7B)
    from ee274_convexcaldera_llm_quantization_tpu_torch.parallel import (
        bootstrap, mesh as pm, tp_fused as TPF)

    config, B, T = LLAMA2_7B, 8, 256
    work = tempfile.mkdtemp(dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        ok = bootstrap.initialize_distributed(
            "file://" + os.path.join(work, "store"), 1, 0, backend="nccl")
        assert ok and dist.get_backend() == "nccl"
        params = _build_fused(config, dev, seed=0)
        mesh = pm.make_mesh(1, 1)
        tpp = TPF.shard_fused_model_tp(params, mesh)
        c1 = llama.HeadMajorQuantKVCache.create(config, B, T, device=dev)
        c2 = TPF.shard_headmajor_cache_tp(
            llama.HeadMajorQuantKVCache.create(config, B, T, device=dev),
            mesh)
        gen = torch.Generator().manual_seed(4)
        tok = torch.randint(0, config.vocab_size, (B,), generator=gen).to(dev)
        equal = True
        for step in range(4):
            pos = torch.full((B,), step, dtype=torch.int32, device=dev)
            l1, c1 = fused.decode_step_fused(params, tok, pos, c1, config,
                                             staged_kv="uniform",
                                             attn_dots="i8")
            l2, c2 = TPF.decode_step_fused_tp(tpp, tok, pos, c2, config,
                                              mesh, attn_dots="i8")
            equal &= bool(torch.equal(l1, l2)) and all(
                torch.equal(getattr(c1, f.name), getattr(c2, f.name))
                for f in dataclasses.fields(c1))
            tok = l1.argmax(-1)
        print(f"parallel (a) tp=1 over nccl (a world of one on "
              f"{torch.cuda.get_device_name(0)}): decode_step_fused_tp on "
              f"phase 4's step (llama2-7b, 32 layers, B {B}, ctx {T}, dots "
              f"i8), 4 steps: logits and cache bit-equal to "
              f"decode_step_fused: {equal}", flush=True)
        if not equal:
            raise AssertionError("parallel (a): tp=1 differs from the "
                                 "single-device step")
        del params, tpp, c1, c2
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        import shutil
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()


def _print_tp2(tag, res, card):
    for r in res:
        b, d = r["b"], r["d"]
        print(f"parallel {tag} rank {r['rank']} ({r['backend']}, "
              f"{r['device']}; shard {r['shard_gb']:.2f} GB): the step from "
              f"the single-device step's cache rel-Frobenius "
              f"{r['synced_rel']:.3e} (bound {KERN_REL:g}), argmax equal "
              f"{r['synced_argmax']}, {r['synced_codes'][0]} of its K/V "
              f"codes differ (by up to {r['synced_codes'][1]}); the prompts' "
              f"K/V codes against the single-device prefill's: "
              f"{r['prompt_codes'][0]} differ (by up to "
              f"{r['prompt_codes'][1]}; R6 flips of the f32 order of a "
              f"two-partial sum); greedy tokens {b['agree']}/{b['total']} "
              f"equal to "
              f"single-device decode" + (f" ({'; '.join(b['notes'])})"
                                          if b["notes"] else "")
              + f"; launches {r['b_launches']}; eager step median "
              f"{b['eager_ms']:.2f} ms, device time of one step "
              f"{b['device_ms']} ms over {b['kernels']} kernels (two ranks "
              f"time-share one card's SMs: not a scaling figure; {card})",
              flush=True)
        print(f"parallel {tag} rank {r['rank']}, factor path \"l\" (row 6 "
              f"on every projection; o and down row-parallel with the "
              f"global act_scale and the summed xr): the step from the "
              f"single-device step's cache rel-Frobenius {r['l_rel']:.3e} "
              f"(bound {KERN_REL:g}), argmax equal {r['l_argmax']}, "
              f"{r['l_codes'][0]} of its K/V codes differ (by up to "
              f"{r['l_codes'][1]}); launches {r['l_launches']}", flush=True)
        print(f"parallel (d) rank {r['rank']}: TPServingEngine(tp=2, "
              f"flash_attn=True), {PAR_B} requests of 16-200 prompt tokens, "
              f"{PAR_NEW} new each: {d['agree']}/{d['total']} tokens equal "
              f"to FastServingEngine's" + (f" ({'; '.join(d['notes'])})"
                                           if d["notes"] else "")
              + f"; wall {d['wall']:.2f} s with every launch checked; "
              f"launches {r['d_launches']}; the "
              f"paged tp step (16-token pages) from the single-device pool: "
              f"rel-Frobenius {r['paged_rel']:.3e} (bound {KERN_REL:g}), "
              f"argmax equal "
              f"{r['paged_argmax']}, {r['paged_codes'][0]} K/V codes differ; "
              f"every launch against its plain version {r['checks']}",
              flush=True)
        if r["bad"]:
            raise AssertionError(f"parallel {tag}: {r['bad']}")
        if not (r["synced_rel"] <= KERN_REL and r["synced_argmax"]
                and r["l_rel"] <= KERN_REL and r["l_argmax"]
                and r["l_launches"]["row 6"] > 0
                and r["paged_rel"] <= KERN_REL and r["paged_argmax"]
                and r["tokens_equal_on_ranks"]):
            raise AssertionError(f"parallel {tag} rank {r['rank']}: a step "
                                 "disagrees with the single-device step")


def _par_kernel_times(torch, dev, card):
    """Rows 2, 3, 9, 11, 13 and 14 at a tp=2 rank's local shapes
    (Llama-2-7B): each launch against its plain version, its device time
    (a CUDA graph of launches over weights or caches rotated past the L2),
    the plain version's and the bound. PP stages run the single-device
    shapes (phase 2)."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        attention as AT, kernels as K)

    gen = torch.Generator(device=dev).manual_seed(14)
    M = 8
    lines = []

    def report(row, name, out, ref, how, ms, plain_ms, nbytes, ops,
               rate=INT8_OPS_PER_S, lib_ms=None):
        """``how``: "exact" (bit-equal), "i8" (phase 2's i8 decode bound) or
        "f32" (phase 2's f32 bound)."""
        exact = how == "exact"
        ok = (torch.equal(out, ref) if exact
              else _attn_ok(torch, out, ref, how)[0])
        if not ok:
            raise AssertionError(f"parallel (k) {row} {name}: the launch "
                                 "disagrees with its plain version")
        bound, by = _bound_ms(nbytes, ops, rate)
        lines.append(f"row {row} {name}: {ms:.4f} ms, plain {plain_ms:.4f}, "
                     f"bound {bound:.4f} ({by}; {bound / ms:.1%} of it)"
                     + ("" if lib_ms is None else f", library {lib_ms:.4f}")
                     + (", bit-equal" if exact else ""))

    # rows 3 and 2: the W4A8 matmul on the local projections, M 8
    for name, N, Kd in (("qkv", 6144, 4096), ("o", 4096, 2048),
                        ("gate/up", 11008, 4096), ("down", 4096, 5504)):
        Lk = max(2, math.ceil(200e6 / (N * Kd // 2)))
        packed = torch.randint(0, 256, (Lk, N, Kd // 2), generator=gen,
                               dtype=torch.uint8, device=dev)
        scales = torch.rand((Lk, N, 1), generator=gen, device=dev) * 0.01
        x = torch.randn((M, Kd), generator=gen, device=dev)
        nbytes, ops = N * Kd // 2 + N * 4 + M * Kd + M * N * 4, 2 * M * N * Kd
        out = K.quantized_matmul_w4a8_stacked(x, packed, scales, 1, 4)
        ref = K.quantized_matmul_w4a8_stacked_plain(x, packed, scales, 1, 4)
        report(3, f"{name} {N} x {Kd}", out, ref, "exact",
               _time_ms(torch, lambda i: K.quantized_matmul_w4a8_stacked(
                   x, packed, scales, i % Lk, 4), Lk),
               _time_ms(torch, lambda i: K.quantized_matmul_w4a8_stacked_plain(
                   x, packed, scales, i % Lk, 4), 3, reps=3), nbytes, ops)
        if name in ("qkv", "o"):
            # row 2, the flat entry: column-parallel q (2048 rows of 4096),
            # row-parallel o (K 2048)
            n2 = 2048 if name == "qkv" else N
            flat = [packed[i, :n2].contiguous() for i in range(Lk)]
            fsc = [scales[i, :n2].contiguous() for i in range(Lk)]
            out = K.quantized_matmul_w4a8(x, flat[0], fsc[0], 4)
            ref = K.quantized_matmul_w4a8_plain(x, flat[0], fsc[0], 4)
            report(2, f"{'q' if name == 'qkv' else 'o'} {n2} x {Kd}", out,
                   ref, "exact",
                   _time_ms(torch, lambda i: K.quantized_matmul_w4a8(
                       x, flat[i % Lk], fsc[i % Lk], 4), Lk),
                   _time_ms(torch, lambda i: K.quantized_matmul_w4a8_plain(
                       x, flat[i % Lk], fsc[i % Lk], 4), 3, reps=3),
                   n2 * Kd // 2 + n2 * 4 + M * Kd + M * n2 * 4,
                   2 * M * n2 * Kd)
        del packed, scales
    # row 9: the vocab-sharded int8 head, 16000 x 4096
    V, Kd, Lk = 16000, 4096, 4
    w8 = [torch.randint(-127, 128, (V, Kd), generator=gen, dtype=torch.int8,
                        device=dev) for _ in range(Lk)]
    sc = [torch.rand((V, 1), generator=gen, device=dev) * 0.01
          for _ in range(Lk)]
    x = torch.randn((M, Kd), generator=gen, device=dev)
    report(9, f"head {V} x {Kd}", K.int8_matmul(x, w8[0], sc[0]),
           K.int8_matmul_plain(x, w8[0], sc[0]), "exact",
           _time_ms(torch, lambda i: K.int8_matmul(x, w8[i % Lk],
                                                   sc[i % Lk]), Lk),
           _time_ms(torch, lambda i: K.int8_matmul_plain(
               x, w8[i % Lk], sc[i % Lk]), 3, reps=3),
           V * Kd + V * 4 + M * Kd + M * V * 4, 2 * M * V * Kd)
    del w8, sc
    # row 11: staged decode over 16 heads, B 8, T 256 from position 128, i8
    B, KVH, D, T, Lk = 8, 16, 128, 256, 24
    q = torch.randn((B, KVH, 1, D), generator=gen, device=dev)
    kc, vc = (torch.randint(-127, 128, (Lk, B, KVH, T, D), generator=gen,
                            dtype=torch.int8, device=dev) for _ in range(2))
    ks, vs = (torch.rand((Lk, B, KVH, T), generator=gen, device=dev) * 0.02
              for _ in range(2))
    kn, vn = (torch.randn((B, KVH, D), generator=gen, device=dev)
              for _ in range(2))
    pos = torch.full((B,), 128, dtype=torch.int32, device=dev)
    live = B * 128
    report(11, f"staged {KVH} heads B {B} T {T} pos 128 i8",
           AT.flash_decode_q8_staged(q, kc, vc, ks, vs, kn, vn, 0, pos,
                                     dots="i8"),
           AT.flash_decode_q8_staged_plain(q, kc, vc, ks, vs, kn, vn, 0, pos,
                                           dots="i8"), "i8",
           _time_ms(torch, lambda i: AT.flash_decode_q8_staged(
               q, kc, vc, ks, vs, kn, vn, i % Lk, pos, dots="i8"), Lk),
           _time_ms(torch, lambda i: AT.flash_decode_q8_staged_plain(
               q, kc, vc, ks, vs, kn, vn, i % Lk, pos, dots="i8"), 3, reps=3),
           KVH * live * (2 * D + 8) + 4 * B * KVH * D * 4,
           4 * live * KVH * D)
    del kc, vc, ks, vs
    # row 13: flash prefill of a 128-token prompt on 16 heads, beside SDPA
    S = 128
    qp, kp, vp = (torch.randn((1, S, KVH, D), generator=gen, device=dev)
                  for _ in range(3))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = _time_ms(torch, lambda i: sdpa(
        qp.transpose(1, 2), kp.transpose(1, 2), vp.transpose(1, 2),
        is_causal=True), 10)
    report(13, f"prefill S {S}, {KVH} heads", AT.flash_prefill(qp, kp, vp),
           AT.flash_prefill_plain(qp, kp, vp), "f32",
           _time_ms(torch, lambda i: AT.flash_prefill(qp, kp, vp), 10),
           _time_ms(torch, lambda i: AT.flash_prefill_plain(qp, kp, vp), 3,
                    reps=3),
           4 * S * KVH * D * 4, 2 * 2 * KVH * D * S * (S + 1) / 2 * 3,
           rate=TF32_OPS_PER_S, lib_ms=lib_ms)
    # row 14: paged decode, 16-token pages, 16 heads, ~2048 tokens a row
    P, ctx, Lk = 16, 2048, 2
    ppos = torch.tensor([0, 300, 777, 1024, 1500, 1801, 2047, 2048],
                        dtype=torch.int32, device=dev)
    NP = B * (ctx // P) + 8
    k, v = (torch.randint(-127, 128, (Lk, NP, KVH, P, D), generator=gen,
                          dtype=torch.int8, device=dev) for _ in range(2))
    ks, vs = (torch.rand((Lk, NP, KVH, P), generator=gen, device=dev) * 0.02
              for _ in range(2))
    tables = torch.randperm(NP, generator=torch.Generator().manual_seed(P))[
        :B * (ctx // P)].reshape(B, ctx // P).to(device=dev,
                                                  dtype=torch.int32)
    args = (q, k, v, ks, vs, kn, vn)
    live = int(ppos.sum())
    report(14, f"paged {KVH} heads B {B} 16-token pages ~{ctx} tokens i8",
           AT.flash_decode_q8_paged(*args, 1, tables, ppos, dots="i8"),
           AT.flash_decode_q8_paged_plain(*args, 1, tables, ppos, dots="i8"),
           "i8",
           _time_ms(torch, lambda i: AT._flash_decode_q8_paged(
               *args, i % Lk, tables, ppos, dots="i8"), 50),
           _time_ms(torch, lambda i: AT.flash_decode_q8_paged_plain(
               *args, i % Lk, tables, ppos, dots="i8"), 3, reps=3),
           KVH * live * (2 * D + 8) + 4 * B * KVH * D * 4,
           4 * live * KVH * D)
    print(f"parallel (k) kernels at a tp=2 rank's local shapes (llama2-7b, "
          f"M {M}; {card}):\n  " + "\n  ".join(lines), flush=True)


def phase_parallel(torch, dev, card):
    """Phase 14: tensor- and pipeline-parallel serving, last. (q)
    Qwen2-0.5B's whole step; (a) tp=1 over NCCL in this process; then
    spawned worlds (``parallel.bootstrap.launch``, after the build, so no
    two ranks build one library): (b) and (d) tp=2, two gloo ranks sharing
    the card (NCCL refuses two ranks on one device); (c) pp=2 and pp=2 x
    tp=2, four gloo ranks on the card, depth cut to ``PAR_PP_LAYERS``; (e)
    (b) over NCCL, one rank a card, where there are two cards. (k) times
    the kernels at the local shapes in this process."""
    import tempfile

    from ee274_convexcaldera_llm_quantization_tpu_torch.parallel import (
        bootstrap)

    t_phase = time.perf_counter()
    _qwen2_step(torch, dev)
    torch.cuda.empty_cache()
    _tp1_nccl(torch, dev)
    _par_kernel_times(torch, dev, card)
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))

    def world(fn, n, args, backend):
        work = tempfile.mkdtemp(dir=root)
        try:
            return bootstrap.launch(fn, n, work, args=args, backend=backend,
                                    timeout=600)
        finally:
            import shutil
            shutil.rmtree(work, ignore_errors=True)

    from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
        LLAMA2_7B)
    spec = _par_spec(LLAMA2_7B)
    t0 = time.perf_counter()
    res = world(_rank_tp2, 2, ("gloo", spec), "gloo")
    print(f"parallel (b)/(d) world of 2 gloo ranks on one card: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    _print_tp2("(b)", res, card)
    t0 = time.perf_counter()
    res = world(_rank_pp, 4, (_par_spec(dataclasses.replace(
        LLAMA2_7B, num_layers=PAR_PP_LAYERS)),), "gloo")
    for r in res:
        for name in ("pp=2", "pp=2 x tp=2"):
            c = r[name]
            print(f"parallel (c) {name} rank {r['rank']} (llama2-7b widths, "
                  f"depth cut 32 -> {PAR_PP_LAYERS} layers, B {PAR_B}, "
                  f"staged, dots i8): the step from the single-device "
                  f"step's cache rel-Frobenius {c['synced_rel']:.3e} (bound "
                  f"{KERN_REL:g}), argmax equal {c['synced_argmax']}; "
                  f"greedy tokens {c['agree']}/{c['total']} equal"
                  + (f" ({'; '.join(c['notes'])})" if c["notes"] else "")
                  + (f"; each microbatch's logits against the single-"
                     f"device step on its {PAR_B // 2} rows alone: "
                     + ", ".join(f"bit-equal {x['equal']} (rel "
                                 f"{x['rel']:.3e})" for x in c["micro"])
                     if "micro" in c else "")
                  + f"; launches {c['launches']}; every launch against its "
                  f"plain version {c['checks']}; eager step median "
                  f"{c['eager_ms']:.2f} ms, device {c['device_ms']} ms over "
                  f"{c['kernels']} kernels (four ranks time-share one card; "
                  f"{card})", flush=True)
            if c["bad"]:
                raise AssertionError(f"parallel (c) {name}: {c['bad']}")
            if not (c["synced_rel"] <= KERN_REL and c["synced_argmax"]):
                raise AssertionError(f"parallel (c) {name} rank {r['rank']}:"
                                     " the step disagrees with the "
                                     "single-device step")
    print(f"parallel (c) world of 4 gloo ranks: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if torch.cuda.device_count() >= 2:
        res = world(_rank_tp2, 2, ("nccl", spec), "nccl")
        _print_tp2("(e)", res, card)
    else:
        print(f"parallel (e) did not run: NCCL tp=2 needs two cards, this "
              f"machine has {torch.cuda.device_count()}", flush=True)
    print(f"parallel phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ee274_convexcaldera_llm_quantization_tpu_torch._device import (
        resolve_device)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
        LLAMA2_7B)
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import _build

    dev = resolve_device("cuda")
    card = _card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s wall "
          f"({', '.join(f'{n} {s:.1f} s' for n, s in secs.items())})",
          flush=True)
    for name in _build.ENTRIES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    src = "ee274_convexcaldera_llm_quantization_tpu_torch/ops/csrc/"
    ref = "ee274_convexcaldera_llm_quantization_tpu/ops/"
    record = {
        "w4a8_stacked": dict(source=src + "w4a8_stacked.cu",
                             replaces=ref + "kernels.py:560"),
        "flash_decode_q8_staged": dict(source=src + "flash_decode.cu",
                                       replaces=ref + "attention.py:304"),
        "int8_matmul": dict(source=src + "int8_matmul.cu",
                            replaces=ref + "kernels.py:1448"),
        "flash_prefill": dict(source=src + "flash_prefill.cu",
                              replaces=ref + "attention.py:632"),
        "flash_decode_q8_ab": dict(source=src + "flash_decode_split.cu",
                                   replaces=ref + "attention.py:506"),
        "flash_decode_q8": dict(source=src + "flash_decode.cu",
                                replaces=ref + "attention.py:155"),
        "quantized_matmul": dict(source=src + "grouped_matmul.cu",
                                 replaces=ref + "kernels.py:222"),
        "quantized_matmul_w4a8": dict(source=src + "w4a8_stacked.cu",
                                      replaces=ref + "kernels.py:460"),
        "flash_decode_q8_paged": dict(source=src + "flash_decode_split.cu",
                                      replaces=ref + "attention.py:761"),
        "quantized_matmul_w4a8_l_stacked": dict(
            source=src + "w4a8_lowrank.cu", replaces=ref + "kernels.py:1021"),
        "quantized_matmul_w4a8_lr_stacked": dict(
            source=src + "w4a8_lowrank.cu", replaces=ref + "kernels.py:870"),
        "quantized_matmul_w4a8_mlp_stacked": dict(
            source=src + "w4a8_lowrank.cu", replaces=ref + "kernels.py:1252"),
        "flash_decode_attn_o": dict(source=src + "attn_o.cu",
                                    replaces=ref + "attention.py:1066"),
        "quantized_matmul_w4a8_stacked_persistent": dict(
            source=src + "w4a8_stacked.cu", replaces=ref + "kernels.py:689"),
        "bf16_matmul_stacked": dict(source=src + "bf16_gemm.cu",
                                    replaces=ref + "kernels.py:1382"),
        "megastep": dict(source=src + "megastep.cu",
                         replaces=ref + "megastep.py:590"),
    }
    measured = ("launches", "launches_per_step", "steps", "max_abs_err",
                "ms", "plain_ms", "bound_ms", "bound_by")
    for r in record.values():
        r.update(dict.fromkeys(measured), library_ms=None)
    t_run = time.perf_counter()
    phase_kernels(torch, dev, record)
    phase_width(torch, dev)
    params = phase_full(torch, dev, record)
    phase_gqa(torch, dev)
    phase_serving(torch, dev, params, record)
    phase_paged(torch, dev, params, record)
    phase_proj_dots(torch, dev, params, record)
    del params
    torch.cuda.empty_cache()
    phase_options(torch, dev, record)
    torch.cuda.empty_cache()
    phase_unfused(torch, dev, record)
    torch.cuda.empty_cache()
    phase_compress(torch, dev,
                   dataclasses.replace(LLAMA2_7B, num_layers=2))
    torch.cuda.empty_cache()
    phase_pipeline(torch, dev,
                   dataclasses.replace(LLAMA2_7B, num_layers=2))
    torch.cuda.empty_cache()
    phase_mixed(torch, dev, card)
    torch.cuda.empty_cache()
    phase_parallel(torch, dev, card)

    for name, r in record.items():
        missing = [k for k in measured if r[k] is None]
        if missing:
            raise AssertionError(f"{name}: {missing} not measured")
    # library_ms: one SDPA call for flash_prefill (f32, causal); for
    # quantized_matmul, one bf16 torch.matmul on its weights dequantized
    # beforehand; for bf16_matmul_stacked, one bf16 torch.matmul on its
    # operands; for the W4A8 kernels (grid, flat and persistent launches) and
    # int8_matmul, one torch._int_mm on int8 weights (the W4A8 codes unpacked
    # to u - maxq beforehand) plus the rescale, where _int_mm takes the
    # record's M (null where it refuses it). No single PyTorch call computes
    # the other functions (the int8 low-rank factors and the MLP's
    # requantization fused in; attention over an int8 cache with per-token
    # scales, or over an int8 pool through a page table, and int8
    # probabilities in dots="i8"; a whole decode step of those in one
    # launch), so theirs is null.
    kernels = [dict(name=name, route="cuda", source=r["source"],
                    replaces=r["replaces"],
                    **{k: r[k] for k in measured},
                    library_ms=r["library_ms"],
                    **{k: r[k] for k in ("ctas", "ctas_per_sm", "ptxas",
                                         "at_m") if k in r})
               for name, r in record.items()]
    print(f"all phases ran in {time.perf_counter() - t_run:.1f} s after the "
          f"build", flush=True)
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
