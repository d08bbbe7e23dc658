#!/usr/bin/env python3
"""Drive the PyTorch port (W4A8 decode, prefill, the serving engines and the
unfused compressed-model path) on one NVIDIA GPU.

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
   f32, the larger): the W4A8 matmul at decode's M = 8 and prefill's M =
   512 and 2048; flash prefill at S = 512, 2048, a ragged 300 and a GQA
   shape, beside one SDPA call; the all-batch decode kernel, staged and
   inline, over a 4096-token cache at ragged positions; the inline and
   staged row decode kernels and the int8 head at the bench shape; the
   grouped bf16 matmul (bound: 989 TFLOP/s bf16 or bytes; beside one bf16
   torch.matmul on its weights dequantized beforehand) and the flat W4A8
   matmul at Llama-2-7B's three projection shapes, M = 8 and 512; the paged
   decode kernel at Llama-2-7B's heads, batch 8, over a randomly permuted
   page table of about 2048 tokens per row at ragged positions, pages of 16
   and 256 tokens, beside the staged kernel over the same context.
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
   one step replayed as a CUDA graph.
5. Serving, Llama-2-7B, 32 layers, on ``FastServingEngine(flash_attn=True,
   max_slots=8)``: 16 seeded requests (16 to 1500 prompt tokens, 32 new
   tokens, greedy and sampled rows) at max_seq_len 4096, which decodes with
   the all-batch kernel; then 8 requests on the inline path at 512, which
   decodes with the inline row kernel. Every prefill and decode tick is
   checked for its exact launches, and the first prefill against the plain
   versions on the card; prints the prefill ms per bucket, the median
   decode tick, tokens/s and wall time.
6. The unfused path, Llama-2-7B, 32 layers (``phase_unfused``): (a) the
   grouped ``stacked.decode_step_batched`` at batch 8, context 256, 32
   steps (224 grouped launches each); (d) ``evaluate_perplexity`` on one
   1024-token window; (b) ``ServingEngine`` on w4a8 params (224 flat W4A8
   launches and the head per prefill and tick); (c) the unfused
   ``FastServingEngine`` on the same params, bf16 cache (greedy tokens
   equal to (b)'s) and int8 cache.
7. Paged serving, Llama-2-7B, 32 layers, on phase 4's params (run before
   phase 6, which builds its own): (a) the paged fused step with identity
   page tables and 256-token pages against the staged fused step, batch 8
   from eight prefilled prompts: identical logits and K/V codes; (b)
   ``PagedServingEngine(flash_attn=True, max_slots=8, page_size=16)`` on 24
   seeded requests (prompts of 64-256 tokens, 16-48 new tokens, some
   sampled) over a pool too small for all of them at once (sized by a dry
   run of the native scheduler), every prefill and tick checked for its
   exact launches, the first prefill and tick against the plain versions;
   (c) the same engine with the prefix cache, 8 requests sharing a
   256-token prefix; (d) ``ServingHTTPServer`` over the paged engine on
   127.0.0.1: 8 concurrent completions, one streamed, and the health and
   stats endpoints.

Before the last line it prints the kernel table as one JSON object, each
number measured in this run: ``launches`` counts the main path of the
kernel's slice, with every count set to 0 just before it (phase 4's decode
run for the W4A8, staged attention and int8 head kernels; phase 5 (a) for
flash prefill and the all-batch kernel, 5 (b) for the inline kernel; phase
6 (a) for the grouped kernel, 6 (b) for the flat W4A8 kernel, 7 (b) for
the paged kernel;
``launches_per_step`` per decode step or prefill, ``steps`` of them);
``ms``, ``plain_ms`` and ``bound_ms`` are per launch at the main path's
shapes (for the W4A8 kernels, the mean over one layer's decode
projections).
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores


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


def phase_kernels(torch, dev, record):
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        attention as AT, kernels as K)

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    M = 8
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
        nbytes = M * Kd + M * 4 + layer_bytes + N * 4 + M * N * 4
        bound, by = _bound_ms(nbytes, 2 * M * N * Kd)
        print(f"w4a8_stacked {name} M={M} N={N} K={Kd} {bits}-bit: max diff "
              f"{err:.3e} (bound rtol 1e-6, atol {tol:.3e}) kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
              f"({bound / ms:.1%} of bound)", flush=True)
        if not ok:
            raise AssertionError(f"w4a8_stacked {name} disagrees with plain")
        w4["max_abs_err"] = max(w4["max_abs_err"] or 0.0, err)
        if main:
            main_times.append((ms, plain_ms, nbytes, 2 * M * N * Kd))
        del packed
    torch.cuda.empty_cache()
    # one launch per projection per layer: the mean is the time per launch
    mean = [statistics.fmean(t[j] for t in main_times) for j in range(4)]
    bound, by = _bound_ms(mean[2], mean[3])
    w4.update(ms=mean[0], plain_ms=mean[1], bound_ms=bound, bound_by=by)

    # --- staged flash-decode attention
    fa = record["flash_decode_q8_staged"]
    for name, B, KVH, G, D, T, pos, dots, main in [
            ("7b mixed pos", 8, 32, 1, 128, 256,
             [0, 1, 100, 128, 129, 200, 255, 256], "i8", False),
            ("7b mixed pos", 8, 32, 1, 128, 256,
             [0, 1, 100, 128, 129, 200, 255, 256], "f32", False),
            ("7b bench pos 128", 8, 32, 1, 128, 256, [128] * 8, "i8", True),
            ("7b T=2048", 8, 32, 1, 128, 2048,
             [0, 255, 256, 700, 1024, 1500, 2047, 2048], "i8", False),
            ("llama3-8b GQA", 8, 8, 4, 128, 2048,
             [0, 1, 300, 511, 512, 1999, 2047, 2048], "i8", False),
            ("llama3-8b GQA", 8, 8, 4, 128, 2048,
             [0, 1, 300, 511, 512, 1999, 2047, 2048], "f32", False)]:
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
        rel = float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref))
        if dots == "i8":
            ok = rel <= 1e-4
            bound_txt = f"rel-Frobenius {rel:.3e} <= 1e-4"
        else:
            ok = torch.allclose(out, ref, rtol=2e-5, atol=2e-6)
            bound_txt = "rtol 2e-5, atol 2e-6"
        ms = _time_ms(torch, lambda i: AT.flash_decode_q8_staged(
            q, k, v, ks, vs, kn, vn, i % Lk, p, dots=dots), 50)
        plain_ms = _time_ms(torch, lambda i: AT.flash_decode_q8_staged_plain(
            q, k, v, ks, vs, kn, vn, i % Lk, p, dots=dots), 3, reps=3)
        live = sum(min(x, T) for x in pos)
        nbytes = (KVH * live * (2 * D + 8) + 2 * B * KVH * G * D * 4
                  + 2 * B * KVH * D * 4 + B * 4)
        bound, by = _bound_ms(nbytes, 4 * KVH * G * live * D)
        print(f"flash_decode_q8_staged {name} dots={dots} B={B} KVH={KVH} "
              f"G={G} D={D} T={T}: max diff {err:.3e} ({bound_txt}) kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
              f"({bound / ms:.1%} of bound)", flush=True)
        if not ok:
            raise AssertionError(f"flash_decode_q8_staged {name} {dots} "
                                 "disagrees with plain")
        fa["max_abs_err"] = max(fa["max_abs_err"] or 0.0, err)
        if main:
            fa.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
        del k, v
    torch.cuda.empty_cache()

    # --- int8 matmul: the Llama-2-7B lm_head
    i8 = record["int8_matmul"]
    N, Kd = 32000, 4096
    w8 = torch.randint(-127, 128, (N, Kd), generator=gen, dtype=torch.int8,
                       device=dev)
    s = torch.rand((N, 1), generator=gen, device=dev) * 0.01
    x = torch.randn((M, Kd), generator=gen, device=dev)
    y = K.int8_matmul(x, w8, s)
    ref = K.int8_matmul_plain(x, w8, s)
    torch.cuda.synchronize()
    err = float((y - ref).abs().max())
    tol = 1e-6 * float(ref.abs().max())
    xq, sx = K.quantize_activations_int8(x)
    ms = _time_ms(torch, lambda i: K._launch_int8_matmul(xq, sx, w8, s), 50)
    plain_ms = _time_ms(torch, lambda i: K.int8_matmul_plain(x, w8, s), 3,
                        reps=3)
    bound, by = _bound_ms(M * Kd + M * 4 + N * Kd + N * 4 + M * N * 4,
                          2 * M * N * Kd)
    print(f"int8_matmul lm_head M={M} N={N} K={Kd}: max diff {err:.3e} "
          f"(bound rtol 1e-6, atol {tol:.3e}) kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({bound / ms:.1%} of "
          f"bound)", flush=True)
    if not torch.allclose(y, ref, rtol=1e-6, atol=tol):
        raise AssertionError("int8_matmul disagrees with plain")
    i8.update(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
              bound_by=by)
    del w8
    _phase_kernels_prefill(torch, dev, gen, record)
    _phase_kernels_decode(torch, dev, gen, record)
    _phase_kernels_packed(torch, dev, gen, record)
    _phase_kernels_paged(torch, dev, gen, record)


def _phase_kernels_packed(torch, dev, gen, record):
    """The grouped bf16 matmul and the flat W4A8 matmul at Llama-2-7B's
    three projection shapes (q/k/v/o 4096 x 4096, gate/up 11008 x 4096,
    down 4096 x 11008; 4-bit), at decode's M = 8 and prefill's M = 512.
    The record takes M = 8, the mean time per launch over one layer's seven
    launches (the unfused path's decode)."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        kernels as K)

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
            # cuBLAS f32 matmul of the same bf16 values
            y = K.quantized_matmul(x, packed[1], sg[1], 4)
            ref = K.quantized_matmul_plain(x, packed[1], sg[1], 4)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            tol = 1e-5 * float(ref.abs().max())
            if not torch.allclose(y, ref, rtol=1e-5, atol=tol):
                raise AssertionError(f"quantized_matmul {name} M={M} "
                                     "disagrees with plain")
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
                  f"max diff {err:.3e} (bound rtol 1e-5, atol {tol:.3e}) "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bf16 "
                  f"torch.matmul {lib_ms:.4f} ms (max diff {lib_err:.3e}), "
                  f"bound {bound:.4f} ms ({by}; {bound / ms:.1%} of bound)",
                  flush=True)
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
            nbytes = M * Kd + M * 4 + N * P + N * 4 + M * N * 4
            bound, by = _bound_ms(nbytes, ops)
            print(f"quantized_matmul_w4a8 {name} M={M} N={N} K={Kd} 4-bit: "
                  f"max diff {err:.3e} (bound rtol 1e-6, atol {tol:.3e}) "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({by}; {bound / ms:.1%} of bound)",
                  flush=True)
            rec = record["quantized_matmul_w4a8"]
            rec["max_abs_err"] = max(rec["max_abs_err"] or 0.0, err)
            for j, v in enumerate((ms, plain_ms, nbytes, ops, 0.0)):
                sums["quantized_matmul_w4a8"][j] += count * v
            del packed, sg, sw
        torch.cuda.empty_cache()
        for name, tot in sums.items():
            mean = [t / 7 for t in tot]
            bound, by = _bound_ms(mean[2], mean[3], BF16_OPS_PER_S
                                  if name == "quantized_matmul"
                                  else INT8_OPS_PER_S)
            print(f"{name} M={M}: one layer's 7 launches, mean per launch "
                  f"{mean[0]:.4f} ms (plain {mean[1]:.4f}, bound {bound:.4f}"
                  f" {by}" + (f", bf16 torch.matmul {mean[4]:.4f}"
                              if name == "quantized_matmul" else "")
                  + ")", flush=True)
            if M == 8:
                record[name].update(
                    ms=mean[0], plain_ms=mean[1], bound_ms=bound,
                    bound_by=by,
                    library_ms=mean[4] if name == "quantized_matmul"
                    else None)


def _phase_kernels_prefill(torch, dev, gen, record):
    """The W4A8 kernel at prefill's M, and the flash prefill kernel."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        attention as AT, kernels as K)

    # W4A8 at M = S (the prefill's rows): 32-row M tiles, each re-reading
    # the weights, so the bound is the int8 operations
    for M in (512, 2048):
        for name, N, Kd in [("qkv", 12288, 4096), ("gate_up", 22016, 4096)]:
            packed = torch.randint(0, 256, (2, N, Kd // 2), generator=gen,
                                   dtype=torch.uint8, device=dev)
            scales = torch.rand((2, N, 1), generator=gen, device=dev) * 0.01
            x = torch.randn((M, Kd), generator=gen, device=dev)
            y = K.quantized_matmul_w4a8_stacked(x, packed, scales, 1, 4)
            ref = K.quantized_matmul_w4a8_stacked_plain(x, packed, scales, 1,
                                                        4)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            tol = 1e-6 * float(ref.abs().max())
            if not torch.allclose(y, ref, rtol=1e-6, atol=tol):
                raise AssertionError(f"w4a8_stacked {name} M={M} disagrees "
                                     "with plain")
            xq, sx = K.quantize_activations_int8(x)
            ms = _time_ms(torch, lambda i: K._launch_w4a8_stacked(
                xq, sx, packed, scales, i % 2, 4), 10)
            plain_ms = _time_ms(
                torch, lambda i: K.quantized_matmul_w4a8_stacked_plain(
                    x, packed, scales, i % 2, 4), 2, reps=3)
            nbytes = M * Kd + M * 4 + N * Kd // 2 + N * 4 + M * N * 4
            bound, by = _bound_ms(nbytes, 2 * M * N * Kd)
            print(f"w4a8_stacked prefill {name} M={M} N={N} K={Kd} 4-bit: "
                  f"max diff {err:.3e} (bound rtol 1e-6, atol {tol:.3e}) "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({by}; {bound / ms:.1%} of bound)",
                  flush=True)
            record["w4a8_stacked"]["max_abs_err"] = max(
                record["w4a8_stacked"]["max_abs_err"], err)
            del packed
    torch.cuda.empty_cache()

    # flash prefill: Llama-2-7B heads at S = 512 and 2048, a ragged S, and
    # Llama-3-8B's GQA (8 kv heads, 4 query heads each)
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
        nbytes = 4 * (2 * S * H * D + 2 * S * KVH * D)
        bound, by = _bound_ms(nbytes, 4 * H * D * S * (S + 1) / 2,
                              F32_OPS_PER_S)
        print(f"flash_prefill {name} S={S} H={H} KVH={KVH} D={D}: max diff "
              f"{err:.3e} (bound rtol 2e-5, atol 2e-6) kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms (max diff "
              f"{lib_err:.3e}), bound {bound:.4f} ms ({by}; "
              f"{bound / ms:.1%} of bound)", flush=True)
        fp["max_abs_err"] = max(fp["max_abs_err"] or 0.0, err)
        if main:
            fp.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                      library_ms=lib_ms)
        del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()


def _phase_kernels_decode(torch, dev, gen, record):
    """The all-batch (staged and inline) and inline row decode kernels."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        attention as AT)

    ab, inl = record["flash_decode_q8_ab"], record["flash_decode_q8"]
    # Llama-2-7B at B 8 over a 4096-token cache, ragged rows (mean 2049)
    ragged = [0, 700, 1300, 1900, 2300, 2700, 3400, 4095]
    cases = [("ab", "7b T=4096 ragged", 4096, ragged, st, dots,
              st and dots == "f32")
             for st in (True, False) for dots in ("f32", "i8")]
    cases += [("row", "7b bench pos 128", 256, [128] * 8, False, dots,
               dots == "i8") for dots in ("i8", "f32")]
    for kind, name, T, pos, staged, dots, main in cases:
        B, KVH, G, D = 8, 32, 1, 128
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
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        rel = float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref))
        if dots == "i8":
            ok = rel <= 1e-4
            bound_txt = f"rel-Frobenius {rel:.3e} <= 1e-4"
        else:
            ok = torch.allclose(out, ref, rtol=2e-5, atol=2e-6)
            bound_txt = "rtol 2e-5, atol 2e-6"
        ms = _time_ms(torch, fn, 50)
        plain_ms = _time_ms(torch, lambda i: fn(i, plain=True), 2, reps=3)
        # tokens attended per row: < pos (staged) or <= pos (inline)
        live = sum(min(x if staged else x + 1, T) for x in pos)
        nbytes = (KVH * live * (2 * D + 8) + 2 * B * KVH * G * D * 4
                  + (2 * B * KVH * D * 4 if staged else 0) + B * 4)
        ops = 4 * KVH * G * live * D
        bound, by = _bound_ms(nbytes, ops, INT8_OPS_PER_S if dots == "i8"
                              else F32_OPS_PER_S)
        print(f"{label} {name} dots={dots} B={B} KVH={KVH} G={G} D={D} "
              f"T={T}: max diff {err:.3e} ({bound_txt}) kernel {ms:.4f} ms, "
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
    row) and of 256 (the staged kernel's block), dots i8 and f32; beside
    the staged kernel over the same context in a contiguous cache. The
    kernel is timed through its launcher: the wrapper's page-id check
    reads the table back to the host, which a CUDA graph cannot capture."""
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
    for dots in ("i8", "f32"):
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
        for dots in ("i8", "f32"):
            out = AT.flash_decode_q8_paged(*args, 1, tables, p, dots=dots)
            ref = AT.flash_decode_q8_paged_plain(*args, 1, tables, p,
                                                 dots=dots)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            rel = float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref))
            if dots == "i8":
                ok = rel <= 1e-4
                bound_txt = f"rel-Frobenius {rel:.3e} <= 1e-4"
            else:
                ok = torch.allclose(out, ref, rtol=2e-5, atol=2e-6)
                bound_txt = "rtol 2e-5, atol 2e-6"
            ms = _time_ms(torch, lambda i: AT._launch_decode(
                "flash_decode_paged_launch", *args, i % Lk, p, P, dots,
                page_tables=tables), 50)
            plain_ms = _time_ms(
                torch, lambda i: AT.flash_decode_q8_paged_plain(
                    *args, i % Lk, tables, p, dots=dots), 2, reps=3)
            bound, by = _bound_ms(nbytes, 4 * KVH * G * live * D,
                                  INT8_OPS_PER_S if dots == "i8"
                                  else F32_OPS_PER_S)
            print(f"flash_decode_q8_paged 7b page {P} dots={dots} B={B} "
                  f"KVH={KVH} G={G} D={D} ctx {ctx} pos {pos}: max diff "
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
        del k, v, ks, vs
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
            attention as AT, kernels as K)
        swaps = [(K, "quantized_matmul_w4a8_stacked",
                  K.quantized_matmul_w4a8_stacked_plain),
                 (K, "quantized_matmul", K.quantized_matmul_plain),
                 (K, "quantized_matmul_w4a8", K.quantized_matmul_w4a8_plain),
                 (K, "int8_matmul", K.int8_matmul_plain),
                 (AT, "flash_decode_q8_staged",
                  AT.flash_decode_q8_staged_plain),
                 (AT, "flash_decode_q8", AT.flash_decode_q8_plain),
                 (AT, "flash_decode_q8_ab", AT.flash_decode_q8_ab_plain),
                 (AT, "flash_decode_q8_paged",
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
    return params


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
    times, with the unwatched functions."""

    def __init__(self, torch, counters, per_prefill, per_tick,
                 first_prefill=None, first_tick=None, module=None,
                 names=("prefill_into_slot_fused", "decode_step_fused"),
                 extra=None):
        self.torch, self.counters = torch, counters
        self.per_prefill, self.per_tick = per_prefill, per_tick
        self.first_prefill, self.first_tick = first_prefill, first_tick
        self.module, self.names = module, names
        self.prefill_ms, self.tick_ms = {}, []
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
                                   lambda ms, *_: self.tick_ms.append(ms),
                                   self._tick_check))
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
    then on an int8 cache (reported)."""
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
    print(f"unfused phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ee274_convexcaldera_llm_quantization_tpu_torch._device import (
        resolve_device)
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
        "flash_decode_q8_ab": dict(source=src + "flash_decode.cu",
                                   replaces=ref + "attention.py:506"),
        "flash_decode_q8": dict(source=src + "flash_decode.cu",
                                replaces=ref + "attention.py:155"),
        "quantized_matmul": dict(source=src + "grouped_matmul.cu",
                                 replaces=ref + "kernels.py:222"),
        "quantized_matmul_w4a8": dict(source=src + "w4a8_stacked.cu",
                                      replaces=ref + "kernels.py:460"),
        "flash_decode_q8_paged": dict(source=src + "flash_decode.cu",
                                      replaces=ref + "attention.py:761"),
    }
    measured = ("launches", "launches_per_step", "steps", "max_abs_err",
                "ms", "plain_ms", "bound_ms", "bound_by")
    for r in record.values():
        r.update(dict.fromkeys(measured), library_ms=None)
    t_run = time.perf_counter()
    phase_kernels(torch, dev, record)
    phase_width(torch, dev)
    params = phase_full(torch, dev, record)
    phase_serving(torch, dev, params, record)
    phase_paged(torch, dev, params, record)
    del params
    torch.cuda.empty_cache()
    phase_unfused(torch, dev, record)

    for name, r in record.items():
        missing = [k for k in measured if r[k] is None]
        if missing:
            raise AssertionError(f"{name}: {missing} not measured")
    # library_ms: one SDPA call for flash_prefill (f32, causal); for
    # quantized_matmul, one bf16 torch.matmul on its weights dequantized
    # beforehand. No single PyTorch call computes the other functions
    # (packed offset-binary codes rescaled per row of int8 activations;
    # attention over an int8 cache with per-token scales, or over an int8
    # pool through a page table, and int8 probabilities in dots="i8"), so
    # theirs is null.
    kernels = [dict(name=name, route="cuda", source=r["source"],
                    replaces=r["replaces"],
                    **{k: r[k] for k in measured},
                    library_ms=r["library_ms"])
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
