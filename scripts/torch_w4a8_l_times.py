#!/usr/bin/env python3
"""Device times of the port's L-fused W4A8 kernel
(``quantized_matmul_w4a8_l_stacked``, ``csrc/w4a8_lowrank.cu``) at prefill
M beside the plain W4A8 kernel's tile path on the same weights, each case
checked first.

    python3 scripts/torch_w4a8_l_times.py [--root TREE] [--check-only]
                                          [--sweep] [--prefill]

imports the port package from ``TREE`` (default: this checkout), builds
only the two kernels' libraries, prints nvcc's ``-Xptxas -v`` lines of the
tile kernels (registers, shared memory, spills), and holds every case
against ``quantized_matmul_w4a8_l_stacked_plain`` run on the card (the same
int8 activations) within rtol 1e-5 / atol 1e-5 of its largest value (exact
i32 sums; the factor dots sum in another f32 order), a second launch to the
first bit for bit, and, where the tree has the L tile path
(``_w4a8_l_plan``), the default launch to a launch of the decode design
(``l_kernel``) within the same bound. The checked cases add M 9, 33, 100 and
1000 on splits whose 128-row tiles straddle three projections, rank 24, 2-
and 8-bit codes. The timed cases are Llama-2-7B's four projections at 4
bits, rank 128 (qkv 3 x 4096 x 4096, o 4096 x 4096, gate/up 2 x 11008 x
4096, down 4096 x 11008) at M 512 and 2048: the kernel's median device time
per launch (launches captured in a CUDA graph, 5 replays, the packed
weights and factors rotated over enough layers to come from device memory),
on a tree with the L tile path also the tile kernel alone on factor
operands made beforehand (``kernel_ms``: the rest of ``ms`` is the bf16
casts of xr and L), the plain W4A8 kernel's (row 3's) launch on the same
packed weights, whose
function is the integer half alone (the gap is the L epilogue's cost), and
the bound: the larger of the bytes (each input read once, the output
written once) over 3.35 TB/s and the int8 operations plus the bf16 factor
operations in int8 units over 1979 TOP/s. ``--sweep`` (a tree with the L
tile path) times, at each M of 8, 9, 16, 17, 32, 64, 96, 128, 192, 256 and
512 and each projection, ``l_kernel`` (up to M 128) and the tile launch at
64 and 128 activation rows a tile, each checked first. ``--prefill`` times
the fused path's 2048-token prefill (``prefill_into_slot_fused``, flash
prefill, Llama-2-7B, 32 layers, synthetic weights from
``bench_params.py``, seed 0) on factor paths "l" and "xla": host clock to a
synchronize, the median of three after one warm-up, with the launches of
the L-fused kernel counted. Then it prints one JSON line ``{"root", "card",
"cases", "sweep", "prefill"}``. The script exits non-zero if any case fails
its checks. To compare two trees, run it on each in one call, in turns (A,
B, B, A): two calls may land on two cards.
"""

import argparse
import json
import math
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import (  # noqa: E402
    _bound_ms, _card_line, _ops_int8_units, _time_ms)

RANK = 128
# (name, splits, K)
SHAPES = [("qkv", (4096,) * 3, 4096), ("o", (4096,), 4096),
          ("gate/up", (11008,) * 2, 4096), ("down", (4096,), 11008)]
# (name, splits, K, rank, bits, M): checked only
CHECKS = ([("straddle", (40, 24, 136), 512, 128, bits, M)
           for bits in (2, 4, 8) for M in (9, 33, 100, 1000)]
          + [("rank 24", (96,), 512, 24, bits, M) for bits in (2, 8)
             for M in (17, 300)]
          + [("down 2-bit", (4096,), 11008, 128, 2, M) for M in (64, 1000)])
SWEEP_M = (8, 9, 16, 17, 32, 64, 96, 128, 192, 256, 512)
SWEEP_ROWDOT_MAX_M = 128  # l_kernel is timed up to here


def _inputs(torch, gen, dev, splits, Kd, rank, bits, M, layers):
    f = 8 // bits
    N, nR = sum(splits), len(splits) * rank
    w = dict(
        packed=torch.randint(0, 256, (layers, N, Kd // f), generator=gen,
                             dtype=torch.uint8, device=dev),
        scales=torch.rand((layers, N, 1), generator=gen,
                          device=dev) * 0.01 + 0.001,
        R=torch.randint(-127, 128, (1, nR, Kd), generator=gen,
                        dtype=torch.int8, device=dev),
        Rs=torch.rand((1, nR, 1), generator=gen, device=dev) * 1e-3,
        L=torch.randint(-127, 128, (layers, N, rank), generator=gen,
                        dtype=torch.int8, device=dev),
        Ls=torch.rand((layers, N, 1), generator=gen, device=dev) * 1e-3)
    x = torch.randn((M, Kd), generator=gen, device=dev)
    return x, w


def _layers(splits, Kd, rank):
    N = sum(splits)
    return max(2, math.ceil(200e6 / (N * Kd // 2 + N * rank)))


def _prefill(torch, dev, failed):
    """The 2048-token prefill on factor paths "l" and "xla"."""
    from ee274_convexcaldera_llm_quantization_tpu_torch import bench_params
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        fused, llama)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
        LLAMA2_7B)
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        kernels as K)
    config, S = LLAMA2_7B, 2048
    base = fused.fuse_stacked(bench_params.build_compressed_llama_params(
        config, num_bits=4, rank=RANK, seed=0, device=dev))
    gen = torch.Generator().manual_seed(13)
    tokens = torch.randint(0, config.vocab_size, (1, S), generator=gen).to(dev)
    out, logits = {}, {}
    for fk in ("l", "xla"):
        params = fused.quantize_factors_int8_fused(base, fuse_factor_kernel=fk)
        cache = llama.HeadMajorQuantKVCache.create(config, 1, S, device=dev)
        times = []
        for i in range(4):
            before = K.quantized_matmul_w4a8_l_stacked.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, _ = fused.prefill_into_slot_fused(params, tokens, 0, cache,
                                                  config, flash=True)
            torch.cuda.synchronize()
            if i:
                times.append(1e3 * (time.perf_counter() - t0))
            launches = K.quantized_matmul_w4a8_l_stacked.launches - before
        logits[fk] = lg
        out[fk] = dict(ms=statistics.median(times), runs=times,
                       l_launches=launches)
        print(json.dumps({"prefill": fk, "S": S, **out[fk]}), flush=True)
        del params, cache
        torch.cuda.empty_cache()
    rel = float(torch.linalg.norm(logits["l"] - logits["xla"])
                / torch.linalg.norm(logits["xla"]))
    same = bool(logits["l"].argmax() == logits["xla"].argmax())
    out["l_vs_xla_rel"], out["same_argmax"] = rel, same
    print(json.dumps({"prefill l vs xla": rel, "same_argmax": same}),
          flush=True)
    if out["l"]["l_launches"] != 4 * config.num_layers:
        failed.append(f"prefill 'l': {out['l']['l_launches']} L-fused "
                      f"launches, expected {4 * config.num_layers}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--prefill", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        _build, kernels as K)
    _build.build(["w4a8_stacked", "w4a8_lowrank"])
    for name in ("w4a8_stacked", "w4a8_lowrank"):
        lines = _build.build_log(name).splitlines()
        for i, line in enumerate(lines):
            # the tile kernels' entries and the property lines after them
            if "tile_kernel" in line and "Compiling" in line:
                for ln in lines[i:i + 4]:
                    if any(w in ln for w in ("registers", "spill",
                                             "Compiling")):
                        print(f"{name}: {ln.strip()}", flush=True)
            elif any(w in line for w in ("error", "C75")):
                print(f"{name}: {line.strip()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tiled = hasattr(K, "_w4a8_l_plan")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases, failed, sweep, prefill = [], [], [], None

    def close(y, ref):
        return bool(torch.allclose(y, ref, rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max())))

    def check(name, splits, Kd, rank, bits, M, x, w, xr, layer):
        N = sum(splits)
        largs = (w["packed"], w["scales"], layer, xr, w["L"], w["Ls"], bits,
                 rank, splits)
        y = K.quantized_matmul_w4a8_l_stacked(x, *largs)
        ref = K.quantized_matmul_w4a8_l_stacked_plain(x, *largs)
        xq, sx = K.quantize_activations_int8(x)
        case = dict(case=name, M=M, N=N, K=Kd, rank=rank, bits=bits,
                    close_plain=close(y, ref),
                    max_abs_err=float((y - ref).abs().max()),
                    equal_repeat=bool(torch.equal(y, K._launch_l(
                        xq, sx, w["packed"], w["scales"], layer, xr, w["L"],
                        w["Ls"], bits, rank, splits))))
        if tiled:
            case["plan"] = {k: v for k, v in K._w4a8_l_plan(
                M, N, Kd, bits, rank, splits, sms).items()
                if k not in ("windows", "l_steps")}
            case["close_l_kernel"] = close(y, K._launch_l(
                xq, sx, w["packed"], w["scales"], layer, xr, w["L"], w["Ls"],
                bits, rank, splits, path="rowdot"))
        print(json.dumps(case), flush=True)
        if not all(v for k, v in case.items()
                   if k.startswith(("close", "equal"))):
            failed.append(f"{name} M={M} N={N} rank {rank} {bits}-bit")
        return case

    for name, splits, Kd, rank, bits, M in CHECKS:
        x, w = _inputs(torch, gen, dev, splits, Kd, rank, bits, M, 3)
        xr = K.thin_xr(x, w["R"][0], w["Rs"][0])
        cases.append(check(name, splits, Kd, rank, bits, M, x, w, xr, 2))

    for M in (512, 2048):
        for name, splits, Kd in SHAPES:
            N, n_proj = sum(splits), len(splits)
            Lk = _layers(splits, Kd, RANK)
            x, w = _inputs(torch, gen, dev, splits, Kd, RANK, 4, M, Lk)
            xr = K.thin_xr(x, w["R"][0], w["Rs"][0])
            case = check(name, splits, Kd, RANK, 4, M, x, w, xr, Lk - 1)
            cases.append(case)
            if args.check_only:
                continue
            xq, sx = K.quantize_activations_int8(x)

            def row6(i):
                return K._launch_l(xq, sx, w["packed"], w["scales"], i % Lk,
                                   xr, w["L"], w["Ls"], 4, RANK, splits)

            def row3(i):
                return K._launch_w4a8_stacked(xq, sx, w["packed"],
                                              w["scales"], i % Lk, 4)

            once = _time_ms(torch, row6, 1, reps=1)
            iters = max(2, min(20, int(30 / max(once, 1e-3))))
            case["ms"] = _time_ms(torch, row6, iters)
            if hasattr(K, "_launch_l_tile"):
                # the tile kernel alone, on factor operands made beforehand
                plan = K._w4a8_l_plan(M, N, Kd, 4, RANK, splits, sms)
                ops = [K._l_tile_operands(xr, w["L"][i], RANK, n_proj)
                       for i in range(Lk)]
                case["kernel_ms"] = _time_ms(torch, lambda i: K._launch_l_tile(
                    xq, sx, w["packed"], w["scales"], i % Lk, *ops[i % Lk],
                    w["Ls"], 4, RANK, splits, plan), iters)
                del ops
            y3 = row3(Lk - 1)
            ref3 = K.quantized_matmul_w4a8_stacked_plain(x, w["packed"],
                                                         w["scales"], Lk - 1,
                                                         4)
            case["row3_equal_plain"] = bool(torch.equal(y3, ref3))
            if not case["row3_equal_plain"]:
                failed.append(f"row 3 {name} M={M}")
            case["row3_ms"] = _time_ms(torch, row3, max(iters, 10))
            nbytes = (M * Kd + M * 4 + N * Kd // 2 + N * 4
                      + M * n_proj * RANK * 4 + N * RANK + N * 4 + M * N * 4)
            ops = _ops_int8_units(i8=2 * M * N * Kd, bf16=2 * M * N * RANK)
            case["bound_ms"], case["bound_by"] = _bound_ms(nbytes, ops)
            case["share_of_bound"] = case["bound_ms"] / case["ms"]
            case["ratio_to_row3"] = case["ms"] / case["row3_ms"]
            print(json.dumps(case), flush=True)
            del x, w, xr
            torch.cuda.empty_cache()

    if args.sweep and tiled and not args.check_only:
        for M in SWEEP_M:
            for name, splits, Kd in SHAPES:
                N = sum(splits)
                Lk = _layers(splits, Kd, RANK)
                x, w = _inputs(torch, gen, dev, splits, Kd, RANK, 4, M, Lk)
                xr = K.thin_xr(x, w["R"][0], w["Rs"][0])
                xq, sx = K.quantize_activations_int8(x)
                largs = (xq, sx, w["packed"], w["scales"])
                rest = (xr, w["L"], w["Ls"], 4, RANK, splits)
                ref = K.quantized_matmul_w4a8_l_stacked_plain(
                    x, w["packed"], w["scales"], Lk - 1, *rest)
                row = dict(M=M, case=name, N=N, K=Kd, plan=K._w4a8_l_plan(
                    M, N, Kd, 4, RANK, splits, sms)["rows"])
                for label, kw in (("l_kernel", dict(path="rowdot")),
                                  ("tile64", dict(path="tile", rows=64)),
                                  ("tile128", dict(path="tile", rows=128))):
                    if label == "l_kernel" and M > SWEEP_ROWDOT_MAX_M:
                        continue
                    y = K._launch_l(*largs, Lk - 1, *rest, **kw)
                    if not close(y, ref):
                        failed.append(f"sweep {label} {name} M={M}")
                        continue
                    row[label] = _time_ms(torch, lambda i: K._launch_l(
                        *largs, i % Lk, *rest, **kw), 20)
                print(json.dumps(row), flush=True)
                sweep.append(row)
                del x, w, xr
                torch.cuda.empty_cache()

    if args.prefill and not args.check_only:
        prefill = _prefill(torch, dev, failed)

    print(json.dumps({"root": args.root, "card": _card_line(),
                      "cases": cases, "sweep": sweep, "prefill": prefill}))
    if failed:
        print(f"failed checks: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
