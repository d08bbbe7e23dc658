#!/usr/bin/env python3
"""Device times of the port's LR-fused W4A8 kernel
(``quantized_matmul_w4a8_lr_stacked``, ``csrc/w4a8_lowrank.cu``) at prefill
M, each case checked first.

    python3 scripts/torch_w4a8_lr_times.py [--root TREE] [--check-only]
                                           [--sweep] [--prefill]

imports the port package from ``TREE`` (default: this checkout), builds
only the libraries it needs, prints nvcc's ``-Xptxas -v`` lines of the
tensor-core kernels of ``w4a8_lowrank.cu`` (registers, shared memory,
spills), and holds every case to the plain version run on the card: the
kernel's ``xr`` to ``thin_xr`` and the output to
``quantized_matmul_w4a8_l_stacked_plain`` on the kernel's own ``xr`` (an xr
element may round to the other bf16 neighbour before the L dot), each
within rtol 1e-5 / atol 1e-5 of its largest value, and a second launch to
the first bit for bit; on a tree with the tile path (``_w4a8_lr_plan``)
each design by override. The checked cases add M 9, 33, 130 and 1000 on
splits whose 128-row tiles straddle three projections, ranks 24 and 130,
2- and 8-bit codes. The timed cases are Llama-2-7B's qkv (3 x 4096 x 4096)
and gate/up (2 x 11008 x 4096) at 4 bits, rank 128, M 512 and 2048: the
call's median device time per launch (``_launch_lr`` on f32 activations
and their int8 codes; launches captured in a CUDA graph, 5 replays, the
weights and factors rotated over enough layers to come from device
memory), on a tree with the tile path also the xr kernel alone on bf16
activations made beforehand (``xr_ms``) and the two kernels alone on
operands made beforehand (``kernel_ms``: the rest of ``ms`` is the casts of
x and L), the L-fused kernel's call ``_launch_l`` on the plain thin dot
(``row6_ms``) and the bound: the larger of the bytes (each input read once, the
output written once) over 3.35 TB/s and the int8 operations plus the bf16
factor operations in int8 units over 1979 TOP/s (the xr kernel's own: its
bf16 operations over 989 TFLOP/s). ``--sweep`` (a tree with the tile path)
times, at each M of 1, 2, 4, 8, 9, 16, 33, 64, 96, 128, 256 and 512 and on
qkv and gate/up, the cooperative kernel and the tile path, and the xr
kernel alone at each tile width and several split counts at M 8, 9, 64,
128, 512 and 2048. ``--prefill`` times the fused path's 2048-token prefill
(``prefill_into_slot_fused``, flash prefill, Llama-2-7B, 32 layers,
synthetic weights from ``bench_params.py``, seed 0) on factor paths "lr",
"l" and "xla": host clock to a synchronize, the median of three after one
warm-up, with the LR-fused launches counted and the logits of "lr" against
"xla". Then it prints one JSON line ``{"root", "card", "cases", "sweep",
"xr_sweep", "prefill"}``. The script exits non-zero if any case fails its
checks. To compare two trees, run it on each in one call, in turns (A, B,
B, A): two calls may land on two cards.
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
    BF16_OPS_PER_S, _bound_ms, _card_line, _ops_int8_units, _time_ms)

RANK = 128
# (name, splits, K)
SHAPES = [("qkv", (4096,) * 3, 4096), ("gate/up", (11008,) * 2, 4096)]
# (name, splits, K, rank, bits, M): checked only
CHECKS = ([("straddle", (40, 24, 136), 512, 128, bits, M)
           for bits in (2, 4, 8) for M in (9, 33, 130, 1000)]
          + [("rank 24", (96,), 512, 24, bits, M) for bits in (2, 8)
             for M in (17, 300)]
          + [("rank 130", (200, 56), 1024, 130, 4, M) for M in (9, 600)])
SWEEP_M = (1, 2, 4, 8, 9, 16, 33, 64, 96, 128, 256, 512)
SWEEP_COOP_MAX_M = 128  # the cooperative kernel is timed up to here
XR_SWEEP_M = (8, 9, 64, 128, 512, 2048)
XR_SWEEP_SPLITS = (1, 2, 4, 8, 16)


def _inputs(torch, gen, dev, splits, Kd, rank, bits, M, layers):
    f = 8 // bits
    N, nR = sum(splits), len(splits) * rank
    w = dict(
        packed=torch.randint(0, 256, (layers, N, Kd // f), generator=gen,
                             dtype=torch.uint8, device=dev),
        scales=torch.rand((layers, N, 1), generator=gen,
                          device=dev) * 0.01 + 0.001,
        R=torch.randint(-127, 128, (layers, nR, Kd), generator=gen,
                        dtype=torch.int8, device=dev),
        Rs=torch.rand((layers, nR, 1), generator=gen, device=dev) * 1e-3,
        L=torch.randint(-127, 128, (layers, N, rank), generator=gen,
                        dtype=torch.int8, device=dev),
        Ls=torch.rand((layers, N, 1), generator=gen, device=dev) * 1e-3)
    x = torch.randn((M, Kd), generator=gen, device=dev)
    return x, w


def _layers(splits, Kd, rank):
    N, nR = sum(splits), len(splits) * rank
    return max(2, math.ceil(200e6 / (N * Kd // 2 + N * rank + nR * Kd)))


def _prefill(torch, dev, failed):
    """The 2048-token prefill on factor paths "lr", "l" and "xla"."""
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
    for fk in ("lr", "l", "xla"):
        params = fused.quantize_factors_int8_fused(base, fuse_factor_kernel=fk)
        cache = llama.HeadMajorQuantKVCache.create(config, 1, S, device=dev)
        times = []
        for i in range(4):
            before = K.quantized_matmul_w4a8_lr_stacked.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, _ = fused.prefill_into_slot_fused(params, tokens, 0, cache,
                                                  config, flash=True)
            torch.cuda.synchronize()
            if i:
                times.append(1e3 * (time.perf_counter() - t0))
            launches = K.quantized_matmul_w4a8_lr_stacked.launches - before
        logits[fk] = lg
        out[fk] = dict(ms=statistics.median(times), runs=times,
                       lr_launches=launches)
        print(json.dumps({"prefill": fk, "S": S, **out[fk]}), flush=True)
        del params, cache
        torch.cuda.empty_cache()
    for fk in ("lr", "l"):
        rel = float(torch.linalg.norm(logits[fk] - logits["xla"])
                    / torch.linalg.norm(logits["xla"]))
        same = bool(logits[fk].argmax() == logits["xla"].argmax())
        out[f"{fk}_vs_xla_rel"], out[f"{fk}_same_argmax"] = rel, same
        print(json.dumps({f"prefill {fk} vs xla": rel, "same_argmax": same}),
              flush=True)
    if out["lr"]["lr_launches"] != 2 * config.num_layers:
        failed.append(f"prefill 'lr': {out['lr']['lr_launches']} LR-fused "
                      f"launches, expected {2 * config.num_layers}")
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
    _build.build(["w4a8_stacked", "w4a8_lowrank", "grouped_matmul"])
    lines = _build.build_log("w4a8_lowrank").splitlines()
    for i, line in enumerate(lines):
        # the tensor-core kernels' entries and the property lines after them
        if ("tile_kernel" in line or "xr_kernel" in line) \
                and "Compiling" in line:
            for ln in lines[i:i + 4]:
                if any(w in ln for w in ("registers", "spill", "Compiling")):
                    print(f"w4a8_lowrank: {ln.strip()}", flush=True)
        elif any(w in line for w in ("error", "C7513", "C7520")):
            print(f"w4a8_lowrank: {line.strip()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tiled = hasattr(K, "_w4a8_lr_plan")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases, failed, sweep, xr_sweep, prefill = [], [], [], [], None

    def close(y, ref):
        return bool(torch.allclose(y, ref, rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max())))

    def lr_args(x, w, layer, bits, rank, splits):
        xq, sx = K.quantize_activations_int8(x)
        return (x, xq, sx, w["packed"], w["scales"], layer, w["R"], w["Rs"],
                w["L"], w["Ls"], bits, rank, splits)

    def check_design(largs, x, w, layer, bits, rank, splits, **kw):
        """(close to thin_xr, close to plain on own xr, repeat equal, the
        output's max error, the xr error's largest share of its bound)."""
        y, xr = K._launch_lr(*largs, **kw)
        y2, xr2 = K._launch_lr(*largs, **kw)
        ref_xr = K.thin_xr(x, w["R"][layer], w["Rs"][layer])
        ref = K.quantized_matmul_w4a8_l_stacked_plain(
            x, w["packed"], w["scales"], layer, xr, w["L"], w["Ls"], bits,
            rank, splits)
        share = float(((xr - ref_xr).abs() / (
            1e-5 * ref_xr.abs() + 1e-5 * ref_xr.abs().max())).max())
        return (close(xr, ref_xr), close(y, ref),
                bool(torch.equal(y, y2) and torch.equal(xr, xr2)),
                float((y - ref).abs().max()), share)

    def check(name, splits, Kd, rank, bits, M, x, w, layer):
        N = sum(splits)
        largs = lr_args(x, w, layer, bits, rank, splits)
        xr_ok, y_ok, rep, err, share = check_design(largs, x, w, layer, bits,
                                                    rank, splits)
        case = dict(case=name, M=M, N=N, K=Kd, rank=rank, bits=bits,
                    close_xr=xr_ok, close_plain=y_ok, equal_repeat=rep,
                    max_abs_err=err, xr_err_of_bound=share)
        if tiled:
            plan = K._w4a8_lr_plan(M, N, Kd, bits, rank, splits, sms)
            case["plan"] = {k: v for k, v in plan.items()
                            if k not in ("windows", "l_steps")}
            for path in ("coop", "tile"):
                ok = check_design(largs, x, w, layer, bits, rank, splits,
                                  path=path)
                case[f"close_{path}"] = all(ok[:3])
        print(json.dumps(case), flush=True)
        if not all(v for k, v in case.items()
                   if k.startswith(("close", "equal"))):
            failed.append(f"{name} M={M} N={N} rank {rank} {bits}-bit")
        return case

    for name, splits, Kd, rank, bits, M in CHECKS:
        x, w = _inputs(torch, gen, dev, splits, Kd, rank, bits, M, 3)
        cases.append(check(name, splits, Kd, rank, bits, M, x, w, 2))

    for M in (512, 2048):
        for name, splits, Kd in SHAPES:
            N, n_proj = sum(splits), len(splits)
            nR = n_proj * RANK
            Lk = _layers(splits, Kd, RANK)
            x, w = _inputs(torch, gen, dev, splits, Kd, RANK, 4, M, Lk)
            case = check(name, splits, Kd, RANK, 4, M, x, w, Lk - 1)
            cases.append(case)
            if args.check_only:
                continue
            largs = lr_args(x, w, 0, 4, RANK, splits)

            def row5(i):
                return K._launch_lr(*largs[:5], i % Lk, *largs[6:])

            once = _time_ms(torch, row5, 1, reps=1)
            iters = max(2, min(20, int(30 / max(once, 1e-3))))
            case["ms"] = _time_ms(torch, row5, iters)
            if tiled:
                plan = K._w4a8_lr_plan(M, N, Kd, 4, RANK, splits, sms)
                xb = x.to(torch.bfloat16)

                def xr_kernel(i):
                    return K._launch_lr_xr(xb, w["R"][i % Lk],
                                           w["Rs"][i % Lk], RANK, plan["xr"])

                case["xr_ms"] = _time_ms(torch, xr_kernel, max(iters, 10))
                L_b = [K._l_tile_L(w["L"][i], RANK) for i in range(Lk)]

                def kernels(i):
                    _, xr_b = xr_kernel(i)
                    return K._launch_l_tile(
                        largs[1], largs[2], w["packed"], w["scales"], i % Lk,
                        xr_b, L_b[i % Lk], w["Ls"], 4, RANK, splits, plan)

                case["kernel_ms"] = _time_ms(torch, kernels, iters)
                del L_b
                xr6 = K.thin_xr(x, w["R"][0], w["Rs"][0])
                case["row6_ms"] = _time_ms(torch, lambda i: K._launch_l(
                    largs[1], largs[2], w["packed"], w["scales"], i % Lk,
                    xr6, w["L"], w["Ls"], 4, RANK, splits), iters)
                # bf16 x and the int8 codes in, f32 xr out
                xbytes = M * Kd * 2 + nR * Kd + nR * 4 + M * nR * 4
                case["xr_bound_ms"], _ = _bound_ms(
                    xbytes, 2 * M * nR * Kd, BF16_OPS_PER_S)
                case["xr_share_of_bound"] = case["xr_bound_ms"] / case[
                    "xr_ms"]
            nbytes = (M * Kd * 5 + M * 4 + N * Kd // 2 + N * 4 + nR * Kd
                      + nR * 4 + N * RANK + N * 4 + M * N * 4)
            ops = _ops_int8_units(i8=2 * M * N * Kd,
                                  bf16=2 * M * nR * Kd + 2 * M * N * RANK)
            case["bound_ms"], case["bound_by"] = _bound_ms(nbytes, ops)
            case["share_of_bound"] = case["bound_ms"] / case["ms"]
            print(json.dumps(case), flush=True)
            del x, w, largs
            torch.cuda.empty_cache()

    if args.sweep and tiled and not args.check_only:
        for M in SWEEP_M:
            for name, splits, Kd in SHAPES:
                N = sum(splits)
                Lk = _layers(splits, Kd, RANK)
                x, w = _inputs(torch, gen, dev, splits, Kd, RANK, 4, M, Lk)
                largs = lr_args(x, w, Lk - 1, 4, RANK, splits)
                row = dict(M=M, case=name, N=N, K=Kd, plan=K._w4a8_lr_plan(
                    M, N, Kd, 4, RANK, splits, sms)["path"])
                for path in ("coop", "tile"):
                    if path == "coop" and M > SWEEP_COOP_MAX_M:
                        continue
                    if not all(check_design(largs, x, w, Lk - 1, 4, RANK,
                                            splits, path=path)[:3]):
                        failed.append(f"sweep {path} {name} M={M}")
                        continue
                    row[path] = _time_ms(torch, lambda i: K._launch_lr(
                        *largs[:5], i % Lk, *largs[6:], path=path), 20)
                print(json.dumps(row), flush=True)
                sweep.append(row)
                del x, w, largs
                torch.cuda.empty_cache()
        for M in XR_SWEEP_M:
            for name, splits, Kd in SHAPES:
                nR = len(splits) * RANK
                Lk = _layers(splits, Kd, RANK)
                x, w = _inputs(torch, gen, dev, splits, Kd, RANK, 4, M, Lk)
                xb = x.to(torch.bfloat16)
                ref = K.thin_xr(x, w["R"][0], w["Rs"][0])
                row = dict(M=M, case=name, nR=nR, plan=K._xr_plan(
                    M, nR, Kd, sms))
                k_steps = -(-Kd // K._XR_BK)
                for cols in (16, 64, 128):
                    for splits_n in XR_SWEEP_SPLITS:
                        p = K._xr_plan(M, nR, Kd, sms, cols,
                                       -(-k_steps // splits_n))
                        if not close(K._launch_lr_xr(
                                xb, w["R"][0], w["Rs"][0], RANK, p)[0], ref):
                            failed.append(f"xr sweep {name} M={M} {cols} "
                                          f"{splits_n}")
                            continue
                        row[f"{cols}x{p['splits']}"] = _time_ms(
                            torch, lambda i: K._launch_lr_xr(
                                xb, w["R"][i % Lk], w["Rs"][i % Lk], RANK,
                                p), 20)
                print(json.dumps(row), flush=True)
                xr_sweep.append(row)
                del x, w, xb
                torch.cuda.empty_cache()

    if args.prefill and not args.check_only:
        prefill = _prefill(torch, dev, failed)

    print(json.dumps({"root": args.root, "card": _card_line(),
                      "cases": cases, "sweep": sweep, "xr_sweep": xr_sweep,
                      "prefill": prefill}))
    if failed:
        print(f"failed checks: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
