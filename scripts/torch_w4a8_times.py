#!/usr/bin/env python3
"""Device times of the port's W4A8 kernel (``quantized_matmul_w4a8_stacked``,
``csrc/w4a8_stacked.cu``) at prefill M beside ``torch._int_mm``, each case
checked against the plain version first.

    python3 scripts/torch_w4a8_times.py [--root TREE] [--check-only]
                                        [--sweep]

imports the port package from ``TREE`` (default: this checkout), builds
only the kernel's own library, prints nvcc's ``-Xptxas -v`` lines (registers,
shared memory, spills), and holds every case against
``quantized_matmul_w4a8_stacked_plain`` on the same inputs bit for bit (the
i32 sums are exact and the f32 epilogue keeps one order), and, where the tree
has the tile path (``_w4a8_plan``), the default launch against a ``rowdot``
launch bit for bit. The checked cases add M 17, 33, 100 and 1000, N 200 and
4104, 2-bit (K 11008: planes of 2752 bytes, not a multiple of the 128-byte
step) and 8-bit codes (0 to 255), the flat entry and the last layer of a
stack. The timed cases are Llama-2-7B's four projections at 4 bits (qkv
12288 x 4096, o 4096 x 4096, gate/up 22016 x 4096, down 4096 x 11008) at M
512 and 2048: the kernel's median device time per launch (launches captured
in a CUDA graph, 5 replays, the packed weights rotated over enough layers to
come from device memory), the yardstick ``torch._int_mm`` on the codes
unpacked to int8 (u - maxq) beforehand plus the rescale, and the bound (int8
operations over 1979 TOP/s or bytes over 3.35 TB/s, the larger). Then it
prints one JSON line ``{"root", "card", "cases", "sweep"}``.
``--check-only`` runs the checks and no timing. ``--sweep`` (a tree with
the tile path) times, at each M of 8, 9, 16, 17, 24, 32, 48, 64, 96, 128,
192, 256 and 512 and each projection, the ``rowdot`` launch (up to M 128)
and the tile launch at 64 and 128 activation rows a tile, each checked
first: the data that sets the M threshold and the tile. The script exits
non-zero if any case fails its checks. To compare two trees, run it on
each in one call, in turns (A, B, B, A): two calls may land on two cards.
"""

import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import _bound_ms, _card_line, _time_ms  # noqa: E402

SHAPES = [("qkv", 12288, 4096), ("o", 4096, 4096), ("gate/up", 22016, 4096),
          ("down", 4096, 11008)]
# (name, N, K, bits, M, flat): checked only
CHECKS = ([("ragged", N, 1024, bits, M, False) for N in (200, 4104)
           for bits in (2, 4, 8) for M in (17, 33, 100)]
          + [("down 2-bit", 4096, 11008, 2, M, False) for M in (64, 1000)]
          + [("flat", 200, 2048, bits, M, True) for bits in (2, 4, 8)
             for M in (17, 128)]
          + [("o", 4096, 4096, 4, M, False) for M in (128, 1000)])
SWEEP_M = (8, 9, 16, 17, 24, 32, 48, 64, 96, 128, 192, 256, 512)
SWEEP_ROWDOT_MAX_M = 128  # rowdot is timed up to here


def _inputs(torch, gen, dev, N, Kd, bits, M, layers):
    f = 8 // bits
    packed = torch.randint(0, 256, (layers, N, Kd // f), generator=gen,
                           dtype=torch.uint8, device=dev)
    scales = torch.rand((layers, N, 1), generator=gen,
                        device=dev) * 0.01 + 0.001
    x = torch.randn((M, Kd), generator=gen, device=dev)
    return x, packed, scales


def _layers(N, Kd, bits):
    return max(2, math.ceil(200e6 / (N * Kd // (8 // bits))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        _build, kernels as K)
    _build.library("w4a8_stacked")
    for line in _build.build_log("w4a8_stacked").splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "error")):
            print(f"w4a8_stacked: {line.strip()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tiled = hasattr(K, "_w4a8_plan")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases, failed, sweep = [], [], []

    def launch(xq, sx, packed, scales, layer, bits, **kw):
        return K._launch_w4a8_stacked(xq, sx, packed, scales, layer, bits,
                                      **kw)

    def check(name, N, Kd, bits, M, x, packed, scales, layer, flat=False):
        if flat:
            y = K.quantized_matmul_w4a8(x, packed[layer], scales[layer],
                                        bits)
        else:
            y = K.quantized_matmul_w4a8_stacked(x, packed, scales, layer,
                                                bits)
        ref = K.quantized_matmul_w4a8_stacked_plain(x, packed, scales, layer,
                                                    bits)
        case = dict(case=name, M=M, N=N, K=Kd, bits=bits, flat=flat,
                    equal_plain=bool(torch.equal(y, ref)),
                    max_abs_err=float((y - ref).abs().max()))
        if tiled:
            xq, sx = K.quantize_activations_int8(x)
            case["plan"] = K._w4a8_plan(M, N, Kd, bits, sms)
            y_row = launch(xq, sx, packed, scales, layer, bits,
                           path="rowdot")
            case["equal_rowdot"] = bool(torch.equal(y, y_row))
            case["equal_repeat"] = bool(torch.equal(y, launch(
                xq, sx, packed, scales, layer, bits)))
        print(json.dumps(case), flush=True)
        if not all(v for k, v in case.items() if k.startswith("equal")):
            failed.append(f"{name} M={M} N={N} {bits}-bit")
        return case

    for name, N, Kd, bits, M, flat in CHECKS:
        x, packed, scales = _inputs(torch, gen, dev, N, Kd, bits, M, 3)
        cases.append(check(name, N, Kd, bits, M, x, packed, scales, 2, flat))

    for M in (512, 2048):
        for name, N, Kd in SHAPES:
            Lk = _layers(N, Kd, 4)
            x, packed, scales = _inputs(torch, gen, dev, N, Kd, 4, M, Lk)
            case = check(name, N, Kd, 4, M, x, packed, scales, Lk - 1)
            cases.append(case)
            if args.check_only:
                continue
            xq, sx = K.quantize_activations_int8(x)
            once = _time_ms(torch, lambda i: launch(
                xq, sx, packed, scales, i % Lk, 4), 1, reps=1)
            iters = max(2, min(20, int(30 / max(once, 1e-3))))
            case["ms"] = _time_ms(torch, lambda i: launch(
                xq, sx, packed, scales, i % Lk, 4), iters)
            # the yardstick: one int8 GEMM on the codes unpacked to int8
            # beforehand (u - maxq), then the same rescale
            W = [(K.unpack_codes(packed[i], 4).to(torch.int16) - 7)
                 .to(torch.int8) for i in range(Lk)]
            srow = [scales[i].reshape(1, -1) for i in range(Lk)]
            lib = (torch._int_mm(xq, W[Lk - 1].t()).float()
                   * srow[Lk - 1]) * sx
            ref = K.quantized_matmul_w4a8_stacked_plain(x, packed, scales,
                                                        Lk - 1, 4)
            case["int_mm_equal_plain"] = bool(torch.equal(lib, ref))
            case["int_mm_ms"] = _time_ms(torch, lambda i: (torch._int_mm(
                xq, W[i % Lk].t()).float() * srow[i % Lk]) * sx, iters)
            del W
            nbytes = M * Kd + M * 4 + N * Kd // 2 + N * 4 + M * N * 4
            case["bound_ms"], case["bound_by"] = _bound_ms(
                nbytes, 2 * M * N * Kd)
            case["share_of_bound"] = case["bound_ms"] / case["ms"]
            print(json.dumps(case), flush=True)
            del x, packed, scales
            torch.cuda.empty_cache()

    if args.sweep and tiled and not args.check_only:
        for M in SWEEP_M:
            for name, N, Kd in SHAPES:
                Lk = _layers(N, Kd, 4)
                x, packed, scales = _inputs(torch, gen, dev, N, Kd, 4, M, Lk)
                xq, sx = K.quantize_activations_int8(x)
                ref = K.quantized_matmul_w4a8_stacked_plain(
                    x, packed, scales, Lk - 1, 4)
                row = dict(M=M, case=name, N=N, K=Kd,
                           plan=K._w4a8_plan(M, N, Kd, 4, sms)["rows"])
                for label, kw in (("rowdot", dict(path="rowdot")),
                                  ("tile64", dict(path="tile", rows=64)),
                                  ("tile128", dict(path="tile", rows=128))):
                    if label == "rowdot" and M > SWEEP_ROWDOT_MAX_M:
                        continue
                    y = launch(xq, sx, packed, scales, Lk - 1, 4, **kw)
                    if not torch.equal(y, ref):
                        failed.append(f"sweep {label} {name} M={M}")
                        continue
                    row[label] = _time_ms(torch, lambda i: launch(
                        xq, sx, packed, scales, i % Lk, 4, **kw), 20)
                print(json.dumps(row), flush=True)
                sweep.append(row)
                del x, packed, scales
                torch.cuda.empty_cache()

    print(json.dumps({"root": args.root, "card": _card_line(),
                      "cases": cases, "sweep": sweep}))
    if failed:
        print(f"not bit-equal to the plain version, the rowdot launch or "
              f"itself: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
