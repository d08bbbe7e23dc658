#!/usr/bin/env python3
"""Device times of the port's int8 head kernel (``int8_matmul``,
``csrc/int8_matmul.cu``) on the Llama-2-7B head beside ``torch._int_mm``, and
of the W4A8 kernel's persistent launch (``quantized_matmul_w4a8_stacked_
persistent``) beside its grid launch, each case checked first.

    python3 scripts/torch_int8_times.py [--root TREE] [--check-only]
                                        [--sweep] [--out F] [--against F]

imports the port package from ``TREE`` (default: this checkout), builds only
the ``int8_matmul`` and ``w4a8_stacked`` libraries and prints nvcc's
``-Xptxas -v`` lines (registers, shared memory, spills). Every case is held
bit for bit to the plain version run on the card on the same inputs (the i32
sums are exact and the f32 epilogue keeps one order) and, where the tree has
the tile path (``_int8_plan``), to a launch of each tile it allows.

- Checked only: M 9, 17, 33, 65 and 130 at N 300 and 32000, K 4096.
- Timed, the head (N 32000, K 4096) at M 1, 8, 9, 16, 17, 32, 64, 65,
  128, 1024 and 2048: the default launch (with its plan), the tile path at
  each tile it allows (swapped, 64 activation columns, up to M 128; above M
  64: 128 activation rows by 128 and 256 weight rows), ``torch._int_mm``
  plus the rescale where it takes M (M > 16), and the bound (bytes over 3.35 TB/s or int8 operations over 1979
  TOP/s, the larger). Device time: the launches captured in a CUDA graph, the
  median of 5 replays; two copies of the weights (262 MB) rotated, so they
  come from device memory.
- Row 4: the persistent launch and the grid launch on Llama-2-7B's o (4096
  x 4096) and down (4096 x 11008), 4-bit, at M 8, 9 and 512, bit-equal to
  each other and to the plain version, beside ``torch._int_mm`` on the codes
  unpacked beforehand (M 512).

``--sweep`` (a tree with the tile path) times the swapped against the
128-row tiles at M 96 and 128 and the 128- against the 256-row weight tiles
at M 96 to 4096: the data that sets the plan's rule. A tree without the
tile path runs the rowdot kernel that the tile path replaced. ``--out F``
writes each case's output digest (sha256 of its bytes) to F;
``--against F`` compares this run's digests with F's. To compare two trees,
run parent, change, change, parent in one call (two calls may land on two
cards). Last line: one JSON object ``{"root", "card", "cases", "row4",
"sweep", "against"}``. Exits non-zero if any check fails.
"""

import argparse
import hashlib
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import _bound_ms, _card_line, _time_ms  # noqa: E402

N_HEAD, K_HEAD = 32000, 4096
TIMED_M = (1, 8, 9, 16, 17, 32, 64, 65, 128, 1024, 2048)
CHECKS = [(M, N, 4096) for M in (9, 17, 33, 65, 130) for N in (300, 32000)]
ROW4 = [("o", 4096, 4096), ("down", 4096, 11008)]
ROW4_M = (8, 9, 512)
SWEEP_M = (96, 128, 192, 256, 512, 1024, 2048, 4096)


def _digest(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def _tile_variants(K, M, N):
    """(label, launch kwargs) of every tile the plan allows at M, N."""
    out = [("swap64", dict(rows=64))] if M <= 128 else []
    if M > 64 and N % 4 == 0:
        out += [(f"tile128x{c}", dict(rows=128, cols=c)) for c in (128, 256)]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--against")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        _build, kernels as K)
    for lib in ("int8_matmul", "w4a8_stacked"):
        _build.library(lib)
        for line in _build.build_log(lib).splitlines():
            if any(w in line for w in ("registers", "spill", "error")):
                print(f"{lib}: {line.strip()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tiled = hasattr(K, "_int8_plan")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases, row4, sweep, failed, digests = [], [], [], [], {}

    def weights(N, Kd, copies):
        w8 = [torch.randint(-127, 128, (N, Kd), generator=gen,
                            dtype=torch.int8, device=dev)
              for _ in range(copies)]
        s = [torch.rand((N, 1), generator=gen, device=dev) * 0.01 + 0.001
             for _ in range(copies)]
        return w8, s

    def launch(xq, sx, w8, s, **kw):
        return K._launch_int8_matmul(xq, sx, w8, s, **kw)

    def check(M, N, Kd, w8, s, key):
        x = torch.randn((M, Kd), generator=gen, device=dev)
        y = K.int8_matmul(x, w8, s)
        ref = K.int8_matmul_plain(x, w8, s)
        case = dict(case=key, M=M, N=N, K=Kd,
                    equal_plain=bool(torch.equal(y, ref)),
                    max_abs_err=float((y - ref).abs().max()))
        digests[key] = _digest(y)
        xq, sx = K.quantize_activations_int8(x)
        if tiled:
            case["plan"] = K._int8_plan(M, N, Kd, sms)
            for label, kw in _tile_variants(Kd, M, N):
                case[f"equal_{label}"] = bool(torch.equal(
                    y, launch(xq, sx, w8, s, **kw)))
        case["equal_repeat"] = bool(torch.equal(y, K.int8_matmul(x, w8, s)))
        print(json.dumps(case), flush=True)
        if not all(v for k, v in case.items() if k.startswith("equal")):
            failed.append(key)
        return case, x, xq, sx

    for M, N, Kd in CHECKS:
        w8, s = weights(N, Kd, 1)
        cases.append(check(M, N, Kd, w8[0], s[0], f"check M={M} N={N}")[0])
        del w8, s

    w8s, ss = weights(N_HEAD, K_HEAD, 2)
    srows = [t.reshape(1, -1) for t in ss]
    for M in TIMED_M:
        case, x, xq, sx = check(M, N_HEAD, K_HEAD, w8s[1], ss[1],
                                f"head M={M}")
        cases.append(case)
        if args.check_only:
            continue
        once = _time_ms(torch, lambda i: launch(xq, sx, w8s[i % 2],
                                                ss[i % 2]), 1, reps=1)
        iters = max(2, min(20, int(20 / max(once, 1e-3))))

        def timed(**kw):
            return _time_ms(torch, lambda i: launch(
                xq, sx, w8s[i % 2], ss[i % 2], **kw), iters)

        case["ms"] = timed()
        if tiled:
            for label, kw in _tile_variants(K_HEAD, M, N_HEAD):
                case[f"{label}_ms"] = timed(**kw)
        if M > 16:
            lib = (torch._int_mm(xq, w8s[1].t()).float() * srows[1]) * sx
            case["int_mm_equal_plain"] = bool(torch.equal(
                lib, K.int8_matmul_plain(x, w8s[1], ss[1])))
            case["int_mm_ms"] = _time_ms(torch, lambda i: (torch._int_mm(
                xq, w8s[i % 2].t()).float() * srows[i % 2]) * sx, iters)
        nbytes = (M * K_HEAD + M * 4 + N_HEAD * K_HEAD + N_HEAD * 4
                  + M * N_HEAD * 4)
        case["bound_ms"], case["bound_by"] = _bound_ms(
            nbytes, 2 * M * N_HEAD * K_HEAD)
        case["share_of_bound"] = case["bound_ms"] / case["ms"]
        print(json.dumps(case), flush=True)
        del x

    if args.sweep and tiled and not args.check_only:
        gen_sweep = torch.Generator(device=dev)
        gen_sweep.manual_seed(2)
        for M in SWEEP_M:
            x = torch.randn((M, K_HEAD), generator=gen_sweep, device=dev)
            xq, sx = K.quantize_activations_int8(x)
            ref = K.int8_matmul_plain(x, w8s[1], ss[1])
            row = dict(M=M, plan=K._int8_plan(M, N_HEAD, K_HEAD, sms))
            for label, kw in _tile_variants(K_HEAD, M, N_HEAD):
                if not torch.equal(launch(xq, sx, w8s[1], ss[1], **kw), ref):
                    failed.append(f"sweep {label} M={M}")
                    continue
                row[label] = _time_ms(torch, lambda i: launch(
                    xq, sx, w8s[i % 2], ss[i % 2], **kw), 10)
            print(json.dumps(row), flush=True)
            sweep.append(row)
            del x
    del w8s, ss
    torch.cuda.empty_cache()

    # the row 4 cases draw from a generator of their own, so that a tree
    # without the sweep draws the same inputs
    gen.manual_seed(3)
    for name, N, Kd in ROW4:
        Lk = max(2, math.ceil(200e6 / (N * Kd // 2)))
        packed = torch.randint(0, 256, (Lk, N, Kd // 2), generator=gen,
                               dtype=torch.uint8, device=dev)
        scales = torch.rand((Lk, N, 1), generator=gen, device=dev) * 0.01
        for M in ROW4_M:
            x = torch.randn((M, Kd), generator=gen, device=dev)
            y = K.quantized_matmul_w4a8_stacked_persistent(x, packed, scales,
                                                           Lk - 1, 4)
            key = f"row4 {name} M={M}"
            digests[key] = _digest(y)
            rec = dict(case=key, M=M, N=N, K=Kd, equal_grid=bool(
                torch.equal(y, K.quantized_matmul_w4a8_stacked(
                    x, packed, scales, Lk - 1, 4))),
                equal_plain=bool(torch.equal(
                    y, K.quantized_matmul_w4a8_stacked_plain(
                        x, packed, scales, Lk - 1, 4))))
            if not (rec["equal_grid"] and rec["equal_plain"]):
                failed.append(key)
            if not args.check_only:
                xq, sx = K.quantize_activations_int8(x)
                iters = 20 if M < 512 else 5
                rec["ms"] = _time_ms(torch, lambda i: K._launch_w4a8_stacked(
                    xq, sx, packed, scales, i % Lk, 4, persistent=True),
                    iters)
                rec["grid_ms"] = _time_ms(
                    torch, lambda i: K._launch_w4a8_stacked(
                        xq, sx, packed, scales, i % Lk, 4), iters)
                if M > 16:
                    W = [(K.unpack_codes(packed[i], 4).to(torch.int16) - 7)
                         .to(torch.int8) for i in range(Lk)]
                    srow = [scales[i].reshape(1, -1) for i in range(Lk)]
                    rec["int_mm_ms"] = _time_ms(torch, lambda i: (
                        torch._int_mm(xq, W[i % Lk].t()).float()
                        * srow[i % Lk]) * sx, iters)
                    del W
                nbytes = M * Kd + M * 4 + N * Kd // 2 + N * 4 + M * N * 4
                rec["bound_ms"], rec["bound_by"] = _bound_ms(
                    nbytes, 2 * M * N * Kd)
            print(json.dumps(rec), flush=True)
            row4.append(rec)
        del packed
        torch.cuda.empty_cache()

    against = None
    if args.against:
        with open(args.against) as f:
            ref = json.load(f)
        against = {k: ref.get(k) == v for k, v in digests.items()}
        print(f"against {args.against}: "
              f"{sum(against.values())} of {len(against)} outputs equal bit "
              f"for bit", flush=True)
        failed += [f"against {k}" for k, ok in against.items() if not ok]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(digests, f)
    print(json.dumps({"root": args.root, "card": _card_line(),
                      "cases": cases, "row4": row4, "sweep": sweep,
                      "against": against}))
    if failed:
        print(f"failed: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
