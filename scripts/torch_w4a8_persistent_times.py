#!/usr/bin/env python3
"""Device times of the W4A8 kernel's persistent launch at decode M
(``K.quantized_matmul_w4a8_stacked_persistent``, row 4 of PERF.md's kernel
table) on one card, beside row 3's two designs on the same operands.

    python3 scripts/torch_w4a8_persistent_times.py [--root TREE] [--out F]
                                                   [--against F]

imports the port package from ``TREE`` (default: this checkout; an A/B
unpacks the parent with ``git archive`` into a directory ``.gitignore``
lists) and runs the cases:

- Llama-2-7B's o (4096 x 4096) and down (4096 x 11008), 4-bit, at M 1, 3
  and 8; down at 2 bits and o at 8 bits, M 8;
- down's width at K 24576, M 8 (a tree whose persistent launch refuses it
  records the refusal);
- beside every M 8 case, on the same operands: row 3's grid launch on its
  ``rowdot`` kernel and on its tile path (``_launch_w4a8_stacked(...,
  path="rowdot" | "tile")``).

Weights are seeded (``torch.Generator``, a seed a shape) and rotate over enough
layers (>= 200 MB) to come from device memory. Each case: the persistent
launch's device time (``chip_smoke._time_ms``: a CUDA graph of launches,
median of 5 replays) beside the bytes' bound; its output held bit for bit
against row 3's grid launch and against a second launch of its own. ``--out
F`` writes the JSON line and the outputs (``F.pt``); ``--against F``
compares every output with that run's (bit for bit) and prints the time
ratio. The last line is one JSON object ``{"root", "card", "cases"}``; the
script exits non-zero if a check fails.
"""

import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import HBM_BYTES_PER_S, _card_line, _time_ms  # noqa: E402

# (name, N, K, bits, M)
CASES = ([("o", 4096, 4096, 4, M) for M in (1, 3, 8)]
         + [("down", 4096, 11008, 4, M) for M in (1, 3, 8)]
         + [("down", 4096, 11008, 2, 8), ("o", 4096, 4096, 8, 8),
            ("down K 24576", 4096, 24576, 4, 8)])
ITERS = 50


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--out", help="write the JSON line and F.pt outputs")
    ap.add_argument("--against", help="compare with an earlier --out run")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        _build, kernels as K)
    _build.build(["w4a8_stacked", "grouped_matmul"])
    dev = torch.device("cuda")
    card = _card_line()
    print(f"card: {card}; root {args.root}", flush=True)
    other, other_out = {}, {}
    if args.against:
        with open(args.against) as fh:
            other = {c["name"]: c for c in json.loads(fh.read())["cases"]}
        other_out = torch.load(args.against + ".pt")
    cases, outs, failed = [], {}, []
    for name, N, Kd, bits, M in CASES:
        label = f"{name} M={M} {bits}-bit"
        f = 8 // bits
        gen = torch.Generator(device=dev)
        gen.manual_seed(N + Kd + bits)
        layer_bytes = N * Kd // f
        Lk = max(2, math.ceil(200e6 / layer_bytes))
        packed = torch.randint(0, 256, (Lk, N, Kd // f), generator=gen,
                               dtype=torch.uint8, device=dev)
        scales = torch.rand((Lk, N, 1), generator=gen, device=dev) * 0.01
        x = torch.randn((M, Kd), generator=gen, device=dev)
        xq, sx = K.quantize_activations_int8(x)
        nbytes = layer_bytes + N * 4 + M * Kd + M * 4 + M * N * 4
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        rec = dict(name=label, N=N, K=Kd, bits=bits, M=M, bound_ms=bound)

        def launch(i, **kw):
            return K._launch_w4a8_stacked(xq, sx, packed, scales, i % Lk,
                                          bits, **kw)
        try:
            y = K.quantized_matmul_w4a8_stacked_persistent(x, packed,
                                                           scales, 1, bits)
        except ValueError as e:
            rec["refused"] = str(e)
            print(f"{label}: the persistent launch refuses it: {e}",
                  flush=True)
            cases.append(rec)
            del packed
            torch.cuda.empty_cache()
            continue
        y2 = launch(1, persistent=True)   # the same codes and scales as y's
        grid = launch(1)
        torch.cuda.synchronize()
        rec["equal_grid"] = bool(torch.equal(y, grid))
        rec["repeat_equal"] = bool(torch.equal(y, y2))
        rec["ms"] = _time_ms(torch, lambda i: launch(i, persistent=True),
                             ITERS)
        line = (f"{label}: persistent {rec['ms']:.4f} ms "
                f"({bound / rec['ms']:.1%} of the {bound:.4f} ms bound), "
                f"equal to the grid launch "
                f"{rec['equal_grid']}, repeat equal {rec['repeat_equal']}")
        if M == 8:
            for path in ("rowdot", "tile"):
                yp = launch(1, path=path)
                torch.cuda.synchronize()
                rec[f"{path}_equal"] = bool(torch.equal(y, yp))
                rec[f"{path}_ms"] = _time_ms(
                    torch, lambda i: launch(i, path=path), ITERS)
                line += (f"; row 3 {path} {rec[f'{path}_ms']:.4f} ms "
                         f"(equal {rec[f'{path}_equal']})")
        if label in other and "ms" in other[label]:
            o = other_out[label].to(dev)
            rec["equal_other"] = bool(torch.equal(y, o))
            rec["ratio"] = rec["ms"] / other[label]["ms"]
            line += (f"; against --against: {rec['ratio']:.3f}x its "
                     f"{other[label]['ms']:.4f} ms, bit-equal "
                     f"{rec['equal_other']}")
        print(line, flush=True)
        if not (rec["equal_grid"] and rec["repeat_equal"]
                and rec.get("equal_other", True)
                and rec.get("rowdot_equal", True)
                and rec.get("tile_equal", True)):
            failed.append(label)
        cases.append(rec)
        outs[label] = y.cpu()
        del packed
        torch.cuda.empty_cache()
    summary = {"root": args.root, "card": card, "cases": cases}
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(json.dumps(summary) + "\n")
        torch.save(outs, args.out + ".pt")
    print(json.dumps(summary))
    for f in failed:
        print(f"FAILED: {f}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
