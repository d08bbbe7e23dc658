#!/usr/bin/env python3
"""Device times of the whole-step megakernel (``ops/megastep.py::megastep``)
and of the decode step that runs on it, on one card, for an A/B of two
trees.

    python3 scripts/torch_megastep_times.py [--root TREE] [--out FILE]
                                            [--against FILE]

imports the port package from ``TREE`` (default: this checkout), builds its
two megastep libraries (printing nvcc's ``-Xptxas -v`` lines: registers,
shared memory, spills), and at Llama-2-7B width, 32 layers, rank 128, T
256, every row at position 128 (phase 10's operands, as
``scripts/torch_megastep_stages.py`` builds them), 4-bit at B 8, 1 and 32
and 2-bit at B 8, times

- ``launch_ms``: the launch alone (``_launch``; 3 launches captured in a
  CUDA graph, median of 5 replays per launch);
- ``step_ms``: phase 10's step, ``decode_step_persistent`` (the megastep
  and the int8 head), captured as a CUDA graph, median of 9 replays;

and prints the cooperative grid (CTAs, CTAs per SM). ``--out`` saves each
case's outputs ``(x, k8, ks8, v8, vs8)``; ``--against`` compares this
tree's with such a file: bit for bit, and the rel-Frobenius of x where
they differ, the codes that differ in k8 and v8. To compare two trees A
and B, run it four times in one call, in turns (A, B, B, A): the first
with ``--out``, the others with ``--against`` that file. Last line: one
JSON object ``{"root", "card", "ptxas", "cases"}``.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import _card_line, _time_ms  # noqa: E402
from torch_megastep_stages import (  # noqa: E402
    load_port, mega_case, mega_params)

CASES = ((4, 8), (4, 1), (4, 32), (2, 8))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--out")
    ap.add_argument("--against")
    ap.add_argument("--layers", type=int, default=32)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    _build, MS = load_port(args.root)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        persistent)
    _build.build(["megastep", "megastep_2bit", "int8_matmul"])
    ptxas = []
    for n in ("megastep", "megastep_2bit"):
        for line in _build.build_log(n).splitlines():
            if "megastep_kernel" in line and "Compiling" in line:
                ptxas.append(f"{n}: {line.strip()}")
            elif any(w in line for w in ("registers", "spill")):
                ptxas.append(f"{n}: {line.strip()}")
    for line in ptxas:
        print(line, flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ref = torch.load(args.against) if args.against else {}
    saved, cases = {}, []
    for bits in (4, 2):
        cfg, params, prep = mega_params(torch, dev, bits, args.layers)
        for b2, B in CASES:
            if b2 != bits:
                continue
            margs, kw, tok, pos, cache = mega_case(torch, dev, cfg, params,
                                                   prep, B)
            a = MS._named(margs, **kw)
            ctas = MS._launch(a, grid_only=True)
            out, _ = MS._launch(a)
            again, _ = MS._launch(a)
            repeat = all(torch.equal(x, y) for x, y in zip(out, again))
            launch_ms = _time_ms(torch, lambda i: MS._launch(a), 3)
            step_ms = _time_ms(torch, lambda i: persistent.
                               decode_step_persistent(params, tok, pos,
                                                      cache, cfg, prep=prep),
                               1, reps=9)
            key = f"{bits}-bit B {B}"
            saved[key] = [t.cpu() for t in out]
            row = dict(case=key, ctas=ctas, per_sm=ctas / sms,
                       launch_ms=launch_ms, step_ms=step_ms,
                       repeat_equal=repeat)
            if key in ref:
                r = ref[key]
                row["equal"] = all(torch.equal(x.cpu(), y)
                                   for x, y in zip(out, r))
                x, rx = out[0].cpu().double(), r[0].double()
                row["x_rel"] = float((x - rx).norm() / rx.norm())
                row["k8_differ"] = int((out[1].cpu() != r[1]).sum())
                row["v8_differ"] = int((out[3].cpu() != r[3]).sum())
            print(json.dumps(row), flush=True)
            cases.append(row)
            del cache, margs, a, out, again
        del params, prep
        torch.cuda.empty_cache()
    if args.out:
        torch.save(saved, args.out)
    print(json.dumps({"root": args.root, "card": _card_line(),
                      "ptxas": ptxas, "cases": cases}))
    return 0 if all(c["repeat_equal"] for c in cases) else 1


if __name__ == "__main__":
    sys.exit(main())
