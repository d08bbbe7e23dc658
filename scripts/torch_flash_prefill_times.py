#!/usr/bin/env python3
"""Device times of the port's ``flash_prefill`` kernel
(``csrc/flash_prefill.cu``) beside SDPA, each case checked first.

    python3 scripts/torch_flash_prefill_times.py [--root TREE] [--check-only]

imports the port package from ``TREE`` (default: this checkout), builds
only the kernel's own library and prints nvcc's ``-Xptxas -v`` lines
(registers, shared memory, spills). The cases are Llama-2-7B's heads (32,
D 128, B 1) at S 300, 512, 1024, 2048 and 4096, and Llama-3-8B's GQA (8 kv
heads of 4 query heads) at S 2048. Each case is held to three checks:

- normal q, k, v: ``allclose`` against ``flash_prefill_plain`` at rtol
  2e-5, atol 2e-6, and a second launch bit-equal to the first;
- sharp logits (q and k times 3): the kernel's max-abs error against a
  float64 attention at most 1.25x the plain f32 version's.

Then it prints one JSON line ``{"root", "card", "cases": [...]}``: per case
the kernel's median device time per launch (launches captured in a CUDA
graph, 5 replays), one f32 causal SDPA call on the same inputs (k and v
expanded to the query heads beforehand), and the bound: q, k, v and out
over 3.35 TB/s against three tf32 products for each causal operation at
495 TFLOP/s, with the f32-FMA bound (67 TFLOP/s) beside it.
``--check-only`` runs the checks and no timing. The script exits non-zero
if any case fails a check. To compare two trees, run it on each in one
call, in turns (A, B, B, A): two calls may land on two cards.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import (  # noqa: E402 (no port import)
    _card_line, _prefill_bounds, _prefill_sharp_errors, _time_ms)

CASES = ([("7b", S, 32, 1) for S in (300, 512, 1024, 2048, 4096)]
         + [("llama3-8b GQA", 2048, 8, 4)])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        _build, attention as AT)
    _build.library("flash_prefill")
    for line in _build.build_log("flash_prefill").splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "error")):
            print(f"flash_prefill: {line.strip()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases, failed = [], []
    for name, S, KVH, G in CASES:
        D, H = 128, KVH * G
        q, k, v = (torch.randn(shape, generator=gen, device=dev)
                   for shape in ((1, S, H, D), (1, S, KVH, D),
                                 (1, S, KVH, D)))
        out = AT.flash_prefill(q, k, v)
        ref = AT.flash_prefill_plain(q, k, v)
        torch.cuda.synchronize()
        ok = bool(torch.allclose(out, ref, rtol=2e-5, atol=2e-6))
        same = bool(torch.equal(out, AT.flash_prefill(q, k, v)))
        sharp_err, sharp_plain = _prefill_sharp_errors(torch, AT, 3 * q,
                                                       3 * k, v)
        sharp_ok = sharp_err <= 1.25 * sharp_plain
        case = dict(case=name, S=S, H=H, KVH=KVH, D=D,
                    max_abs_err=float((out - ref).abs().max()), ok=ok,
                    repeat_equal=same, sharp_err=sharp_err,
                    sharp_plain_err=sharp_plain, sharp_ok=sharp_ok)
        print(json.dumps(case), flush=True)
        if not (ok and same and sharp_ok):
            failed.append(f"{name} S={S}")
        elif not args.check_only:
            case["ms"] = _time_ms(torch, lambda i: AT.flash_prefill(q, k, v),
                                  10)
            qt = q.transpose(1, 2).contiguous()
            kt = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
            vt = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
            case["sdpa_ms"] = _time_ms(torch, lambda i: sdpa(
                qt, kt, vt, is_causal=True), 10)
            case["bound_ms"], case["bound_by"], case["f32_fma_bound_ms"] = (
                _prefill_bounds(S, H, KVH, D))
            del qt, kt, vt
        cases.append(case)
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    print(json.dumps({"root": args.root, "card": _card_line(),
                      "cases": cases}))
    if failed:
        print(f"fail their checks: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
