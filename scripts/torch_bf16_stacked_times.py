#!/usr/bin/env python3
"""Device times of the port's ``bf16_matmul_stacked`` kernel
(``csrc/bf16_gemm.cu``) beside cuBLAS, at the shapes ``PERF.md`` records,
each checked against the plain version first.

    python3 scripts/torch_bf16_stacked_times.py [--root TREE] [--check-only]
                                                [--sweep]

imports the port package from ``TREE`` (default: this checkout), builds
only the kernel's own library, prints nvcc's ``-Xptxas -v`` lines (registers,
shared memory, spills), and holds every case against
``bf16_matmul_stacked_plain`` on the same inputs (rtol 1e-5, atol 1e-5 x
max|ref|: exact bf16 products, f32 sums in another order) and two launches
at each split-K case against each other, bit for bit. Then it prints one
JSON line ``{"root", "card", "cases": [...]}``: per case the kernel's median
device time per launch (launches captured in a CUDA graph, 5 replays, W
rotated over enough layers to come from device memory), one bf16
``torch.matmul`` on the same operands (cuBLAS), the bound (bytes over 3.35
TB/s or operations over 989 TFLOP/s, the larger) and the plan. The cases
are the rank-128 factor shapes R (128 x 4096) and L (4096 x 128) and 4096 x
4096 at M 8 and 512, and 4096 x 4096 at M 1, 16, 17, 64 and 65.
``--check-only`` runs the checks and no timing; ``--sweep`` adds, for each
case, the time at every split of K into steps of 1, 2, 4, 8, 16, 22, 32
and 64 (``sweep``: splits x steps -> ms), each split checked too. The script exits non-zero
if any case fails its checks. To compare two trees, run it on each in one
call, in turns (A, B, B, A): two calls may land on two cards.
"""

import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import (  # noqa: E402 (no port import)
    BF16_OPS_PER_S, _bound_ms, _card_line, _time_ms)

CASES = ([("R", 128, 4096, M) for M in (8, 512)]
         + [("L", 4096, 128, M) for M in (8, 512)]
         + [("4096^2", 4096, 4096, M) for M in (8, 512, 1, 16, 17, 64, 65)])


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
    lib = "bf16_gemm" if "bf16_gemm" in _build.ENTRIES else "grouped_matmul"
    _build.library(lib)
    for line in _build.build_log(lib).splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "error")):
            print(f"{lib}: {line.strip()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    plan_of = getattr(K, "_bf16_stacked_plan", None)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases, failed = [], []
    for name, N, Kd, M in CASES:
        layer_bytes = N * Kd * 2
        Lk = max(2, math.ceil(200e6 / layer_bytes))
        W = (torch.randn((Lk, N, Kd), generator=gen, device=dev)
             * 0.05).to(torch.bfloat16)
        x = torch.randn((M, Kd), generator=gen, device=dev)
        y = K.bf16_matmul_stacked(x, W, Lk - 1)
        ref = K.bf16_matmul_stacked_plain(x, W, Lk - 1)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        tol = 1e-5 * float(ref.abs().max())
        ok = bool(torch.allclose(y, ref, rtol=1e-5, atol=tol))
        plan = plan_of(M, N, Kd, sms) if plan_of else None
        same = bool(torch.equal(y, K.bf16_matmul_stacked(x, W, Lk - 1)))
        case = dict(case=name, M=M, N=N, K=Kd, max_abs_err=err, atol=tol,
                    ok=ok, repeat_equal=same, plan=plan)
        print(json.dumps(case), flush=True)
        if not (ok and same):
            failed.append(f"{name} M={M}")
        xb = x.to(torch.bfloat16)
        iters = 50 if M <= 64 else 20
        if ok and same and not args.check_only:
            case["ms"] = _time_ms(torch, lambda i: K._launch_bf16_stacked(
                xb, W, i % Lk), iters)
            case["cublas_ms"] = _time_ms(torch, lambda i: torch.matmul(
                xb, W[i % Lk].T), iters)
            case["bound_ms"], case["bound_by"] = _bound_ms(
                M * Kd * 2 + layer_bytes + M * N * 4, 2 * M * N * Kd,
                BF16_OPS_PER_S)
        if args.sweep and plan_of:
            case["sweep"] = {}
            k_steps = -(-Kd // 64)
            for step in (1, 2, 4, 8, 16, 22, 32, 64):
                if step > k_steps:
                    continue
                splits = -(-k_steps // step)
                ys = K._launch_bf16_stacked(xb, W, Lk - 1, step)
                if not torch.allclose(ys, ref, rtol=1e-5, atol=tol):
                    failed.append(f"{name} M={M} {splits}x{step}")
                case["sweep"][f"{splits}x{step}"] = _time_ms(
                    torch, lambda i: K._launch_bf16_stacked(
                        xb, W, i % Lk, step), iters)
        cases.append(case)
        del W
    print(json.dumps({"root": args.root, "card": _card_line(),
                      "cases": cases}))
    if failed:
        print(f"disagree with the plain version or with themselves: "
              f"{', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
