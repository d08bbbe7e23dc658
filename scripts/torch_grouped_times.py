#!/usr/bin/env python3
"""Device times of the port's grouped bf16 matmul ``quantized_matmul``
(``csrc/grouped_matmul.cu``) beside cuBLAS, at the shapes ``PERF.md``
records, each checked against the plain version first.

    python3 scripts/torch_grouped_times.py [--root TREE] [--check-only]
                                           [--sweep]

imports the port package from ``TREE`` (default: this checkout), builds
only the kernel's own library, prints nvcc's ``-Xptxas -v`` lines (registers,
shared memory, spills), and holds every case against
``quantized_matmul_plain`` on the same inputs (rtol 1e-5, atol 1e-5 x
max|ref|: exact bf16 products, f32 sums in another order) and two launches
against each other, bit for bit. The timed cases are Llama-2-7B's three
projection shapes at 4 bits (q/k/v/o 4096 x 4096 and gate/up 11008 x 4096
with G 512, down 4096 x 11008 with G 128) at M 8, 512 and 1024; the checked
ones add M 1, 16, 17 and 65 at 4096 x 4096, a plane whose length is 32 past
a multiple of 64 (N 200, K 320 at 4 bits), 2-bit and 8-bit codes, and G 48.
Then it prints one JSON line ``{"root", "card", "cases": [...]}``: per case
the kernel's median device time per launch (launches captured in a CUDA
graph, 5 replays, the packed weights rotated over enough layers to come
from device memory), one bf16 ``torch.matmul`` on the same weights
dequantized beforehand (cuBLAS), the bound (bytes over 3.35 TB/s or bf16
operations over 989 TFLOP/s, the larger), the plan, and per M the mean of
one layer's seven launches (four q/k/v/o, two gate/up, one down).
``--check-only`` runs the checks and no timing; ``--sweep`` adds, for each
timed case, the time at each split of K into steps of 1, 2, 4, 8, 11, 16,
22, 32, 43 and 86 (``sweep``: splits x steps -> ms), each split checked
too. The script exits non-zero if any case fails its checks. To compare two
trees, run it on each in one call, in turns (A, B, B, A): two calls may
land on two cards.
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

SHAPES = [("q/k/v/o", 4096, 4096, 4), ("gate/up", 11008, 4096, 2),
          ("down", 4096, 11008, 1)]
# (name, N, K, bits, G or None, M): checked only
CHECKS = ([("4096^2", 4096, 4096, 4, None, M) for M in (1, 16, 17, 65)]
          + [("P%64=32", 200, 320, 4, None, M) for M in (8, 40)]
          + [("2-bit", 200, 1024, 2, None, M) for M in (5, 100)]
          + [("8-bit G48", 200, 768, 8, 48, M) for M in (3, 33)])


def _inputs(torch, gen, dev, N, Kd, bits, G, M, layers):
    f = 8 // bits
    packed = torch.randint(0, 255 if bits == 8 else 256,
                           (layers, N, Kd // f), generator=gen,
                           dtype=torch.uint8, device=dev)
    scales = torch.rand((layers, N, Kd // G), generator=gen,
                        device=dev) * 0.01 + 0.001
    x = torch.randn((M, Kd), generator=gen, device=dev)
    return x, packed, scales


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
    _build.library("grouped_matmul")
    for line in _build.build_log("grouped_matmul").splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "error")):
            print(f"grouped_matmul: {line.strip()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    plan_of = getattr(K, "_grouped_plan", None)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases, failed = [], []

    def check(name, N, Kd, bits, G, M, x, packed, scales, layer):
        y = K.quantized_matmul(x, packed[layer], scales[layer], bits, G)
        ref = K.quantized_matmul_plain(x, packed[layer], scales[layer], bits,
                                       G)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        tol = 1e-5 * float(ref.abs().max())
        ok = bool(torch.allclose(y, ref, rtol=1e-5, atol=tol))
        same = bool(torch.equal(y, K.quantized_matmul(
            x, packed[layer], scales[layer], bits, G)))
        plan = plan_of(M, N, Kd, bits, sms) if plan_of else None
        case = dict(case=name, M=M, N=N, K=Kd, bits=bits, G=G,
                    max_abs_err=err, atol=tol, ok=ok, repeat_equal=same,
                    plan=plan)
        print(json.dumps(case), flush=True)
        if not (ok and same):
            failed.append(f"{name} M={M}")
        return case, ref

    for name, N, Kd, bits, G, M in CHECKS:
        G = K.resolve_group(bits, Kd, G)
        x, packed, scales = _inputs(torch, gen, dev, N, Kd, bits, G, M, 2)
        cases.append(check(name, N, Kd, bits, G, M, x, packed, scales, 1)[0])

    means = {}
    for M in (8, 512, 1024):
        sums = [0.0] * 4  # launch-weighted ms, cuBLAS ms, bytes, ops
        for name, N, Kd, count in SHAPES:
            G = K.resolve_group(4, Kd, None)
            P = Kd // 2
            Lk = max(2, math.ceil(200e6 / (N * P)))
            x, packed, scales = _inputs(torch, gen, dev, N, Kd, 4, G, M, Lk)
            case, ref = check(name, N, Kd, 4, G, M, x, packed, scales, Lk - 1)
            cases.append(case)
            if args.check_only or not (case["ok"] and case["repeat_equal"]):
                continue
            xb = x.to(torch.bfloat16)
            iters = 50 if M <= 64 else 10
            case["ms"] = _time_ms(torch, lambda i: K._launch_grouped(
                xb, packed[i % Lk], scales[i % Lk], 4, G), iters)
            W = [K.dequant_serving_xla(packed[i], scales[i], 4)
                 for i in range(Lk)]
            case["cublas_ms"] = _time_ms(torch, lambda i: torch.matmul(
                xb, W[i % Lk].T), iters)
            del W
            nbytes = M * Kd * 2 + N * P + N * (Kd // G) * 4 + M * N * 4
            ops = 2 * M * N * Kd
            case["bound_ms"], case["bound_by"] = _bound_ms(
                nbytes, ops, BF16_OPS_PER_S)
            for j, v in enumerate((case["ms"], case["cublas_ms"], nbytes,
                                   ops)):
                sums[j] += count * v
            if args.sweep and plan_of:
                case["sweep"] = {}
                k_steps = -(-P // 64)
                for step in (1, 2, 4, 8, 11, 16, 22, 32, 43, 86):
                    if step > k_steps:
                        continue
                    splits = -(-k_steps // step)
                    ys = K._launch_grouped(xb, packed[Lk - 1],
                                           scales[Lk - 1], 4, G, step)
                    if not torch.allclose(ys, ref, rtol=1e-5,
                                          atol=case["atol"]):
                        failed.append(f"{name} M={M} {splits}x{step}")
                    case["sweep"][f"{splits}x{step}"] = _time_ms(
                        torch, lambda i: K._launch_grouped(
                            xb, packed[i % Lk], scales[i % Lk], 4, G, step),
                        iters)
            print(json.dumps({k: case[k] for k in case if k != "plan"}),
                  flush=True)
            del x, packed, scales
        if not args.check_only and sums[0]:
            mean = [v / 7 for v in sums]
            bound, by = _bound_ms(mean[2], mean[3], BF16_OPS_PER_S)
            means[M] = dict(ms=mean[0], cublas_ms=mean[1], bound_ms=bound,
                            bound_by=by)
            print(f"M={M}: mean of one layer's 7 launches {mean[0]:.4f} ms, "
                  f"cuBLAS {mean[1]:.4f} ms, bound {bound:.4f} ms ({by})",
                  flush=True)
    print(json.dumps({"root": args.root, "card": _card_line(),
                      "means": means, "cases": cases}))
    if failed:
        print(f"disagree with the plain version or with themselves: "
              f"{', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
