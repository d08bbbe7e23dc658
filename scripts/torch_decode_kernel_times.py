#!/usr/bin/env python3
"""Device times of the port's CUDA decode-attention kernels at the shapes
``PERF.md`` records (Llama-2-7B heads, batch 8), for comparing two trees of
the repository on one card in one call.

    python3 scripts/torch_decode_kernel_times.py --root TREE [--build-only]

imports the port package from ``TREE`` (its ``build/kernels`` too), builds
its kernels, and prints one JSON line ``{"root": ..., "card": ..., "ms":
{case: ms}}``: each case's median device time per launch (50 launches
captured in a CUDA graph, 5 replays, caches rotated over enough layers to
come from device memory). The cases are the staged and inline kernels at
T 256, position 128; the all-batch kernel over a 4096-token cache at ragged
positions, staged and inline; the paged kernel on 16- and 256-token pages
over 2048 tokens per row; and the fused attention + o_proj kernel (f32).
Compare trees in turns within one call (A, B, B, A): two calls may land on
two cards.
"""

import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import _card_line, _time_ms  # noqa: E402 (no port import)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--build-only", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        _build, attention as AT)
    _build.build_all()
    if args.build_only:
        return 0
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    B, KVH, G, D = 8, 32, 1, 128
    ms = {}

    def cache(Lk, rows, T):
        shape = (Lk, rows, KVH, T)
        return (torch.randint(-127, 128, shape + (D,), generator=gen,
                              dtype=torch.int8, device=dev),
                torch.randint(-127, 128, shape + (D,), generator=gen,
                              dtype=torch.int8, device=dev),
                torch.rand(shape, generator=gen, device=dev) * 0.02,
                torch.rand(shape, generator=gen, device=dev) * 0.02)

    q = torch.randn((B, KVH, G, D), generator=gen, device=dev)
    kn = torch.randn((B, KVH, D), generator=gen, device=dev)
    vn = torch.randn((B, KVH, D), generator=gen, device=dev)
    # row kernels at the bench shape, all-batch over a ragged 4096 cache
    for T, pos, bt, entries in (
            (256, [128] * 8, 256, (("staged", "flash_decode_staged_launch",
                                    ()), ("inline",
                                          "flash_decode_inline_launch", ()))),
            (4096, [0, 700, 1300, 1900, 2300, 2700, 3400, 4095], 128,
             (("ab staged", "flash_decode_ab_launch", (1,)),
              ("ab inline", "flash_decode_ab_launch", (0,))))):
        Lk = max(2, math.ceil(200e6 / (B * KVH * T * (2 * D + 8))))
        k, v, ks, vs = cache(Lk, B, T)
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        for name, entry, flags in entries:
            for dots in ("i8", "f32"):
                news = ((None, None) if entry == "flash_decode_inline_launch"
                        or flags == (0,) else (kn, vn))
                ms[f"{name} T={T} {dots}"] = _time_ms(
                    torch, lambda i: AT._launch_decode(
                        entry, q, k, v, ks, vs, *news, i % Lk, p, bt, dots,
                        *flags), 50)
        del k, v, ks, vs
    # paged: a permuted table over 2048 tokens per row
    pos = [0, 300, 777, 1024, 1500, 1801, 2047, 2048]
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    for P in (16, 256):
        max_pages = 2048 // P
        NP = B * max_pages + 8
        k, v, ks, vs = cache(2, NP, P)
        perm = torch.randperm(NP, generator=torch.Generator().manual_seed(P))
        tables = perm[:B * max_pages].reshape(B, max_pages).to(
            device=dev, dtype=torch.int32)
        for dots in ("i8", "f32"):
            ms[f"paged page={P} {dots}"] = _time_ms(
                torch, lambda i: AT._launch_decode(
                    "flash_decode_paged_launch", q, k, v, ks, vs, kn, vn,
                    i % 2, p, P, dots, page_tables=tables), 50)
        del k, v, ks, vs
    # attention + o_proj, f32 dots, staged and inline, T 256 at 128
    T, h, rank, Lk = 256, 4096, 128, 8
    k, v, ks, vs = cache(Lk, B, T)
    p = torch.full((B,), 128, dtype=torch.int32, device=dev)
    o = (torch.randint(0, 256, (Lk, h, KVH * D // 2), generator=gen,
                       dtype=torch.uint8, device=dev),
         torch.rand((Lk, h, 1), generator=gen, device=dev) * 0.01,
         torch.randint(-127, 128, (Lk, rank, KVH * D), generator=gen,
                       dtype=torch.int8, device=dev),
         torch.rand((Lk, rank, 1), generator=gen, device=dev) * 1e-3,
         torch.randint(-127, 128, (Lk, h, rank), generator=gen,
                       dtype=torch.int8, device=dev),
         torch.rand((Lk, h, 1), generator=gen, device=dev) * 1e-3)
    for staged in (True, False):
        ms[f"attn_o {'staged' if staged else 'inline'}"] = _time_ms(
            torch, lambda i: AT._launch_attn_o(
                q, k, v, ks, vs, kn, vn, i % Lk, p, *o, 4, rank, staged,
                256), 50)
    print(json.dumps({"root": args.root, "card": _card_line(), "ms": ms}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
