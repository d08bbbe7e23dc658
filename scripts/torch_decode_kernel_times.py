#!/usr/bin/env python3
"""Device times of the port's CUDA decode-attention kernels at the shapes
``PERF.md`` records (Llama-2-7B heads, batch 8), for comparing two trees of
the repository on one card in one call.

    python3 scripts/torch_decode_kernel_times.py --root TREE [--build-only]
                                                 [--out F] [--against F]

imports the port package from ``TREE`` (its ``build/kernels`` too), builds
its decode-attention libraries, and prints one JSON line ``{"root",
"card", "ms", "against"}``: each case's median device time per launch (50
launches captured in a CUDA graph, 5 replays, caches rotated over enough
layers to come from device memory). The cases:

- the staged and inline row kernels (rows 11 and 10) at the bench shape
  (T 256, every row at 128) and at mixed positions 0-256 of T 256; the
  staged kernel at Llama-2-7B T 2048 (mixed positions, also inline), one
  row over a 4096-token cache at position 4095, 32 rows at the bench shape,
  Llama-3-8B's GQA heads (KVH 8, G 4) at T 2048 (mixed positions, also
  inline) and Qwen2-0.5B's (KVH 2, G 7, D 64) at T 2048 and at T 16384
  (mixed positions; a cache longer than the row kernel's shared memory
  takes, which the wrappers give to the block-parallel kernel); beside
  each, the block-parallel kernel (``AT._launch_split``) on the same
  operands and block (``split`` in the case's name), whose output the row
  kernel's must equal bit for bit (``row_vs_split``); and, for each head
  shape, the longest cache of 256-token blocks the row kernel takes at B 8
  on this card (``row_limit``);
- the all-batch kernel (``flash_decode_q8_ab``, staged and inline) over a
  4096-token cache at ragged positions, at the bench shape (T 256,
  position 128) and over a 4096-token cache with every row at 128;
- the paged kernel on 16- and 256-token pages over 2048 tokens per row at
  ragged positions, and on 16-token pages at ~300 tokens per row in the
  paged engine's 4096-token tables (256 pages a row);
- the fused attention + o_proj kernel (f32).

Every attention case runs in dots i8, f32 and bf16. The all-batch and paged
kernels are launched through the tree's own entry (the public wrapper, and
for the paged kernel the launcher without the page-id check, which reads the
table back to the host). ``--out F`` writes each case's output digest
(sha256 of its bytes, one launch on layer 1) to F; ``--against F``
compares this run's digests with F's. Compare trees in turns within one
call (A, B, B, A): two calls may land on two cards.
"""

import argparse
import hashlib
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import _card_line, _time_ms  # noqa: E402 (no port import)

DOTS = ("i8", "f32", "bf16")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--against")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        _build, attention as AT)
    _build.build([n for n in ("flash_decode", "flash_decode_split",
                              "attn_o") if n in _build.ENTRIES])
    if args.build_only:
        return 0
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    B, KVH, G, D = 8, 32, 1, 128
    ms, digests = {}, {}

    def run(case, fn, iters=50):
        out = fn(1)
        torch.cuda.synchronize()
        digests[case] = hashlib.sha256(
            out.contiguous().cpu().numpy().tobytes()).hexdigest()
        ms[case] = _time_ms(torch, fn, iters)

    def cache(Lk, rows, T):
        shape = (Lk, rows, KVH, T)
        return (torch.randint(-127, 128, shape + (D,), generator=gen,
                              dtype=torch.int8, device=dev),
                torch.randint(-127, 128, shape + (D,), generator=gen,
                              dtype=torch.int8, device=dev),
                torch.rand(shape, generator=gen, device=dev) * 0.02,
                torch.rand(shape, generator=gen, device=dev) * 0.02)

    def layers(T):
        return max(2, math.ceil(200e6 / (B * KVH * T * (2 * D + 8))))

    row_vs_split = {}
    mixed = [0, 1, 100, 128, 129, 200, 255, 256]
    mixed_2048 = [0, 255, 256, 700, 1024, 1500, 2047, 2048]
    # the row kernels: (label, rows, kv heads, G, D, T, positions, staged
    # and/or inline); the bench shape's labels are the parent's
    for label, rows, kvh, g, d, T, pos, kinds in (
            ("", B, KVH, G, D, 256, [128] * 8, ("staged", "inline")),
            (" mixed", B, KVH, G, D, 256, mixed, ("staged", "inline")),
            (" 7b mixed", B, KVH, G, D, 2048, mixed_2048,
             ("staged", "inline")),
            (" B=1 pos 4095", 1, KVH, G, D, 4096, [4095], ("staged",)),
            (" B=32", 32, KVH, G, D, 256, [128] * 32, ("staged",)),
            (" llama3-8b GQA", B, 8, 4, D, 2048,
             [0, 1, 300, 511, 512, 1999, 2047, 2048], ("staged", "inline")),
            (" qwen2-0.5b", B, 2, 7, 64, 2048, mixed_2048, ("staged",)),
            (" qwen2-0.5b", B, 2, 7, 64, 16384,
             [0, 1, 2047, 4096, 8191, 12000, 16383, 16384], ("staged",))):
        Lk = max(2, math.ceil(200e6 / (rows * kvh * T * (2 * d + 8))))
        shape = (Lk, rows, kvh, T)
        k = torch.randint(-127, 128, shape + (d,), generator=gen,
                          dtype=torch.int8, device=dev)
        v = torch.randint(-127, 128, shape + (d,), generator=gen,
                          dtype=torch.int8, device=dev)
        ks = torch.rand(shape, generator=gen, device=dev) * 0.02
        vs = torch.rand(shape, generator=gen, device=dev) * 0.02
        qr = torch.randn((rows, kvh, g, d), generator=gen, device=dev)
        knr = torch.randn((rows, kvh, d), generator=gen, device=dev)
        vnr = torch.randn((rows, kvh, d), generator=gen, device=dev)
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        bt = AT.resolve_block_t(256, T)
        for kind in kinds:
            staged = kind == "staged"
            entry = f"flash_decode_{kind}_launch"
            news = (knr, vnr) if staged else (None, None)
            for dots in DOTS:
                case = f"{kind} T={T}{label} {dots}"
                run(case, lambda i: AT._launch_decode(
                    entry, qr, k, v, ks, vs, *news, i % Lk, p, bt, dots))
                split = AT._launch_split(qr, k, v, ks, vs, knr, vnr, 1, p,
                                         bt, dots, staged)
                row_vs_split[case] = bool(torch.equal(
                    AT._launch_decode(entry, qr, k, v, ks, vs, *news, 1, p,
                                      bt, dots), split))
                ms[f"{case} split"] = _time_ms(torch, lambda i: AT._launch_split(
                    qr, k, v, ks, vs, knr, vnr, i % Lk, p, bt, dots, staged),
                    50)
        del k, v, ks, vs
    q = torch.randn((B, KVH, G, D), generator=gen, device=dev)
    kn = torch.randn((B, KVH, D), generator=gen, device=dev)
    vn = torch.randn((B, KVH, D), generator=gen, device=dev)
    # the all-batch kernel: ragged over 4096, the bench shape, and 4096
    # with every row at 128
    for T, pos, label in (
            (4096, [0, 700, 1300, 1900, 2300, 2700, 3400, 4095], ""),
            (256, [128] * 8, " pos 128"), (4096, [128] * 8, " pos 128")):
        Lk = layers(T)
        k, v, ks, vs = cache(Lk, B, T)
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        for staged in (True, False):
            for dots in DOTS:
                run(f"ab {'staged' if staged else 'inline'} T={T}{label} "
                    f"{dots}", lambda i: AT.flash_decode_q8_ab(
                        q, k, v, ks, vs, kn, vn, i % Lk, p, staged=staged,
                        dots=dots))
        del k, v, ks, vs
    # paged: permuted tables over 2048 tokens a row, and the paged engine's
    # 4096-token tables at ~300 tokens a row
    for P, ctx, pos, label in (
            (16, 2048, [0, 300, 777, 1024, 1500, 1801, 2047, 2048], ""),
            (256, 2048, [0, 300, 777, 1024, 1500, 1801, 2047, 2048], ""),
            (16, 4096, [272, 283, 290, 297, 301, 306, 311, 318],
             " ctx 4096 pos ~300")):
        max_pages = ctx // P
        live_pages = -(-max(pos) // P)
        NP = B * live_pages + 8
        k, v, ks, vs = cache(2, NP, P)
        perm = torch.randperm(NP, generator=torch.Generator().manual_seed(P))
        tables = torch.zeros((B, max_pages), dtype=torch.int32)
        tables[:, :live_pages] = perm[:B * live_pages].reshape(B, live_pages)
        tables = tables.to(dev)
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        for dots in DOTS:
            if hasattr(AT, "_flash_decode_q8_paged"):
                def fn(i):
                    return AT._flash_decode_q8_paged(
                        q, k, v, ks, vs, kn, vn, i % 2, tables, p, dots=dots)
            else:
                def fn(i):
                    return AT._launch_decode(
                        "flash_decode_paged_launch", q, k, v, ks, vs, kn, vn,
                        i % 2, p, P, dots, page_tables=tables)
            run(f"paged page={P}{label} {dots}", fn)
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
        run(f"attn_o {'staged' if staged else 'inline'}",
            lambda i: AT._launch_attn_o(
                q, k, v, ks, vs, kn, vn, i % Lk, p, *o, 4, rank, staged,
                256)[0])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(digests, f)
    against = None
    if args.against:
        with open(args.against) as f:
            ref = json.load(f)
        against = {c: ref.get(c) == d for c, d in digests.items()}
        print(f"against {args.against}: {sum(against.values())} of "
              f"{len(against)} outputs equal bit for bit", flush=True)
    print(f"row kernel equal to the split kernel: "
          f"{sum(row_vs_split.values())} of {len(row_vs_split)}", flush=True)
    row_limit = {}
    if hasattr(AT, "_row_decode_plan"):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for name, (kvh, g, d) in {"llama2-7b": (KVH, G, D),
                                  "llama3-8b": (8, 4, D),
                                  "qwen2-0.5b": (2, 7, 64)}.items():
            T = 256
            while AT._row_decode_plan(B, kvh, g, d, T + 256, 256,
                                      sms)["route"] == "row":
                T += 256
            row_limit[name] = T
        print(f"longest cache of the row kernel at B {B}: {row_limit}",
              flush=True)
    print(json.dumps({"root": args.root, "card": _card_line(), "ms": ms,
                      "against": against, "row_vs_split": row_vs_split,
                      "row_limit": row_limit}),
          flush=True)
    return 0 if ((against is None or all(against.values()))
                 and all(row_vs_split.values())) else 1


if __name__ == "__main__":
    sys.exit(main())
