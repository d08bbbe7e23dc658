#!/usr/bin/env python3
"""Device times of the two cooperative fusion kernels on one card: the
whole-MLP kernel (``K.quantized_matmul_w4a8_mlp_stacked``, row 7 of PERF.md's
kernel table) and attention + o_proj (``AT.flash_decode_attn_o``, row 15).

    python3 scripts/torch_mlp_attn_o_times.py [--root TREE] [--out F]
                                              [--against F]

imports the port package from ``TREE`` (default: this checkout; an A/B
unpacks the parent with ``git archive`` into a directory ``.gitignore``
lists) and runs the sweep:

- row 7 at Llama-2-7B's MLP (h 4096, im 11008, rank 128): M 1, 3, 8, 33, 128
  at 4 bits, M 8 at 2 and 8 bits;
- row 15 at Llama-2-7B's heads (KVH 32, D 128, o_proj 4096 x 4096, rank
  128), B 1, 8, 32, staged and inline: a 256-token cache at position 128,
  and a 2048-token cache at seeded ragged positions.

Weights are seeded (``torch.Generator``, seed 0) and rotate over enough
layers (>= 200 MB) to come from device memory. Each case: the device time
(``chip_smoke._time_ms``: a CUDA graph of launches, median of 5 replays),
the output against its plain version on the card (rel-Frobenius, bound
1e-3 as ``tests/test_torch_cuda.py`` holds it), the count of int8 codes of
``m`` (row 7) or of the attention (row 15) that differ from the plain
version's, and a second launch bit-equal to the first. ``--out F`` writes
the JSON line and the outputs (``F.pt``); ``--against F`` compares every
output with that run's (bit-equal or not, rel-Frobenius) and prints the
time ratio. The last line is one JSON object ``{"root", "card", "cases"}``.
"""

import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import _card_line, _lowrank_weights, _time_ms  # noqa: E402

REL = 1e-3      # tests/test_torch_cuda.py's bound for both kernels
H, IM, RANK = 4096, 11008, 128
KVH, D = 32, 128


def load_port(root):
    sys.path.insert(0, os.path.abspath(root))
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        attention as AT, kernels as K)
    return K, AT


def mlp_weights(torch, dev, bits, seed=0):
    """Gate/up and down of a Llama-2-7B MLP at ``bits``, stacked over
    enough layers to exceed L2 several times."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + bits)
    f = 8 // bits
    layer_bytes = 3 * H * IM // f + 3 * IM * RANK + H * RANK
    Lk = max(2, math.ceil(200e6 / layer_bytes))
    gu = _lowrank_weights(torch, dev, gen, Lk, 2 * IM, H, 2)
    dn = _lowrank_weights(torch, dev, gen, Lk, H, IM, 1)
    if bits != 4:   # codes of the other width (0..2^bits - 1 a code)
        for w, K in ((gu, H), (dn, IM)):
            w["packed"] = torch.randint(0, 256, (Lk, w["packed"].shape[1],
                                                 K // f), generator=gen,
                                        dtype=torch.uint8, device=dev)
    gs = 0.5 + 1.5 * torch.rand((Lk, 2), generator=gen, device=dev)
    return gu, dn, gs, Lk, layer_bytes


def mlp_args(gu, dn, gs, xr, layer, bits):
    return (gu["packed"], gu["scales"], layer, xr, gu["L"], gu["Ls"], gs,
            dn["packed"], dn["scales"], dn["R"], dn["Rs"], dn["L"],
            dn["Ls"], bits, RANK)


def attn_cache(torch, dev, B, T, seed=0):
    """A layer-stacked int8 cache of T tokens, q and the current token's K/V,
    and o_proj's weights; rotating over enough layers for device memory."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + B + T)
    qdim = KVH * D
    Lk = max(2, math.ceil(200e6 / (B * KVH * T * (2 * D + 8)
                                   + H * qdim // 2 + 2 * H * RANK)))
    k, v = (torch.randint(-127, 128, (Lk, B, KVH, T, D), generator=gen,
                          dtype=torch.int8, device=dev) for _ in range(2))
    ks, vs = (torch.rand((Lk, B, KVH, T), generator=gen, device=dev) * 0.02
              for _ in range(2))
    q = torch.randn((B, KVH, 1, D), generator=gen, device=dev)
    kn, vn = (torch.randn((B, KVH, D), generator=gen, device=dev)
              for _ in range(2))
    o = _lowrank_weights(torch, dev, gen, Lk, H, qdim, 1)
    ow = (o["packed"], o["scales"], o["R"], o["Rs"], o["L"], o["Ls"])
    return (q, k, v, ks, vs, kn, vn), ow, Lk, gen


def rel(torch, a, b):
    return float(torch.linalg.norm((a - b).float())
                 / torch.linalg.norm(b.float()))


def run_cases(torch, K, AT, dev):
    """Every case of the sweep: yields (name, dict of numbers, output)."""
    for bits, Ms in ((4, (1, 3, 8, 33, 128)), (2, (8,)), (8, (8,))):
        gu, dn, gs, Lk, _ = mlp_weights(torch, dev, bits)
        for M in Ms:
            gen = torch.Generator(device=dev)
            gen.manual_seed(100 + M)
            x = torch.randn((M, H), generator=gen, device=dev)
            xr = K.thin_xr(x, gu["R"][1], gu["Rs"][1])
            xq, sx = K.quantize_activations_int8(x)

            def launch(layer):
                return K._launch_mlp(xq, sx, xr, gu["packed"], gu["scales"],
                                     layer, *mlp_args(gu, dn, gs, xr, layer,
                                                      bits)[4:])
            y, scr = launch(1)
            y2, _ = launch(1)
            parts = K._mlp_plain_parts(x, *mlp_args(gu, dn, gs, xr, 1, bits))
            torch.cuda.synchronize()
            ms = _time_ms(torch, lambda i: launch(i % Lk), 20)
            yield (f"mlp M={M} {bits}-bit",
                   dict(ms=ms, rel=rel(torch, y, parts["out"]),
                        flips=int((scr["m8"] != parts["m8"]).sum()),
                        codes=M * IM, repeat_equal=bool(torch.equal(y, y2))),
                   y)
        del gu, dn
        torch.cuda.empty_cache()
    for T, ragged in ((256, False), (2048, True)):
        for B in (1, 8, 32):
            cache, ow, Lk, gen = attn_cache(torch, dev, B, T)
            if ragged:
                pos = torch.randint(1, T, (B,), generator=gen, device=dev,
                                    dtype=torch.int32)
            else:
                pos = torch.full((B,), 128, dtype=torch.int32, device=dev)
            for staged in (True, False):
                y, scr = AT._launch_attn_o(*cache, 1, pos, *ow, 4, RANK,
                                           staged, 256)
                y2, _ = AT._launch_attn_o(*cache, 1, pos, *ow, 4, RANK,
                                          staged, 256)
                parts = AT._attn_o_plain_parts(*cache, 1, pos, *ow, 4, RANK,
                                               staged, 256)
                torch.cuda.synchronize()
                ms = _time_ms(torch, lambda i: AT._launch_attn_o(
                    *cache, i % Lk, pos, *ow, 4, RANK, staged, 256), 20)
                where = "pos 128" if not ragged else "ragged"
                yield (f"attn_o B={B} T={T} {where} "
                       f"{'staged' if staged else 'inline'}",
                       dict(ms=ms, rel=rel(torch, y, parts["out"]),
                            flips=int((scr["xq8"] != parts["xq8"]).sum()),
                            codes=B * KVH * D,
                            repeat_equal=bool(torch.equal(y, y2))), y)
            del cache, ow
            torch.cuda.empty_cache()


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
    K, AT = load_port(args.root)
    dev = torch.device("cuda")
    card = _card_line()
    print(f"card: {card}; root {args.root}", flush=True)
    other, other_out = {}, {}
    if args.against:
        with open(args.against) as fh:
            other = {c["name"]: c for c in json.loads(fh.read())["cases"]}
        other_out = torch.load(args.against + ".pt")
    cases, outs, failed = [], {}, []
    for name, rec, y in run_cases(torch, K, AT, dev):
        rec["name"] = name
        line = (f"{name}: {rec['ms']:.4f} ms, rel {rec['rel']:.3e} (bound "
                f"{REL:g}), {rec['flips']} of {rec['codes']} int8 codes "
                f"differ from the plain version's, repeat bit-equal "
                f"{rec['repeat_equal']}")
        if name in other:
            o = other_out[name].to(dev)
            rec["equal_other"] = bool(torch.equal(y, o))
            rec["rel_other"] = rel(torch, y, o)
            rec["ratio"] = rec["ms"] / other[name]["ms"]
            line += (f"; against --against: {rec['ratio']:.3f}x its "
                     f"{other[name]['ms']:.4f} ms, bit-equal "
                     f"{rec['equal_other']} (rel {rec['rel_other']:.3e})")
        print(line, flush=True)
        if rec["rel"] > REL or not rec["repeat_equal"]:
            failed.append(name)
        cases.append(rec)
        outs[name] = y.cpu()
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
