#!/usr/bin/env python3
"""Where the block-parallel decode attention (``csrc/flash_decode_split.cu``,
the all-batch and paged kernels) spends its time: device times of ablated
copies of the source beside the kernel itself, on one card.

    python3 scripts/torch_decode_split_ablate.py

Each copy changes the source by a text edit (the script stops if an edited
passage is no longer there), is built with the port's nvcc flags, and is
timed through the port's own launch path (``ops/attention.py``) on the
cases of ``scripts/torch_decode_kernel_times.py`` that set rows 12 and 14
(the all-batch kernel over a 4096-token cache at ragged positions, staged,
128-token blocks; the paged kernel on 16-token pages over 2048 tokens a
row) and at its short contexts (the all-batch kernel at position 128 over
T 256, staged and inline, and over T 4096; the paged kernel at ~300 tokens
a row in 4096-token tables), dots i8 and f32. ``kernel`` computes the
function (each launch is held to the plain version); ``no_whole`` too,
and the copies without a phase are timings only:

- ``a_only``: the A items alone (the chunks' logits and block maxima;
  the whole streams' W items run in full);
- ``a_b``: the A and B items, without the ordered combines (C items);
- ``plain_loads``: the 16- and 4-byte ``cp.async`` copies into shared
  memory replaced by plain loads and stores (each thread waits for its
  own loads before its next copy);
- ``no_whole``: no W items (a row whose live tokens fit one chunk and one
  window runs its chunk, window and combine as separate items; only the
  rows with no cache token stay whole).

Prints one JSON line per copy and round (two rounds, copies in turn) and a
last line ``{"card", "rounds": [...]}``.
"""

import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import _card_line, _time_ms  # noqa: E402 (no port import)

sys.path.append(os.path.dirname(os.path.abspath(__file__)))
from torch_w4a8_ablate import _build_copies, _check, _load  # noqa: E402

B_ITEMS = "    } else if (region == 1) {\n"
NO_B_ITEMS = "    } else if (region == 1 && a.B < 0) {\n"
C_ITEMS = "    } else {\n      item_combine<DOTS>"
NO_C_ITEMS = "    } else if (a.B < 0) {\n      item_combine<DOTS>"
CP16 = """  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(s),
               "l"(src));
"""
LOAD16 = """  (void)s;
  *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
"""
CP4 = """  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n" ::"r"(s),
               "l"(src));
"""
LOAD4 = """  (void)s;
  *reinterpret_cast<float*>(dst) = __ldg(reinterpret_cast<const float*>(src));
"""
WHOLE = """  return n == 0 || (a.bt <= kChunk && n * a.D <= kWholeBytes &&
                    live_blocks(a, n) <= a.nbw);
"""
NO_WHOLE = """  return n == 0;
"""


def _variants(src):
    _check(src, (B_ITEMS, C_ITEMS, CP16, CP4, WHOLE))
    return {
        "kernel": src,
        "a_only": src.replace(B_ITEMS, NO_B_ITEMS).replace(C_ITEMS,
                                                           NO_C_ITEMS),
        "a_b": src.replace(C_ITEMS, NO_C_ITEMS),
        "plain_loads": src.replace(CP16, LOAD16).replace(CP4, LOAD4),
        "no_whole": src.replace(WHOLE, NO_WHOLE),
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        _build, attention as AT)
    source = "flash_decode_split.cu"
    libs = _build_copies(_build, source,
                         _variants((_build.CSRC / source).read_text()),
                         _build.BUILD_DIR / "ablate_decode_split", source)
    _build.library("flash_decode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    B, KVH, G, D = 8, 32, 1, 128

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
    cases = {}

    def ab_case(label, T, pos, staged):
        Lk = max(2, math.ceil(200e6 / (B * KVH * T * (2 * D + 8))))
        ab = cache(Lk, B, T)
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        for dots in ("i8", "f32"):
            cases[f"{label} {dots}"] = (
                lambda i, dots=dots: AT.flash_decode_q8_ab(
                    q, *ab, kn, vn, i % Lk, p, staged=staged, dots=dots),
                lambda dots=dots: AT.flash_decode_q8_ab_plain(
                    q, *ab, kn, vn, 1, p, staged=staged, dots=dots))

    def paged_case(label, ctx, pos):
        P = 16
        max_pages, live = ctx // P, -(-max(pos) // P)
        NP = B * live + 8
        pool = cache(2, NP, P)
        perm = torch.randperm(NP, generator=torch.Generator().manual_seed(P))
        tables = torch.zeros((B, max_pages), dtype=torch.int32)
        tables[:, :live] = perm[:B * live].reshape(B, live)
        tables = tables.to(dev)
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        for dots in ("i8", "f32"):
            cases[f"{label} {dots}"] = (
                lambda i, dots=dots: AT._flash_decode_q8_paged(
                    q, *pool, kn, vn, i % 2, tables, p, dots=dots),
                lambda dots=dots: AT.flash_decode_q8_paged_plain(
                    q, *pool, kn, vn, 1, tables, p, dots=dots))

    ab_case("ab staged T=4096", 4096,
            [0, 700, 1300, 1900, 2300, 2700, 3400, 4095], True)
    paged_case("paged page=16", 2048,
               [0, 300, 777, 1024, 1500, 1801, 2047, 2048])
    for staged in (True, False):
        ab_case(f"ab {'staged' if staged else 'inline'} T=256 pos 128", 256,
                [128] * B, staged)
    ab_case("ab staged T=4096 pos 128", 4096, [128] * B, True)
    paged_case("paged page=16 ctx 4096 pos ~300", 4096,
               [272, 283, 290, 297, 301, 306, 311, 318])
    refs = {name: plain() for name, (_, plain) in cases.items()}
    rounds = []
    for rnd in range(2):
        for name, path in libs.items():
            _load(_build, "flash_decode_split", path)
            row = {}
            for case, (fn, _) in cases.items():
                out = fn(1)
                if name in ("kernel", "no_whole") and not torch.allclose(
                        out, refs[case], rtol=1e-3, atol=1e-4):
                    raise SystemExit(f"{case}: the kernel disagrees with "
                                     "the plain version")
                row[case] = _time_ms(torch, fn, 50)
            line = dict(round=rnd, copy=name, ms=row)
            print(json.dumps(line), flush=True)
            rounds.append(line)
    print(json.dumps({"card": _card_line(), "rounds": rounds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
