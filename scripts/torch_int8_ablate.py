#!/usr/bin/env python3
"""Where the int8 head kernel's tile path spends its time: device times of
ablated copies of ``csrc/int8_matmul.cu`` beside the kernel itself, on one
card.

    python3 scripts/torch_int8_ablate.py

Each copy removes one part of the tile kernel by a text edit of the source
(the script stops if an edited passage is no longer there), is built with
the port's nvcc flags, and is timed through the port's own launch path
(``ops/kernels.py::_launch_int8_matmul``) on the Llama-2-7B head (N 32000, K
4096) at M 32 (swapped tiles of 64 columns), 1024 and 2048 (128 x 256
tiles), two copies of the weights rotated through device memory as in
``scripts/torch_int8_times.py``. Only ``kernel`` computes the function (it
is checked against the plain version); the others give wrong results and
are timings only:

- ``no_products``: the consumers wait for each stage and release it without
  ``wgmma`` (the TMA ring and the epilogue remain);
- ``no_stores``: the epilogue computes and stages its outputs but stores
  none (no TMA store; swapped, no global store);
- ``no_epilogue``: the consumers go on to their next tile right after its
  products.

Prints one JSON line per copy and round (two rounds, copies in turn) and a
last line ``{"card", "rounds": [...]}``.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import _card_line, _time_ms  # noqa: E402 (no port import)

sys.path.append(os.path.dirname(os.path.abspath(__file__)))
from torch_w4a8_ablate import _build_copies, _check, _load  # noqa: E402

MMA = """#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        wgmma_m64k32_s8s8<NB>(d, desc_sw128(st + wg * 64 * kBK + 32 * kk),
                              desc_sw128(st + S::kA + 32 * kk));
"""
NO_MMA = "      d[0] += st[threadIdx.x];\n"
EPILOGUE = """#pragma unroll
    for (int u = 0; u < kSU; ++u)
      if (wt + 128 * u < kS) s_buf[wg][p][wt + 128 * u] = s_reg[u];
"""
SKIP_EPILOGUE = "    if (d[0] != 0x7fffffff) continue;\n"
TMA_STORE = ("              tma_store_2d(&to, ob + bx * kBox, n0 + 128 * h + "
             "32 * bx, m0);\n")
DIRECT_STORE = "            if (m < M && n < N)\n"
NO_DIRECT_STORE = "            if (m < M && n < N && d[0] == 0x7fffffff)\n"
CASES = ((32, dict(rows=64, cols=128)), (1024, dict(rows=128, cols=256)),
         (2048, dict(rows=128, cols=256)))


def _variants(src):
    _check(src, (MMA, EPILOGUE, TMA_STORE, DIRECT_STORE))
    return {
        "kernel": src,
        "no_products": src.replace(MMA, NO_MMA),
        "no_stores": src.replace(TMA_STORE, "").replace(DIRECT_STORE,
                                                        NO_DIRECT_STORE),
        "no_epilogue": src.replace(EPILOGUE, SKIP_EPILOGUE + EPILOGUE),
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        _build, kernels as K)
    source = "int8_matmul.cu"
    libs = _build_copies(_build, source,
                         _variants((_build.CSRC / source).read_text()),
                         _build.BUILD_DIR / "ablate_int8_matmul", source)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    N, Kd = 32000, 4096
    w8 = [torch.randint(-127, 128, (N, Kd), generator=gen, dtype=torch.int8,
                        device=dev) for _ in range(2)]
    s = [torch.rand((N, 1), generator=gen, device=dev) * 0.01
         for _ in range(2)]
    inputs = {}
    for M, kw in CASES:
        x = torch.randn((M, Kd), generator=gen, device=dev)
        inputs[M] = (*K.quantize_activations_int8(x),
                     K.int8_matmul_plain(x, w8[1], s[1]), kw)
    rounds = []
    for rnd in range(2):
        for name, path in libs.items():
            _load(_build, "int8_matmul", path)
            row = dict(round=rnd, copy=name)
            for M, (xq, sx, ref, kw) in inputs.items():
                y = K._launch_int8_matmul(xq, sx, w8[1], s[1], **kw)
                if name == "kernel" and not torch.equal(y, ref):
                    print(f"kernel M={M}: not the plain version's bits",
                          file=sys.stderr)
                    return 1
                row[f"M{M}"] = _time_ms(torch, lambda i: K._launch_int8_matmul(
                    xq, sx, w8[i % 2], s[i % 2], **kw),
                    20 if M <= 32 else 10)
            print(json.dumps(row), flush=True)
            rounds.append(row)
    print(json.dumps({"card": _card_line(), "rounds": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
