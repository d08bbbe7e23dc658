#!/usr/bin/env python3
"""Where the grouped kernel's time goes: device times of ablated copies of
``csrc/grouped_matmul.cu`` beside the kernel itself, on one card.

    python3 scripts/torch_grouped_ablate.py

Each copy removes one part of the kernel by a text edit of the source (the
script checks that every edited passage is still there and stops if one is
not), is built with the port's nvcc flags, and is timed through the port's
own launch path (``ops/kernels.py::_launch_grouped``, the plan of
``_grouped_plan``) at Llama-2-7B's projection shapes, 4-bit, M 8 and 512,
packed weights rotated through device memory as in
``scripts/torch_grouped_times.py``. Only ``kernel`` computes the function;
the others give wrong results and are timings only:

- ``kernel``: the kernel as it is (checked against the plain version);
- ``no_math``: the dequantization's byte select, subtract, multiply and
  bf16 pack replaced by one byte select and one xor per pair of codes;
- ``no_products``: every ``wgmma`` replaced by an xor of its A registers
  into the accumulators;
- ``no_epilogue``: each split returns after its products, without writing
  or summing partial tiles;
- ``ring_only``: the consumers only wait for each stage and release it (the
  TMA ring, the scale loads and the split-K epilogue remain).

Prints one JSON line per copy and round (two rounds, copies in turn) and a
last line ``{"card", "rounds": [...]}``.
"""

import ctypes
import json
import math
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import _card_line, _time_ms  # noqa: E402 (no port import)

MATH = ("  const float lo = __fmul_rn(", "  return *reinterpret_cast<const "
        "uint32_t*>(&v);\n")
MMA = """    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < F; ++p)
        wgmma_m64k16_rs<NT>(d[kAcc > 1 ? kk : 0], a[kk][p],
                            desc_sw128(st + S::kRaw + p * S::kXT + 32 * kk));
    wgmma_commit();
    wgmma_wait<0>();
"""
NO_MMA = """#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < F; ++p)
        d[kAcc > 1 ? kk : 0][0] += __uint_as_float(
            a[kk][p][0] ^ a[kk][p][1] ^ a[kk][p][2] ^ a[kk][p][3]);
"""
BODY = ("    const uint8_t* st = ring + s * S::kStage;\n",
        "    __syncwarp();\n    if (lane == 0) mbar_arrive(&bars.empty[s]);")
EPILOGUE = "  if (splits == 1) {\n    store(acc);\n    return;\n  }\n"


def _cut(src, start, end, keep_end=True, insert=""):
    i0 = src.index(start) + (len(start) if keep_end else 0)
    i1 = src.index(end, i0)
    return src[:i0] + insert + src[i1 + (0 if keep_end else len(end)):]


def _variants(src):
    for piece in (MATH[0], MATH[1], MMA, BODY[0], BODY[1], EPILOGUE):
        if piece not in src:
            raise SystemExit(f"the kernel source changed: {piece[:40]!r} "
                             f"not found")
    no_math = _cut(src, MATH[0], MATH[1], keep_end=False, insert=(
        "  return __byte_perm(c, 0x3F00u, 0x4140 + B * 0x11) ^ "
        "__float_as_uint(s);\n"))
    return {
        "kernel": src,
        "no_math": no_math,
        "no_products": src.replace(MMA, NO_MMA),
        "no_epilogue": src.replace(EPILOGUE, "  store(acc);\n  return;\n"),
        "ring_only": _cut(src, BODY[0], BODY[1],
                          insert="    d[0][0] += (float)st[threadIdx.x];\n"),
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        _build, kernels as K)
    variants = _variants((_build.CSRC / "grouped_matmul.cu").read_text())
    out = _build.BUILD_DIR / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants.items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed\n{err}", file=sys.stderr)
            return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    cases = {}
    for nm, N, Kd, M in (("q/k/v/o", 4096, 4096, 8),
                         ("gate/up", 11008, 4096, 8),
                         ("down", 4096, 11008, 8),
                         ("q/k/v/o", 4096, 4096, 512)):
        G = K.resolve_group(4, Kd, None)
        P = Kd // 2
        Lk = max(2, math.ceil(200e6 / (N * P)))
        packed = torch.randint(0, 256, (Lk, N, P), generator=gen,
                               dtype=torch.uint8, device=dev)
        sc = torch.rand((Lk, N, Kd // G), generator=gen, device=dev) * 0.01
        x = torch.randn((M, Kd), generator=gen, device=dev)
        ref = K.quantized_matmul_plain(x, packed[0], sc[0], 4, G)
        cases[f"{nm} M={M}"] = (x.to(torch.bfloat16), packed, sc, G, Lk,
                                ref, 50 if M == 8 else 10)
    rounds = []
    for rnd in range(2):
        for name in variants:
            lib = ctypes.CDLL(str(out / f"lib{name}.so"))
            for fn, argtypes in _build.ENTRIES["grouped_matmul"].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _build._libs["grouped_matmul"] = lib
            ms = {}
            for key, (xb, packed, sc, G, Lk, ref, iters) in cases.items():
                if name == "kernel":
                    y = K._launch_grouped(xb, packed[0], sc[0], 4, G)
                    if not torch.allclose(y, ref, rtol=1e-5, atol=1e-5 * float(
                            ref.abs().max())):
                        print(f"kernel {key} disagrees with the plain "
                              f"version", file=sys.stderr)
                        return 1
                ms[key] = _time_ms(torch, lambda i: K._launch_grouped(
                    xb, packed[i % Lk], sc[i % Lk], 4, G), iters)
            rounds.append(dict(round=rnd, copy=name, ms=ms))
            print(json.dumps(rounds[-1]), flush=True)
    print(json.dumps({"card": _card_line(), "rounds": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
