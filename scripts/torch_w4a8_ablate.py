#!/usr/bin/env python3
"""Where the W4A8 tile path's time goes: device times of ablated copies of
``csrc/w4a8_stacked.cu`` beside the kernel itself, on one card.

    python3 scripts/torch_w4a8_ablate.py

Each copy removes one part of the tile kernel by a text edit of the source
(the script checks that every edited passage is still there and stops if
one is not), is built with the port's nvcc flags, and is timed through the
port's own launch path (``ops/kernels.py::_launch_w4a8_stacked``, the plan
of ``_w4a8_plan``) at Llama-2-7B's projection shapes, 4-bit, M 512 and
2048, packed weights rotated through device memory as in
``scripts/torch_w4a8_times.py``. Only ``kernel`` computes the function; the
others give wrong results and are timings only:

- ``kernel``: the kernel as it is (checked against the plain version);
- ``n128``: the products on ``wgmma m64n128k32`` (no rows of ones, so no
  row sum: the eighth more products that the row sum costs);
- ``no_unpack``: the unpacker waits, issues the x boxes and arrives, but
  writes no code tile (its shared-memory writes and shifts);
- ``no_x``: no activation boxes (the sub-steps complete on the unpacker's
  arrivals alone);
- ``no_products``: the consumers wait for each sub-step and release it,
  without ``wgmma`` (the TMA ring, the unpacker and the epilogue remain);
- ``no_epilogue``: the consumers go on to their next tile after its
  products, storing nothing.

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

UNPACK = """#pragma unroll
          for (int v = 0; v < kRaw / 16 / 128; ++v)
            dst[ut + 128 * v] = plane16<BITS>(w[v], p);
"""
X_BOX = """            mbar_expect_tx(&bars.sub_full[b], S::kXT);
            tma_load_3d(st, &tx, &bars.sub_full[b], k * kBK, p, m0);
"""
MMA = """      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        wgmma_m64n144k32_s8u8(d, desc_sw128(st + wg * 64 * kBK + 32 * kk),
                              desc_sw128(st + S::kXT + 32 * kk));
      wgmma_commit();
      wgmma_wait<1>();
"""
N128 = """      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        wgmma_m64n128k32_s8u8(*reinterpret_cast<int(*)[64]>(d),
                              desc_sw128(st + wg * 64 * kBK + 32 * kk),
                              desc_sw128(st + S::kXT + 32 * kk));
      wgmma_commit();
      wgmma_wait<1>();
"""
NO_MMA = "      d[0] += st[threadIdx.x];\n"
EPILOGUE = ("    // accumulator e = 4 c + 2 i + j: x row rl + 8 i, weight row 8 c "
            "+ 2 t +\n")
SKIP_EPILOGUE = """    if (d[0] != 0x7fffffff) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&bars.ep_empty[local & 1]);
      continue;
    }
"""
N128_FN = """// D (64 x 128, s32, 64 registers a thread) += A (64 x 32, s8) *
// B (128 x 32, u8)^T, both in shared memory, K-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_m64n128k32_s8u8(int (&d)[64],
    uint64_t a, uint64_t b) {
  asm volatile(
      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %66, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\\n}\\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}
"""
ANCHOR = "namespace tile {\n"


def _variants(src):
    for piece in (UNPACK, X_BOX, MMA, EPILOGUE, ANCHOR):
        if piece not in src:
            raise SystemExit(f"the kernel source changed: {piece[:40]!r} "
                             f"not found")
    i = src.index(EPILOGUE)
    no_epilogue = src[:i] + SKIP_EPILOGUE + src[i:]
    return {
        "kernel": src,
        "n128": src.replace(ANCHOR, ANCHOR + "using namespace hopper;\n"
                            + N128_FN).replace(MMA, N128),
        "no_unpack": src.replace(UNPACK, ""),
        "no_x": src.replace(
            X_BOX, "            mbar_arrive(&bars.sub_full[b]);\n"),
        "no_products": src.replace(MMA, NO_MMA),
        "no_epilogue": no_epilogue,
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        _build, kernels as K)
    variants = _variants((_build.CSRC / "w4a8_stacked.cu").read_text())
    out = _build.BUILD_DIR / "ablate_w4a8"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants.items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    logs = {}
    for name, proc in procs.items():
        log, err = proc.communicate()
        logs[name] = log + err
        if proc.returncode:
            print(f"{name}: nvcc failed\n{err}", file=sys.stderr)
            return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    cases = {}
    for nm, N, Kd, M in (("qkv", 12288, 4096, 512), ("o", 4096, 4096, 512),
                         ("down", 4096, 11008, 512),
                         ("qkv", 12288, 4096, 2048),
                         ("gate/up", 22016, 4096, 2048)):
        P = Kd // 2
        Lk = max(2, math.ceil(200e6 / (N * P)))
        packed = torch.randint(0, 256, (Lk, N, P), generator=gen,
                               dtype=torch.uint8, device=dev)
        sc = torch.rand((Lk, N, 1), generator=gen, device=dev) * 0.01
        x = torch.randn((M, Kd), generator=gen, device=dev)
        xq, sx = K.quantize_activations_int8(x)
        ref = K.quantized_matmul_w4a8_stacked_plain(x, packed, sc, 0, 4)
        cases[f"{nm} M={M}"] = (xq, sx, packed, sc, Lk, ref)
    rounds = []
    for rnd in range(2):
        for name in variants:
            lib = ctypes.CDLL(str(out / f"lib{name}.so"))
            for fn, argtypes in _build.ENTRIES["w4a8_stacked"].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _build._libs["w4a8_stacked"] = lib
            ms = {}
            for key, (xq, sx, packed, sc, Lk, ref) in cases.items():
                if name == "kernel":
                    y = K._launch_w4a8_stacked(xq, sx, packed, sc, 0, 4)
                    if not torch.equal(y, ref):
                        print(f"kernel {key} disagrees with the plain "
                              f"version", file=sys.stderr)
                        return 1
                try:
                    ms[key] = _time_ms(torch, lambda i: K._launch_w4a8_stacked(
                        xq, sx, packed, sc, i % Lk, 4), 10)
                except RuntimeError as exc:
                    # a copy that does not launch is reported, not timed
                    ms[key] = None
                    print(f"{name} {key}: {exc}; ptxas: " + "; ".join(
                        line.strip() for line in logs[name].splitlines()
                        if "tile_kernel" in line or "registers" in line
                        or "stack" in line)[:2000], flush=True)
            rounds.append(dict(round=rnd, copy=name, ms=ms))
            print(json.dumps(rounds[-1]), flush=True)
    print(json.dumps({"card": _card_line(), "rounds": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
