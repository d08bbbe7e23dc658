#!/usr/bin/env python3
"""Where the W4A8 tile path's time goes: device times of ablated copies of
its kernel (``csrc/w4a8_tile.cuh``) beside the kernel itself, on one card.

    python3 scripts/torch_w4a8_ablate.py [--l | --xr]

Each copy removes one part of the tile kernel by a text edit of the header
(the script checks that every edited passage is still there and stops if
one is not), is built with the port's nvcc flags beside a copy of the
source that includes it, and is timed through the port's own launch path at
Llama-2-7B's projection shapes, 4-bit, M 512 and 2048, packed weights
rotated through device memory as in ``scripts/torch_w4a8_times.py``. Only
``kernel`` computes the function; the others give wrong results and are
timings only.

Without ``--l``, the plain W4A8 kernel (rows 3 and 2: ``csrc/w4a8_stacked.cu``
through ``ops/kernels.py::_launch_w4a8_stacked`` on the plan of
``_w4a8_plan``):

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

With ``--l``, the L-fused kernel's tile path (row 6: ``csrc/w4a8_lowrank.cu``
through ``ops/kernels.py::_launch_l_tile``, rank 128, on factor operands
made beforehand), beside the plain W4A8 kernel's tile path on the same
weights (``row3``):

- ``kernel``: the kernel as it is (checked against the plain version);
- ``no_l_products``: the L sub-steps fill and are waited for, but the
  consumers run no bf16 ``wgmma`` on them;
- ``no_l_substeps``: no L sub-steps at all (the L epilogue's structure
  remains: ``setmaxnreg``, the outputs held in registers, Ls staged).

With ``--xr``, the LR-fused kernel's tensor-core xr kernel (row 5's tile
path: ``xr_kernel`` of ``csrc/w4a8_lowrank.cu`` through
``ops/kernels.py::_launch_lr_xr`` on its plan), the source itself edited:

- ``kernel``: the kernel as it is (checked against ``thin_xr``);
- ``no_widen``: the consumers load the R codes' fragment bytes but pass
  them to ``wgmma`` as they are, without widening them to bf16;
- ``no_products``: the codes are loaded and widened, but no ``wgmma``
  runs (the TMA ring, the split-K sum and the stores remain).

Prints one JSON line per copy and round (two rounds, copies in turn) and a
last line ``{"card", "rounds": [...]}``.
"""

import argparse
import ctypes
import json
import math
import os
import shutil
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
XR_WIDEN = """      a[kk][0] = widen2<0>(u0);
      a[kk][1] = widen2<0>(u1);
      a[kk][2] = widen2<2>(u0);
      a[kk][3] = widen2<2>(u1);
"""
XR_NO_WIDEN = """      a[kk][0] = u0;
      a[kk][1] = u1;
      a[kk][2] = u0 >> 8;
      a[kk][3] = u1 >> 8;
"""
XR_MMA = """    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_m64k16_rs<NT>(acc, a[kk],
                                  hopper::desc_sw128(st + kRaw + 32 * kk),
                                  !(fresh && kk == 0));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
"""
XR_NO_MMA = """#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      acc[kk] += __uint_as_float(a[kk][0] ^ a[kk][1] ^ a[kk][2] ^ a[kk][3]);
"""
L_MMA = """#pragma unroll
            for (int kk = 0; kk < kLK / 16; ++kk)
              wgmma_m64n64k16(
                  a, desc_sw128(st + wg * 64 * kBK + 32 * kk),
                  desc_sw128(st + S::kXT + h * 64 * kBK + 32 * kk));
"""
NO_L_MMA = "            a[0] += st[threadIdx.x];\n"
L_FILL = "        const int nl = l_windows(lf, n0, N, &p0) * chunks;\n"
L_PASSES = "      const int nw = l_windows(lf, n0, N, &p0);\n"


def _check(src, pieces):
    for piece in pieces:
        if piece not in src:
            raise SystemExit(f"the kernel source changed: {piece[:40]!r} "
                             f"not found")


def _l_variants(src):
    _check(src, (L_MMA, L_FILL, L_PASSES))
    return {
        "kernel": src,
        "no_l_products": src.replace(L_MMA, NO_L_MMA),
        "no_l_substeps": src.replace(L_FILL, L_FILL.replace(
            "l_windows", "0 * l_windows")).replace(L_PASSES, L_PASSES.replace(
                "l_windows", "0 * l_windows")),
    }


def _xr_variants(src):
    _check(src, (XR_WIDEN, XR_MMA))
    return {
        "kernel": src,
        "no_widen": src.replace(XR_WIDEN, XR_NO_WIDEN),
        "no_products": src.replace(XR_MMA, XR_NO_MMA),
    }


def _variants(src):
    _check(src, (UNPACK, X_BOX, MMA, EPILOGUE, ANCHOR))
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


def _build_copies(_build, source, variants, out, edited="w4a8_tile.cuh"):
    """Build ``source`` (a ``csrc`` file name) once per edited text of the
    file ``edited`` (a header beside a copy of the source, or the source
    itself); returns {name: library path}."""
    procs, libs = {}, {}
    for name, text in variants.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        if edited != source:
            shutil.copy(_build.CSRC / source, d / source)
        (d / edited).write_text(text)
        libs[name] = d / f"lib{name}.so"
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(libs[name]), str(d / source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{err}")
    return libs


def _load(_build, lib_name, path):
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _build.ENTRIES[lib_name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    _build._libs[lib_name] = lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--l", action="store_true",
                    help="ablate the L-fused kernel's tile path")
    ap.add_argument("--xr", action="store_true",
                    help="ablate the LR-fused kernel's xr kernel")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        _build, kernels as K)
    header = (_build.CSRC / "w4a8_tile.cuh").read_text()
    edited = "w4a8_tile.cuh"
    if args.xr:
        source = edited = "w4a8_lowrank.cu"
        lib_name = "w4a8_lowrank"
        variants = _xr_variants((_build.CSRC / source).read_text())
        _build.library("grouped_matmul")  # the split-K counters' capture id
    elif args.l:
        source, lib_name = "w4a8_lowrank.cu", "w4a8_lowrank"
        variants = _l_variants(header)
        _build.library("w4a8_stacked")  # row 3 beside it
    else:
        source, lib_name = "w4a8_stacked.cu", "w4a8_stacked"
        variants = _variants(header)
    libs = _build_copies(_build, source, variants,
                         _build.BUILD_DIR / f"ablate_{lib_name}"
                         f"{'_xr' if args.xr else ''}", edited)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rank = 128
    cases = {}
    if args.xr:
        for nm, n_proj, M in (("qkv", 3, 512), ("gate/up", 2, 512),
                              ("qkv", 3, 2048), ("gate/up", 2, 2048)):
            nR, Kd = n_proj * rank, 4096
            Lk = max(2, math.ceil(200e6 / (nR * Kd)))
            w = dict(R=torch.randint(-127, 128, (Lk, nR, Kd), generator=gen,
                                     dtype=torch.int8, device=dev),
                     Rs=torch.rand((Lk, nR, 1), generator=gen,
                                   device=dev) * 1e-3)
            x = torch.randn((M, Kd), generator=gen, device=dev)
            xb, plan = x.to(torch.bfloat16), K._xr_plan(M, nR, Kd, sms)
            w["ref"] = K.thin_xr(x, w["R"][0], w["Rs"][0])
            w["launch"] = (lambda i, w=w, xb=xb, plan=plan, Lk=Lk:
                           K._launch_lr_xr(xb, w["R"][i % Lk],
                                           w["Rs"][i % Lk], rank, plan)[0])
            cases[f"{nm} M={M}"] = w
    w4a8_cases = (("qkv", (4096,) * 3, 4096, 512), ("o", (4096,), 4096, 512),
                  ("down", (4096,), 11008, 512),
                  ("qkv", (4096,) * 3, 4096, 2048),
                  ("gate/up", (11008,) * 2, 4096, 2048))
    for nm, splits, Kd, M in () if args.xr else w4a8_cases:
        N, P = sum(splits), Kd // 2
        Lk = max(2, math.ceil(200e6 / (N * P)))
        w = dict(packed=torch.randint(0, 256, (Lk, N, P), generator=gen,
                                      dtype=torch.uint8, device=dev),
                 sc=torch.rand((Lk, N, 1), generator=gen, device=dev) * 0.01)
        x = torch.randn((M, Kd), generator=gen, device=dev)
        xq, sx = K.quantize_activations_int8(x)
        if args.l:
            xr = torch.randn((M, len(splits) * rank), generator=gen,
                             device=dev) * 0.5
            w["L"] = torch.randint(-127, 128, (Lk, N, rank), generator=gen,
                                   dtype=torch.int8, device=dev)
            w["Ls"] = torch.rand((Lk, N, 1), generator=gen, device=dev) * 1e-3
            w["ops"] = [K._l_tile_operands(xr, w["L"][i], rank, len(splits))
                        for i in range(Lk)]
            w["plan"] = K._w4a8_l_plan(M, N, Kd, 4, rank, splits, sms)
            w["ref"] = K.quantized_matmul_w4a8_l_stacked_plain(
                x, w["packed"], w["sc"], 0, xr, w["L"], w["Ls"], 4, rank,
                splits)
            w["launch"] = (lambda i, w=w, xq=xq, sx=sx, splits=splits, Lk=Lk:
                           K._launch_l_tile(xq, sx, w["packed"], w["sc"],
                                            i % Lk, *w["ops"][i % Lk],
                                            w["Ls"], 4, rank, splits,
                                            w["plan"]))
            w["row3"] = (lambda i, w=w, xq=xq, sx=sx, Lk=Lk:
                         K._launch_w4a8_stacked(xq, sx, w["packed"], w["sc"],
                                                i % Lk, 4))
        else:
            w["ref"] = K.quantized_matmul_w4a8_stacked_plain(
                x, w["packed"], w["sc"], 0, 4)
            w["launch"] = (lambda i, w=w, xq=xq, sx=sx, Lk=Lk:
                           K._launch_w4a8_stacked(xq, sx, w["packed"],
                                                  w["sc"], i % Lk, 4))
        cases[f"{nm} M={M}"] = w
    rounds = []
    for rnd in range(2):
        if args.l:
            ms = {key: _time_ms(torch, w["row3"], 10)
                  for key, w in cases.items()}
            rounds.append(dict(round=rnd, copy="row3", ms=ms))
            print(json.dumps(rounds[-1]), flush=True)
        for name in variants:
            _load(_build, lib_name, libs[name])
            ms = {}
            for key, w in cases.items():
                if name == "kernel":
                    y, ref = w["launch"](0), w["ref"]
                    tol = 1e-5 * float(ref.abs().max())
                    ok = (torch.allclose(y, ref, rtol=1e-5, atol=tol)
                          if args.l or args.xr else torch.equal(y, ref))
                    if not ok:
                        print(f"kernel {key} disagrees with the plain "
                              f"version", file=sys.stderr)
                        return 1
                try:
                    ms[key] = _time_ms(torch, w["launch"], 10)
                except RuntimeError as exc:
                    # a copy that does not launch is reported, not timed
                    ms[key] = None
                    print(f"{name} {key}: {exc}", flush=True)
            rounds.append(dict(round=rnd, copy=name, ms=ms))
            print(json.dumps(rounds[-1]), flush=True)
    print(json.dumps({"card": _card_line(), "rounds": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
