#!/usr/bin/env python3
"""Ablated copies of the two cooperative fusion kernels (``csrc/w4a8_lowrank.cu``'s
whole-MLP kernel and ``csrc/attn_o.cu``), timed beside the tree's own build
on one card.

    python3 scripts/torch_mlp_attn_o_ablate.py [--variants a,b,...]

Each variant is a copy of the two sources and of ``fused_proj.cuh`` (every
other header copied beside them), edited by text (the script stops if an
edited passage is not there), built by nvcc into a directory of its own:

- ``no_fold``: the thin R dots (xrd, xro) back in phase 2 as
  ``megastep.cuh``'s ``thin_rows`` (units of 4 R rows x 1 activation row
  over every warp of the grid, ``lowrank::xr_rows``' per-output order, so
  xrd and xro equal the parent's bit for bit; for attention + o_proj's
  CTAs of 4 warps, a copy of it), not folded into phase 1;
- ``no_prefetch``: no slab of a phase behind a grid barrier is issued before
  it: each warp's stream stops at the end of a stage and restarts after the
  barrier (attention + o_proj: the o_proj's stream starts after barrier 2,
  not before barrier 1);
- ``no_windows``: the L slabs' xr read from global memory, not staged in
  shared memory as bf16 at a stage's start;
- ``no_pre``: the whole-MLP kernel without the x loads of the next slab
  ahead of the current one's products (at 8-row tiles).

Cases: row 7 at M 8, 4 bits (Llama-2-7B MLP); row 15 at B 8, T 256,
position 128, staged and inline (``torch_mlp_attn_o_times.py``'s operands).
For each variant: the device time (a CUDA graph of launches, median of 5
replays) beside the tree's in the same process, and the output's
rel-Frobenius distance from the tree's. Last line: one JSON object
``{"card", "cases"}``.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import _card_line, _time_ms  # noqa: E402
import torch_mlp_attn_o_times as T  # noqa: E402

MLP_FOLD = ("        __syncwarp();  // T\n",
            "      });\n  lowrank::grid_sync();\n\n  // phase 2: the row "
            "scales of m")
MLP_REDUCE = ("  {\n    // item (mt, j) a CTA;",
              "  lowrank::grid_sync();\n\n  // phase 3: down")
AO_FOLD = ("    // xpart[bh, j] = sum_d ob[d] R[j, d]",
           "  // o_proj's first slabs load across both barriers")
AO_REDUCE = ("  {\n    const int W = gridDim.x * kWarps, w = blockIdx.x * "
             "kWarps + warp;\n    for (int item = w; item < B * rank;",
             "  lowrank::grid_sync();\n\n  // phase 3: the o_proj")
# megastep.cuh's thin_rows for CTAs of kWarps warps (attention + o_proj's)
AO_THIN = r"""  {
    const int W = gridDim.x * kWarps, w = blockIdx.x * kWarps + warp;
    for (int u = w; u < rank / 4 * B; u += W) {
      const int j0 = 4 * (u / B), b = u - (u / B) * B;
      const float* ar = a.attn + (size_t)b * qdim;
      const int8_t* Rr = a.oR + (size_t)j0 * qdim;
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int c = 4 * lane; c < qdim; c += 128) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(ar + c));
        const float x0 = lowrank::bf16r(v.x), x1 = lowrank::bf16r(v.y);
        const float x2 = lowrank::bf16r(v.z), x3 = lowrank::bf16r(v.w);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int rw =
              __ldg(reinterpret_cast<const int*>(Rr + (size_t)r * qdim + c));
          part[r] = fmaf(x0, (float)(int8_t)(rw & 0xFF), part[r]);
          part[r] = fmaf(x1, (float)(int8_t)((rw >> 8) & 0xFF), part[r]);
          part[r] = fmaf(x2, (float)(int8_t)((rw >> 16) & 0xFF), part[r]);
          part[r] = fmaf(x3, (float)(int8_t)((rw >> 24) & 0xFF), part[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float sum = lowrank::warp_sum_f(part[r]);
        if (lane == r)
          a.xro[(size_t)b * rank + j0 + r] = __fmul_rn(sum, a.oRs[j0 + r]);
      }
    }
  }
"""
AO_START = ("  // o_proj's first slabs load across both barriers and phase 2 "
            "(started\n  // earlier, they would take bandwidth from the "
            "attention)\n  fproj::stream_start(pl, ring, rg, q);\n")
AO_RUN = "  fproj::run_stage<BITS, MT, false>(\n      pl, 0, q, rg, a.pws, a.cnt,"
SEEK = ("    if (++q.s == q.hi) {\n      ++q.si;\n      stream_seek(q, pl, w, "
        "W);\n    }\n")
CG = "  const bool cg = d.cg != 0;\n"
PRE = "fproj::run_stage<BITS, MT, MT == 8>("
WIN_MLP = "constexpr int kMlpWin = 16 * 1024;"
WIN_AO = "constexpr int kWin = 8 * 1024;"


def _need(src, piece, what):
    if src.count(piece) != 1:
        raise SystemExit(f"{what} changed: {piece.strip()[:50]!r} found "
                         f"{src.count(piece)} times, expected 1")


def _cut(src, span, new, what):
    """src with the text from span[0] up to (not including) span[1]
    replaced by new."""
    _need(src, span[0], what)
    _need(src, span[1], what)
    a, b = src.index(span[0]), src.index(span[1])
    return src[:a] + new + src[b:]


def variant(name, mlp, ao, fp):
    """(w4a8_lowrank.cu, attn_o.cu, fused_proj.cuh) of variant ``name``."""
    if name == "no_fold":
        mlp = '#include "megastep.cuh"\n' + _cut(mlp, MLP_FOLD, "", "mlp")
        mlp = _cut(mlp, MLP_REDUCE, "  megastep::thin_rows(a.mbuf, M, im, "
                   "a.dn_R, a.dn_Rs, rank, a.xrd);\n", "mlp")
        ao = '#include "megastep.cuh"\n' + _cut(
            ao, AO_FOLD, "    __syncthreads();\n  }\n", "ao")
        ao = _cut(ao, AO_REDUCE, AO_THIN, "ao")
    elif name == "no_prefetch":
        for src, piece, what in ((fp, SEEK, "fp"), (fp, CG, "fp"),
                                 (ao, AO_START, "ao"), (ao, AO_RUN, "ao")):
            _need(src, piece, what)
        fp = fp.replace(SEEK, "    if (++q.s == q.hi) q.si = pl.nst;\n")
        fp = fp.replace(CG, CG + "  if (si > 0) {  // restart after the "
                        "barrier\n    q.si = si;\n    stream_seek(q, pl, w, "
                        "W);\n    q.n = rg.nc;\n    for (int i = 0; i < "
                        "kDepth; ++i) stream_issue(q, pl, rg, w, W);\n  }\n")
        ao = ao.replace(AO_START, "").replace(
            AO_RUN, "  fproj::stream_start(pl, ring, rg, q);\n" + AO_RUN)
    elif name == "no_windows":
        _need(mlp, WIN_MLP, "mlp")
        _need(ao, WIN_AO, "ao")
        mlp = mlp.replace(WIN_MLP, "constexpr int kMlpWin = 0;")
        ao = ao.replace(WIN_AO, "constexpr int kWin = 0;")
    elif name == "no_pre":
        if mlp.count(PRE) != 2:
            raise SystemExit("mlp changed: the run_stage calls")
        mlp = mlp.replace(PRE, "fproj::run_stage<BITS, MT, false>(")
    else:
        raise SystemExit(f"unknown variant {name}")
    return mlp, ao, fp


def build_variant(_build, out_dir, name):
    """Start nvcc on variant ``name``'s two libraries; returns a function
    that waits for them and returns {library: CDLL}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    for hdr in _build.CSRC.glob("*.cuh"):
        shutil.copy(hdr, out_dir / hdr.name)
    mlp, ao, fp = variant(
        name, (_build.CSRC / "w4a8_lowrank.cu").read_text(),
        (_build.CSRC / "attn_o.cu").read_text(),
        (_build.CSRC / "fused_proj.cuh").read_text())
    (out_dir / "fused_proj.cuh").write_text(fp)
    procs = {}
    for lib, src in (("w4a8_lowrank", mlp), ("attn_o", ao)):
        (out_dir / f"{lib}.cu").write_text(src)
        so = out_dir / f"lib{lib}_{name}.so"
        procs[lib] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(out_dir), "-o",
             str(so), str(out_dir / f"{lib}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))

    def wait():
        loaded = {}
        for lib, (so, proc) in procs.items():
            out, err = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"{name} {lib}: nvcc failed\n{err[-4000:]}")
            lines = (out + err).splitlines()
            for i, line in enumerate(lines):   # the 4-bit, 8-row kernels
                if ("mlp_kernelILi4ELi8E" in line
                        or "attn_o_kernelILi4ELi8E" in line) \
                        and "Compiling" in line:
                    print(f"{name} {lib}: " + " / ".join(
                        x.strip() for x in lines[i + 2:i + 4]), flush=True)
            dll = ctypes.CDLL(str(so))
            for fn, argtypes in _build.ENTRIES[lib].items():
                getattr(dll, fn).argtypes = argtypes
                getattr(dll, fn).restype = ctypes.c_int
            loaded[lib] = dll
        return loaded
    return wait


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants",
                    default="no_fold,no_prefetch,no_windows,no_pre")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    K, AT = T.load_port(root)
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import _build
    names = args.variants.split(",")
    for n in names:   # every edit checked before any build
        variant(n, (_build.CSRC / "w4a8_lowrank.cu").read_text(),
                (_build.CSRC / "attn_o.cu").read_text(),
                (_build.CSRC / "fused_proj.cuh").read_text())
    waits = {n: build_variant(_build, _build.BUILD_DIR / f"ablate_{n}", n)
             for n in names}
    _build.build(["w4a8_lowrank", "attn_o", "grouped_matmul"])
    prod = {lib: _build.library(lib) for lib in ("w4a8_lowrank", "attn_o")}
    libs = {n: w() for n, w in waits.items()}
    dev = torch.device("cuda")
    card = _card_line()
    print(f"card: {card}", flush=True)

    gu, dn, gs, Lk, _ = T.mlp_weights(torch, dev, 4)
    gen = torch.Generator(device=dev)
    gen.manual_seed(108)
    x = torch.randn((8, T.H), generator=gen, device=dev)
    xr = K.thin_xr(x, gu["R"][1], gu["Rs"][1])
    xq, sx = K.quantize_activations_int8(x)
    cache, ow, Lka, _ = T.attn_cache(torch, dev, 8, 256)
    pos = torch.full((8,), 128, dtype=torch.int32, device=dev)
    calls = {
        "row 7, M 8, 4-bit": ("w4a8_lowrank", lambda i: K._launch_mlp(
            xq, sx, xr, gu["packed"], gu["scales"], i % Lk,
            *T.mlp_args(gu, dn, gs, xr, i % Lk, 4)[4:])[0]),
        "row 15 staged": ("attn_o", lambda i: AT._launch_attn_o(
            *cache, i % Lka, pos, *ow, 4, T.RANK, True, 256)[0]),
        "row 15 inline": ("attn_o", lambda i: AT._launch_attn_o(
            *cache, i % Lka, pos, *ow, 4, T.RANK, False, 256)[0]),
    }
    cases = []
    for case, (lib, call) in calls.items():
        _build._libs[lib] = prod[lib]
        K._FUSED_GRIDS.clear()
        ref = call(1)
        ms = _time_ms(torch, call, 20)
        row = dict(case=case, tree_ms=ms, variants={})
        print(f"{case}: tree {ms:.4f} ms", flush=True)
        for n in names:
            _build._libs[lib] = libs[n][lib]
            K._FUSED_GRIDS.clear()
            y = call(1)
            vms = _time_ms(torch, call, 20)
            rel = float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))
            row["variants"][n] = dict(ms=vms, rel_to_tree=rel)
            print(f"  {n}: {vms:.4f} ms ({vms / ms:.3f}x), rel to the tree's "
                  f"output {rel:.3e}", flush=True)
        _build._libs[lib] = prod[lib]
        K._FUSED_GRIDS.clear()
        row["tree_ms_after"] = _time_ms(torch, call, 20)
        print(f"  tree again: {row['tree_ms_after']:.4f} ms", flush=True)
        cases.append(row)
    print(json.dumps({"card": card, "cases": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
