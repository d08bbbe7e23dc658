#!/usr/bin/env python3
"""Per-stage device times of the row decode kernels (the staged and inline
attention of ``AT.flash_decode_q8_staged`` / ``AT.flash_decode_q8``, rows 11
and 10 of PERF.md's kernel table) on one card.

    python3 scripts/torch_decode_row_stages.py [--root TREE] [--ablate]

imports the port package from ``TREE`` (default: this checkout) and builds a
copy of its ``flash_decode.cu`` beside copies of every header, the kernel
the tree runs at a block of at most 256 tokens edited by text in a
directory of its own (the script stops if an edited passage is not there):
``flash_decode.cuh``'s ``decode_attend`` where the tree's ``flash_decode.cu``
has no ``row_kernel`` (the sequential walk), else ``flash_decode.cu``'s
``row_kernel`` (a stream's blocks over a thread-block cluster). In the copy,
thread 0 of each CTA writes ``%globaltimer`` when the CTA starts and ends,
and adds the time between laps to the stage it closes:

- the walk: q staging (the load and, in i8 and bf16, its rounding), K loads
  (thread 0 waiting on its K rows), logits, softmax pieces, V loads + p @ V,
  the block combine, the staged current token, the store;
- ``row_kernel``: the prologue (q, scales and the first copies issued, q
  rounded), K wait (the ring's waits in the K pass), logits (with the block
  maxima), the exchange (the cluster barrier and the running maxima),
  softmax pieces, V wait, p @ V (with the chains' fixed-order sums), the
  chain (the second barrier and the rank-0 CTA's ordered combine), the
  current token and the store (with the last barrier).

Cases: Llama-2-7B's heads at the bench shape (B 8, KVH 32, G 1, D 128, T
256, every row at 128), staged i8 and f32, and inline i8; Llama-2-7B at T
2048 with mixed positions, staged i8; Llama-3-8B's GQA heads (B 8, KVH 8, G
4, D 128, T 2048, mixed positions), staged i8 and f32. Caches rotate over
enough layers (>= 200 MB) to come from device memory. For each: the launch
as the tree builds it (a CUDA graph of launches, median of 5 replays), the
stamped copy's graph time a launch, the span of the last of a CUDA graph of
20 stamped launches (the latest CTA end less the earliest CTA start) beside
the bytes' bound, each stage's mean over the CTAs that had work and its
largest (means over the 20 launches), and the stamped copy's output against
the tree's (bit for bit). ``--ablate`` (a tree with ``row_kernel``) also
times the tree's kernel with its cluster size forced (``ABLATIONS``: no
cluster split and other cluster sizes) and copies with one constant changed
(``SOURCE_ABLATIONS``: 4 warps a CTA in place of 8, rings of 2 and 3 slots)
beside the tree's build, each output against the tree's. Last line:
one JSON object ``{"root", "card", "kernel", "cases"}``.
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
from chip_smoke import HBM_BYTES_PER_S, _card_line, _time_ms  # noqa: E402

N_GRAPH = 20           # launches of the stamped copy's graph
STRIDE = 8192          # CTAs a stamp row holds
TIMING = r"""// per-CTA stamps and stage laps (a timing copy only)
#pragma once
static __device__ unsigned long long* g_wstamp = nullptr;
static __device__ unsigned long long* g_wbrk = nullptr;
static __device__ __forceinline__ unsigned long long ws_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  return t;
}
#define WS_STAMP(i)                                                         \
  if (threadIdx.x == 0 && g_wstamp != nullptr)                              \
    atomicMax(g_wstamp + (size_t)(i) * 8192 + blockIdx.x, ws_now());
// the time since the last lap to stage i (thread 0's view of its CTA)
#define WS_LAP(i)                                                           \
  {                                                                         \
    const unsigned long long t_ = ws_now();                                 \
    ws_p[i] += t_ - ws_t;                                                   \
    ws_t = t_;                                                              \
  }
// thread 0 waits for a loaded value before the next lap
#define WS_USE(x) asm volatile("" ::"r"(x) : "memory");
#define WS_FLUSH(n)                                                         \
  if (threadIdx.x == 0 && g_wbrk != nullptr)                                \
    for (int i_ = 0; i_ < (n); ++i_)                                        \
      atomicAdd(g_wbrk + (size_t)i_ * 8192 + blockIdx.x, ws_p[i_]);
"""
SETTER = r"""
extern "C" int decode_set_stamps(void* stamps, void* brk) {
  cudaError_t e = cudaMemcpyToSymbol(g_wstamp, &stamps, sizeof(stamps));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_wbrk, &brk, sizeof(brk));
  return (int)e;
}
"""
WALK_PARTS = ("q staging", "K loads", "logits", "softmax", "V loads + PV",
              "combine", "current token", "store")


def _need(src, piece, n, what):
    if src.count(piece) != n:
        raise SystemExit(f"{what} changed: {piece.strip()[:60]!r} found "
                         f"{src.count(piece)} times, expected {n}")


def _edit(src, edits, what):
    for old, new in edits:
        _need(src, old, 1, what)
        src = src.replace(old, new)
    return '#include "decode_timing.cuh"\n' + src


def stamp_walk(src):
    """flash_decode.cuh with decode_attend stamped: a lap at the end of
    each stage."""
    return _edit(src, [
        ("  const int dw = D / 4;\n",
         "  const int dw = D / 4;\n  unsigned long long ws_p[8] = {0, 0, 0, "
         "0, 0, 0, 0, 0};\n  WS_STAMP(0)\n  unsigned long long ws_t = "
         "ws_now();\n"),
        ("  __syncthreads();\n\n  for (int t = 0; t < nblk; ++t) {\n",
         "  __syncthreads();\n  WS_LAP(0)\n\n  for (int t = 0; t < nblk; ++t)"
         " {\n"),
        ("          if (j < D / 16) kv[j] = __ldg(krow + j);\n",
         "          if (j < D / 16) kv[j] = __ldg(krow + j);\n"
         "        WS_USE(kv[0].x)\n        WS_LAP(1)\n"),
        ("          lg[g * kSub + i] = logit;\n        }\n      }\n"
         "      __syncthreads();\n",
         "          lg[g * kSub + i] = logit;\n        }\n      }\n"
         "      __syncthreads();\n      WS_LAP(2)\n"),
        ("      // 3. (p * vs) @ v: warp w sums",
         "      WS_LAP(3)\n      // 3. (p * vs) @ v: warp w sums"),
        ("      if (more) __syncthreads();\n",
         "      WS_LAP(4)\n      if (more) __syncthreads();\n"),
        ("          acc[g] = acc[g] * alpha_s[g] + contrib;\n        }\n"
         "      }\n    }\n    __syncthreads();\n  }\n",
         "          acc[g] = acc[g] * alpha_s[g] + contrib;\n        }\n"
         "      }\n    }\n    __syncthreads();\n    WS_LAP(5)\n  }\n"),
        ("          if (g == 0) first = o;\n        }\n      }\n    }\n"
         "    return first;\n",
         "          if (g == 0) first = o;\n        }\n      }\n    }\n"
         "    WS_LAP(7)\n    WS_FLUSH(8)\n    WS_STAMP(1)\n    return first;\n"),
        ("      pcur_s[g] = p;\n    }\n  }\n  __syncthreads();\n",
         "      pcur_s[g] = p;\n    }\n  }\n  __syncthreads();\n  WS_LAP(6)\n"),
        ("        if (g == 0) first = o;\n      }\n    }\n  }\n"
         "  return first;\n",
         "        if (g == 0) first = o;\n      }\n    }\n  }\n"
         "  WS_LAP(7)\n  WS_FLUSH(8)\n  WS_STAMP(1)\n  return first;\n"),
    ], "flash_decode.cuh")


def _nvcc(_build, out_dir, src, tag):
    """nvcc on ``src`` (a flash_decode.cu) in out_dir; returns the CDLL."""
    (out_dir / "flash_decode.cu").write_text(src)
    lib_path = out_dir / f"libflash_decode_{tag}.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(out_dir), "-o",
         str(lib_path), str(out_dir / "flash_decode.cu")],
        capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"flash_decode ({tag}): nvcc failed\n"
                         f"{proc.stderr[-4000:]}")
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in _build.ENTRIES["flash_decode"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def build_stamped(_build, out_dir):
    """nvcc on a copy of flash_decode.cu beside copies of every header, the
    tree's row kernel stamped; returns (CDLL, stage names, kernel name)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    for hdr in _build.CSRC.glob("*.cuh"):
        shutil.copy(hdr, out_dir / hdr.name)
    (out_dir / "decode_timing.cuh").write_text(TIMING)
    src = (_build.CSRC / "flash_decode.cu").read_text()
    if "row_kernel" in src:
        src, parts = stamp_row(src)
        kernel = "row_kernel"
    else:
        (out_dir / "flash_decode.cuh").write_text(stamp_walk(
            (_build.CSRC / "flash_decode.cuh").read_text()))
        src = '#include "decode_timing.cuh"\n' + src
        parts, kernel = WALK_PARTS, "walk"
    lib = _nvcc(_build, out_dir, src + SETTER, "stamped")
    lib.decode_set_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.decode_set_stamps.restype = ctypes.c_int
    return lib, parts, kernel


ROW_PARTS = ("prologue", "K wait", "logits", "exchange", "softmax",
             "V wait", "PV", "chain", "current + store")


def stamp_row(src):
    """flash_decode.cu with row_kernel stamped: a lap at the end of each
    stage; returns (source, stage names)."""
    return _edit(src, [
        ("  const size_t row0 = (size_t)bh * a.T + (size_t)lo * bt;  // first "
         "row\n",
         "  const size_t row0 = (size_t)bh * a.T + (size_t)lo * bt;\n"
         "  unsigned long long ws_p[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};\n"
         "  WS_STAMP(0)\n  unsigned long long ws_t = ws_now();\n"),
        ("  // 1. the logits of each window's tokens: each thread takes its "
         "tokens' K\n",
         "  WS_LAP(0)\n  // 1. the logits of each window's tokens: each thread "
         "takes its tokens' K\n"),
        ("    cp_async_wait<kSlots - 1>();\n    __syncthreads();\n"
         "    const int t0 = w * nbw * bt;\n",
         "    cp_async_wait<kSlots - 1>();\n    __syncthreads();\n"
         "    WS_LAP(1)\n    const int t0 = w * nbw * bt;\n"),
        ("                           lg + t0 + i, span);\n    }\n  }\n",
         "                           lg + t0 + i, span);\n    }\n"
         "    WS_LAP(2)\n  }\n"),
        ("  cluster_sync(C);\n  // the running max before",
         "  WS_LAP(2)\n  cluster_sync(C);\n  // the running max before"),
        ("  // 2. each block's probabilities",
         "  WS_LAP(3)\n  // 2. each block's probabilities"),
        ("  // 3. (p * vs) @ v of each window's blocks",
         "  WS_LAP(4)\n  // 3. (p * vs) @ v of each window's blocks"),
        ("    cp_async_wait<kSlots - 1>();\n    __syncthreads();\n"
         "    const int j0 = w * nbw, nbk = min(nbw, nbc - j0);\n",
         "    cp_async_wait<kSlots - 1>();\n    __syncthreads();\n"
         "    WS_LAP(5)\n    const int j0 = w * nbw, nbk = min(nbw, nbc - j0);\n"),
        ("        contrib[(j0 * G + k) * D + d] = cv;\n      }\n    }\n  }\n",
         "        contrib[(j0 * G + k) * D + d] = cv;\n      }\n    }\n"
         "    WS_LAP(6)\n  }\n"),
        ("  if (rank != 0) return;\n",
         "  WS_LAP(7)\n  if (rank != 0) {\n    WS_FLUSH(9)\n    WS_STAMP(1)\n"
         "    return;\n  }\n"),
        ("  // 5. staged: the current token",
         "  WS_LAP(7)\n  // 5. staged: the current token"),
        ("    a.out[(size_t)bh * G * D + x] = o;\n  }\n}\n",
         "    a.out[(size_t)bh * G * D + x] = o;\n  }\n  WS_LAP(8)\n"
         "  WS_FLUSH(9)\n  WS_STAMP(1)\n}\n"),
    ], "flash_decode.cu"), ROW_PARTS


# --ablate: the cluster size forced (no cluster split: one CTA a stream;
# other sizes), by a plan of the tree's own choice with that size
ABLATIONS = {"cluster 1": 1, "cluster 2": 2, "cluster 4": 4, "cluster 8": 8}
# ... and copies of flash_decode.cu with one constant changed, each built as
# a library of its own, with the plan's mirror of that constant: 4 warps a
# CTA in place of 8; rings of 2 and 3 slots (a window's K and V copied at
# once)
SOURCE_ABLATIONS = {
    "4 warps": ("constexpr int kRowThreads = 256;",
                "constexpr int kRowThreads = 128;", {}),
    "2 slots": ("constexpr int kSlots = 1;", "constexpr int kSlots = 2;",
                {"_ROW_SLOTS": 2}),
    "3 slots": ("constexpr int kSlots = 1;", "constexpr int kSlots = 3;",
                {"_ROW_SLOTS": 3}),
}


def build_source_ablations(_build, out_dir):
    """{name: (CDLL, the plan's constants)} of the SOURCE_ABLATIONS
    copies."""
    libs = {}
    src = (_build.CSRC / "flash_decode.cu").read_text()
    for i, (name, (old, new, consts)) in enumerate(SOURCE_ABLATIONS.items()):
        d = out_dir / f"ablate{i}"
        d.mkdir(parents=True, exist_ok=True)
        for hdr in _build.CSRC.glob("*.cuh"):
            shutil.copy(hdr, d / hdr.name)
        _need(src, old, 1, f"flash_decode.cu ({name})")
        libs[name] = (_nvcc(_build, d, src.replace(old, new), f"ablate{i}"),
                      consts)
    return libs


def forced_plan(AT, C):
    """AT._row_decode_plan with the cluster size C; raises ValueError where
    the shapes cannot take it."""
    base = AT._row_decode_plan

    def plan(B, KVH, G, D, T, bt, sms):
        p = base(B, KVH, G, D, T, bt, sms)
        maxb = -(-(T // bt) // C)
        smem = AT._row_smem(G, D, bt, maxb, p["nbw"], C)
        if (p["route"] != "row" or maxb * G > AT._ROW_MAX_PAIRS
                or smem > AT._ROW_MAX_SMEM or C > T // bt):
            raise ValueError(f"no plan of cluster {C} at G={G} D={D} T={T}")
        return dict(p, cluster=C, maxb=maxb, smem=smem, grid=B * KVH * C)
    return plan


# (name, staged, B, KVH, G, D, T, positions, dots)
CASES = [
    ("bench staged", True, 8, 32, 1, 128, 256, [128] * 8, "i8"),
    ("bench staged", True, 8, 32, 1, 128, 256, [128] * 8, "f32"),
    ("bench inline", False, 8, 32, 1, 128, 256, [128] * 8, "i8"),
    ("7b T=2048 mixed", True, 8, 32, 1, 128, 2048,
     [0, 255, 256, 700, 1024, 1500, 2047, 2048], "i8"),
    ("llama3-8b GQA T=2048", True, 8, 8, 4, 128, 2048,
     [0, 1, 300, 511, 512, 1999, 2047, 2048], "i8"),
    ("llama3-8b GQA T=2048", True, 8, 8, 4, 128, 2048,
     [0, 1, 300, 511, 512, 1999, 2047, 2048], "f32"),
]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--ablate", action="store_true",
                    help="also time the tree's kernel with its plan changed "
                         "(a tree with row_kernel)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        _build, attention as AT)
    stamped, parts, kernel = build_stamped(
        _build, _build.BUILD_DIR / "stages_decode_row")
    copies = (build_source_ablations(_build, _build.BUILD_DIR /
                                     "stages_decode_row_ablate")
              if args.ablate else {})
    _build.build(["flash_decode"])
    prod = _build.library("flash_decode")
    for line in _build.build_log("flash_decode").splitlines():
        if "Used" in line or "spill" in line:
            print(f"flash_decode: {line.strip()}", flush=True)
    dev = torch.device("cuda")
    card = _card_line()
    print(f"card: {card}; root {args.root}; kernel {kernel}", flush=True)
    stamps = torch.zeros((2, STRIDE), dtype=torch.int64, device=dev)
    brk = torch.zeros((len(parts), STRIDE), dtype=torch.int64, device=dev)
    cases, failed = [], []
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    for name, staged, B, KVH, G, D, T, pos, dots in CASES:
        layer_bytes = B * KVH * T * (2 * D + 8)
        Lk = max(2, math.ceil(200e6 / layer_bytes))
        q = torch.randn((B, KVH, G, D), generator=gen, device=dev)
        k = torch.randint(-127, 128, (Lk, B, KVH, T, D), generator=gen,
                          dtype=torch.int8, device=dev)
        v = torch.randint(-127, 128, (Lk, B, KVH, T, D), generator=gen,
                          dtype=torch.int8, device=dev)
        ks = torch.rand((Lk, B, KVH, T), generator=gen, device=dev) * 0.02
        vs = torch.rand((Lk, B, KVH, T), generator=gen, device=dev) * 0.02
        kn = torch.randn((B, KVH, D), generator=gen, device=dev)
        vn = torch.randn((B, KVH, D), generator=gen, device=dev)
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        bt = AT.resolve_block_t(256, T)
        entry = ("flash_decode_staged_launch" if staged
                 else "flash_decode_inline_launch")
        news = (kn, vn) if staged else (None, None)

        def call(i):
            return AT._launch_decode(entry, q, k, v, ks, vs, *news, i % Lk,
                                     p, bt, dots)

        _build._libs["flash_decode"] = prod
        ref = call(1)
        ms = _time_ms(torch, call, 50)
        _build._libs["flash_decode"] = stamped
        got = call(1)
        _build.check(stamped.decode_set_stamps(stamps.data_ptr(),
                                               brk.data_ptr()), "set_stamps")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call(0)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(N_GRAPH):
                call(i)
        stamps.zero_()
        brk.zero_()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        ms_st = start.elapsed_time(end) / N_GRAPH
        st, b = stamps.cpu(), brk.cpu()
        _build.check(stamped.decode_set_stamps(None, None), "set_stamps")
        del graph
        _build._libs["flash_decode"] = prod
        same = bool(torch.equal(got, ref))
        if not same:
            failed.append(f"{name} {dots}: the stamped copy's output differs")
        # the stamps hold the latest launch's times (atomicMax): its span
        grid = int((st[0] > 0).sum())
        s = st[:, :grid].double()
        span_us = float(s[1].max() - s[0].min()) * 1e-3
        late_us = float(s[0].max() - s[0].min()) * 1e-3
        us = b[:, :grid].double() * 1e-3 / N_GRAPH
        busy = us.sum(0) > 0
        live = sum(min(x if staged else x + 1, T) for x in pos)
        nbytes = (KVH * live * (2 * D + 8) + 2 * B * KVH * G * D * 4
                  + (2 * B * KVH * D * 4 if staged else 0) + B * 4)
        bound = nbytes / HBM_BYTES_PER_S * 1e6
        part = {pn: (float(us[i][busy].mean()), float(us[i].max()))
                for i, pn in enumerate(parts)}
        print(f"\n{name} dots={dots} B={B} KVH={KVH} G={G} D={D} T={T} "
              f"bt={bt}: launch {ms:.4f} ms ({ms_st:.4f} stamped), grid "
              f"{grid} CTAs ({int(busy.sum())} timed); span {span_us:.2f} us "
              f"(last CTA start +{late_us:.2f} us), bound {bound:.2f} us; "
              f"stamped output equal: {same}", flush=True)
        print("  per CTA, mean / max us: " + ", ".join(
            f"{pn} {m:.2f} / {x_:.2f}" for pn, (m, x_) in part.items()),
            flush=True)
        abl = {}
        if args.ablate:
            variants = [(n, {"_row_decode_plan": forced_plan(AT, C)}, prod)
                        for n, C in ABLATIONS.items()]
            variants += [(n, consts, lib)
                         for n, (lib, consts) in copies.items()]
            for vname, consts, lib in variants:
                _build._libs["flash_decode"] = lib
                saved = {n: getattr(AT, n) for n in consts}
                for n, val in consts.items():
                    setattr(AT, n, val)
                try:
                    eq = bool(torch.equal(call(1), ref))
                    vms = _time_ms(torch, call, 50)
                except ValueError as err:   # a plan the shapes cannot take
                    print(f"  ablation {vname}: {err}", flush=True)
                    continue
                finally:
                    for n, val in saved.items():
                        setattr(AT, n, val)
                    _build._libs["flash_decode"] = prod
                base = 0.5 * (ms + _time_ms(torch, call, 50))
                abl[vname] = dict(ms=vms, tree_ms=base, ratio=vms / base,
                                  equal=eq)
                if not eq:
                    failed.append(f"{name} {dots} {vname}: output differs")
                print(f"  ablation {vname}: {vms:.4f} ms, {vms / base:.3f}x "
                      f"the tree's {base:.4f}, output equal {eq}",
                      flush=True)
        cases.append(dict(name=name, staged=staged, dots=dots, B=B, KVH=KVH,
                          G=G, D=D, T=T, bt=bt, pos=pos, ms=ms,
                          ms_stamped=ms_st, grid=grid, span_us=span_us,
                          last_start_us=late_us, bound_us=bound, same=same,
                          parts_us=part, ablations=abl))
        del k, v, ks, vs
        torch.cuda.empty_cache()
    print(json.dumps({"root": args.root, "card": card, "kernel": kernel,
                      "cases": cases}))
    for f in failed:
        print(f, file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
