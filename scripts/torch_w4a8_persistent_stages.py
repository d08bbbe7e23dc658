#!/usr/bin/env python3
"""Per-stage device times of the W4A8 kernel's persistent launch at decode M
(``K.quantized_matmul_w4a8_stacked_persistent``, row 4 of PERF.md's kernel
table) on one card.

    python3 scripts/torch_w4a8_persistent_stages.py [--root TREE] [--ablate]

imports the port package from ``TREE`` (default: this checkout) and builds a
copy of its ``w4a8_stacked.cu`` beside copies of every header, edited by
text in a directory of its own (the script stops if an edited passage is
not there). The edited kernel is the one the tree runs at M <= 8:
``rowdot.cuh``'s ``rowdot_persistent_kernel`` where the tree has it (the
``__dp4a`` design), else ``w4a8_stream.cuh``'s ``stream_kernel``. In the
copy, thread 0 of each CTA writes ``%globaltimer`` when the CTA starts its
work and when it ends, and lane 0 of each warp adds the time of each of the
warp's parts:

- ``rowdot_persistent_kernel``: activation staging and row sums (once per M
  tile), the wait on each weight stage (its next stage's ``cp.async``
  issue, ``cp.async.wait_group 1`` and the CTA barrier), the ``__dp4a``
  products, the epilogue, and the barrier that ends each stage;
- ``stream_kernel``: the wait on the ring (the ``mbarrier`` of its slot),
  the slab's activation reads from its slot, the ``mma.sync`` products,
  the next slab's issue, the split sum (partials, counter, the last warp's
  reads) and the epilogue; beside them the prologue (the ring's first
  issues) and the loop as a whole, whose excess over its parts is the rest
  of the loop's instructions.

Cases: Llama-2-7B's o (4096 x 4096) and down (4096 x 11008) at M 8, 4-bit,
seeded weights rotating over enough layers (>= 200 MB) to come from device
memory. For each: the launch as the tree builds it (a CUDA graph of
launches, median of 5 replays), the stamped copy's graph time a launch,
the span of the last of a CUDA graph of 20 stamped launches (the latest
CTA end less the earliest CTA start) beside the bytes' bound, each part's
mean and largest time a warp (means over the 20 launches), and the stamped
copy's output against the tree's (bit for bit). ``--ablate`` (a tree with
``w4a8_stream.cuh``) also builds copies of that header with one design
choice changed (``ABLATIONS``: a ring of 3 or 4 slots in place of 2, two
CTAs an SM, the activations loaded by each lane from L2 (the next slab's
during this slab's products) in place of the ring's boxes; and, as
diagnostics whose outputs are wrong, no products or no activation reads)
and times
each beside the tree's build, with "no split" (the tree's build on 16
CTAs: one whole group of 32 rows a warp, no split sums). Last line: one JSON object ``{"root", "card",
"kernel", "cases"}``.
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
STRIDE = 4096          # CTAs a stamp row holds
WSTRIDE = 32 * STRIDE  # warps a part row holds
TIMING = r"""// per-CTA stamps and per-warp parts (a timing copy only)
#pragma once
static __device__ unsigned long long* g_wstamp = nullptr;
static __device__ unsigned long long* g_wbrk = nullptr;
static __device__ __forceinline__ unsigned long long ws_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define WS_STAMP(i)                                                         \
  if (threadIdx.x == 0 && g_wstamp != nullptr)                              \
    g_wstamp[(size_t)(i) * 4096 + blockIdx.x] = ws_now();
#define WS_TIME(acc, ...)                                                   \
  {                                                                         \
    const unsigned long long t_ = ws_now();                                 \
    __VA_ARGS__;                                                            \
    acc += ws_now() - t_;                                                   \
  }
// add this warp's part times (lane 0), part i at row i
#define WS_FLUSH(n, arr)                                                    \
  if ((threadIdx.x & 31) == 0 && g_wbrk != nullptr)                         \
    for (int i_ = 0; i_ < (n); ++i_)                                        \
      atomicAdd(g_wbrk + (size_t)i_ * 131072 +                              \
                    blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5),    \
                arr[i_]);
"""
SETTER = r"""
extern "C" int w4a8_set_stamps(void* stamps, void* brk) {
  cudaError_t e = cudaMemcpyToSymbol(g_wstamp, &stamps, sizeof(stamps));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_wbrk, &brk, sizeof(brk));
  return (int)e;
}
"""
ROWDOT_PARTS = ("staging", "wait", "products", "epilogue", "barrier")
STREAM_PARTS = ("wait", "x reads", "products", "issue", "split", "epilogue",
                "prologue", "loop")


def _need(src, piece, n, what):
    if src.count(piece) != n:
        raise SystemExit(f"{what} changed: {piece.strip()[:60]!r} found "
                         f"{src.count(piece)} times, expected {n}")


def _edit(src, edits, what):
    for old, new in edits:
        _need(src, old, 1, what)
        src = src.replace(old, new)
    return '#include "w4a8_timing.cuh"\n' + src


def stamp_rowdot(src):
    """rowdot.cuh with rowdot_persistent_kernel stamped and its parts
    timed."""
    return _edit(src, [
        # the copy's own smem attribute: a function-local static of the
        # template is one symbol across the tree's library and the copy
        ("  static const cudaError_t attr = allow_smem(kernel, "
         "kMaxSmemBytes);\n",
         "  const cudaError_t attr = allow_smem(kernel, kMaxSmemBytes);\n"),
        ("  int acc[RPW][MT];\n  load_stage(0);\n",
         "  int acc[RPW][MT];\n  unsigned long long ws_p[5] = {0, 0, 0, 0, "
         "0};\n  WS_STAMP(0)\n  load_stage(0);\n"),
        ("    if (r == 0) {\n      // a new M tile",
         "    const unsigned long long ws_t0 = ws_now();\n"
         "    if (r == 0) {\n      // a new M tile"),
        ("    if (c == 0) {\n#pragma unroll\n      for (int q = 0; q < RPW; "
         "++q)\n",
         "    ws_p[0] += ws_now() - ws_t0;\n    if (c == 0) {\n#pragma unroll\n"
         "      for (int q = 0; q < RPW; ++q)\n"),
        ("    load_stage(s + 1);\n    cp_async_wait_one();  // stage s has "
         "landed (this thread's copies)\n    __syncthreads();      // ... and "
         "every thread's\n",
         "    WS_TIME(ws_p[1], load_stage(s + 1); cp_async_wait_one(); "
         "__syncthreads())\n"),
        ("    const uint8_t* buf = wbuf + (s & 1) * RPB * kPersistChunk;\n",
         "    const uint8_t* buf = wbuf + (s & 1) * RPB * kPersistChunk;\n"
         "    const unsigned long long ws_t1 = ws_now();\n"),
        ("    }\n\n    if (c == nchunk - 1) {\n",
         "    }\n    ws_p[2] += ws_now() - ws_t1;\n"
         "    const unsigned long long ws_t2 = ws_now();\n"
         "    if (c == nchunk - 1) {\n"),
        ("    __syncthreads();  // stage s's buffer is refilled by "
         "load_stage(s + 2)\n  }\n}\n",
         "    ws_p[3] += ws_now() - ws_t2;\n    WS_TIME(ws_p[4], "
         "__syncthreads())\n  }\n  WS_FLUSH(5, ws_p)\n  __syncthreads();\n"
         "  WS_STAMP(1)\n}\n"),
    ], "rowdot.cuh")


def stamp_stream(src):
    """w4a8_stream.cuh with stream_kernel stamped and its parts timed."""
    return _edit(src, [
        ("  Ring rg;\n  Cursor q;\n",
         "  unsigned long long ws_p[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
         "  WS_STAMP(0)\n  const unsigned long long ws_t0 = ws_now();\n"
         "  Ring rg;\n  Cursor q;\n"),
        ("  fproj::XFrag<BITS, 1> xf;\n",
         "  fproj::XFrag<BITS, 1> xf;\n"
         "  const unsigned long long ws_t1 = ws_now();\n"
         "  ws_p[6] = ws_t1 - ws_t0;\n"),
        ("      ring_wait(rg);\n",
         "      WS_TIME(ws_p[0], ring_wait(rg))\n"),
        ("      ring_x<BITS>(sl, xf);\n",
         "      WS_TIME(ws_p[1], ring_x<BITS>(sl, xf))\n"),
        (_PRODUCTS,
         "      WS_TIME(ws_p[2], fproj::slab_codes<BITS, 8, true>(sl, xf, "
         "nullptr, 0, 0, 0, 0, false, acc))\n"),
        ("      issue<BITS>(q, pl, rg, hi);\n",
         "      WS_TIME(ws_p[3], issue<BITS>(q, pl, rg, hi))\n"),
        ("    if (!(lo <= g0 && end == g0 + pl.nk) && !split_sum(acc, pl, G))"
         "\n      continue;\n",
         "    bool ws_skip;\n    WS_TIME(ws_p[4], ws_skip = !(lo <= g0 && "
         "end == g0 + pl.nk) && !split_sum(acc, pl, G))\n"
         "    if (ws_skip) continue;\n"),
        ("    epilogue(acc, pl, G);\n  }\n",
         "    WS_TIME(ws_p[5], epilogue(acc, pl, G))\n  }\n"
         "  ws_p[7] = ws_now() - ws_t1;\n  WS_FLUSH(8, ws_p)\n"
         "  __syncthreads();\n  WS_STAMP(1)\n"),
    ], "w4a8_stream.cuh")


# --ablate: copies of w4a8_stream.cuh with one design choice changed:
# name -> (edits, CTAs an SM, whether the output stays the tree's)
_DEPTH = "constexpr int kDepth = 2;"
_PRODUCTS = ("      fproj::slab_codes<BITS, 8, true>(sl, xf, nullptr, 0, 0, 0, 0, "
             "false,\n                                       acc);\n")
_LOAD_X = ("fproj::load_x<BITS, 1>({}, pl.x, pl.K, pl.P, ({}) % pl.nk, pl.M, "
           "false);\n")
ABLATIONS = {
    "depth 3": ([(_DEPTH, "constexpr int kDepth = 3;")], 1, True),
    "depth 4": ([(_DEPTH, "constexpr int kDepth = 4;")], 1, True),
    "2 CTAs an SM": ([], 2, True),
    # each lane loads its activation words from L2 (the next slab's during
    # this slab's products), and the slots hold the weights alone
    "x from L2": ([
        ("  return kSlabBytes + (8 / BITS) * kXBox;\n",
         "  return kSlabBytes;\n"),
        ("      for (int p = 0; p < 8 / BITS; ++p)\n"
         "        hopper::tma_load_3d(dst + kSlabBytes + p * kXBox, rg.xmap,\n"
         "                            rg.bar + slot, c * kKC, p, 0);\n", ""),
        ("  fproj::XFrag<BITS, 1> xf;\n",
         "  fproj::XFrag<BITS, 1> xf;\n  if (lo < hi) "
         + _LOAD_X.format("xf", "lo")),
        ("      ring_wait(rg);\n",
         "      fproj::XFrag<BITS, 1> nxt;\n      if (s + 1 < hi) "
         + _LOAD_X.format("nxt", "s + 1") + "      ring_wait(rg);\n"),
        ("      ring_x<BITS>(sl, xf);\n", ""),
        ("      issue<BITS>(q, pl, rg, hi);\n    }\n",
         "      issue<BITS>(q, pl, rg, hi);\n      xf = nxt;\n    }\n")],
        1, True),
    # diagnostics (wrong outputs): no products; no activation reads
    "no products": ([(_PRODUCTS, "      acc[0][0][0] += sl[threadIdx.x & 31];"
                                 "\n")], 1, False),
    "no x reads": ([("      ring_x<BITS>(sl, xf);\n", "")], 1, False),
}


def _nvcc(_build, out_dir, src, tag):
    """nvcc on ``src`` (a w4a8_stacked.cu) in out_dir; returns the CDLL."""
    (out_dir / "w4a8_stacked.cu").write_text(src)
    lib_path = out_dir / f"libw4a8_stacked_{tag}.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(out_dir), "-o",
         str(lib_path), str(out_dir / "w4a8_stacked.cu")],
        capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"w4a8_stacked ({tag}): nvcc failed\n"
                         f"{proc.stderr[-4000:]}")
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in _build.ENTRIES["w4a8_stacked"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _headers(_build, out_dir):
    out_dir.mkdir(parents=True, exist_ok=True)
    for hdr in _build.CSRC.glob("*.cuh"):
        shutil.copy(hdr, out_dir / hdr.name)


def build_stamped(_build, out_dir):
    """nvcc on a copy of w4a8_stacked.cu beside copies of every header, the
    persistent kernel's header stamped; returns (CDLL, parts)."""
    _headers(_build, out_dir)
    (out_dir / "w4a8_timing.cuh").write_text(TIMING)
    stream = (_build.CSRC / "w4a8_stream.cuh").exists()
    if stream:
        (out_dir / "w4a8_stream.cuh").write_text(
            stamp_stream((_build.CSRC / "w4a8_stream.cuh").read_text()))
    else:
        (out_dir / "rowdot.cuh").write_text(
            stamp_rowdot((_build.CSRC / "rowdot.cuh").read_text()))
    src = (_build.CSRC / "w4a8_stacked.cu").read_text()
    lib = _nvcc(_build, out_dir, '#include "w4a8_timing.cuh"\n' + src
                + SETTER, "stamped")
    lib.w4a8_set_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.w4a8_set_stamps.restype = ctypes.c_int
    return lib, (STREAM_PARTS if stream else ROWDOT_PARTS)


def build_ablations(_build, out_dir):
    """{name: CDLL} of the ABLATIONS copies, built in parallel."""
    import concurrent.futures as cf
    hdr = (_build.CSRC / "w4a8_stream.cuh").read_text()
    src = (_build.CSRC / "w4a8_stacked.cu").read_text()
    dirs = {}
    for i, (name, edits) in enumerate(ABLATIONS.items()):
        d = out_dir / f"ablate{i}"
        _headers(_build, d)
        text = hdr
        for old, new in edits[0]:
            _need(text, old, 1, f"w4a8_stream.cuh ({name})")
            text = text.replace(old, new)
        (d / "w4a8_stream.cuh").write_text(text)
        dirs[name] = d
    with cf.ThreadPoolExecutor(len(dirs)) as ex:
        futs = {n: ex.submit(_nvcc, _build, d, src, f"ablate{i}")
                for i, (n, d) in enumerate(dirs.items())}
        return {n: f.result() for n, f in futs.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--ablate", action="store_true",
                    help="also time copies with one design choice changed "
                         "(a tree with w4a8_stream.cuh)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        _build, kernels as K)
    tag = "stream" if (_build.CSRC / "w4a8_stream.cuh").exists() else "rowdot"
    stamped, parts = build_stamped(_build, _build.BUILD_DIR / f"stages_{tag}")
    ablated = (build_ablations(_build, _build.BUILD_DIR / "stages_ablate")
               if args.ablate else {})
    _build.build(["w4a8_stacked", "grouped_matmul"])
    prod = _build.library("w4a8_stacked")
    for line in _build.build_log("w4a8_stacked").splitlines():
        if ("persistent" in line or "stream_kernel" in line) \
                or "Used" in line:
            print(f"w4a8_stacked: {line.strip()}", flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    card = _card_line()
    print(f"card: {card}; root {args.root}; kernel {tag}", flush=True)
    stamps = torch.zeros((2, STRIDE), dtype=torch.int64, device=dev)
    brk = torch.zeros((len(parts), WSTRIDE), dtype=torch.int64, device=dev)
    cases, failed = [], []
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    for name, N, Kd in (("o", 4096, 4096), ("down", 4096, 11008)):
        M, bits = 8, 4
        layer_bytes = N * Kd // 2
        Lk = max(2, math.ceil(200e6 / layer_bytes))
        packed = torch.randint(0, 256, (Lk, N, Kd // 2), generator=gen,
                               dtype=torch.uint8, device=dev)
        scales = torch.rand((Lk, N, 1), generator=gen, device=dev) * 0.01
        x = torch.randn((M, Kd), generator=gen, device=dev)
        xq, sx = K.quantize_activations_int8(x)

        def call(i):
            return K._launch_w4a8_stacked(xq, sx, packed, scales, i % Lk,
                                          bits, persistent=True)

        _build._libs["w4a8_stacked"] = prod
        ref = call(1)
        ms = _time_ms(torch, call, 50)
        _build._libs["w4a8_stacked"] = stamped
        got = call(1)
        _build.check(stamped.w4a8_set_stamps(stamps.data_ptr(),
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
        _build.check(stamped.w4a8_set_stamps(None, None), "set_stamps")
        del graph
        _build._libs["w4a8_stacked"] = prod
        same = bool(torch.equal(got, ref))
        if not same:
            failed.append(f"{name}: the stamped copy's output differs")
        grid = int((st[0] > 0).sum())
        s = st[:, :grid].double()
        span_us = float(s[1].max() - s[0].min()) * 1e-3
        late_us = float(s[0].max() - s[0].min()) * 1e-3
        warps = int((b.sum(0) > 0).sum())
        us = b[:, :warps].double() * 1e-3 / N_GRAPH
        nbytes = layer_bytes + N * 4 + M * Kd + M * 4 + M * N * 4
        bound = nbytes / HBM_BYTES_PER_S * 1e6
        part = {p: (float(us[i].mean()), float(us[i].max()))
                for i, p in enumerate(parts)}
        print(f"\n{name} M={M} N={N} K={Kd} {bits}-bit: launch {ms:.4f} ms "
              f"({ms_st:.4f} stamped), grid {grid} CTAs, {warps} warps; span "
              f"{span_us:.2f} us (last CTA start +{late_us:.2f} us), bound "
              f"{bound:.2f} us; stamped output equal: {same}", flush=True)
        print("  per warp, mean / max us: " + ", ".join(
            f"{p} {m:.2f} / {x_:.2f}" for p, (m, x_) in part.items()),
            flush=True)
        abl = {}
        if ablated:
            # each copy beside the tree's build (timed before and after);
            # "no split": 16 CTAs, one whole group of 32 rows a warp
            variants = {n: (lib, ABLATIONS[n][1] * sms, ABLATIONS[n][2])
                        for n, lib in ablated.items()}
            variants["no split"] = (prod, 16, True)
            for vname, (lib, ctas, keeps) in variants.items():
                _build._libs["w4a8_stacked"] = lib
                kw = dict(ctas=ctas)

                def vcall(i):
                    return K._launch_w4a8_stacked(
                        xq, sx, packed, scales, i % Lk, bits,
                        persistent=True, **kw)
                eq = bool(torch.equal(vcall(1), ref))
                vms = _time_ms(torch, vcall, 50)
                _build._libs["w4a8_stacked"] = prod
                base = 0.5 * (ms + _time_ms(torch, call, 50))
                abl[vname] = dict(ms=vms, tree_ms=base, ratio=vms / base,
                                  equal=eq)
                if keeps and not eq:
                    failed.append(f"{name} {vname}: output differs")
                print(f"  ablation {vname}: {vms:.4f} ms, {vms / base:.3f}x "
                      f"the tree's {base:.4f}, output equal {eq}",
                      flush=True)
        cases.append(dict(name=name, M=M, N=N, K=Kd, bits=bits, ms=ms,
                          ms_stamped=ms_st, grid=grid, warps=warps,
                          span_us=span_us, last_start_us=late_us,
                          bound_us=bound, same=same, parts_us=part,
                          ablations=abl))
        del packed
        torch.cuda.empty_cache()
    print(json.dumps({"root": args.root, "card": card, "kernel": tag,
                      "cases": cases}))
    for f in failed:
        print(f, file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
