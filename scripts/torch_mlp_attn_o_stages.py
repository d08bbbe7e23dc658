#!/usr/bin/env python3
"""Per-phase device times of the two cooperative fusion kernels on one card:
the whole-MLP kernel (``csrc/w4a8_lowrank.cu``'s ``mlp_kernel``, row 7 of
PERF.md's kernel table) and attention + o_proj (``csrc/attn_o.cu``'s
``attn_o_kernel``, row 15).

    python3 scripts/torch_mlp_attn_o_stages.py [--root TREE]

imports the port package from ``TREE`` (default: this checkout) and builds
copies of its ``w4a8_lowrank.cu`` and ``attn_o.cu``, edited by text into a
directory of their own (the other sources and headers from the tree's
``csrc``; the script stops if an edited passage is not there). In a copy,
thread 0 of each CTA writes ``%globaltimer`` at the kernel's start, around
each of its two grid barriers (once the CTA's work of the phase is done,
after a ``__syncthreads``, and once it leaves the barrier) and at its end.
Copies of the projection code add each warp's time in its parts:
``lowrank.cuh``'s ``lr_tile`` (the ``__dp4a`` tiles: the window and row-sum
staging, the products, the L epilogue) where the tree runs on it, else
``fused_proj.cuh``'s ``run_stage`` (ring waits, next-slab x loads, code
slabs, L slabs, issue, split sums, epilogue). The tree's own sources get no
stamp.

Cases (chip_smoke phase 2's shapes, seeded weights rotating over layers):
row 7 at h 4096, im 11008, rank 128, 4 bits, M 8; row 15 at B 8, KVH 32, D
128, T 256, every row at position 128, staged and inline. For each phase:
the span (latest barrier exit, or kernel end, minus the earliest start
across CTAs; a phase starts where the first CTA left the previous barrier)
and the work (the same up to the latest end of work: the rest is the
barrier), beside the phase's byte bound, read from the last launch of a
CUDA graph of 20 launches of the stamped copy (the parts: each warp's mean
over the 20); the launch alone as the tree builds it (a graph of launches,
median of 5 replays) and the stamped copy's graph time a launch; the
copy's output against the tree's. Last line: one JSON object
``{"root", "card", "cases"}``.
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import HBM_BYTES_PER_S, _card_line, _time_ms  # noqa: E402
import torch_mlp_attn_o_times as T  # noqa: E402

N = 20                 # launches of the stamped copy's graph
STRIDE = 4096          # CTAs a stamp row holds
WSTRIDE = 8 * STRIDE   # warps a breakdown row holds
BARRIER = "lowrank::grid_sync();"
TIMING = r"""// per-phase stamps and per-warp parts (a timing copy only)
#pragma once
static __device__ unsigned long long* g_fstamp = nullptr;
static __device__ unsigned long long* g_fbrk = nullptr;
static __device__ __forceinline__ unsigned long long fs_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define FS_STAMP(i)                                                         \
  if (threadIdx.x == 0 && g_fstamp != nullptr)                              \
    g_fstamp[(size_t)(i) * 4096 + blockIdx.x] = fs_now();
#define FS_TIME(acc, ...)                                                   \
  {                                                                         \
    const unsigned long long t_ = fs_now();                                 \
    __VA_ARGS__;                                                            \
    acc += fs_now() - t_;                                                   \
  }
// add this warp's part times (lane 0) at row (base + i)
#define FS_FLUSH(base, n, arr)                                              \
  if ((threadIdx.x & 31) == 0 && g_fbrk != nullptr)                         \
    for (int i_ = 0; i_ < (n); ++i_)                                        \
      atomicAdd(g_fbrk + (size_t)((base) + i_) * 32768 +                    \
                    blockIdx.x * 8 + (threadIdx.x >> 5), arr[i_]);
"""
SETTER = r"""
extern "C" int fusion_set_stamps(void* stamps, void* brk) {
  cudaError_t e = cudaMemcpyToSymbol(g_fstamp, &stamps, sizeof(stamps));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_fbrk, &brk, sizeof(brk));
  return (int)e;
}
"""
# parts of a warp's time (rows of the breakdown buffer)
LR_PARTS = ("window", "products", "L epilogue")        # lr_tile, per phase
FP_PARTS = ("wait", "x loads", "code slabs", "L slabs", "issue", "split",
            "epilogue")                                # run_stage, per stage


def _need(src, piece, n, what):
    if src.count(piece) != n:
        raise SystemExit(f"{what} changed: {piece.strip()[:50]!r} found "
                         f"{src.count(piece)} times, expected {n}")


def stamp_kernel(src, name):
    """src with the body of __global__ kernel ``name`` stamped: 0 at its
    start, 1 / 2 around the first barrier, 3 / 4 around the second, 5 at
    its end."""
    m = re.search(r"__global__[^;{]*?\b" + name + r"\(", src)
    if m is None:
        raise SystemExit(f"kernel {name} not found")
    open_ = src.index(") {\n", m.end()) + 2
    depth, i = 0, open_
    while True:
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            break
        i += 1
    body = src[open_ + 1:i]
    _need(body, BARRIER, 2, name)
    parts = body.split(BARRIER)
    body = (parts[0] + "{ __syncthreads(); FS_STAMP(1) } " + BARRIER
            + " FS_STAMP(2)" + parts[1] + "{ __syncthreads(); FS_STAMP(3) } "
            + BARRIER + " FS_STAMP(4)" + parts[2])
    return (src[:open_ + 1] + "\n  FS_STAMP(0)" + body
            + "  __syncthreads();\n  FS_STAMP(5)\n" + src[i:])


def breakdown_lowrank(src):
    """lowrank.cuh with lr_tile's parts timed (rows CGX * 3 + part)."""
    a = "  __syncthreads();  // the previous tile is done with xrw and rowsum\n"
    b = "  int acc[RPW][MT];\n  const int n_first = nb0 + warp * RPW;\n"
    c = ("  rowdot::tile_accumulate<BITS, CODE, MT, CGX>(x32, mt, kw, w, N, pw,"
         "\n                                               jc_words, n_first, "
         "xs, acc);\n")
    d = ("        emit(m, n, warp * RPW + r,\n             __fadd_rn(base, "
         "__fmul_rn(ylr, f.Ls[n])));\n      }\n    }\n  }\n")
    for piece in (a, b, c, d):
        _need(src, piece, 1, "lowrank.cuh")
    src = src.replace(a, "  unsigned long long fs_t[4];\n  fs_t[0] = fs_now();\n"
                      + a)
    src = src.replace(b, "  fs_t[1] = fs_now();\n" + b)
    src = src.replace(c, c + "  fs_t[2] = fs_now();\n")
    src = src.replace(d, d + "  fs_t[3] = fs_now();\n  unsigned long long "
                      "fs_d[3] = {fs_t[1] - fs_t[0], fs_t[2] - fs_t[1], "
                      "fs_t[3] - fs_t[2]};\n  FS_FLUSH(CGX ? 3 : 0, 3, fs_d)\n")
    return '#include "fusion_timing.cuh"\n' + src


def breakdown_fused(src):
    """fused_proj.cuh with run_stage's parts timed (rows si * 7 + part)."""
    edits = [
        ("      if (PRE && s + 1 < hi) fetch(s + 1, nxt);\n",
         "      FS_TIME(fs_p[1], if (PRE && s + 1 < hi) fetch(s + 1, nxt))\n"),
        ('      asm volatile("cp.async.wait_group %0;\\n" ::"n"(kDepth - 1) '
         ': "memory");\n      __syncwarp();  // every lane\'s copies of slab '
         'nc have landed\n',
         '      FS_TIME(fs_p[0], asm volatile("cp.async.wait_group %0;\\n" '
         '::"n"(kDepth - 1) : "memory"); __syncwarp())\n'),
        ("        slab_codes<BITS, MT, PRE>(sl, xf, xm, d.K, d.P, c, rows, cg, "
         "acc);\n",
         "        FS_TIME(fs_p[2], slab_codes<BITS, MT, PRE>(sl, xf, xm, d.K, "
         "d.P, c, rows, cg, acc))\n"),
        ("        slab_l<MT>(sl, d, mt, c - d.nk, win, accl);\n",
         "        FS_TIME(fs_p[3], slab_l<MT>(sl, d, mt, c - d.nk, win, accl))"
         "\n"),
        ("      stream_issue(q, pl, rg, w, W);\n      if (PRE) xf = nxt;\n",
         "      FS_TIME(fs_p[4], stream_issue(q, pl, rg, w, W))\n"
         "      if (PRE) xf = nxt;\n"),
        ("    if (!(lo <= g0 && end == g0 + per) &&\n        !split_sum<MT>"
         "(acc, accl, pws, cnt, G, per, S, W, w))\n      continue;\n",
         "    bool fs_skip;\n    FS_TIME(fs_p[5], fs_skip = !(lo <= g0 && end"
         " == g0 + per) && !split_sum<MT>(acc, accl, pws, cnt, G, per, S, W, "
         "w))\n    if (fs_skip) continue;\n"),
        ("    epi(G, mt, G - mt * d.groups, acc, accl);\n  }\n}\n",
         "    FS_TIME(fs_p[6], epi(G, mt, G - mt * d.groups, acc, accl))\n  }\n"
         "  FS_FLUSH(si * 7, 7, fs_p)\n}\n"),
        ("  XFrag<BITS, NF> xf;\n",
         "  XFrag<BITS, NF> xf;\n  unsigned long long fs_p[7] = {0, 0, 0, 0, "
         "0, 0, 0};\n"),
    ]
    for old, new in edits:
        _need(src, old, 1, "fused_proj.cuh")
        src = src.replace(old, new)
    return '#include "fusion_timing.cuh"\n' + src


def build_stamped(_build, out_dir, names):
    """nvcc on the stamped copies of ``names`` beside copies of every header
    (``lowrank.cuh`` and, where the tree has it, ``fused_proj.cuh`` with
    their parts timed); returns {name: CDLL}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    # every header beside the copies, so that each include resolves there
    for hdr in _build.CSRC.glob("*.cuh"):
        shutil.copy(hdr, out_dir / hdr.name)
    (out_dir / "fusion_timing.cuh").write_text(TIMING)
    fused = _build.CSRC / "fused_proj.cuh"
    if fused.exists():
        (out_dir / "fused_proj.cuh").write_text(
            breakdown_fused(fused.read_text()))
    (out_dir / "lowrank.cuh").write_text(
        breakdown_lowrank((_build.CSRC / "lowrank.cuh").read_text()))
    kernels = {"w4a8_lowrank": "mlp_kernel", "attn_o": "attn_o_kernel"}
    procs, libs = {}, {}
    for name in names:
        src = (_build.CSRC / f"{name}.cu").read_text()
        src = '#include "fusion_timing.cuh"\n' + stamp_kernel(
            src, kernels[name]) + SETTER
        (out_dir / f"{name}.cu").write_text(src)
        libs[name] = out_dir / f"lib{name}_stamped.so"
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(out_dir),
             "-o", str(libs[name]),
             str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    loaded = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name} (stamped): nvcc failed\n{err[-4000:]}")
        lib = ctypes.CDLL(str(libs[name]))
        for fn, argtypes in _build.ENTRIES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.fusion_set_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.fusion_set_stamps.restype = ctypes.c_int
        loaded[name] = lib
    return loaded


def phases(st):
    """(span, work) ms of the three phases from the (6, STRIDE) stamps."""
    grid = int((st[0] > 0).sum())
    s = st[:, :grid].double()
    out = []
    for p, (b, w, e) in enumerate(((0, 1, 2), (2, 3, 4), (4, 5, 5))):
        begin = s[b].min()
        out.append((float(s[e].max() - begin) * 1e-6,
                    float(s[w].max() - begin) * 1e-6))
    return out, grid


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    K, AT = T.load_port(args.root)
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import _build
    names = ("w4a8_lowrank", "attn_o")
    tag = "parent" if "fused_proj.cuh" not in os.listdir(_build.CSRC) \
        else "tree"
    stamped = build_stamped(_build, _build.BUILD_DIR / f"stages_{tag}", names)
    _build.build(list(names) + ["grouped_matmul"])
    prod = {n: _build.library(n) for n in names}
    for n in names:
        for line in _build.build_log(n).splitlines():
            if ("mlp_kernel" in line or "attn_o_kernel" in line
                    or "registers" in line) and "Used" in line:
                print(f"{n}: {line.strip()}", flush=True)
    dev = torch.device("cuda")
    card = _card_line()
    fp = "fused_proj.cuh" in os.listdir(_build.CSRC)
    parts = FP_PARTS if fp else LR_PARTS
    stamps = torch.zeros((6, STRIDE), dtype=torch.int64, device=dev)
    brk = torch.zeros((2 * len(parts), WSTRIDE), dtype=torch.int64,
                      device=dev)
    cases, failed = [], []

    def measure(name, call, nbytes, lib_name):
        _build._libs[lib_name] = prod[lib_name]
        ref = call(1)
        ms = _time_ms(torch, call, 20)
        lib = stamped[lib_name]
        _build._libs[lib_name] = lib
        got = call(1)
        # the stamped copy's steady state: a CUDA graph of N launches,
        # replayed once; the stamps are its last launch's, the parts the
        # mean over its launches
        _build.check(lib.fusion_set_stamps(stamps.data_ptr(),
                                           brk.data_ptr()), "set_stamps")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call(0)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(N):
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
        ms_st = start.elapsed_time(end) / N
        st, b = stamps.cpu(), brk.cpu()
        _build.check(lib.fusion_set_stamps(None, None), "set_stamps")
        del graph
        _build._libs[lib_name] = prod[lib_name]
        same = bool(torch.equal(got, ref))
        if not same:
            failed.append(f"{name}: the stamped copy's output differs")
        ph, grid = phases(st)
        W = grid * 8
        us = b[:, :W].double() * 1e-3 / N
        print(f"\n{name}: launch {ms:.4f} ms ({ms_st:.4f} stamped), grid "
              f"{grid}, stamped output equal: {same}")
        rows = []
        for p, ((span, work), nb) in enumerate(zip(ph, nbytes)):
            bound = nb / HBM_BYTES_PER_S * 1e6
            rows.append(dict(span_us=1e3 * span, work_us=1e3 * work,
                             mb=nb / 1e6, bound_us=bound))
            print(f"  phase {p + 1}: span {1e3 * span:8.2f} us, work "
                  f"{1e3 * work:8.2f} us, {nb / 1e6:6.2f} MB, bound "
                  f"{bound:6.2f} us", flush=True)
        brk_rec = {}
        for ph_i in range(2):
            row = {p: (float(us[ph_i * len(parts) + i].mean()),
                       float(us[ph_i * len(parts) + i].max()))
                   for i, p in enumerate(parts)}
            if any(v[1] > 0 for v in row.values()):
                label = (("phase 1", "phase 3") if not fp
                         else ("stage 0", "stage 1"))[ph_i]
                brk_rec[label] = row
                print(f"  {label} per warp, mean / max us: " + ", ".join(
                    f"{p} {m:.2f} / {x:.2f}" for p, (m, x) in row.items()),
                    flush=True)
        cases.append(dict(name=name, ms=ms, ms_stamped=ms_st, grid=grid,
                          same=same, phases=rows, breakdown_us=brk_rec))

    gu, dn, gs, Lk, _ = T.mlp_weights(torch, dev, 4)
    M = 8
    gen = torch.Generator(device=dev)
    gen.manual_seed(108)
    x = torch.randn((M, T.H), generator=gen, device=dev)
    xr = K.thin_xr(x, gu["R"][1], gu["Rs"][1])
    xq, sx = K.quantize_activations_int8(x)
    h, im, r = T.H, T.IM, T.RANK
    measure("row 7, M 8, 4-bit", lambda i: K._launch_mlp(
        xq, sx, xr, gu["packed"], gu["scales"], i % Lk,
        *T.mlp_args(gu, dn, gs, xr, i % Lk, 4)[4:])[0],
        (2 * im * h // 2 + 2 * im * r, r * im, h * im // 2 + h * r),
        "w4a8_lowrank")
    del gu, dn
    torch.cuda.empty_cache()
    B = 8
    cache, ow, Lk, _ = T.attn_cache(torch, dev, B, 256)
    pos = torch.full((B,), 128, dtype=torch.int32, device=dev)
    qdim = T.KVH * T.D
    for staged in (True, False):
        live = 128 if staged else 129
        measure(f"row 15, B 8, T 256, pos 128, "
                f"{'staged' if staged else 'inline'}",
                lambda i: AT._launch_attn_o(*cache, i % Lk, pos, *ow, 4, r,
                                            staged, 256)[0],
                (B * T.KVH * live * (2 * T.D + 8) + r * qdim, 0,
                 h * qdim // 2 + h * r), "attn_o")
    print(json.dumps({"root": args.root, "card": card, "cases": cases}))
    for f in failed:
        print(f, file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
