#!/usr/bin/env python3
"""Per-stage device times of the whole-step megakernel
(``ops/megastep.py::megastep``, ``csrc/megastep.cuh``) on one card.

    python3 scripts/torch_megastep_stages.py [--root TREE] [--layers L]

imports the port package from ``TREE`` (default: this checkout) and builds a
copy of its ``megastep.cuh``, edited by text, beside copies of
``megastep.cu`` and ``megastep_2bit.cu`` (the other headers from the tree's
``csrc``; the script checks that every edited passage is still there and
stops if one is not). In the copy, thread 0 of each CTA writes
``%globaltimer`` at the kernel's start and around each of the eleven grid
barriers of a layer: once the CTA's work of the stage is done (after a
``__syncthreads``) and once it leaves the barrier. The tree's own source
gets no flag and no stamp.

The launch runs through the tree's own ``_launch`` at Llama-2-7B width, 32
layers, rank 128, T 256, every row at position 128 (phase 10's operands:
``bench_params.py`` weights, seed 0, factor path "l", the interleaved
gate/up set; a seeded random int8 cache): 4-bit at B 8, 1 and 32, and
2-bit at B 8. For each stage it prints the median over layers of (latest
barrier exit - earliest start across CTAs; a stage starts where the CTA
left the previous barrier), the same up to the latest end of work (the rest
is the barrier), and the stage's byte bound (its weight, factor and live
K/V bytes over 3.35 TB/s). Beside them: the launch alone as the tree builds
it, and the stamped copy's launch (both median device times of launches
captured in a CUDA graph), and the copy's outputs against the tree's (the
stamps change no value). Last line: one JSON object ``{"root", "card",
"cases"}``.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import HBM_BYTES_PER_S, _card_line, _time_ms  # noqa: E402

STAGES = ("PRE", "XRQ", "QKV", "ATTN", "FIN+XRO", "O", "MLP", "XRG", "GU",
          "DQ+XRD", "DOWN")
BARRIER = "lowrank::grid_sync();"
LAYER_LOOP = "  for (int l = 0; l < a.L; ++l) {\n"
NAMESPACE = "namespace megastep {\n"
STAMP_DEFS = r"""
// per-stage stamps (a timing copy only): (2, L, 11, grid) then (grid)
__device__ unsigned long long* g_stamp = nullptr;

__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define MS_STAMP_AT(i)                                                      \
  if (threadIdx.x == 0 && megastep::g_stamp != nullptr)                     \
    megastep::g_stamp[(size_t)(i) * gridDim.x + blockIdx.x] =               \
        megastep::gtimer();
#define MS_STAMP(w, s)                                                      \
  {                                                                         \
    if ((w) == 0) __syncthreads();                                          \
    MS_STAMP_AT(((size_t)(w) * a.L + l) * 11 + (s))                         \
  }
"""
EPILOGUE = ("    store_totals<MT>(acc, tot);\n"
            "    epilogue<MT>(e, d, g, B, tot);\n")
YLR = "  if (e.mode != kEpiSums) ylr_phase<MT>(e, d, B, pl.rank, scr, wcta);\n"
TAIL = ("  }\n  // the L rows of this warp's share of the next projection "
        "stage, into L2\n")
DEPTH = "constexpr int kDepth = 3;"
PRODUCTS = """      slab_mma<BITS, MT>(rg.buf + slot * kSlabBytes, x32, K / 4, d.P, s - g0,
                         B, acc);
"""
WAIT = ("      asm volatile(\"cp.async.wait_group %0;\\n\" ::\"n\"(kDepth - 1) : "
        "\"memory\");\n      __syncwarp();  // every lane's copies of slab nc "
        "have landed\n")
ISSUE = "      stream_issue(q, pl, rg, w, W);\n"
SPLIT = """    if (!(lo <= g0 && end == g0 + d.nk) &&
        !split_sum<MT>(acc, pws, cnt, g, d.nk, S, W, w))
      continue;
"""
X32 = "  const int* x32 = reinterpret_cast<const int*>(x8);\n"
PROJ_NS = "namespace mproj {\n"
PARTS = ("wait", "products", "issue", "split", "epilogue", "ylr")
BRK_DEFS = r"""
// per-warp time in the parts of a projection stage (a timing copy only):
// (4 stages, 6 parts, warps) ns summed over layers
__device__ unsigned long long* g_brk = nullptr;
__device__ __forceinline__ unsigned long long mp_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define MP_TIME(i, ...)                                                     \
  {                                                                         \
    const unsigned long long t_ = mp_now();                                 \
    __VA_ARGS__;                                                            \
    mp_t[i] += mp_now() - t_;                                               \
  }
"""
BRK_ENTRY = r"""
extern "C" int megastep_set_breakdown(void* p) {
  return (int)cudaMemcpyToSymbol(mproj::g_brk, &p, sizeof(p));
}
"""
SET_ENTRY = r"""
extern "C" int megastep_set_stamps(void* p) {
  return (int)cudaMemcpyToSymbol(megastep_stamped::g_stamp, &p, sizeof(p));
}
"""


def stage_bytes(cfg, bits, rank, B, live):
    """Bytes each stage must read from device memory (weights, factors,
    scales; the live int8 K/V and its scales for ATTN), one layer."""
    h, im, qdim = cfg.hidden_size, cfg.intermediate_size, cfg.q_dim
    f = 8 // bits

    def proj(N, K):   # packed codes, L codes, the row and L scales
        return N * K // f + N * rank + 8 * N
    return {"PRE": 0, "XRQ": 3 * rank * (h + 4), "QKV": proj(3 * qdim, h),
            "ATTN": B * cfg.num_kv_heads * live * (2 * cfg.head_dim + 8),
            "FIN+XRO": rank * (qdim + 4), "O": proj(h, qdim), "MLP": 0,
            "XRG": 2 * rank * (h + 4), "GU": proj(2 * im, h),
            "DQ+XRD": rank * (im + 4), "DOWN": proj(h, im)}


def load_port(root):
    sys.path.insert(0, os.path.abspath(root))
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
        _build, megastep as MS)
    return _build, MS


def mega_params(torch, dev, bits, layers):
    """Phase 10's params at Llama-2-7B width (``layers`` layers): synthetic
    weights (seed 0), factor path "l", the interleaved gate/up set."""
    import dataclasses
    from ee274_convexcaldera_llm_quantization_tpu_torch import bench_params
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        fused, persistent)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
        LLAMA2_7B)
    cfg = dataclasses.replace(LLAMA2_7B, num_layers=layers)
    params = fused.quantize_factors_int8_fused(fused.fuse_stacked(
        bench_params.build_compressed_llama_params(
            cfg, num_bits=bits, rank=128, seed=0, device=dev)),
        fuse_factor_kernel="l")
    prep = persistent.prepare_gateup_interleaved(params.layers.gateup,
                                                 cfg.intermediate_size)
    torch.cuda.synchronize()
    return cfg, params, prep


def mega_case(torch, dev, cfg, params, prep, B, T=256, pos=128, seed=7):
    """One step's operands: seeded tokens and int8 cache (T tokens), every
    row at ``pos``. Returns (args, kw, tokens, pos, cache)."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        llama, persistent)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + B)
    shape = (cfg.num_layers, B, cfg.num_kv_heads, T, cfg.head_dim)
    cache = llama.HeadMajorQuantKVCache(
        *(torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8,
                        device=dev) for _ in range(2)),
        *(torch.rand(shape[:4], generator=gen, device=dev) * 0.02 + 1e-3
          for _ in range(2)))
    tokens = torch.randint(0, cfg.vocab_size, (B,), generator=gen,
                           device=dev)
    p = torch.full((B,), pos, dtype=torch.int32, device=dev)
    args, kw = persistent.megastep_operands(params, tokens, p, cache, cfg,
                                            prep)
    return args, kw, tokens, p, cache


def _edit(src):
    """The stamped copy of megastep.cuh's text."""
    for piece, n in ((BARRIER, 11), (LAYER_LOOP, 1), (NAMESPACE, 1)):
        if src.count(piece) != n:
            raise SystemExit(f"megastep.cuh changed: {piece.strip()!r} found "
                             f"{src.count(piece)} times, expected {n}")
    parts = src.split(BARRIER)
    out = parts[0]
    for s, rest in enumerate(parts[1:]):
        out += f"MS_STAMP(0, {s}) {BARRIER} MS_STAMP(1, {s})" + rest
    out = out.replace(LAYER_LOOP, "  MS_STAMP_AT((size_t)2 * a.L * 11)\n"
                      + LAYER_LOOP)
    out = out.replace(NAMESPACE, NAMESPACE + STAMP_DEFS)
    # a namespace of its own: the copy's template instances (and their
    # function-local statics) must not merge with the tree's library loaded
    # in the same process
    out = out.replace(NAMESPACE, "namespace megastep_stamped {\n")
    return (out + SET_ENTRY).replace("megastep::", "megastep_stamped::")


def _ablations(src):
    """Copies of megastep_proj.cuh: without the epilogue of a group (its
    totals, split sums stay), or without the products of a slab (the stream
    and the waits stay), both timings only (wrong results); and with rings
    of 2 slabs a warp (right results)."""
    for piece in (EPILOGUE, PRODUCTS, DEPTH):
        if src.count(piece) != 1:
            raise SystemExit(f"megastep_proj.cuh changed: {piece.strip()[:40]!r}"
                             f" found {src.count(piece)} times, expected 1")
    return {"no_epilogue": src.replace(EPILOGUE, ""),
            "no_products": src.replace(PRODUCTS, "      (void)x32;\n"),
            "depth2": src.replace(DEPTH, DEPTH.replace("3", "2"))}


def _breakdown(src):
    """A copy of megastep_proj.cuh that adds each warp's time in the parts
    of each projection stage (PARTS) to g_brk."""
    for piece in (WAIT, PRODUCTS, ISSUE, SPLIT, X32, PROJ_NS, EPILOGUE, YLR,
                  TAIL):
        if src.count(piece) != 1:
            raise SystemExit(f"megastep_proj.cuh changed: {piece.strip()[:40]!r}"
                             f" found {src.count(piece)} times, expected 1")
    flush = ("  if ((threadIdx.x & 31) == 0 && g_brk != nullptr)\n"
             "    for (int i = 0; i < 6; ++i)\n"
             "      atomicAdd(g_brk + ((size_t)si * 6 + i) * W + w, mp_t[i]);\n")
    out = src.replace(EPILOGUE, EPILOGUE.replace(
        "epilogue<MT>(e, d, g, B, tot);", "MP_TIME(4, epilogue<MT>(e, d, g, B, "
        "tot))"))
    out = out.replace(TAIL, TAIL.split("\n")[0] + "\n" + flush
                      + TAIL.split("\n", 1)[1])
    out = out.replace(YLR, "  MP_TIME(5, " + YLR.strip()[:-1] + ")\n")
    out = out.replace(WAIT, "      MP_TIME(0, " + WAIT.split("\n")[0].strip()
                      + " __syncwarp())\n")
    out = out.replace(PRODUCTS, "      MP_TIME(1, " + PRODUCTS.strip()[:-1]
                      + ")\n")
    out = out.replace(ISSUE, "      MP_TIME(2, " + ISSUE.strip()[:-1] + ")\n")
    out = out.replace(SPLIT, "    bool skip_;\n    MP_TIME(3, skip_ = !(lo <= g0 && "
                      "end == g0 + d.nk) && !split_sum<MT>(acc, pws, cnt, g, "
                      "d.nk, S, W, w))\n    if (skip_) continue;\n")
    out = out.replace(X32, X32 + "  unsigned long long mp_t[6] = {0, 0, 0, 0, "
                      "0, 0};\n")
    return out.replace(PROJ_NS, PROJ_NS + BRK_DEFS)


def build_stamped(_build, out_dir, names=("megastep", "megastep_2bit"),
                  proj=None):
    """Start nvcc on the stamped copies of the libraries ``names`` (with
    ``proj`` as their megastep_proj.cuh when given); returns a function that
    waits for them and returns {name: CDLL}."""
    import ctypes
    text = _edit((_build.CSRC / "megastep.cuh").read_text())
    if proj is not None and "g_brk" in proj:
        text += BRK_ENTRY
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "megastep.cuh").write_text(text)
    if proj is not None:
        (out_dir / "megastep_proj.cuh").write_text(proj)
    procs, libs = {}, {}
    for name in names:
        shutil.copy(_build.CSRC / f"{name}.cu", out_dir / f"{name}.cu")
        libs[name] = out_dir / f"lib{name}_stamped.so"
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(libs[name]), str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def wait():
        loaded = {}
        for name, proc in procs.items():
            _, err = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"{name} (stamped): nvcc failed\n{err}")
            lib = ctypes.CDLL(str(libs[name]))
            for fn, argtypes in _build.ENTRIES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.megastep_set_stamps.argtypes = [ctypes.c_void_p]
            lib.megastep_set_stamps.restype = ctypes.c_int
            if proj is not None and "g_brk" in proj:
                lib.megastep_set_breakdown.argtypes = [ctypes.c_void_p]
                lib.megastep_set_breakdown.restype = ctypes.c_int
            loaded[name] = lib
        return loaded
    return wait


def per_stage(torch, stamps, L, grid):
    """{stage: (median span ms, median work ms)} and the median layer ms
    from the (2 L 11 + 1) x grid stamps (ns)."""
    st = stamps.double().view(2 * L * 11 + 1, grid)
    before = st[:L * 11].view(L, 11, grid)
    after = st[L * 11:2 * L * 11].view(L, 11, grid)
    start0 = st[2 * L * 11]
    out, layer = {}, []
    for s, name in enumerate(STAGES):
        span, work = [], []
        for l in range(L):
            if s == 0:
                begin = (start0 if l == 0 else after[l - 1, 10]).min()
            else:
                begin = after[l, s - 1].min()
            span.append(float(after[l, s].max() - begin) * 1e-6)
            work.append(float(before[l, s].max() - begin) * 1e-6)
        out[name] = (statistics.median(span), statistics.median(work))
    for l in range(L):
        begin = (start0 if l == 0 else after[l - 1, 10]).min()
        layer.append(float(after[l, 10].max() - begin) * 1e-6)
    return out, statistics.median(layer)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--ablate", action="store_true",
                    help="also time copies of the 4-bit build without the "
                         "projection epilogue or products (B 8)")
    ap.add_argument("--breakdown", action="store_true",
                    help="also time, at 4-bit B 8, a copy that sums each "
                         "warp's time in the parts of the projection stages")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    _build, MS = load_port(args.root)
    # every edited text first (each checks its passages), then the builds
    copies = {}
    if args.ablate or args.breakdown:
        proj_src = (_build.CSRC / "megastep_proj.cuh").read_text()
        if args.breakdown:
            copies["breakdown"] = _breakdown(proj_src)
        if args.ablate:
            copies.update(_ablations(proj_src))
    _edit((_build.CSRC / "megastep.cuh").read_text())
    wait = build_stamped(_build, _build.BUILD_DIR / "megastep_stamped")
    waits = {v: build_stamped(_build, _build.BUILD_DIR / f"megastep_{v}",
                              ("megastep",), text)
             for v, text in copies.items()}
    _build.build(["megastep", "megastep_2bit"])
    prod = {n: _build.library(n) for n in ("megastep", "megastep_2bit")}
    stamped = wait()
    ablated = {v: w()["megastep"] for v, w in waits.items()}
    for n in prod:
        for line in _build.build_log(n).splitlines():
            if "megastep_kernel" in line or "registers" in line \
                    or "spill" in line:
                print(f"{n}: {line.strip()}", flush=True)
    dev = torch.device("cuda")
    card = _card_line()
    cases, failed = [], []
    for bits, Bs in ((4, (8, 1, 32)), (2, (8,))):
        cfg, params, prep = mega_params(torch, dev, bits, args.layers)
        name = "megastep" if bits == 4 else "megastep_2bit"
        for B in Bs:
            margs, kw, *_ = mega_case(torch, dev, cfg, params, prep, B)
            a = MS._named(margs, **kw)
            grid = MS._launch(a, grid_only=True)
            L = cfg.num_layers
            _build._libs[name] = prod[name]
            ref, _ = MS._launch(a)
            ms = _time_ms(torch, lambda i: MS._launch(a), 3)
            _build._libs[name] = stamped[name]
            buf = torch.zeros(((2 * L * 11 + 1) * grid,), dtype=torch.int64,
                              device=dev)
            _build.check(stamped[name].megastep_set_stamps(buf.data_ptr()),
                         "megastep_set_stamps")
            got, _ = MS._launch(a)
            torch.cuda.synchronize()
            stamps = buf.cpu()
            _build.check(stamped[name].megastep_set_stamps(None),
                         "megastep_set_stamps")
            ms_stamped = _time_ms(torch, lambda i: MS._launch(a), 3)
            _build._libs[name] = prod[name]
            same = all(torch.equal(g, r) for g, r in zip(got, ref))
            if not same:
                failed.append(f"{bits}-bit B {B}: the stamped copy's outputs "
                              f"differ from the tree's")
            stages, layer_ms = per_stage(torch, stamps, L, grid)
            nbytes = stage_bytes(cfg, bits, kw["rank"], B, 128)
            print(f"\n{bits}-bit, B {B}, {L} layers, grid {grid} CTAs: launch "
                  f"{ms:.3f} ms ({ms_stamped:.3f} stamped), median layer "
                  f"{1e3 * layer_ms:.1f} us, stamped outputs equal: {same}")
            print(f"{'stage':8s} {'span us':>9s} {'work us':>9s} "
                  f"{'MB':>7s} {'bound us':>9s}")
            rows = {}
            for s in STAGES:
                span, work = stages[s]
                bound = nbytes[s] / HBM_BYTES_PER_S * 1e6
                rows[s] = dict(span_us=1e3 * span, work_us=1e3 * work,
                               mb=nbytes[s] / 1e6, bound_us=bound)
                print(f"{s:8s} {1e3 * span:9.2f} {1e3 * work:9.2f} "
                      f"{nbytes[s] / 1e6:7.2f} {bound:9.2f}", flush=True)
            cases.append(dict(bits=bits, B=B, layers=L, grid=grid, ms=ms,
                              ms_stamped=ms_stamped, layer_us=1e3 * layer_ms,
                              same=same, stages=rows))
            for v, lib in ablated.items() if (bits, B) == (4, 8) else ():
                _build._libs[name] = lib
                buf.zero_()
                _build.check(lib.megastep_set_stamps(buf.data_ptr()),
                             "megastep_set_stamps")
                MS._launch(a)
                torch.cuda.synchronize()
                vst, vlayer = per_stage(torch, buf.cpu(), L, grid)
                _build.check(lib.megastep_set_stamps(None),
                             "megastep_set_stamps")
                vms = _time_ms(torch, lambda i: MS._launch(a), 3)
                if v == "breakdown":
                    W = grid * 8
                    brk = torch.zeros((4, len(PARTS), W), dtype=torch.int64,
                                      device=dev)
                    _build.check(lib.megastep_set_breakdown(brk.data_ptr()),
                                 "megastep_set_breakdown")
                    MS._launch(a)
                    torch.cuda.synchronize()
                    _build.check(lib.megastep_set_breakdown(None),
                                 "megastep_set_breakdown")
                    us = brk.double().cpu() * 1e-3 / L
                    cases[-1]["breakdown_us"] = {}
                    for si, st in enumerate(("QKV", "O", "GU", "DOWN")):
                        row = {p: (float(us[si, i].mean()),
                                   float(us[si, i].max()))
                               for i, p in enumerate(PARTS)}
                        cases[-1]["breakdown_us"][st] = row
                        print(f"  {st} per warp and layer, mean / max us: "
                              + ", ".join(f"{p} {m:.2f} / {x:.2f}"
                                          for p, (m, x) in row.items()),
                              flush=True)
                _build._libs[name] = prod[name]
                print(f"{v}: launch {vms:.3f} ms, layer {1e3 * vlayer:.1f} "
                      f"us; " + ", ".join(f"{s} {1e3 * vst[s][0]:.2f}"
                                          for s in STAGES), flush=True)
                cases[-1][v] = dict(ms=vms, layer_us=1e3 * vlayer,
                                    span_us={s: 1e3 * vst[s][0]
                                             for s in STAGES})
        del params, prep
        torch.cuda.empty_cache()
    print(json.dumps({"root": args.root, "card": card, "cases": cases}))
    for f in failed:
        print(f, file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
