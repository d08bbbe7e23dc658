"""Build the CUDA kernels in ``csrc/`` at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds): ``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
-shared -Xcompiler -fPIC``. All sources build in parallel, one ``nvcc`` per
source; :func:`library` builds only the source it is asked for. The library
file name carries a hash of the source, every header and the flags, so a
stale build is never loaded. Pointers and the stream go to the C entries as
``c_void_p``; every entry returns ``cudaGetLastError()`` after its launch and
:func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_MEGASTEP = {
    # sizeof(MegaArgs), checked against ops/megastep.py's mirror
    "megastep_args_size": [],
    # MegaArgs*, stream
    "megastep_launch": [_P, _P],
    # MegaArgs*, int* (the cooperative grid's CTAs)
    "megastep_grid": [_P, _P],
    # x8, packed, out (N, B) i32, partials, counters, N, K, B, bng, CTAs,
    # stream: one projection stage's i32 sums alone (card tests)
    "megastep_proj_launch": [_P] * 5 + [_I] * 5 + [_P],
}

# C entry points of each source: name -> argtypes (all return int).
ENTRIES = {
    "w4a8_stacked": {
        # xq, sx, packed, scales, out, M, N, K, bits, layer, stream
        "w4a8_stacked_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        # xq, sx, packed, scales, out, split counters and sums, M, N, K,
        # bits, layer, CTAs, warps a CTA, stream: the persistent launch at
        # M <= 8 (w4a8_stream.cuh)
        "w4a8_stacked_persistent_launch": [_P] * 6 + [_I] * 7 + [_P],
        # xq, sx, packed, scales, out, M, N, K, bits, stream
        "w4a8_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        # xq, sx, packed, scales, out, M, N, K, bits, layer, rows (64 or
        # 128), persistent CTAs, stream: the int8 wgmma tile path
        "w4a8_tile_launch": [_P] * 5 + [_I] * 7 + [_P],
    },
    "grouped_matmul": {
        # x (bf16), packed, scales, out, split-K workspace, split-K counters,
        # M, N, K, bits, group, path, cols, split_steps, splits, stream
        "grouped_matmul_launch": [_P] * 6 + [_I] * 9 + [_P],
        # stream, unsigned long long* (the capture id, 0 when none)
        "grouped_capture_id": [_P, _P],
    },
    "bf16_gemm": {
        # x (bf16), W (bf16, layer-stacked), out, split-K workspace, M, N, K,
        # layer, path, cols, split_steps, splits, stream
        "bf16_stacked_launch": [_P, _P, _P, _P] + [_I] * 8 + [_P],
    },
    "int8_matmul": {
        # xq, sx, w8, scales, out, M, N, K, rows, cols, persistent CTAs,
        # stream
        "int8_tile_launch": [_P] * 5 + [_I] * 6 + [_P],
    },
    "flash_decode": {
        # q, k, v, ks, vs, k_new, v_new, pos, out, B, KVH, G, D, T,
        # block_t, scale, dots (0 f32, 1 bf16, 2 i8), the plan's cluster,
        # nbw, maxb, smem, stream
        "flash_decode_staged_launch": [_P] * 9 + [_I] * 6 + [_F] + [_I] * 5
                                      + [_P],
        # q, k, v, ks, vs, pos, out, then as the staged entry
        "flash_decode_inline_launch": [_P] * 7 + [_I] * 6 + [_F] + [_I] * 5
                                      + [_P],
    },
    "flash_decode_split": {
        # q, k, v, ks, vs, k_new, v_new, pos, page_tables, out, scratch
        # logits, smax, state, contrib, counters, B, KVH, G, D, T, block_t,
        # max_pages, seg, spb, nseg, asegs, nbw, grid, scale, dots, staged,
        # stream
        "flash_decode_split_launch": [_P] * 15 + [_I] * 13 + [_F, _I, _I,
                                                              _P],
    },
    "flash_prefill": {
        # q, k, v, out, B, S, H, KVH, D, scale, stream
        "flash_prefill_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    },
    "w4a8_lowrank": {
        # xq, sx, packed, scales, xr, L_cat, L_scale, out, M, N, K, bits,
        # layer, rank, n_proj, b1, b2, b3, stream
        "w4a8_l_stacked_launch": [_P] * 8 + [_I] * 10 + [_P],
        # the same arguments (xr and the layer's L as padded bf16), then
        # rows (64 or 128), persistent CTAs: the int8 wgmma tile path with
        # the L epilogue
        "w4a8_l_tile_launch": [_P] * 8 + [_I] * 12 + [_P],
        # x, xq, sx, packed, scales, R, R_scale, L_cat, L_scale, xr scratch,
        # out, M, N, K, bits, layer, rank, n_proj, b1, b2, b3, stream
        "w4a8_lr_stacked_launch": [_P] * 11 + [_I] * 10 + [_P],
        # x (bf16), a layer's R (int8) and R_scale, xr (f32 out), xr (bf16
        # out, the L tile kernel's layout), split-K workspace, split-K
        # counters, M, nR, K, rank, cols, split_steps, splits, stream: the
        # tensor-core xr of the LR-fused tile path
        "w4a8_lr_xr_launch": [_P] * 7 + [_I] * 7 + [_P],
        # xq, sx, xr_gu, gu packed, scales, L, L scales, global scales, dn
        # packed, scales, R, R scales, L, L scales, scratch m, m8, amax,
        # xpart, xrd, split partials, split counters, out, M, h, im, bits,
        # layer, rank, CTAs (0: the cooperative grid), stream
        "w4a8_mlp_stacked_launch": [_P] * 22 + [_I] * 7 + [_P],
        # M, bits, int* (the cooperative grid's CTAs)
        "w4a8_mlp_grid": [_I, _I, _P],
    },
    "attn_o": {
        # q, k, v, ks, vs, k_new, v_new, pos, o packed, scales, R, R scales,
        # L, L scales, scratch attn, amax, xpart, xq8, xro, split partials,
        # split counters, out, B, KVH, D, T, block_t, scale, staged, h, bits,
        # layer, rank, CTAs (0: the cooperative grid), stream
        "attn_o_launch": [_P] * 22 + [_I] * 5 + [_F] + [_I] * 6 + [_P],
        # B, bits, staged, int* (the cooperative grid's CTAs)
        "attn_o_grid": [_I, _I, _I, _P],
    },
    # the whole-step megakernel (megastep.cuh), one library per bit width
    "megastep": _MEGASTEP,
    "megastep_2bit": _MEGASTEP,
}

_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset and no "
                           "nvcc on PATH); cannot build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names) -> Dict[str, float]:
    """Build each source of ``names`` whose library is missing, all ``nvcc``
    processes started together, and load them. Returns the seconds each
    build took (0.0 for a library that was already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if name in _libs:
            continue
        out = _lib_path(name)
        if out.exists():
            build_seconds.setdefault(name, 0.0)
            continue
        tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out, time.perf_counter())
    errors = []
    for name, (proc, tmp, out, t0) in procs.items():
        stdout, stderr = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(stdout + stderr)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{stderr}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    for name in names:
        if name in _libs:
            continue
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in ENTRIES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return {name: build_seconds[name] for name in names}


def build_all() -> Dict[str, float]:
    """:func:`build` of every source in ``ENTRIES``."""
    return build(list(ENTRIES))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built (alone) on first
    use."""
    if name not in _libs:
        build([name])
    return _libs[name]


def build_log(name: str) -> str:
    """nvcc's output (with ``-Xptxas -v``: registers, shared memory and
    spills per kernel) of the last build of ``name``, or '' if none."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a pointer."""
    return torch.cuda.current_stream(device).cuda_stream
