"""Build the CUDA kernels in ``csrc/`` at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds): ``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
-shared -Xcompiler -fPIC``. All sources build in parallel, one ``nvcc`` per
source. The library file name carries a hash of the sources and flags, so a
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

# C entry points of each source: name -> argtypes (all return int).
ENTRIES = {
    "w4a8_stacked": {
        # xq, sx, packed, scales, out, M, N, K, bits, layer, stream
        "w4a8_stacked_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        # xq, sx, packed, scales, out, M, N, K, bits, stream
        "w4a8_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "grouped_matmul": {
        # x (bf16), packed, scales, out, M, N, K, bits, group, stream
        "grouped_matmul_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "int8_matmul": {
        # xq, sx, w8, scales, out, M, N, K, stream
        "int8_matmul_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    },
    "flash_decode": {
        # q, k, v, ks, vs, k_new, v_new, pos, out, B, KVH, G, D, T,
        # block_t, scale, i8, stream
        "flash_decode_staged_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _I, _I, _I, _I, _I, _I, _F, _I, _P],
        # q, k, v, ks, vs, pos, out, B, KVH, G, D, T, block_t, scale, i8,
        # stream
        "flash_decode_inline_launch": [_P, _P, _P, _P, _P, _P, _P,
                                       _I, _I, _I, _I, _I, _I, _F, _I, _P],
        # as staged, then staged (0/1) before the stream
        "flash_decode_ab_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
        # q, k, v, ks, vs, k_new, v_new, pos, page_tables, out, B, KVH, G,
        # D, max_pages, page_size, scale, i8, stream
        "flash_decode_paged_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _I, _I, _F, _I, _P],
    },
    "flash_prefill": {
        # q, k, v, out, B, S, H, KVH, D, scale, stream
        "flash_prefill_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    },
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


def build_all() -> Dict[str, float]:
    """Build every source whose library is missing, all ``nvcc`` processes
    started together; load them all. Returns the seconds each build took
    (0.0 for a library that was already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ENTRIES:
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
    for name, entries in ENTRIES.items():
        if name in _libs:
            continue
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in entries.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return dict(build_seconds)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _libs:
        build_all()
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
