"""ctypes bindings for the native serving runtime
(``runtime/ccq_runtime.cpp``).

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.serve.runtime``:
the C++ side owns page tables and admission control; Python owns the device
tensors and the steps.

The port compiles its own copy of the library from the same source, at first
use, with ``g++ -O2 -shared -fPIC -std=c++17`` into
``build/runtime/libccq_runtime-<hash of source and flags>.so`` (a stale
build is never loaded; the tracked prebuilt ``runtime/libccq_runtime.so`` is
neither read nor written). Each build writes a file of its own and renames
it into place, so processes building at once do not collide. ctypes loads it
with ``RTLD_LOCAL``, so it and another copy of the runtime can live in one
process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SRC = _ROOT / "runtime" / "ccq_runtime.cpp"
BUILD_DIR = _ROOT / "build" / "runtime"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_I32 = ctypes.c_int32
_P = ctypes.c_void_p
_PI32 = ctypes.POINTER(_I32)
_PI64 = ctypes.POINTER(ctypes.c_int64)
_SIGS = {
    "ccq_alloc_create": ([_I32, _I32], _P),
    "ccq_alloc_destroy": ([_P], None),
    "ccq_alloc_free_pages": ([_P], _I32),
    "ccq_seq_create": ([_P, _I32, _I32], _I32),
    "ccq_seq_create_cached": ([_P, _I32, _PI32, _I32], _I32),
    "ccq_alloc_cache_stats": ([_P, _PI64, _PI64], None),
    "ccq_seq_append": ([_P, _I32], _I32),
    "ccq_seq_length": ([_P, _I32], _I32),
    "ccq_seq_page_table": ([_P, _I32, _PI32, _I32], _I32),
    "ccq_seq_free": ([_P, _I32], _I32),
    "ccq_sched_create": ([_I32], _P),
    "ccq_sched_destroy": ([_P], None),
    "ccq_sched_submit": ([_P, _I32, _I32, _I32], None),
    "ccq_sched_submit_pri": ([_P, _I32, _I32, _I32, _I32, _I32], None),
    "ccq_sched_queue_len": ([_P], _I32),
    "ccq_sched_active_count": ([_P], _I32),
    "ccq_sched_admit": ([_P, _P, _PI32, _PI32, _I32], _I32),
    "ccq_sched_admit_nocreate": ([_P, _P, _PI32, _PI32, _I32], _I32),
    "ccq_sched_record_token": ([_P, _P, _I32, _I32], _I32),
    "ccq_sched_finish": ([_P, _P, _I32], _I32),
}


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libccq_runtime-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: cannot build the native serving "
                           f"runtime from {SRC}")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    proc = subprocess.run([gxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SRC} (exit {proc.returncode}):"
                           f"\n{proc.stderr}")
    os.replace(tmp, out)


def load_library() -> ctypes.CDLL:
    """The runtime library, built on first use (see the module docstring)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        for name, (argtypes, restype) in _SIGS.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
        return lib


def _i32_ptr(a: np.ndarray):
    return a.ctypes.data_as(_PI32)


class PageAllocator:
    """Python handle over the native page allocator."""

    def __init__(self, num_pages: int, page_size: int):
        self._lib = load_library()
        self._ptr = self._lib.ccq_alloc_create(num_pages, page_size)
        self.num_pages = num_pages
        self.page_size = page_size

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.ccq_alloc_destroy(self._ptr)
            self._ptr = None

    @property
    def free_pages(self) -> int:
        return self._lib.ccq_alloc_free_pages(self._ptr)

    def create_seq(self, seq_id: int, prompt_len: int) -> bool:
        return self._lib.ccq_seq_create(self._ptr, seq_id, prompt_len) == 0

    def create_seq_cached(self, seq_id: int, tokens: np.ndarray) -> int:
        """Create a sequence with prefix-cache reuse.

        Page-aligned prompt prefixes seen before share their KV pages
        (refcounted, never rewritten). Returns the number of prompt tokens
        whose KV is already in the pool: the caller prefills only the
        remainder. Raises on OOM / duplicate id.
        """
        toks = np.ascontiguousarray(tokens, np.int32)
        r = self._lib.ccq_seq_create_cached(self._ptr, seq_id, _i32_ptr(toks),
                                            len(toks))
        if r == -1:
            raise MemoryError("KV page pool exhausted")
        if r == -2:
            raise KeyError(f"duplicate sequence {seq_id}")
        return r

    @property
    def cache_stats(self) -> Tuple[int, int]:
        """(tokens served from prefix cache, tokens eligible)."""
        hits = ctypes.c_int64()
        lookups = ctypes.c_int64()
        self._lib.ccq_alloc_cache_stats(self._ptr, ctypes.byref(hits),
                                        ctypes.byref(lookups))
        return hits.value, lookups.value

    def append(self, seq_id: int) -> int:
        """Append a token; returns the page index (raises on OOM)."""
        page = self._lib.ccq_seq_append(self._ptr, seq_id)
        if page == -1:
            raise MemoryError("KV page pool exhausted")
        if page == -2:
            raise KeyError(f"unknown sequence {seq_id}")
        return page

    def length(self, seq_id: int) -> int:
        return self._lib.ccq_seq_length(self._ptr, seq_id)

    def page_table(self, seq_id: int, max_pages: Optional[int] = None
                   ) -> np.ndarray:
        cap = max_pages or self.num_pages
        buf = np.zeros(cap, np.int32)
        n = self._lib.ccq_seq_page_table(self._ptr, seq_id, _i32_ptr(buf),
                                         cap)
        if n == -2:
            raise KeyError(f"unknown sequence {seq_id}")
        return buf[:n]

    def free_seq(self, seq_id: int) -> None:
        self._lib.ccq_seq_free(self._ptr, seq_id)


class NativeScheduler:
    """Python handle over the native continuous-batching scheduler."""

    def __init__(self, max_slots: int, allocator: PageAllocator):
        self._lib = load_library()
        self._ptr = self._lib.ccq_sched_create(max_slots)
        self.allocator = allocator
        self.max_slots = max_slots

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.ccq_sched_destroy(self._ptr)
            self._ptr = None

    def submit(self, uid: int, prompt_len: int, max_new_tokens: int,
               priority: int = 0, tenant: int = 0) -> None:
        """Queue a request. Admission order: priority desc, then tenants
        with fewer generated tokens (fair share), then FIFO age."""
        if priority or tenant:
            self._lib.ccq_sched_submit_pri(self._ptr, uid, prompt_len,
                                           max_new_tokens, priority, tenant)
        else:
            self._lib.ccq_sched_submit(self._ptr, uid, prompt_len,
                                       max_new_tokens)

    @property
    def queue_len(self) -> int:
        return self._lib.ccq_sched_queue_len(self._ptr)

    @property
    def active_count(self) -> int:
        return self._lib.ccq_sched_active_count(self._ptr)

    def admit(self, create_seqs: bool = True) -> List[Tuple[int, int]]:
        """Admit as many queued requests as slots/pages allow.
        Returns [(uid, slot), ...]. With ``create_seqs=False`` the caller
        must create each allocator sequence itself (e.g. with
        ``PageAllocator.create_seq_cached`` for prefix reuse)."""
        uids = np.zeros(self.max_slots, np.int32)
        slots = np.zeros(self.max_slots, np.int32)
        fn = (self._lib.ccq_sched_admit if create_seqs
              else self._lib.ccq_sched_admit_nocreate)
        n = fn(self._ptr, self.allocator._ptr, _i32_ptr(uids),
               _i32_ptr(slots), self.max_slots)
        return list(zip(uids[:n].tolist(), slots[:n].tolist()))

    def record_token(self, uid: int, is_eos: bool = False) -> bool:
        """Record one generated token (appending its KV position, which may
        take a new page). Returns True if the sequence just finished."""
        r = self._lib.ccq_sched_record_token(self._ptr, self.allocator._ptr,
                                             uid, int(is_eos))
        if r == -1:
            raise MemoryError("KV page pool exhausted")
        if r == -2:
            raise KeyError(f"unknown uid {uid}")
        return r == 1

    def finish(self, uid: int) -> int:
        """Free the sequence; returns the released slot."""
        slot = self._lib.ccq_sched_finish(self._ptr, self.allocator._ptr, uid)
        if slot == -2:
            raise KeyError(f"unknown uid {uid}")
        return slot
