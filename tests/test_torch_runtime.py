"""PyTorch port, ``serve/runtime.py``: the ctypes bindings of the native page
allocator and scheduler (``runtime/ccq_runtime.cpp``) against the
reference's bindings, and how the port builds its own copy of the library.

The port compiles the same source into ``build/runtime/``; the reference
loads ``runtime/libccq_runtime.so``. Both live in this process at once, and
each scripted call sequence below runs on both, which must give the same
page tables, admissions, counts and errors."""

import hashlib
import threading

import numpy as np
import pytest

from ee274_convexcaldera_llm_quantization_tpu.serve import runtime as JR
from ee274_convexcaldera_llm_quantization_tpu_torch.serve import runtime as TR


def _obs(fn, *args, **kw):
    """The call's result as plain data, or the name of what it raised."""
    try:
        out = fn(*args, **kw)
    except (MemoryError, KeyError) as e:
        return ("raises", type(e).__name__)
    if isinstance(out, np.ndarray):
        return out.tolist()
    return out


def _allocator_script(rt):
    a = rt.PageAllocator(num_pages=10, page_size=4)
    trace = [a.free_pages, _obs(a.create_seq, 1, 9), a.free_pages,
             a.length(1), _obs(a.page_table, 1)]
    trace += [_obs(a.create_seq, 2, 8), _obs(a.create_seq, 3, 1)]
    for _ in range(5):                      # across a page boundary
        trace += [_obs(a.append, 2), a.free_pages]
    trace += [_obs(a.page_table, 2), _obs(a.page_table, 2, 2)]
    a.free_seq(1)
    trace += [a.free_pages, _obs(a.create_seq, 4, 13), _obs(a.page_table, 4),
              _obs(a.create_seq, 5, 40), _obs(a.append, 99),
              _obs(a.page_table, 99)]
    b = rt.PageAllocator(num_pages=1, page_size=2)
    b.create_seq(1, 2)
    trace += [_obs(b.append, 1)]            # the pool is dry
    return trace


def _prefix_script(rt):
    a = rt.PageAllocator(num_pages=12, page_size=4)
    toks = np.arange(10, dtype=np.int32)
    trace = [_obs(a.create_seq_cached, 1, toks),
             _obs(a.create_seq_cached, 2, toks),       # 2 full pages shared
             _obs(a.page_table, 1), _obs(a.page_table, 2), a.cache_stats]
    trace += [_obs(a.create_seq_cached, 3, np.arange(8, dtype=np.int32))]
    a.free_seq(1)
    a.free_seq(2)                                      # shared pages -> LRU
    diverging = np.concatenate([toks[:4], 100 + np.arange(8)]).astype(
        np.int32)
    trace += [a.free_pages, _obs(a.create_seq_cached, 4, toks),
              _obs(a.create_seq_cached, 5, diverging), _obs(a.page_table, 5)]
    for _ in range(4):                      # a hit never writes a shared page
        trace += [_obs(a.append, 4)]
    trace += [_obs(a.page_table, 4), _obs(a.create_seq_cached, 4, toks),
              _obs(a.create_seq_cached, 6, np.arange(40, dtype=np.int32)),
              a.free_pages, a.cache_stats]
    # pool pressure evicts the cached pages: the same prompt misses
    a.free_seq(4)
    a.free_seq(5)
    a.free_seq(3)
    trace += [_obs(a.create_seq, 7, 48), a.free_pages]
    a.free_seq(7)
    trace += [_obs(a.create_seq_cached, 8, toks), a.cache_stats]
    return trace


def _scheduler_script(rt):
    a = rt.PageAllocator(num_pages=14, page_size=4)
    s = rt.NativeScheduler(max_slots=3, allocator=a)
    for uid, (n, m, pri, ten) in enumerate([
            (5, 3, 0, 0), (9, 4, 2, 1), (4, 2, 0, 1), (12, 5, 1, 2),
            (3, 6, 0, 2), (7, 2, 5, 0)]):
        s.submit(uid, n, m, priority=pri, tenant=ten)
    trace = []
    for _ in range(12):
        admitted = s.admit()
        trace += [admitted, s.queue_len, s.active_count, a.free_pages]
        for uid, _ in admitted:
            trace.append(_obs(a.page_table, uid))
        for uid in sorted(u for u in range(6) if a.length(u) > 0):
            done = _obs(s.record_token, uid)
            trace.append((uid, done, a.length(uid)))
            if done is True:
                trace.append(s.finish(uid))
    trace += [_obs(s.record_token, 99), _obs(s.finish, 99)]
    # admission without sequences, the caller creating them with reuse
    c = rt.NativeScheduler(max_slots=2, allocator=a)
    toks = np.arange(9, dtype=np.int32)
    for uid in (20, 21):
        c.submit(uid, len(toks), 2)
    for uid, slot in c.admit(create_seqs=False):
        trace += [(uid, slot), _obs(a.create_seq_cached, uid, toks),
                  _obs(a.page_table, uid)]
    return trace


@pytest.mark.parametrize("script", [_allocator_script, _prefix_script,
                                    _scheduler_script])
def test_same_tables_and_admissions_as_reference(script):
    ref = script(JR)
    got = script(TR)
    assert got == ref
    assert len(ref) > 10


def _sha(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_library_is_built_under_build_and_tracked_one_untouched(
        tmp_path, monkeypatch):
    tracked = TR.SRC.parent / "libccq_runtime.so"
    before = (_sha(tracked), tracked.stat().st_mtime_ns)
    lib = TR.load_library()
    path = TR.library_path()
    assert lib._name == str(path) and path.exists()
    assert path.parent == TR._ROOT / "build" / "runtime"
    assert path.name.startswith("libccq_runtime-") and path.suffix == ".so"
    # a fresh build into an empty directory never reads or writes the
    # tracked library
    monkeypatch.setattr(TR, "BUILD_DIR", tmp_path / "runtime")
    monkeypatch.setattr(TR, "_lib", None)
    fresh = TR.load_library()
    assert fresh._name == str(TR.library_path())
    assert TR.library_path().parent == tmp_path / "runtime"
    assert (_sha(tracked), tracked.stat().st_mtime_ns) == before
    # the reference's copy and the port's live side by side (RTLD_LOCAL)
    ref = JR.load_library()
    assert ref._handle not in (lib._handle, fresh._handle)
    a = TR.PageAllocator(4, 4)
    b = JR.PageAllocator(4, 4)
    a.create_seq(1, 8)
    assert (a.free_pages, b.free_pages) == (2, 4)


def test_library_name_follows_source_and_flags(monkeypatch):
    name = TR.library_path().name
    monkeypatch.setattr(TR, "CXX_FLAGS", TR.CXX_FLAGS + ("-DCCQ_X=1",))
    assert TR.library_path().name != name


def test_concurrent_builds_do_not_collide(tmp_path):
    out = tmp_path / "libccq_runtime-test.so"
    errors = []

    def build():
        try:
            TR._build(out)
        except Exception as e:        # noqa: BLE001 (reported below)
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors
    assert sorted(p.name for p in tmp_path.iterdir()) == [out.name]


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(TR.shutil, "which", lambda name: None)
    monkeypatch.setattr(TR, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(TR, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        TR.load_library()
    assert list(tmp_path.iterdir()) == []
