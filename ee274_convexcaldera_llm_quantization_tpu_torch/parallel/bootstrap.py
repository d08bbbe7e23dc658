"""Process-group bootstrap and a local launcher, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.parallel.
bootstrap``. A rank is one process and one device: where the reference
initializes ``jax.distributed`` once per host and then sees every device
of the slice, each rank here calls :func:`initialize_distributed` once and
joins the world's ``torch.distributed`` process group; the steps of
``parallel`` then run one SPMD program per rank over the groups of a
:class:`torch.distributed.device_mesh.DeviceMesh` (:func:`global_mesh`).

The backend is always the caller's choice: ``"nccl"`` for one rank a card,
``"gloo"`` for CPU ranks and for ranks that share one card (NCCL refuses
two ranks on one device). :func:`launch` spawns a local world of N ranks
over a ``file://`` store, for tests and single-host runs; ``torchrun``
sets the environment variables :func:`initialize_distributed` reads.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import traceback
from typing import Callable, Optional, Sequence


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None,
                           local_rank: Optional[int] = None) -> bool:
    """Join the world's process group.

    ``init_method`` (``"tcp://host:port"`` or ``"file:///path"``),
    ``world_size`` and ``rank`` come from the arguments, or else from
    torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` /
    ``RANK``. Returns False when neither names a world (the single-process
    path), True once the group is initialized. ``backend`` must be given
    whenever a world is configured. ``local_rank`` (else ``LOCAL_RANK``,
    else the rank) picks the card: a rank takes ``cuda:local_rank %
    device_count`` as its current device when a card is present.
    """
    import torch
    import torch.distributed as dist

    env = os.environ
    if init_method is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if local_rank is None and "LOCAL_RANK" in env:
        local_rank = int(env["LOCAL_RANK"])
    if init_method is None:
        return False
    if world_size is None or rank is None:
        raise ValueError(f"init_method {init_method!r} needs world_size and "
                         f"rank (got {world_size}, {rank})")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if torch.cuda.is_available():
        torch.cuda.set_device((rank if local_rank is None else local_rank)
                              % torch.cuda.device_count())
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def global_mesh(dp: Optional[int] = None, tp: Optional[int] = None,
                device_type: str = "cuda"):
    """A ``("dp", "tp")`` mesh over every rank of the world.

    Defaults, as the reference's: tp = the ranks of this host (torchrun's
    ``LOCAL_WORLD_SIZE``, else the whole world), so the per-token
    collectives stay within the host; dp = the number of hosts.
    """
    import torch.distributed as dist

    from ee274_convexcaldera_llm_quantization_tpu_torch.parallel.mesh import (
        make_mesh)

    n = dist.get_world_size()
    if tp is None:
        tp = max(1, int(os.environ.get("LOCAL_WORLD_SIZE", n)))
    if dp is None:
        dp = n // tp
    return make_mesh(dp=dp, tp=tp, device_type=device_type)


def _rank_main(fn, rank: int, world_size: int, init_method: str,
               backend: str, threads: Optional[int], out_dir: str,
               args: tuple) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world_size),
                      LOCAL_WORLD_SIZE=str(world_size))
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        import torch
        import torch.distributed as dist
        if threads is not None:
            torch.set_num_threads(threads)
        initialize_distributed(init_method, world_size, rank, backend)
        try:
            result = ("ok", fn(rank, *args))
        finally:
            dist.destroy_process_group()
    except Exception:                          # reported by launch()
        result = ("error", traceback.format_exc())
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".tmp", path)


def launch(fn: Callable, world_size: int, work_dir: str,
           args: Sequence = (), backend: str = "gloo",
           threads: Optional[int] = 1, timeout: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` spawned processes that form
    one world over a ``file://`` store in ``work_dir`` (which must exist and
    be this world's own, so concurrent worlds never share a store).

    ``fn`` must be importable by name in a fresh interpreter (a module-level
    function) and return something picklable. Each rank sets LOCAL_RANK to
    its rank, so ranks take ``cuda:rank % device_count``; ``threads`` sets
    each rank's torch threads. Returns the ranks' return values in rank
    order; raises with every failing rank's traceback if any rank failed,
    and kills the ranks left when ``timeout`` seconds pass.
    """
    init_method = "file://" + os.path.abspath(
        os.path.join(work_dir, "store"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, world_size, init_method, backend, threads, work_dir,
        tuple(args))) for r in range(world_size)]
    for p in procs:
        p.start()
    import time
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results, errors = [], []
    for r, p in enumerate(procs):
        path = os.path.join(work_dir, f"rank{r}.pkl")
        if not os.path.exists(path):
            errors.append(f"rank {r}: no result (exit code {p.exitcode}"
                          + (", killed at the timeout" if r in hung else "")
                          + ")")
            results.append(None)
            continue
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        os.remove(path)
        if status != "ok":
            errors.append(f"rank {r}:\n{value}")
        results.append(value)
    if errors:
        raise RuntimeError("launch: " + "\n".join(errors))
    return results
