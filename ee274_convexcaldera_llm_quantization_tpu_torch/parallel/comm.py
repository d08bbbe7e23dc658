"""The collectives of the parallel steps, over ``torch.distributed`` groups.

The port's counterparts of the reference's ``shard_map`` collectives: a
``tp_axis`` is a ``ProcessGroup`` (``mesh.get_group("tp")``) and each
function here runs on every rank of it.

- ``psum`` / ``pmax`` -> :func:`all_sum` / :func:`all_max` (``all_reduce``);
- ``axis_index`` -> :func:`group_rank`;
- a vocab-sharded output gathered to its global value -> :func:`gather_last`,
  an ``all_reduce`` of a zero-filled full buffer (exact: every other rank
  adds zeros), which gloo also runs on CUDA tensors;
- ``ppermute`` one stage forward -> :func:`send` / :func:`recv`; gloo sends
  host memory only, so a CUDA tensor goes through the host there.

A collective that fails raises; nothing falls back.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_rank(group) -> int:
    return dist.get_rank(group)


def group_size(group) -> int:
    return dist.get_world_size(group)


def global_rank(group, rank: int) -> int:
    """The world rank of ``group``'s rank ``rank``."""
    return dist.get_global_rank(group, rank)


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``psum``: the sum of every rank's ``x`` (a new tensor)."""
    x = x.contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_max(x: torch.Tensor, group) -> torch.Tensor:
    """``pmax``: the elementwise maximum over the ranks (a new tensor)."""
    x = x.contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenate every rank's ``x`` along the last axis, in rank order:
    the global value of an output sharded on that axis."""
    n, r = x.shape[-1], group_rank(group)
    full = torch.zeros((*x.shape[:-1], n * group_size(group)),
                       dtype=x.dtype, device=x.device)
    full[..., r * n:(r + 1) * n] = x
    dist.all_reduce(full, op=dist.ReduceOp.SUM, group=group)
    return full


def gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` (equal shapes)."""
    return gather_last(x.movedim(dim, -1), group).movedim(-1, dim)


def broadcast(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """``x`` of ``group``'s rank ``src`` on every rank (in place)."""
    dist.broadcast(x, src=global_rank(group, src), group=group)
    return x


def _through_host(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def send(x: torch.Tensor, group, dst: int) -> None:
    """Send ``x`` to ``group``'s rank ``dst`` (one pipeline hop)."""
    x = x.contiguous()
    if _through_host(x, group):
        x = x.cpu()
    dist.send(x, dst=global_rank(group, dst), group=group)


def recv(shape, dtype, device, group, src: int) -> torch.Tensor:
    """Receive a ``shape`` tensor from ``group``'s rank ``src``."""
    on_host = (torch.device(device).type == "cuda"
               and dist.get_backend(group) == "gloo")
    buf = torch.empty(shape, dtype=dtype,
                      device="cpu" if on_host else device)
    dist.recv(buf, src=global_rank(group, src), group=group)
    return buf.to(device) if on_host else buf


# Mesh dims by name (a torch.distributed.device_mesh.DeviceMesh).

def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along the mesh dim ``axis``."""
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis`` (the reference's
    axis name inside ``shard_map``)."""
    return mesh.get_group(axis)
