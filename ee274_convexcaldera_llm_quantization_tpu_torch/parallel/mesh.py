"""Device mesh construction and the sharding catalog, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.parallel.mesh``:

- :func:`make_mesh` builds a :class:`torch.distributed.device_mesh.
  DeviceMesh` with named dims ``("dp", "tp")`` over the world's ranks (one
  process and one device each; :mod:`parallel.bootstrap`).
- :func:`model_shardings` gives the placements of a
  :class:`models.llama.ModelParams` (dense or CALDERA-compressed) in the
  Megatron layout of the reference's ``_linear_spec``: q/k/v/gate/up
  column-parallel (output features sharded over tp), o/down row-parallel
  (input features sharded), the embedding sharded over the vocabulary;
  a dimension that tp does not divide is replicated (``_fit_spec``).
- :func:`shard_params` places the params as ``DTensor``s with those
  placements, the counterpart of ``NamedSharding`` under GSPMD;
  :func:`batch_sharding` shards a batch over dp. The port's plain
  ``llama.forward``, ``train.train_step`` and ``evaluate_perplexity`` run on
  them: DTensor propagates the placements op by op and inserts the
  collectives, as GSPMD partitions the reference's jitted functions.
- :func:`kvcache_shardings`: KV heads over tp, batch over dp.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ee274_convexcaldera_llm_quantization_tpu_torch.models.compressed import (
    CalderaLinear, DenseLinear)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.llama import (
    KVCache, LayerParams, ModelParams)


def make_mesh(dp: int = 1, tp: int = 1, device_type: str = "cuda",
              ranks: Optional[Sequence[int]] = None):
    """A ``("dp", "tp")`` mesh of ``dp * tp`` ranks (the first ones of the
    world, or ``ranks``); tp is the fast axis. Every rank of the world calls
    it. ``device_type`` "cuda" places DTensors on each rank's card, "cpu"
    on its host memory."""
    from torch.distributed.device_mesh import DeviceMesh

    n = dist.get_world_size()
    if ranks is None:
        if dp * tp > n:
            raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} ranks, "
                             f"have {n}")
        ranks = range(dp * tp)
    ranks = torch.as_tensor(list(ranks), dtype=torch.int64)
    if ranks.numel() != dp * tp:
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} ranks, got "
                         f"{ranks.numel()}")
    return DeviceMesh(device_type, ranks.reshape(dp, tp),
                      mesh_dim_names=("dp", "tp"))


# Column-parallel: shard output features. Row-parallel: shard input features.
_COL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
_ROW = ("o_proj", "down_proj")

# A spec names, per tensor dimension, the mesh dim it is sharded over (or
# None): the reference's PartitionSpec.


def _linear_spec(lin, kind: str) -> dict:
    """Field -> spec for one linear. ``kind``: 'col' | 'row' | 'rep'."""
    if isinstance(lin, DenseLinear):
        w = {"col": ("tp", None), "row": (None, "tp")}.get(kind,
                                                            (None, None))
        b = ("tp",) if kind == "col" else (None,)
        return dict(w=w, b=b)
    assert isinstance(lin, CalderaLinear), type(lin).__name__
    if kind == "col":
        spec = dict(packed=("tp", None), scales=("tp", None),
                    L=("tp", None), R=(None, None), b=("tp",),
                    L_scale=("tp", None), R_scale=(None, None))
    elif kind == "row":
        spec = dict(packed=(None, "tp"), scales=(None, "tp"),
                    L=(None, None), R=(None, "tp"), b=(None,),
                    L_scale=(None, None), R_scale=(None, None))
    else:
        spec = dict(packed=(None, None), scales=(None, None),
                    L=(None, None), R=(None, None), b=(None,),
                    L_scale=(None, None), R_scale=(None, None))
    spec["global_scale"] = ()
    return spec


def _fit_spec(spec, shape, mesh) -> tuple:
    """Replicate a dimension that its mesh dim does not divide (small arrays:
    one scale group, a rank below tp)."""
    fixed = []
    for i, axis in enumerate(spec):
        if axis is None or i >= len(shape):
            fixed.append(None)
            continue
        fixed.append(axis if shape[i] % mesh.size(
            mesh.mesh_dim_names.index(axis)) == 0 else None)
    return tuple(fixed)


def _placements(spec, mesh):
    """DTensor placements (one per mesh dim) of a spec."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * mesh.ndim
    for i, axis in enumerate(spec):
        if axis is not None:
            out[mesh.mesh_dim_names.index(axis)] = Shard(i)
    return out


@dataclasses.dataclass
class Sharding:
    """The placement of one tensor: its spec, fitted to its shape."""
    mesh: object
    spec: tuple

    @property
    def placements(self):
        return _placements(self.spec, self.mesh)


def _linear_shardings(lin, kind: str, mesh):
    spec = _linear_spec(lin, kind)
    return dataclasses.replace(lin, **{
        name: Sharding(mesh, _fit_spec(s, getattr(lin, name).shape, mesh))
        for name, s in spec.items() if getattr(lin, name) is not None})


def model_shardings(params: ModelParams, mesh) -> ModelParams:
    """A :class:`ModelParams` of :class:`Sharding` (same structure as
    ``params``; static fields kept) in the Megatron layout."""
    def norm():
        return Sharding(mesh, (None,))

    layers = []
    for lp in params.layers:
        fields = {}
        for f in dataclasses.fields(LayerParams):
            lin = getattr(lp, f.name)
            if f.name.endswith("_norm"):
                fields[f.name] = norm()
            else:
                kind = ("col" if f.name in _COL else
                        "row" if f.name in _ROW else "rep")
                fields[f.name] = _linear_shardings(lin, kind, mesh)
        layers.append(LayerParams(**fields))
    lm_head = None
    if params.lm_head is not None:
        lm_head = _linear_shardings(params.lm_head, "col", mesh)
    return ModelParams(
        embed=Sharding(mesh, _fit_spec(("tp", None), params.embed.shape,
                                       mesh)),
        layers=layers, final_norm=norm(), lm_head=lm_head)


def kvcache_shardings(mesh) -> KVCache:
    """KV heads over tp and batch over dp: (layers, batch, seq, kv_heads,
    head_dim)."""
    s = Sharding(mesh, (None, "dp", None, "tp", None))
    return KVCache(k=s, v=s)


def _place(x: torch.Tensor, sharding: Sharding):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, sharding.mesh, sharding.placements)


def _map2(fn, values, shardings):
    if isinstance(values, torch.Tensor):
        return fn(values, shardings)
    if dataclasses.is_dataclass(values):
        return dataclasses.replace(values, **{
            f.name: _map2(fn, getattr(values, f.name),
                          getattr(shardings, f.name))
            for f in dataclasses.fields(values)
            if isinstance(getattr(values, f.name),
                          (torch.Tensor, list, tuple))
            or dataclasses.is_dataclass(getattr(values, f.name))})
    if isinstance(values, (list, tuple)):
        return type(values)(_map2(fn, v, s)
                            for v, s in zip(values, shardings))
    return values


def shard_params(params: ModelParams, mesh) -> ModelParams:
    """Place ``params`` (the same full tensors on every rank, on the mesh's
    device) as DTensors with the catalog's placements. Column-sharding the
    KV projections needs ``num_kv_heads % tp == 0``."""
    return _map2(_place, params, model_shardings(params, mesh))


def batch_sharding(mesh) -> Sharding:
    """Windows or sequences (B, S) sharded over dp."""
    return Sharding(mesh, ("dp", None))


def shard_batch(tokens: torch.Tensor, mesh):
    """Place a (B, S) token batch with :func:`batch_sharding`."""
    return _place(tokens, batch_sharding(mesh))
