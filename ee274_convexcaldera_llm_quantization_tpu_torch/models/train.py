"""Training step (next-token LM loss), in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.models.train``:
the mean next-token cross entropy over :func:`llama.forward`, gradients by
autograd through the plain forward (dense training runs no kernel), and an
AdamW that computes what ``optax.adamw(lr)`` computes: b1 0.9, b2 0.999,
eps 1e-8, weight decay 1e-4 added to the Adam update before the ``-lr``
scale, moments in each parameter's dtype, every operation rounded to that
dtype with its scalar cast to it first (JAX's weakly typed scalars), so a
bf16 leaf takes the reference's bf16 roundings in its order.

Only floating leaves train (the reference's ``_trainable_mask``): packed
codes and integer leaves of a compressed model stay as they are, as does a
floating leaf that no gradient reaches (a kernel on the card has no
backward). Params are rebuilt, not changed in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    ModelConfig)


def lm_loss(params, tokens: torch.Tensor, config: ModelConfig
            ) -> torch.Tensor:
    """Mean next-token cross entropy (nats) over (B, S) tokens."""
    tokens = llama.on_mesh(tokens, params.embed)
    logits = llama.forward(params, tokens, config)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = tokens[:, 1:].long()
    return -logp.gather(-1, tgt[..., None])[..., 0].mean()


def tensor_leaves(obj, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Every tensor of nested dataclasses and lists, keyed by its path
    (``layers.0.q_proj.w``)."""
    out = {}
    if isinstance(obj, torch.Tensor):
        out[prefix] = obj
    elif isinstance(obj, (list, tuple)):
        for i, o in enumerate(obj):
            out.update(tensor_leaves(o, f"{prefix}.{i}" if prefix
                                     else str(i)))
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            out.update(tensor_leaves(getattr(obj, f.name),
                                     f"{prefix}.{f.name}" if prefix
                                     else f.name))
    return out


def replace_leaves(obj, new: Dict[str, torch.Tensor], prefix: str = ""):
    """``obj`` rebuilt with the tensors of ``new`` (keyed as
    :func:`tensor_leaves` keys them) in place of its own."""
    if isinstance(obj, torch.Tensor):
        return new.get(prefix, obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(replace_leaves(o, new, f"{prefix}.{i}" if prefix
                                        else str(i))
                         for i, o in enumerate(obj))
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: replace_leaves(getattr(obj, f.name), new,
                                   f"{prefix}.{f.name}" if prefix
                                   else f.name)
            for f in dataclasses.fields(obj) if f.init})
    return obj


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.adamw(lr)``'s update, over the floating leaves whose last
    path component is not in ``frozen``."""

    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4
    frozen: Tuple[str, ...] = ()

    def trainable(self, params) -> Dict[str, torch.Tensor]:
        return {k: t for k, t in tensor_leaves(params).items()
                if t.is_floating_point()
                and k.rsplit(".", 1)[-1] not in self.frozen}

    def init(self, params) -> "AdamWState":
        leaves = self.trainable(params)
        return AdamWState(
            count=0, mu={k: torch.zeros_like(t) for k, t in leaves.items()},
            nu={k: torch.zeros_like(t) for k, t in leaves.items()})

    def step(self, p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
             nu: torch.Tensor, count: int):
        """One leaf's ``(new p, mu, nu)``."""
        dt = p.dtype

        def s(x):
            return torch.tensor(x, dtype=dt, device=p.device)

        def correction(b):
            one = torch.tensor(1.0, dtype=torch.float32, device=p.device)
            return (one - torch.tensor(b, dtype=torch.float32,
                                       device=p.device) ** count).to(dt)

        g = _like(g, p).to(dt)
        mu = s(1 - self.b1) * g + s(self.b1) * mu
        nu = s(1 - self.b2) * (g * g) + s(self.b2) * nu
        u = (mu / correction(self.b1)) / (torch.sqrt(nu / correction(
            self.b2)) + s(self.eps))
        u = s(-self.lr) * (u + s(self.weight_decay) * p)
        return p + u, mu, nu


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient (params placed by ``parallel.mesh.shard_params``)
    in its parameter's placements: a gradient over a dp-sharded batch comes
    back as per-rank partial sums, which must be summed before the update's
    nonlinear steps run on them (the reference's gradients take their
    params' shardings)."""
    from torch.distributed.tensor import DTensor

    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


@dataclasses.dataclass
class AdamWState:
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def make_optimizer(lr: float = 1e-4) -> AdamW:
    return AdamW(lr=lr)


def init_train_state(params, optimizer: AdamW) -> AdamWState:
    return optimizer.init(params)


def train_step(params, opt_state: AdamWState, tokens: torch.Tensor,
               config: ModelConfig, optimizer: AdamW
               ) -> Tuple[object, AdamWState, torch.Tensor]:
    """One AdamW step on ``tokens`` (B, S) on the params' device. Returns
    ``(params, opt_state, loss)``: new params and state (the old ones are
    left as they were), the loss before the step."""
    leaves = optimizer.trainable(params)
    names = [k for k in leaves if k in opt_state.mu]
    xs = {k: leaves[k].detach().requires_grad_(True) for k in names}
    loss = lm_loss(replace_leaves(params, xs), tokens, config)
    grads = torch.autograd.grad(loss, [xs[k] for k in names],
                                allow_unused=True)
    count = opt_state.count + 1
    new_p: Dict[str, torch.Tensor] = {}
    mu, nu = dict(opt_state.mu), dict(opt_state.nu)
    with torch.no_grad():
        for k, g in zip(names, grads):
            if g is None:
                continue
            new_p[k], mu[k], nu[k] = optimizer.step(
                leaves[k], g, opt_state.mu[k], opt_state.nu[k], count)
    return (replace_leaves(params, new_p), AdamWState(count, mu, nu),
            loss.detach())
