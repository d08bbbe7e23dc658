"""Multi-group bit allocation under a global budget, in PyTorch's package.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.allocate.
multigroup`` (which uses numpy only; so does this copy, the port keeping
its own): minimize ``sum_g w_g c_g e^{-k_g b_g}`` subject to
``sum_g p_g b_g <= B_tot`` (``p_g`` the groups' parameter shares).

- :func:`allocate_bits_continuous`: reverse water-filling,
  ``b_g = clip((1/k_g) ln(w_g c_g k_g / (nu p_g)), b_min, b_max)``, the
  water level ``nu`` by bisection on the budget used; its certificate is
  the complementary-slackness residual.
- :func:`allocate_bits_discrete`: bits from a menu by greedy marginal
  upgrades from a heap (exact for convex decreasing costs, Fox 1966); its
  certificate is the distance to the continuous bound.

A :class:`GroupSpec`'s constants may be given as floats or 0-d tensors
(the budgeted surgery computes them on the weights' device).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class GroupSpec:
    """One allocation group (a layer, or a block of rows within a layer)."""

    name: str
    num_params: int          # parameter count p_g (weight of the group)
    c: float                 # rate-distortion constant c_g
    k: float = 1.0           # rate-distortion exponent k_g
    weight: float = 1.0      # distortion weight (e.g. Hessian sensitivity)

    def __post_init__(self):
        self.c, self.k, self.weight = (float(self.c), float(self.k),
                                       float(self.weight))
        self.num_params = int(self.num_params)


@dataclasses.dataclass
class AllocationResult:
    bits: Dict[str, float]            # per-group allocation
    avg_bits: float                   # sum p_g b_g / sum p_g
    total_distortion: float           # sum w_g c_g exp(-k_g b_g)
    budget_used: float                # sum p_g b_g
    duality_gap: float                # certificate for the allocation
    water_level: Optional[float] = None


def _distortion(groups: Sequence[GroupSpec], bits: np.ndarray) -> float:
    return float(sum(g.weight * g.c * np.exp(-g.k * b)
                     for g, b in zip(groups, bits)))


def allocate_bits_continuous(
    groups: Sequence[GroupSpec],
    B_tot: float,
    b_min: float = 2.0,
    b_max: float = 16.0,
    tol: float = 1e-10,
) -> AllocationResult:
    """Reverse water-filling over groups. ``B_tot`` is bits per parameter."""
    p = np.array([g.num_params for g in groups], np.float64)
    p = p / p.sum()                               # normalize weights
    budget = B_tot                                 # avg-bits budget

    def bits_for(nu: float) -> np.ndarray:
        b = np.empty(len(groups))
        for i, g in enumerate(groups):
            num = g.weight * g.c * g.k
            if num <= 0 or nu <= 0:
                b[i] = b_max
            else:
                b[i] = np.log(num / (nu * p[i])) / g.k
        return np.clip(b, b_min, b_max)

    # all-min allocation must fit; otherwise clamp and report
    if b_min > budget:
        bits = np.full(len(groups), b_min)
        return AllocationResult(
            bits={g.name: float(b) for g, b in zip(groups, bits)},
            avg_bits=float(p @ bits),
            total_distortion=_distortion(groups, bits),
            budget_used=float(p @ bits), duality_gap=np.inf)

    # bisection on nu: budget usage is decreasing in nu
    lo, hi = 0.0, 1.0
    while float(p @ bits_for(hi)) > budget:
        hi *= 2.0
        if hi > 1e30:
            break
    for _ in range(200):
        mid = (lo + hi) / 2
        if float(p @ bits_for(mid)) > budget:
            lo = mid
        else:
            hi = mid
        if hi - lo < tol * max(hi, 1.0):
            break
    nu = hi
    bits = bits_for(nu)
    used = float(p @ bits)

    # Duality gap of the allocation subproblem: the dual at water level nu is
    # L(b*, nu) = distortion(b*) + nu * (p.b* - budget); for the exact
    # water-filling solution interior groups satisfy stationarity so the gap
    # reduces to nu * (budget - used) >= 0 (complementary slackness residual).
    gap = max(nu * (budget - used), 0.0)
    return AllocationResult(
        bits={g.name: float(b) for g, b in zip(groups, bits)},
        avg_bits=used,
        total_distortion=_distortion(groups, bits),
        budget_used=used,
        duality_gap=gap,
        water_level=nu,
    )


def allocate_bits_discrete(
    groups: Sequence[GroupSpec],
    B_tot: float,
    menu: Sequence[int] = (2, 3, 4, 8, 16),
) -> AllocationResult:
    """Optimal discrete allocation by marginal analysis (greedy upgrades).

    Start every group at the smallest menu entry; repeatedly apply the
    upgrade with the largest distortion decrease per unit of budget until
    the budget is exhausted. For convex decreasing per-group cost curves
    this greedy is exactly optimal among menu allocations.
    """
    menu = sorted(menu)
    p = np.array([g.num_params for g in groups], np.float64)
    p = p / p.sum()
    budget = B_tot

    level = np.zeros(len(groups), dtype=int)      # index into menu
    used = float(p @ np.array([menu[0]] * len(groups)))
    if used > budget + 1e-12:
        bits = np.array([menu[0]] * len(groups), float)
        return AllocationResult(
            bits={g.name: float(b) for g, b in zip(groups, bits)},
            avg_bits=used, total_distortion=_distortion(groups, bits),
            budget_used=used, duality_gap=np.inf)

    def dist(i, li):
        g = groups[i]
        return g.weight * g.c * np.exp(-g.k * menu[li])

    import heapq
    heap = []
    for i in range(len(groups)):
        if len(menu) > 1:
            gain = dist(i, 0) - dist(i, 1)
            cost = p[i] * (menu[1] - menu[0])
            heapq.heappush(heap, (-gain / max(cost, 1e-30), i, 1))

    while heap:
        neg_eff, i, li = heapq.heappop(heap)
        if level[i] != li - 1:
            continue                               # stale entry
        cost = p[i] * (menu[li] - menu[li - 1])
        if used + cost > budget + 1e-12:
            continue
        level[i] = li
        used += cost
        if li + 1 < len(menu):
            gain = dist(i, li) - dist(i, li + 1)
            cost2 = p[i] * (menu[li + 1] - menu[li])
            heapq.heappush(heap, (-gain / max(cost2, 1e-30), i, li + 1))

    bits = np.array([menu[l] for l in level], float)
    cont = allocate_bits_continuous(groups, B_tot, b_min=menu[0],
                                    b_max=menu[-1])
    # certificate: discrete distortion minus the continuous lower bound
    gap = max(_distortion(groups, bits) - cont.total_distortion, 0.0)
    return AllocationResult(
        bits={g.name: float(b) for g, b in zip(groups, bits)},
        avg_bits=float(p @ bits),
        total_distortion=_distortion(groups, bits),
        budget_used=float(p @ bits),
        duality_gap=gap,
    )


def groups_from_layers(
    layer_shapes: Dict[str, Tuple[int, int]],
    layer_variances: Optional[Dict[str, float]] = None,
    layer_sensitivities: Optional[Dict[str, float]] = None,
    k: float = 1.0,
) -> List[GroupSpec]:
    """Build allocation groups from a model's layer inventory.

    ``c_g = 0.1 * Var(W_g)`` mirrors the reference's rate-distortion constant
    (``convex_caldera.py:123``); sensitivities (e.g. mean diagonal Hessian)
    become distortion weights.
    """
    specs = []
    for name, (m, n) in layer_shapes.items():
        var = (1.0 if layer_variances is None
               else layer_variances.get(name, 1.0))
        w = 1.0 if layer_sensitivities is None else layer_sensitivities.get(
            name, 1.0)
        specs.append(GroupSpec(name=name, num_params=m * n, c=0.1 * var, k=k,
                               weight=w))
    return specs
