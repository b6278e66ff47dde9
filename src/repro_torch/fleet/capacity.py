"""Capacity policies — how one bounded fast tier is split among tenants
(PyTorch port of ``repro/fleet/capacity.py``).

Three policies, all compiled into a :class:`~repro_torch.core.runtime.
Tenancy` whose quotas the fused epoch step enforces on the device
(segment-capped selection, see ``runtime._epoch_step``):

* ``"shared"``    — one pool, no quotas: every lane's top-k selection is
  global, tenants compete on raw counter magnitude (TPP's default regime
  and the fleet's interference baseline).
* ``"partition"`` — static partition proportional to each tenant's declared
  demand (its solo ``k_hot``).
* ``"weighted"``  — weighted-fair quotas from explicit per-tenant weights:
  the operator's SLO knob.

Quota arithmetic is largest-remainder apportionment (exact total, zero
weight -> zero quota) through the scenario layer's
:func:`~repro_torch.scenarios.kv_cache.quantize_access_counts`, with a
``min_quota`` floor so no positive-weight tenant is starved to zero slots.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..core.runtime import Tenancy
from ..scenarios.kv_cache import quantize_access_counts

__all__ = ["CAPACITY_POLICIES", "fair_quotas", "make_tenancy"]

CAPACITY_POLICIES = ("shared", "partition", "weighted")


def fair_quotas(weights: Sequence[float], k_hot: int,
                min_quota: int = 1) -> np.ndarray:
    """Apportion ``k_hot`` fast-tier slots proportionally to ``weights``
    (largest-remainder, exact total), then raise every positive-weight
    tenant to at least ``min_quota`` slots, taking the shortfall from the
    largest quotas — a floor, not a fairness change."""
    w = np.asarray(weights, np.float64)
    if (w < 0).any() or w.sum() <= 0:
        raise ValueError(f"weights must be non-negative with a positive "
                         f"sum, got {list(weights)}")
    if k_hot < min_quota * int((w > 0).sum()):
        raise ValueError(f"k_hot={k_hot} cannot give {int((w > 0).sum())} "
                         f"tenants min_quota={min_quota} slots each")
    q = quantize_access_counts(w, int(k_hot))
    while True:
        short = (w > 0) & (q < min_quota)
        if not short.any():
            return q
        q[np.argmax(short)] += 1
        q[np.argmax(np.where(short, -1, q))] -= 1


def make_tenancy(
    offsets: Sequence[int],
    hot_k: Sequence[int],
    k_hot: int,
    capacity: str = "shared",
    weights: Optional[Sequence[float]] = None,
) -> Tenancy:
    """Compile a capacity policy into the runtime's :class:`Tenancy`.

    ``offsets``/``hot_k`` are the fleet's id-space layout (cumulative block
    offsets, per-tenant solo hot-set sizes); ``k_hot`` the shared fast
    tier's capacity.  ``"partition"`` derives quota weights from ``hot_k``
    (demand-proportional); ``"weighted"`` uses ``weights`` (required);
    ``"shared"`` sets no quotas."""
    if capacity not in CAPACITY_POLICIES:
        raise ValueError(f"unknown capacity policy {capacity!r}; choose "
                         f"from {CAPACITY_POLICIES}")
    caps: Optional[Tuple[int, ...]] = None
    if capacity == "partition":
        caps = tuple(int(c) for c in fair_quotas(hot_k, k_hot))
    elif capacity == "weighted":
        if weights is None:
            raise ValueError("capacity='weighted' needs per-tenant weights")
        if len(weights) != len(hot_k):
            raise ValueError(f"need one weight per tenant, got "
                             f"{len(weights)} for {len(hot_k)} tenants")
        caps = tuple(int(c) for c in fair_quotas(weights, k_hot))
    return Tenancy(offsets=tuple(int(o) for o in offsets),
                   hot_k=tuple(int(h) for h in hot_k), caps=caps)
