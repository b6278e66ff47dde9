"""Policy helpers the fused epoch step uses (PyTorch port of the matching
functions of ``repro/core/policy.py``).

The reference's per-lane eager policies (``oracle_top_k``, ``hinted`` ...)
serve its unfused reference path, which is not ported yet (ROADMAP Queue 1,
item 12); the fused step decides every lane through ``selectk`` and these
helpers.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["cold_streak", "coldest_victims", "ewma", "fma_f32",
           "hinted_score", "plan_eviction"]

_INT32_MAX = (1 << 31) - 1


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded ONCE — the fused multiply-add that
    XLA's CPU backend contracts ``a * b + c`` into inside ``jit``, which is
    how the reference's fused epoch step computes the two float32 blends
    below.  PyTorch has no fma op, so: the product of two float32 values
    is exact in float64, the sum is rounded once in float64 (TwoSum keeps
    its error), and where that float64 sum lies exactly halfway between two
    float32 values the error's sign breaks the tie the way one rounding of
    the exact sum would."""
    p = a.to(torch.float64) * b.to(torch.float64)        # exact
    c64 = c.to(torch.float64)
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)                    # (p + c) - s, exact
    r = s.to(torch.float32)
    up = torch.full_like(r, torch.inf)
    toward_s = torch.where(s > r.to(torch.float64), up, -up)
    mid = (r.to(torch.float64)
           + torch.nextafter(r, toward_s).to(torch.float64)) * 0.5
    s64_up = torch.full_like(s, torch.inf)
    nudged = torch.nextafter(s, torch.where(err > 0, s64_up, -s64_up))
    return torch.where((s == mid) & (err != 0), nudged.to(torch.float32), r)


def hinted_score(est_counts: torch.Tensor, t_rank: torch.Tensor,
                 hint_rank: torch.Tensor, hint_weight: float) -> torch.Tensor:
    """The hinted lane's blended score
    ``(1 - w) * t_rank / (n - 1) + w * hint_rank``: telemetry rank mixed
    with the static priority in rank space, and a -1 sentinel for blocks
    with neither telemetry nor a hint.

    Held bit-identical to the reference's fused (jit) step, where XLA
    folds the division into the float32 constant
    ``C = f32(f32(1 - w) * f32(1 / (n - 1)))`` and contracts the first
    product into a fused multiply-add: ``fma(t_rank, C, f32(w * hint))``.
    (The reference's eager call rounds each op separately and differs in
    the last bit on a few percent of elements.)"""
    n = est_counts.shape[0]
    recip = np.float32(1.0) / np.float32(max(n - 1, 1))
    c = float(np.float32(np.float32(1.0 - hint_weight) * recip))
    score = fma_f32(t_rank.to(torch.float32),
                    torch.full_like(hint_rank, c), hint_weight * hint_rank)
    eligible = (est_counts > 0) | (hint_rank > 0)
    return torch.where(eligible, score, -1.0)


def ewma(alpha: float, x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """``alpha * x + (1 - alpha) * prev`` in float32 as the reference's
    fused step computes it: ``fma(alpha, x, f32((1 - alpha) * prev))``.
    (Identical to separate rounding when ``alpha * x`` is exact, as at the
    default ``alpha = 0.5``.)"""
    return fma_f32(torch.full_like(x, alpha), x, (1.0 - alpha) * prev)


def cold_streak(streak: torch.Tensor, est: torch.Tensor,
                fast_mask: torch.Tensor) -> torch.Tensor:
    """Consecutive cold epochs per resident block (demotion hysteresis)."""
    return torch.where(fast_mask & (est == 0), streak + 1, 0)


def coldest_victims(est_counts: torch.Tensor, slot_to_block: torch.Tensor,
                    n: int) -> torch.Tensor:
    """The n coldest currently-fast blocks as demotion victims (stable
    order, so ties go to the lowest slot as in ``jnp.argsort``)."""
    occ = slot_to_block >= 0
    blk = torch.clamp(slot_to_block, min=0).to(torch.int64)
    heat = torch.where(occ, est_counts[blk].to(torch.float32),
                       float(_INT32_MAX))
    order = torch.sort(heat, stable=True).indices
    sel = order[: min(n, order.shape[0])]
    return torch.where(occ[sel], slot_to_block[sel], -1)


def plan_eviction(est_counts: torch.Tensor, want: torch.Tensor,
                  slot_to_block: torch.Tensor, n: int) -> torch.Tensor:
    """Victims to free ``n`` slots for a plan: the coldest residents, with
    blocks in ``want`` (-1 padding allowed) guarded by +inf heat."""
    est = est_counts.to(torch.float32).clone()
    if want.shape[0]:
        safe = torch.clamp(want, min=0).to(torch.int64)
        est[safe] = torch.where(want >= 0, torch.inf, est[safe])
    return coldest_victims(est, slot_to_block, n)
