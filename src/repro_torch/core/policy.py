"""Promotion policies (PyTorch port of ``repro/core/policy.py``).

Two groups:

* the eager per-call policies of the offline path, ``TieredEmbedding``
  and the runtime's per-lane reference path (:func:`oracle_top_k`,
  :func:`nb_two_touch`, :func:`reactive_watermark`, :func:`proactive_ewma`,
  :func:`hinted`, :func:`prefetch`).  Every ``lax.top_k`` of the reference
  goes through :func:`repro_torch.core.selectk.select_top_k` (the
  ``hist_select`` kernel on the card), ties lowest index first; float
  scores join through ``selectk.sortable_key``.  The reference calls these
  outside ``jit``, so every float op rounds on its own, and so do they here
  (:func:`ewma_eager`, :func:`hinted_score_eager`);
* the helpers of the fused epoch step, which reproduce the reference's
  *jit* arithmetic (``fma_f32``, ``ewma``, ``hinted_score``, and the
  hardened runtime's ``quality_estimate`` / ``quality_smooth``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import selectk

__all__ = ["MigrationPlan", "cold_streak", "coldest_victims", "ewma",
           "ewma_eager", "fma_f32", "hinted", "hinted_score",
           "hinted_score_eager", "nb_two_touch", "oracle_top_k",
           "plan_eviction", "prefetch", "proactive_ewma", "quality_estimate",
           "quality_smooth", "reactive_watermark", "stable_rank"]

_INT32_MAX = (1 << 31) - 1


# ====================================================  eager policies
@dataclasses.dataclass(frozen=True)
class MigrationPlan:
    """Block ids to promote (int32, padded with -1), in priority order."""
    promote: torch.Tensor
    demote: Optional[torch.Tensor] = None


def _top_k(key: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` on a 1-D int32 key: (values, int32 indices)."""
    vals, ids = selectk.select_top_k(key.to(torch.int32), k)
    return vals, ids.to(torch.int32)


def _plan(keep: torch.Tensor, ids: torch.Tensor) -> MigrationPlan:
    return MigrationPlan(promote=torch.where(keep, ids, -1))


def oracle_top_k(est_counts: torch.Tensor, k: int,
                 min_count: int = 1) -> MigrationPlan:
    """Promote the top-k blocks by estimated count; blocks below
    ``min_count`` are never promoted (PEBS's coverage limit)."""
    counts, ids = _top_k(est_counts, min(k, est_counts.shape[0]))
    return _plan(counts >= min_count, ids)


def nb_two_touch(faults: torch.Tensor, k: int,
                 rate_limit: Optional[int] = None) -> MigrationPlan:
    """Linux NB promotion: >= 2 hint faults, ranked by fault count;
    ``rate_limit`` caps the pages per call."""
    k = min(k, faults.shape[0])
    if rate_limit is not None:
        k = min(k, rate_limit)
    counts, ids = _top_k(faults, k)
    return _plan(counts >= 2, ids)


def reactive_watermark(est_counts: torch.Tensor, hot_threshold: int,
                       free_slots, max_moves: int) -> MigrationPlan:
    """Promote blocks whose counter crosses ``hot_threshold``, bounded by
    the free fast-tier slots (int or scalar tensor)."""
    counts, ids = _top_k(est_counts, min(int(max_moves),
                                         est_counts.shape[0]))
    rank = torch.arange(counts.shape[0], device=counts.device)
    return _plan((counts >= hot_threshold) & (rank < free_slots), ids)


def ewma_eager(alpha: float, x: torch.Tensor,
               prev: torch.Tensor) -> torch.Tensor:
    """``alpha * x + (1 - alpha) * prev`` in float32, each op rounded on its
    own as in the reference's eager :func:`proactive_ewma` (unlike
    :func:`ewma`, which mirrors its fused form)."""
    return alpha * x.to(torch.float32) + (1.0 - alpha) * prev


def proactive_ewma(prev_pred: torch.Tensor, est_counts: torch.Tensor, k: int,
                   alpha: float = 0.5,
                   ) -> Tuple[torch.Tensor, MigrationPlan]:
    """EWMA trend prediction per block; promote the blocks predicted hot
    (:func:`ewma_eager`).  ``pred`` is non-negative, so its float32 bits
    order like its values."""
    pred = ewma_eager(alpha, est_counts, prev_pred)
    _, ids = _top_k(selectk.sortable_key(pred), min(k, pred.shape[0]))
    return pred, _plan(pred[ids.to(torch.int64)] > 0, ids)


def stable_rank(x: torch.Tensor) -> torch.Tensor:
    """``argsort(argsort(x))`` with stable sorts: each element's position
    in ascending order, ties by index (int64)."""
    return torch.argsort(torch.argsort(x, stable=True), stable=True)


def hinted_score_eager(est_counts: torch.Tensor, t_rank: torch.Tensor,
                       hint_rank: torch.Tensor,
                       hint_weight: float) -> torch.Tensor:
    """:func:`hinted_score` as the reference computes it outside ``jit``
    (its eager ``hinted`` and its quota path's hinted key): every op rounds
    on its own in float32 — ``t_rank / (n - 1)`` a true division, then the
    product with ``1 - w``, then ``w * hint``, then the sum.  The divisor is
    a tensor, not a Python scalar: on a CUDA tensor PyTorch turns division
    by a scalar into a product with its reciprocal."""
    n = est_counts.shape[0]
    t = t_rank.to(torch.float32)
    q = t / torch.full_like(t, float(max(n - 1, 1)))
    score = (1.0 - hint_weight) * q + hint_weight * hint_rank
    eligible = (est_counts > 0) | (hint_rank > 0)
    return torch.where(eligible, score, -1.0)


def hinted(est_counts: torch.Tensor, hint_rank: torch.Tensor, k: int,
           hint_weight: float = 0.25) -> MigrationPlan:
    """Blend the telemetry rank with a static priority ``hint_rank`` in
    [0, 1] (:func:`hinted_score_eager`); blocks with neither telemetry nor
    a hint score -1 and are never promoted."""
    score = hinted_score_eager(est_counts, stable_rank(est_counts),
                               hint_rank, hint_weight)
    _, ids = _top_k(selectk.sortable_key(score), min(k, score.shape[0]))
    return _plan(score[ids.to(torch.int64)] >= 0, ids)


def prefetch(lookahead_rank: torch.Tensor, k: int) -> MigrationPlan:
    """Promote the blocks the lookahead window says the next epoch touches,
    heaviest first; rank 0 (outside the window) is never promoted."""
    _, ids = _top_k(selectk.sortable_key(lookahead_rank),
                    min(k, lookahead_rank.shape[0]))
    return _plan(lookahead_rank[ids.to(torch.int64)] > 0, ids)


# =============================================  fused-step helpers


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
                 hint_rank: torch.Tensor, hint_weight: float,
                 n_blocks: Optional[int] = None) -> torch.Tensor:
    """The hinted lane's blended score
    ``(1 - w) * t_rank / (n - 1) + w * hint_rank``: telemetry rank mixed
    with the static priority in rank space, and a -1 sentinel for blocks
    with neither telemetry nor a hint.

    Held bit-identical to the reference's fused (jit) step, where XLA
    folds the division into the float32 constant
    ``C = f32(f32(1 - w) * f32(1 / (n - 1)))`` and contracts the first
    product into a fused multiply-add: ``fma(t_rank, C, f32(w * hint))``.
    (The reference's eager call rounds each op separately and differs in
    the last bit on a few percent of elements.)  ``n_blocks`` is the
    length of the block axis the rank counts over (a sharded rank's inputs
    are its slice of it; default ``est_counts``' length)."""
    n = est_counts.shape[0] if n_blocks is None else int(n_blocks)
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


def quality_estimate(observed_mass: torch.Tensor,
                     expected_mass: torch.Tensor) -> torch.Tensor:
    """Per-collector signal quality: the share of the expected epoch access
    mass the collector's served estimate reported, clipped to [0, 1] (both
    float32 tensors; a true float32 division, as the reference's)."""
    return torch.clamp(observed_mass / torch.clamp_min(expected_mass, 1.0),
                       0.0, 1.0)


def quality_smooth(prev_q: torch.Tensor, raw_q: torch.Tensor, beta: float,
                   fma_on_prev) -> torch.Tensor:
    """EWMA of the raw quality signal, ``beta * raw + (1 - beta) * prev``,
    in the form the reference's fused epoch step computes each element in
    (the step's fusion on jax 0.9.0 x86 XLA:CPU), picked per element by
    ``fma_on_prev`` (a bool or a bool tensor broadcast against ``prev_q``):

    - ``True``: ``fma(1 - beta, prev, f32(beta * raw))``, the product on
      the carried state contracted: quality elements 0 (HMU) and 2 (NB);
    - ``False``: ``fma(beta, raw, f32((1 - beta) * prev))``: quality
      element 1 (PEBS) and NB's smoothed fault mass ``nb_ewma``.

    The two forms differ in the last bit unless both products are exact,
    as at the default ``beta = 0.5``."""
    def on_prev():
        return fma_f32(torch.full_like(prev_q, 1.0 - beta), prev_q,
                       beta * raw_q)

    def on_raw():
        return fma_f32(torch.full_like(raw_q, beta), raw_q,
                       (1.0 - beta) * prev_q)

    if isinstance(fma_on_prev, bool):
        return on_prev() if fma_on_prev else on_raw()
    return torch.where(fma_on_prev, on_prev(), on_raw())


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
