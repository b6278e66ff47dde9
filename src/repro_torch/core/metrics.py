"""Hotness/placement quality metrics — the quantities in Fig. 3 and §III.

Definitions match the paper's usage:

* accuracy(promoted | true hot set): of the blocks a strategy promoted, what
  fraction are truly hot ("PEBS achieved 87% accuracy confirmed by HMU").
* coverage(promoted | K): what fraction of the true top-K a strategy promoted
  ("it only promoted 6% of K pages as hot").
* overlap(A, B): |A ∩ B| / K for two promotion sets ("75% overlap between NB
  and HMU selections").
"""
from __future__ import annotations

import numpy as np


def _valid(ids) -> np.ndarray:
    a = np.asarray(ids).reshape(-1)
    return np.unique(a[a >= 0])


def true_top_k(true_counts, k: int) -> np.ndarray:
    """Top-k with deterministic (stable, lowest-index-first) tie-break, so a
    collector that sees the exact stream selects the identical set."""
    c = np.asarray(true_counts)
    k = min(k, c.shape[0])
    return np.argsort(-c, kind="stable")[:k]


def accuracy(promoted, true_hot) -> float:
    p, t = _valid(promoted), _valid(true_hot)
    if p.size == 0:
        return 0.0
    return float(np.intersect1d(p, t).size / p.size)


def coverage(promoted, true_hot, k: int | None = None) -> float:
    p, t = _valid(promoted), _valid(true_hot)
    denom = k if k is not None else t.size
    if denom == 0:
        return 0.0
    return float(np.intersect1d(p, t).size / denom)


def overlap(promoted_a, promoted_b, k: int | None = None) -> float:
    a, b = _valid(promoted_a), _valid(promoted_b)
    denom = k if k is not None else max(min(a.size, b.size), 1)
    return float(np.intersect1d(a, b).size / denom)


def hotness_cdf(counts, n_points: int = 100):
    """Fig. 3: fraction of accesses covered by the hottest x% of (accessed)
    pages.  Returns (page_fraction, access_fraction) arrays."""
    c = np.asarray(counts, np.float64)
    c = c[c > 0]
    if c.size == 0:
        return np.zeros(1), np.zeros(1)
    c.sort()
    c = c[::-1]
    cum = np.cumsum(c) / c.sum()
    xs = np.linspace(0, 1, n_points + 1)[1:]
    idx = np.clip((xs * c.size).astype(int) - 1, 0, c.size - 1)
    return xs, cum[idx]


def pages_for_access_fraction(counts, frac: float) -> float:
    """Smallest fraction of accessed pages covering ``frac`` of accesses
    (paper: ~10% of pages -> ~90% of accesses)."""
    xs, cdf = hotness_cdf(counts, n_points=1000)
    hit = np.searchsorted(cdf, frac)
    return float(xs[min(hit, xs.size - 1)])
