"""Synthetic DLRM embedding access traces calibrated to the Meta dataset stats.

Paper (§III.B, Meta production dataset): a typical split table holds 5.12 B
parameters = 20.48 GB; ~2.95 GB of weights are touched per pass => ~14 % of
parameters utilized — a sparse, heavy-tailed popularity distribution.

We model row popularity as Zipf(alpha) over pages (rank randomly assigned to
page ids, as embedding row ids carry no popularity order), with alpha chosen
so the top-K pages (K = the paper's promoted count, ~9 % of pages) carry
~97 % of lookups — the regime in which Table 1's numbers are self-consistent
(HMU within 3 % of DRAM-only while >90 % of pages stay in CXL).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

PAGE_BYTES = 4096


@dataclasses.dataclass(frozen=True)
class DLRMTraceSpec:
    n_params: int = 5_120_000_000       # 5.12 B parameters (fp32)
    emb_dim: int = 256                  # row = 1 KiB
    alpha: float = 1.31                 # Zipf skew (calibrated, see module doc)
    lookups_per_batch: int = 2_400_000  # ~2.4 GB row traffic / inference batch
    page_bytes: int = PAGE_BYTES
    param_bytes: int = 4                # fp32 embeddings

    @property
    def row_bytes(self) -> int:
        return self.emb_dim * self.param_bytes

    @property
    def n_rows(self) -> int:
        return self.n_params // self.emb_dim

    @property
    def rows_per_page(self) -> int:
        return self.page_bytes // self.row_bytes

    @property
    def n_pages(self) -> int:
        return self.n_rows // self.rows_per_page

    @property
    def table_bytes(self) -> int:
        return self.n_params * self.param_bytes

    @property
    def k_hot_paper(self) -> int:
        """The paper's HMU promoted-page count (Table 1)."""
        return 486_587


# Reduced spec for tests: ~5000 pages, same skew.
SMALL = DLRMTraceSpec(n_params=5_120_000, lookups_per_batch=40_000)
PAPER = DLRMTraceSpec()


class ZipfPageSampler:
    """Zipf(alpha) over pages with rank->page-id shuffling, inverse-CDF
    sampling.  Deterministic given seed."""

    def __init__(self, spec: DLRMTraceSpec, seed: int = 0):
        self.spec = spec
        n = spec.n_pages
        rng = np.random.default_rng(seed)
        ranks = np.arange(1, n + 1, dtype=np.float64)
        w = ranks ** (-spec.alpha)
        self.cdf = np.cumsum(w)
        self.cdf /= self.cdf[-1]
        # popularity rank -> page id (ids carry no popularity order)
        self.rank_to_page = rng.permutation(n).astype(np.int32)
        self._rng = np.random.default_rng(seed + 1)

    def sample(self, n: int) -> np.ndarray:
        u = self._rng.random(n)
        rank = np.searchsorted(self.cdf, u)
        return self.rank_to_page[rank]

    def true_top_k_pages(self, k: int) -> np.ndarray:
        return self.rank_to_page[:k]

    def page_probabilities(self) -> np.ndarray:
        p = np.empty_like(self.cdf)
        p[0] = self.cdf[0]
        p[1:] = np.diff(self.cdf)
        out = np.empty_like(p)
        out[self.rank_to_page] = p
        return out


def batches(spec: DLRMTraceSpec, n_batches: int, seed: int = 0) -> Iterator[np.ndarray]:
    s = ZipfPageSampler(spec, seed)
    for _ in range(n_batches):
        yield s.sample(spec.lookups_per_batch)


class PhaseShiftSampler:
    """Zipf popularity whose hot set *rotates* between phases.

    Phase ``p`` maps popularity rank ``r`` to page
    ``rank_to_page[(r + p * rotate_by) % n_pages]`` — same skew, disjoint(ish)
    hot head each phase.  This is the workload where frequency-tracking
    telemetry driven per-epoch (proactive/EWMA over HMU counts) should win
    and recency-based NB collapses: NB's cumulative two-touch faults keep
    ranking the *previous* phase's pages hot, while an epoch-delta counter
    re-ranks within one epoch of the shift (the NeoMem / HybridTier
    phase-change regime).
    """

    def __init__(self, spec: DLRMTraceSpec, rotate_by: Optional[int] = None,
                 seed: int = 0):
        self.spec = spec
        self._base = ZipfPageSampler(spec, seed)
        n = spec.n_pages
        # rotations are modular, so rotate_by >= n_pages wraps (rotate_by == n
        # is the identity rotation) rather than indexing out of bounds
        self.rotate_by = int(rotate_by) if rotate_by is not None else n // 3
        self._rng = np.random.default_rng(seed + 2)

    @property
    def rank_to_page(self) -> np.ndarray:
        """Phase-0 popularity-rank -> page-id layout (what a compiler that
        laid the table out knows; see ``repro_torch.hints.StaticTableHints``)."""
        return self._base.rank_to_page

    def sample(self, n: int, phase: int = 0) -> np.ndarray:
        u = self._rng.random(n)
        rank = np.searchsorted(self._base.cdf, u)
        shifted = (rank + phase * self.rotate_by) % self.spec.n_pages
        return self._base.rank_to_page[shifted]

    def true_top_k_pages(self, k: int, phase: int = 0) -> np.ndarray:
        n = self.spec.n_pages
        ranks = (np.arange(k) + phase * self.rotate_by) % n
        return self._base.rank_to_page[ranks]

    def page_probabilities(self, phase: int = 0) -> np.ndarray:
        """Per-page access probability during ``phase`` (the base Zipf mass
        rotated onto that phase's pages)."""
        n = self.spec.n_pages
        p = self._base.page_probabilities()[self._base.rank_to_page]  # by rank
        shifted = (np.arange(n) + phase * self.rotate_by) % n
        out = np.empty_like(p)
        out[self._base.rank_to_page[shifted]] = p
        return out


def phase_shift_epochs(
    spec: DLRMTraceSpec,
    n_epochs: int,
    batches_per_epoch: int,
    shift_at: int,
    rotate_by: Optional[int] = None,
    seed: int = 0,
) -> Iterator[np.ndarray]:
    """Epoch-shaped stream ``(batches_per_epoch, lookups_per_batch)`` whose
    hot set rotates once at epoch ``shift_at`` (phase 0 before, 1 after)."""
    s = PhaseShiftSampler(spec, rotate_by=rotate_by, seed=seed)
    for e in range(n_epochs):
        phase = int(e >= shift_at)
        yield np.stack([s.sample(spec.lookups_per_batch, phase=phase)
                        for _ in range(batches_per_epoch)])


def _distribution_stats(spec: DLRMTraceSpec, probs: np.ndarray,
                        n_batches: int) -> dict:
    p = np.sort(probs)[::-1]
    total_lookups = spec.lookups_per_batch * n_batches
    exp_unique = float(np.sum(1.0 - np.exp(-total_lookups * p)))
    k = min(spec.k_hot_paper, spec.n_pages)
    return {
        "table_gb": spec.table_bytes / 1e9,
        "touched_fraction": exp_unique / spec.n_pages,
        "touched_gb": exp_unique * spec.page_bytes / 1e9,
        "topk_traffic_share": float(p[:k].sum()),
        "traffic_gb_per_batch": spec.lookups_per_batch * spec.row_bytes / 1e9,
    }


def trace_stats(spec: DLRMTraceSpec, n_batches: int = 20, seed: int = 0,
                phases: Optional[int] = None,
                rotate_by: Optional[int] = None) -> dict:
    """Measured analogues of the paper's dataset stats (computed analytically
    from the popularity distribution; exact in expectation).

    With ``phases`` the trace is a :class:`PhaseShiftSampler` and the result
    gains a ``"phases"`` list with the hot-head drift each rotation causes —
    ``hot_overlap_prev`` / ``hot_overlap_phase0`` (fraction of the hot head
    of size ``k_head`` shared with the previous phase / phase 0; 1.0 means
    the rotation wrapped to an identity, 0.0 a fully disjoint hot head).
    The distribution stats are reported once: a rotation only permutes the
    same Zipf mass onto a different support, so they are identical in every
    phase.  The head is the paper's promoted count capped at a tenth of the
    table, so the drift stays meaningful for reduced specs whose page count
    is below ``k_hot_paper``.  ``rotate_by`` is modular, so values >=
    ``n_pages`` wrap."""
    if phases is None:
        s = ZipfPageSampler(spec, seed)
        return _distribution_stats(spec, s.page_probabilities(), n_batches)
    ps = PhaseShiftSampler(spec, rotate_by=rotate_by, seed=seed)
    k = min(spec.k_hot_paper, max(spec.n_pages // 10, 1))
    out = _distribution_stats(spec, ps.page_probabilities(0), n_batches)
    out["rotate_by"] = ps.rotate_by
    out["k_head"] = k
    out["phases"] = []
    hot0 = prev = ps.true_top_k_pages(k, phase=0)
    for phase in range(int(phases)):
        hot = ps.true_top_k_pages(k, phase=phase)
        out["phases"].append({
            "phase": phase,
            "hot_overlap_prev": float(np.intersect1d(hot, prev).size / k),
            "hot_overlap_phase0": float(np.intersect1d(hot, hot0).size / k),
        })
        prev = hot
    return out
