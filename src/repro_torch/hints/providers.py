"""Hint providers — the compiler/dataloader side of the §VI hint triad.

The paper's HMU case rests on reactive placement, proactive movement, and
*compiler hints*.  Until now the ``hinted`` lane consumed caller-provided
oracle ranks; these providers derive per-block ``hint_rank`` arrays in [0,1]
from what a compiler/dataloader legitimately knows about the workload:

* :class:`StaticTableHints` — static analysis of the embedding-table
  *structure*: the compiler laid the rows out, so it knows which popularity
  rank lands on which page (the table layout) and the row-popularity prior
  (the Zipf skew of the training distribution), including how
  ``rows_per_page`` rows alias into one page.  It knows **nothing** about
  runtime phase rotations — after a :class:`~repro_torch.dlrm.datagen.
  PhaseShiftSampler` rotation its ranks point at the *old* hot head, which is
  exactly the failure mode the lookahead provider and the phase detector
  exist to cover.
* :class:`LookaheadWindow` — the "compiler knows the next minibatch's
  indices" model: a bounded queue of upcoming epoch batch arrays (the
  dataloader's prefetch queue), histogrammed and normalized.  This is what
  drives the ``prefetch`` policy lane.
* :class:`PhaseChangeDetector` — an EWMA over the epoch's host-side access
  histogram; a similarity collapse against the EWMA flags a hot-set rotation
  and permanently down-weights the static hints (their layout prior is stale
  from that point on).

Everything here is host-side numpy *by design*: providers model the
compiler/dataloader, which sees batch queues before they are dispatched.  The
resulting rank arrays ride into the fused epoch step as inputs — a transfer,
not a dispatch.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Optional, Sequence, Union

import numpy as np

from ..dlrm.datagen import DLRMTraceSpec

__all__ = ["HintLayout", "StaticTableHints", "LookaheadWindow",
           "PhaseChangeDetector", "epoch_histogram"]

# One-entry memo: with depth-1 lookahead the SAME epoch array is histogrammed
# twice — by the window at step e-1 (as lookahead) and by the detector at
# step e.  Keyed by weakref identity so a freed-and-reused address can never
# serve a stale histogram, PLUS an O(1) content fingerprint so a dataloader
# that refills one preallocated buffer in place (same object, new epoch)
# invalidates the entry instead of silently replaying the old histogram
# (which would blind the phase detector to a rotation).  The fingerprint
# samples a fixed handful of elements — a refill that happens to match all
# of them is vanishingly unlikely but not impossible, so callers that mutate
# buffers in place and need a hard guarantee should pass fresh arrays.
_hist_memo = (None, 0, None, None)      # (weakref, n_blocks, fingerprint, hist)


def _fingerprint(arr: np.ndarray):
    flat = arr.reshape(-1)
    step = max(flat.size // 8, 1)
    return (arr.shape, arr.dtype.str, flat[::step].tobytes(),
            flat[-1:].tobytes())


def epoch_histogram(batches: np.ndarray, n_blocks: int) -> np.ndarray:
    """Per-block float64 access histogram of one epoch's batches (ids outside
    [0, n_blocks) dropped).  Callers must not mutate the result."""
    global _hist_memo
    batches = np.asarray(batches)
    ref, n, fp, h = _hist_memo
    if (ref is not None and ref() is batches and n == n_blocks
            and fp == _fingerprint(batches)):
        return h
    h = np.bincount(batches.ravel(),
                    minlength=n_blocks)[:n_blocks].astype(np.float64)
    try:
        _hist_memo = (weakref.ref(batches), n_blocks,
                      _fingerprint(batches), h)
    except TypeError:                    # non-weakrefable input: skip memo
        pass
    return h


@dataclasses.dataclass(frozen=True)
class HintLayout:
    """What a compiler knows *statically* about a scenario's block space.

    The workload-agnostic contract between a scenario (see
    :mod:`repro_torch.scenarios`) and the hint providers: how many blocks there
    are, which popularity rank the compiler laid out on which block
    (``rank_to_page``), the skew of the popularity prior (``alpha``) and how
    many sub-blocks alias into one block (``rows_per_page`` — embedding rows
    per page for DLRM; 1 when blocks are the access granularity).

    ``rank_to_page=None`` means the scenario has no static layout at all —
    hotness is runtime-only, as for a KV cache whose per-page attention mass
    depends on the decoded text.  Pipelines built from such a layout run
    lookahead-only (:meth:`~repro_torch.hints.HintPipeline.for_scenario`).
    """
    n_blocks: int
    rank_to_page: Optional[np.ndarray] = None
    alpha: float = 1.0
    rows_per_page: int = 1


class StaticTableHints:
    """Per-page hint ranks from a block space's compile-time structure.

    Page weight = sum of the row-level Zipf(alpha) prior over the
    ``rows_per_page`` rows aliased into that page (page-granular telemetry
    cannot separate rows that share a page; neither can a page hint), mapped
    through ``rank_to_page`` (the layout: which popularity rank the compiler
    placed on which page) and normalized so the hottest page ranks 1.0.

    The first argument is either a :class:`HintLayout` (the workload-agnostic
    form the scenario layer uses) or a DLRM trace spec plus its
    ``rank_to_page`` array (the original DLRM-shaped call, kept working).

    ``clip_rank`` keeps only the hottest ``clip_rank`` pages' hints and zeroes
    the tail — a compiler annotates the hot head, not five million pages.
    """

    def __init__(self, spec: Union[DLRMTraceSpec, HintLayout],
                 rank_to_page: Optional[np.ndarray] = None,
                 clip_rank: Optional[int] = None):
        if isinstance(spec, HintLayout):
            if rank_to_page is not None:
                raise ValueError("pass the layout's rank_to_page inside the "
                                 "HintLayout, not as a second argument")
            layout = spec
        else:
            layout = HintLayout(spec.n_pages, rank_to_page,
                                alpha=spec.alpha,
                                rows_per_page=spec.rows_per_page)
        n = layout.n_blocks
        if layout.rank_to_page is None:
            raise ValueError("static hints need a rank_to_page layout; "
                             "use a lookahead-only pipeline for scenarios "
                             "without one")
        rank_to_page = np.asarray(layout.rank_to_page)
        if rank_to_page.shape != (n,):
            raise ValueError(f"rank_to_page must be ({n},), "
                             f"got {rank_to_page.shape}")
        if clip_rank is not None and clip_rank < 1:
            raise ValueError(f"clip_rank must be >= 1 (clipping every hint "
                             f"makes the rank 0/0), got {clip_rank}")
        rpp = max(layout.rows_per_page, 1)
        # row-level prior aggregated per page-popularity rank: the page with
        # popularity rank r aliases rows [r*rpp, (r+1)*rpp); accumulated one
        # row-offset at a time so paper-scale tables (n*rpp ~ 20M rows) never
        # materialize an n*rpp-sized temporary
        base = np.arange(n, dtype=np.float64) * rpp
        page_w = np.zeros((n,), np.float64)
        for j in range(1, rpp + 1):
            page_w += (base + j) ** (-layout.alpha)
        if clip_rank is not None:
            page_w[int(clip_rank):] = 0.0
        rank = np.zeros((n,), np.float32)
        rank[rank_to_page] = (page_w / page_w[0]).astype(np.float32)
        self.spec = spec
        self.layout = layout
        self.rank = rank

    def __call__(self) -> np.ndarray:
        return self.rank


class LookaheadWindow:
    """Bounded lookahead over the dataloader's batch queue.

    ``rank(upcoming)`` histograms up to ``depth`` upcoming epoch batch arrays
    (nearer epochs weighted by ``decay**distance``) and normalizes to [0,1];
    blocks outside the window rank 0 and are never prefetched.  An empty
    queue (end of stream) yields all-zeros — the prefetch lane goes idle.
    """

    def __init__(self, n_blocks: int, depth: int = 1, decay: float = 0.5):
        if depth < 1:
            raise ValueError(f"lookahead depth must be >= 1, got {depth}")
        self.n_blocks = int(n_blocks)
        self.depth = int(depth)
        self.decay = float(decay)
        # single cached empty rank, so an idle window returns the SAME object
        # every epoch and the runtime's identity-skip avoids re-uploading it
        self._zeros = np.zeros((self.n_blocks,), np.float32)

    def rank(self, upcoming: Sequence[np.ndarray]) -> np.ndarray:
        counts = np.zeros((self.n_blocks,), np.float64)
        for d, batches in enumerate(upcoming[: self.depth]):
            counts += (self.decay ** d) * epoch_histogram(batches,
                                                          self.n_blocks)
        top = counts.max()
        if top <= 0.0:
            return self._zeros
        return (counts / top).astype(np.float32)


class PhaseChangeDetector:
    """EWMA phase-change detector: re-weights static hints after rotations.

    Tracks an EWMA of the epoch's access histogram (the dataloader's own view
    of the batches it just queued — no telemetry readback) and compares each
    new epoch against it by cosine similarity.  A drop below ``threshold``
    flags a hot-set rotation: the static-hint scale is multiplied by
    ``penalty`` (the layout prior is stale from now on — there is no recovery
    path, a rotated workload does not rotate back on its own) and the EWMA
    snaps to the new phase so one rotation is detected once, not every epoch.
    """

    def __init__(self, n_blocks: int, alpha: float = 0.5,
                 threshold: float = 0.6, penalty: float = 0.25):
        self.n_blocks = int(n_blocks)
        self.alpha = float(alpha)
        self.threshold = float(threshold)
        self.penalty = float(penalty)
        self.scale = 1.0
        self.shifts_detected = 0
        self._ewma: Optional[np.ndarray] = None

    def update(self, batches: np.ndarray) -> float:
        """Fold one epoch's batches in; returns the current static-hint scale."""
        h = epoch_histogram(batches, self.n_blocks)
        if self._ewma is None:
            self._ewma = h
            return self.scale
        denom = np.linalg.norm(self._ewma) * np.linalg.norm(h)
        sim = float(self._ewma @ h / denom) if denom > 0.0 else 1.0
        if sim < self.threshold:
            self.shifts_detected += 1
            self.scale *= self.penalty
            self._ewma = h
        else:
            self._ewma = self.alpha * h + (1.0 - self.alpha) * self._ewma
        return self.scale
