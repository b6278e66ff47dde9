"""HintPipeline — per-epoch hint refresh for the EpochRuntime.

One pipeline owns the three providers and turns (this epoch's batches, the
lookahead queue) into the two rank arrays the runtime's hint-consuming lanes
read:

* ``hint_rank``      — the ``hinted`` lane's static priority: the
  :class:`~repro_torch.hints.providers.StaticTableHints` ranks scaled by the
  :class:`~repro_torch.hints.providers.PhaseChangeDetector`'s current weight.
* ``prefetch_rank``  — the ``prefetch`` lane's lookahead priority from the
  :class:`~repro_torch.hints.providers.LookaheadWindow`.

The refresh is host-side (the providers model the compiler/dataloader) and
rides into the fused ``_epoch_step`` as replaced state leaves — a
host-to-device transfer, **not** a dispatch, so the 2-dispatch/epoch
invariant holds; ``runtime.DISPATCH_COUNTS["hint_refresh"]`` counts refreshes
separately so the accounting stays auditable.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np

from ..dlrm.datagen import DLRMTraceSpec, ZipfPageSampler
from .providers import (HintLayout, LookaheadWindow, PhaseChangeDetector,
                        StaticTableHints)

__all__ = ["HintPipeline"]


class HintPipeline:
    """Providers -> per-epoch ``(hint_rank, prefetch_rank)`` refresh.

    Any provider may be omitted: without ``static`` the hinted lane sees
    zeros (pure telemetry), without ``lookahead`` the prefetch lane idles,
    without ``detector`` static hints are never re-weighted.
    """

    def __init__(
        self,
        n_blocks: int,
        static: Union[StaticTableHints, np.ndarray, None] = None,
        lookahead: Optional[LookaheadWindow] = None,
        detector: Optional[PhaseChangeDetector] = None,
    ):
        self.n_blocks = int(n_blocks)
        rank = static() if callable(static) else static
        self._static_rank = (np.zeros((self.n_blocks,), np.float32)
                             if rank is None
                             else np.asarray(rank, np.float32))
        if self._static_rank.shape != (self.n_blocks,):
            raise ValueError(f"static rank must be ({self.n_blocks},), "
                             f"got {self._static_rank.shape}")
        self.lookahead = lookahead
        self.detector = detector
        # (scale, scaled array) cache: epoch_ranks returns the SAME object
        # until the detector moves the scale, so the runtime can skip the
        # host-to-device re-upload of an unchanged hint_rank by identity
        self._scaled = (1.0, self._static_rank)
        self._no_lookahead = np.zeros((self.n_blocks,), np.float32)

    @property
    def lookahead_depth(self) -> int:
        """Epochs of batch queue the runtime must buffer ahead."""
        return self.lookahead.depth if self.lookahead is not None else 0

    @property
    def static_scale(self) -> float:
        return self.detector.scale if self.detector is not None else 1.0

    def epoch_ranks(
        self, batches: np.ndarray, upcoming: Sequence[np.ndarray] = (),
    ) -> Tuple[np.ndarray, np.ndarray]:
        """One epoch's refresh: fold ``batches`` into the phase detector and
        return ``(hint_rank, prefetch_rank)`` float32 arrays in [0,1]."""
        scale = (self.detector.update(batches)
                 if self.detector is not None else 1.0)
        if scale != self._scaled[0]:
            self._scaled = (scale, self._static_rank * np.float32(scale))
        hint_rank = self._scaled[1]
        # no-lookahead pipelines hand back the static rank's zero-filled
        # sibling — also cached, so the identity-skip holds there too
        prefetch_rank = (self.lookahead.rank(upcoming)
                         if self.lookahead is not None
                         else self._no_lookahead)
        return hint_rank, prefetch_rank

    @staticmethod
    def for_scenario(
        layout: HintLayout,
        depth: int = 1,
        clip_rank: Optional[int] = None,
        detector: bool = True,
    ) -> "HintPipeline":
        """Layout-driven default pipeline — the workload-agnostic form every
        scenario uses (see :meth:`repro_torch.scenarios.AccessScenario.hint_layout`):
        static hints when the layout carries a ``rank_to_page`` map (a
        compiler that laid the blocks out), ``depth`` epochs of lookahead
        over the scenario's batch queue, and the phase detector.  A layout
        without a ``rank_to_page`` (runtime-only hotness, e.g. a KV cache)
        yields a lookahead-only pipeline: the hinted lane falls back to pure
        telemetry while the prefetch lane stays live.  ``clip_rank`` defaults
        to an eighth of the blocks — a compiler annotates the hot head only.
        """
        n = layout.n_blocks
        static = None
        if layout.rank_to_page is not None:
            clip = max(n // 8, 1) if clip_rank is None else clip_rank
            static = StaticTableHints(layout, clip_rank=clip)
        return HintPipeline(
            n,
            static=static,
            lookahead=LookaheadWindow(n, depth=depth),
            detector=PhaseChangeDetector(n) if detector else None,
        )

    @staticmethod
    def for_fleet(
        n_blocks: int,
        members: Sequence,
        depth: int = 1,
        clip_rank: Optional[int] = None,
        detector: bool = True,
    ) -> "HintPipeline":
        """Composed pipeline for a multi-tenant block space (``repro_torch.fleet``).

        ``members`` is a sequence of ``(offset, layout_or_None)`` pairs, one
        per tenant, offsets into the concatenated global id space.  Each
        tenant that has a static layout gets its *own*
        :class:`StaticTableHints` rank — computed with the tenant's own
        ``alpha``/``rows_per_page`` prior and its own clip, then scattered
        into the global array at the tenant's offset.  Tenants are NOT
        concatenated in rank space: a global Zipf prior over concatenated
        ranks would push every later tenant's pages under the first
        tenant's tail (and the default clip would zero them outright), so
        each tenant's compiler annotates its own hot head and the scales
        stay comparable (every tenant's hottest block ranks 1.0).  Tenants
        without a layout contribute zeros — their hinted-lane share falls
        back to pure telemetry, exactly as solo.  The lookahead window and
        phase detector span the whole fleet stream (the dataloader queues
        the interleaved batches, so that IS what the compiler sees).
        ``clip_rank`` applies per tenant (default: an eighth of the
        *tenant's* blocks)."""
        static = np.zeros((int(n_blocks),), np.float32)
        any_static = False
        for offset, layout in members:
            if layout is None or layout.rank_to_page is None:
                continue
            clip = (max(layout.n_blocks // 8, 1) if clip_rank is None
                    else min(int(clip_rank), layout.n_blocks))
            rank = StaticTableHints(layout, clip_rank=clip).rank
            static[int(offset):int(offset) + layout.n_blocks] = rank
            any_static = True
        return HintPipeline(
            int(n_blocks),
            static=static if any_static else None,
            lookahead=LookaheadWindow(int(n_blocks), depth=depth),
            detector=PhaseChangeDetector(int(n_blocks)) if detector else None,
        )

    @staticmethod
    def for_dlrm(
        spec: DLRMTraceSpec,
        seed: int = 0,
        depth: int = 1,
        clip_rank: Optional[int] = None,
        detector: bool = True,
        layout: Optional[np.ndarray] = None,
    ) -> "HintPipeline":
        """Default pipeline for a DLRM trace — :meth:`for_scenario` on the
        table's :class:`~repro_torch.hints.HintLayout`: static hints from the table
        structure (``layout`` = the trace sampler's rank->page map — the
        compiler that laid the table out; pass the actual sampler's
        ``rank_to_page`` when you have it, e.g.
        ``PhaseShiftSampler.rank_to_page``, else the ``seed``'s
        :class:`ZipfPageSampler` layout is rebuilt here), one-epoch
        lookahead, and the phase detector."""
        if layout is None:
            layout = ZipfPageSampler(spec, seed).rank_to_page
        return HintPipeline.for_scenario(
            HintLayout(spec.n_pages, rank_to_page=layout, alpha=spec.alpha,
                       rows_per_page=spec.rows_per_page),
            depth=depth, clip_rank=clip_rank, detector=detector,
        )
