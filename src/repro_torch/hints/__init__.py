"""repro_torch.hints — compiler-derived hint providers + per-epoch hint pipeline.

The third leg of the paper's §VI triad (reactive placement, proactive
movement, **compiler hints**): providers that derive ``hint_rank`` arrays
from the workload's structure and the dataloader's batch queue instead of a
caller-supplied oracle, and the :class:`HintPipeline` that refreshes them
into the :class:`~repro_torch.core.runtime.EpochRuntime` every epoch without
breaking its 2-dispatch/epoch invariant.
"""
from .pipeline import HintPipeline
from .providers import (HintLayout, LookaheadWindow, PhaseChangeDetector,
                        StaticTableHints)

__all__ = [
    "HintLayout", "HintPipeline", "LookaheadWindow", "PhaseChangeDetector",
    "StaticTableHints",
]
