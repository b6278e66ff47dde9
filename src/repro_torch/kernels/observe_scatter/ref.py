"""Plain PyTorch version of observe_scatter.

Exactly the reference's per-batch ``.at[ids].add(..., mode="drop")``
scatters, reduced to their two histograms.  ``index_add_`` neither wraps
nor drops, so the drop semantics are spelled out: a negative id wraps once
(``id + n_blocks``) and anything still outside ``[0, n_blocks)`` is routed
to a spare slot past the end that is cut off.  A block range (``lo``,
``n_global``: a sharded rank's ``[lo, lo + n_blocks)``) wraps by
``n_global`` and routes every id outside the range to the spare slot.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def observe_scatter_ref(
    ids: torch.Tensor,                  # (M,) int32 block ids
    cursor: torch.Tensor,               # () int32 PEBS stream position mod period
    *,
    n_blocks: int,
    period: int,
    keep: Optional[torch.Tensor] = None,   # (M,) bool per-event survival
    lo: int = 0,
    n_global: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (hist, pebs_hist): (n_blocks,) int32 access and sampled counts
    of the bins ``lo .. lo + n_blocks - 1``."""
    flat = ids.reshape(-1).to(torch.int64)
    m = flat.shape[0]
    n_global = n_blocks if n_global is None else n_global
    blk = torch.where(flat < 0, flat + n_global, flat) - lo
    idx = torch.where((blk >= 0) & (blk < n_blocks), blk, n_blocks)
    pos = (cursor.reshape(()).to(torch.int32)
           + torch.arange(m, dtype=torch.int32, device=flat.device))
    kept = torch.remainder(pos, period) == 0
    if keep is not None:
        kept = kept & keep.reshape(-1).to(torch.bool)
    hist = torch.zeros(n_blocks + 1, dtype=torch.int32, device=flat.device)
    hist.index_add_(0, idx, torch.ones(m, dtype=torch.int32,
                                       device=flat.device))
    pebs = torch.zeros(n_blocks + 1, dtype=torch.int32, device=flat.device)
    pebs.index_add_(0, idx, kept.to(torch.int32))
    return hist[:n_blocks], pebs[:n_blocks]
