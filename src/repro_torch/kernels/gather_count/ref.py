"""Plain PyTorch version of gather_count: ``index_select`` of the rows and
an ``index_add_`` of one per row into its block's counter (the reference's
``jnp.take`` and ``counts.at[blk].add(1)``)."""
from __future__ import annotations

from typing import Tuple

import torch


def gather_count_ref(
    storage: torch.Tensor,   # (N, D)
    indices: torch.Tensor,   # (M,) row ids, 0 <= id < N
    counts: torch.Tensor,    # (n_blocks,) int32
    *,
    block_rows: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (rows (M, D), counts + per-block hits)."""
    idx = indices.reshape(-1).to(torch.int64)
    out = storage.index_select(0, idx)
    blk = torch.div(idx, block_rows, rounding_mode="floor")
    new_counts = counts.to(torch.int32).clone()
    new_counts.index_add_(0, blk, torch.ones_like(blk, dtype=torch.int32))
    return out, new_counts
