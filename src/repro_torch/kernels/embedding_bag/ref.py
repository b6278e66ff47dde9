"""Plain PyTorch version of embedding_bag: ``index_select`` of the bag rows,
an ``einsum("bl,bld->bd")`` in float32 cast to the storage dtype, and an
``index_add_`` of one per looked-up row into its block's counter (the
reference's ``ref.py``)."""
from __future__ import annotations

from typing import Tuple

import torch


def embedding_bag_ref(
    storage: torch.Tensor,   # (N, D)
    indices: torch.Tensor,   # (B, L) row ids, 0 <= id < N
    weights: torch.Tensor,   # (B, L)
    counts: torch.Tensor,    # (n_blocks,) int32
    *,
    block_rows: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (pooled (B, D) in storage's dtype, counts + per-block hits)."""
    b, l = indices.shape
    idx = indices.reshape(-1).to(torch.int64)
    rows = storage.index_select(0, idx).to(torch.float32).reshape(
        b, l, storage.shape[1])
    out = torch.einsum("bl,bld->bd", weights.to(torch.float32), rows)
    blk = torch.div(idx, block_rows, rounding_mode="floor")
    new_counts = counts.to(torch.int32).clone()
    new_counts.index_add_(0, blk, torch.ones_like(blk, dtype=torch.int32))
    return out.to(storage.dtype), new_counts
