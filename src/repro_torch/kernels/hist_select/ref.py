"""Plain PyTorch version of hist_select: a sort per segment.

``kth_key_ref`` computes, per row and per segment, the k-th largest key in
the order-preserving uint32 image ``u = key + 2**31`` (the bit pattern of
``selectk._to_u``, carried as int64 because PyTorch's uint32 support is
partial) — the largest threshold ``t`` with ``count(u >= t) >= k``, which
over a set of integers is its k-th largest element.  ``k == 0`` yields the
all-ones threshold ``2**32 - 1``, as in the reference.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

ALL_ONES = 0xFFFFFFFF


def kth_key_ref(keys: torch.Tensor, seg_ids: Optional[torch.Tensor],
                ks: Sequence[int]) -> torch.Tensor:
    """(B, n) int32 keys + (n,) int32 segment ids (None: one segment) ->
    (B, S) int64 u-domain thresholds: segment s's ``ks[s]``-th largest.

    Segment ids outside [0, S) (padding: -1) belong to no segment.  Requires
    ``0 <= ks[s] <= |segment s|`` — the callers clamp."""
    u = keys.to(torch.int64) + (1 << 31)
    outs = []
    for s, k in enumerate(ks):
        k = int(k)
        if k == 0:
            outs.append(torch.full(u.shape[:1], ALL_ONES, dtype=torch.int64,
                                   device=u.device))
            continue
        # non-members sink to 0, the minimum: with k <= |segment| they never
        # displace the k-th largest member
        uu = u if seg_ids is None else torch.where(seg_ids == s, u, 0)
        outs.append(torch.sort(uu, dim=-1).values[:, -k])
    return torch.stack(outs, dim=-1)
