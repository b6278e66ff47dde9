"""Public wrapper for gather_count: dispatch by the tensor's device.

A CUDA tensor launches the kernel, which takes any M (no tile, so no
padding and none of the reference wrapper's phantom-count fix-up); a CPU
tensor runs the plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..dispatch import DEFAULT_BACKEND, KernelBackend, use_kernel
from .kernel import gather_count_cuda
from .ref import gather_count_ref


def gather_count(
    storage: torch.Tensor,      # (N, D) float32 / bfloat16
    indices: torch.Tensor,      # (M,) row ids
    counts: torch.Tensor,       # (n_blocks,) int32 carry-in
    *,
    block_rows: int,
    backend: KernelBackend = DEFAULT_BACKEND,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tier-aware gather + HMU counter update -> (rows, new_counts)."""
    if not use_kernel(storage, backend):
        return gather_count_ref(storage, indices, counts,
                                block_rows=block_rows)
    return gather_count_cuda(
        storage.contiguous(), indices.reshape(-1).to(torch.int32).contiguous(),
        counts.to(torch.int32), block_rows=block_rows)
