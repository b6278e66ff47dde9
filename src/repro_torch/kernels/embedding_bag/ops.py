"""Public wrapper for embedding_bag: dispatch by the tensor's device (a CUDA
tensor launches the kernel, a CPU tensor runs the plain version)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..dispatch import DEFAULT_BACKEND, KernelBackend, use_kernel
from .kernel import embedding_bag_cuda
from .ref import embedding_bag_ref


def embedding_bag(
    storage: torch.Tensor,                  # (N, D) float32 / bfloat16
    indices: torch.Tensor,                  # (B, L) row ids
    counts: torch.Tensor,                   # (n_blocks,) int32 carry-in
    weights: Optional[torch.Tensor] = None,     # (B, L), default ones
    *,
    block_rows: int,
    backend: KernelBackend = DEFAULT_BACKEND,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched (weighted) embedding bag with fused HMU counters ->
    (pooled (B, D), new_counts)."""
    if weights is None:
        weights = torch.ones(indices.shape, dtype=torch.float32,
                             device=indices.device)
    if not use_kernel(storage, backend):
        return embedding_bag_ref(storage, indices, weights, counts,
                                 block_rows=block_rows)
    return embedding_bag_cuda(
        storage.contiguous(), indices.to(torch.int32).contiguous(),
        weights.to(torch.float32).contiguous(), counts.to(torch.int32),
        block_rows=block_rows)
