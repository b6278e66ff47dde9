"""Public wrapper for observe_scatter: dispatch by the tensor's device.

A CUDA tensor launches the kernel (which masks its own ragged edge, so
nothing is padded); a CPU tensor runs the plain version.  Unlike the
reference there is no ``MAX_BLOCKS``: that was a VMEM limit, and the
kernel's hashed table takes any ``n_blocks``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..dispatch import DEFAULT_BACKEND, KernelBackend, use_kernel
from .kernel import observe_scatter_cuda
from .ref import observe_scatter_ref


def observe_scatter(
    ids: torch.Tensor,                  # (M,) int32 block ids
    cursor: torch.Tensor,               # () int32 PEBS position mod period
    *,
    n_blocks: int,
    period: int,
    keep: Optional[torch.Tensor] = None,   # (M,) bool survival mask
    backend: KernelBackend = DEFAULT_BACKEND,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused epoch-batch telemetry scatter -> (hist, pebs_hist)."""
    flat = ids.reshape(-1)
    if not use_kernel(flat, backend):
        return observe_scatter_ref(flat, cursor, n_blocks=n_blocks,
                                   period=period, keep=keep)
    return observe_scatter_cuda(
        flat.to(torch.int32).contiguous(), cursor.reshape(1),
        n_blocks=n_blocks, period=period,
        keep=None if keep is None else keep.reshape(-1).to(torch.bool)
        .contiguous())
