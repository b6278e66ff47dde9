"""Public wrapper for hist_select: dispatch by the tensor's device.

``kth_key`` is the primitive ``selectk`` plugs in: per row and per static
segment, the k-th largest key.  A CUDA tensor launches the kernel (which
masks its own ragged edge, so nothing is padded); a CPU tensor runs the
plain sort.  The reference's ``MAX_N`` bound was an f32-accumulation
artefact of the TPU's matrix unit; the kernel's counts are int32, so the
port has none.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..dispatch import DEFAULT_BACKEND, KernelBackend, use_kernel
from .kernel import kth_key_cuda
from .ref import kth_key_ref


def kth_key(keys: torch.Tensor, seg_ids: Optional[torch.Tensor],
            ks: Sequence[int], *,
            backend: KernelBackend = DEFAULT_BACKEND) -> torch.Tensor:
    """(B, n) int32 keys -> (B, S) int64 u-domain thresholds (segment s's
    ``ks[s]``-th largest key; ``0 <= ks[s] <= |segment s|``)."""
    if not use_kernel(keys, backend):
        return kth_key_ref(keys, seg_ids, ks)
    return kth_key_cuda(
        keys.to(torch.int32).contiguous(),
        None if seg_ids is None else seg_ids.to(torch.int32).contiguous(),
        ks)
