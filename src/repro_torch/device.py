"""Host<->device transfers the epoch loop may make without a host sync.

A pageable host->device copy makes the host wait for the copy to finish
(``torch.cuda.set_sync_debug_mode`` flags it), so every upload on the loop's
path goes through pinned memory with ``non_blocking=True``; and the one
device->host transfer, the record pull, runs under :func:`sync_allowed`.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["sync_allowed", "upload"]


def upload(x, device: torch.device) -> torch.Tensor:
    """Copy a host array to ``device`` without stalling the host (always a
    copy: the result never aliases the caller's array)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":                  # pin_memory() is the copy
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


@contextlib.contextmanager
def sync_allowed(device: torch.device):
    """Lift a caller's ``set_sync_debug_mode`` for one deliberate sync."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)
