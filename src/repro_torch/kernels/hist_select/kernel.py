"""ctypes wrapper around ``csrc/hist_select.cu`` (see the note there for what
it replaces, what bounds it and how).

The wrapper checks its inputs, allocates the output and the scratch (the
``(B, S)`` search state, and the zeroed ``(B, S, 3, bins)`` global bins,
``(B,)`` tickets and the passes' lists of open rows), launches on the
current stream and raises if the launch failed.  The per-segment widths reach the kernel as one
device tensor cached per static ``ks`` tuple (uploaded once, from pinned
memory), so a call makes no host->device copy.  ``LAUNCHES`` counts the
calls that launched.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ...device import upload
from .. import _build

__all__ = ["LAUNCHES", "kth_key_cuda", "max_segments"]

LAUNCHES = 0

_P = ctypes.c_void_p
_KS_CACHE: Dict[Tuple[Tuple[int, ...], torch.device], torch.Tensor] = {}


def _lib() -> ctypes.CDLL:
    lib = _build.load("hist_select")
    if not getattr(lib, "_typed", False):
        lib.hist_select_launch.argtypes = [
            _P, _P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            _P, _P, _P, _P, _P, _P]
        lib.hist_select_launch.restype = ctypes.c_int
        lib.hist_select_max_segments.argtypes = []
        lib.hist_select_max_segments.restype = ctypes.c_int
        lib.hist_select_digit_bits.argtypes = []
        lib.hist_select_digit_bits.restype = ctypes.c_int
        lib.hist_select_passes.argtypes = []
        lib.hist_select_passes.restype = ctypes.c_int
        lib._typed = True
    return lib


def max_segments() -> int:
    """The most segments one call takes (the kernel's shared memory holds
    a search state per segment); loads the library, building it if need
    be."""
    return int(_lib().hist_select_max_segments())


def _ks_tensor(ks: Tuple[int, ...], dev: torch.device) -> torch.Tensor:
    t = _KS_CACHE.get((ks, dev))
    if t is None:
        t = _KS_CACHE[(ks, dev)] = upload(np.asarray(ks, np.int32), dev)
    return t


def kth_key_cuda(keys: torch.Tensor, seg_ids: Optional[torch.Tensor],
                 ks: Sequence[int]) -> torch.Tensor:
    """(B, n) int32 keys, (n,) int32 segment ids or None (one segment) ->
    (B, S) int64 u-domain thresholds."""
    global LAUNCHES
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"kth_key_cuda needs CUDA tensors, got {dev}")
    if keys.dtype != torch.int32 or keys.dim() != 2 \
            or not keys.is_contiguous():
        raise ValueError("keys must be a contiguous (B, n) int32 tensor")
    rows, n = keys.shape
    if seg_ids is not None and (
            seg_ids.device != dev or seg_ids.dtype != torch.int32
            or seg_ids.shape != (n,) or not seg_ids.is_contiguous()):
        raise ValueError("seg_ids must be a contiguous (n,) int32 tensor on "
                         "keys' device")
    ks = tuple(int(k) for k in ks)
    segs = len(ks)
    if segs < 1 or any(k < 0 for k in ks):
        raise ValueError(f"ks must be one or more non-negative widths, "
                         f"got {ks}")
    if seg_ids is None and segs != 1:
        raise ValueError("several segments need seg_ids")
    lib = _lib()
    with torch.cuda.device(dev):
        if segs > lib.hist_select_max_segments():
            raise ValueError(f"{segs} segments exceed the kernel's shared "
                             f"memory ({lib.hist_select_max_segments()})")
        out = torch.empty((rows, segs), dtype=torch.int64, device=dev)
        if rows == 0 or n == 0:
            return out.fill_(0xFFFFFFFF)
        state = torch.empty((rows, segs, 4), dtype=torch.int32, device=dev)
        n_bins = rows * segs * 3 << lib.hist_select_digit_bits()
        passes = lib.hist_select_passes()
        scratch = torch.zeros(n_bins + rows + passes * (rows + 1),
                              dtype=torch.int32, device=dev)
        rc = lib.hist_select_launch(
            keys.data_ptr(), None if seg_ids is None else seg_ids.data_ptr(),
            _ks_tensor(ks, dev).data_ptr(), rows, n, segs, out.data_ptr(),
            state.data_ptr(), scratch.data_ptr(),
            scratch[n_bins:].data_ptr(), scratch[n_bins + rows:].data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"hist_select launch failed: CUDA error {rc}")
    return out
