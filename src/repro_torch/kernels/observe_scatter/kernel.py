"""ctypes wrapper around ``csrc/observe_scatter.cu`` (see the note there for
what it replaces, what bounds it and how).

One kernel, two table modes: up to :func:`shared_limit` blocks a block's
shared memory holds both histograms (``"direct"``: slot = id), above it a
hashed table of the ids it meets (``"hashed"``).  :func:`table_mode` picks
the mode from ``n_blocks`` and the wrapper passes it to the kernel, which
refuses the direct table above the limit.

A sharded state's rank passes its block range (``lo`` and ``n_global``;
``n_blocks`` is then the range's length): the kernel counts the ids in
``[lo, lo + n_blocks)`` of the ``n_global`` id space and the mode follows
``n_blocks``.  The defaults (``lo`` 0, ``n_global`` = ``n_blocks``) are the
whole space.

The wrapper checks its inputs, allocates the zeroed outputs, launches on the
current stream and raises if the launch failed.  ``LAUNCHES`` counts the
launches, so a run can show that its main path went through the kernel,
``MODE_LAUNCHES`` the launches on each mode, and ``KEEP_LAUNCHES`` those
given a keep mask (the fault model's PEBS drops).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build

__all__ = ["KEEP_LAUNCHES", "LAUNCHES", "MODE_LAUNCHES",
           "observe_scatter_cuda", "shared_limit", "table_mode"]

LAUNCHES = 0
MODE_LAUNCHES = {"direct": 0, "hashed": 0}
KEEP_LAUNCHES = 0

_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = _build.load("observe_scatter")
    if not getattr(lib, "_typed", False):
        lib.observe_scatter_launch.argtypes = [
            _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P]
        lib.observe_scatter_launch.restype = ctypes.c_int
        lib.observe_scatter_shared_limit.argtypes = []
        lib.observe_scatter_shared_limit.restype = ctypes.c_int
        lib._typed = True
    return lib


def shared_limit() -> int:
    """Largest ``n_blocks`` that takes the direct table."""
    return _lib().observe_scatter_shared_limit()


def table_mode(n_blocks: int) -> str:
    """The table a call with ``n_blocks`` sums in: ``"direct"`` or
    ``"hashed"``."""
    return "direct" if n_blocks <= shared_limit() else "hashed"


def observe_scatter_cuda(
    ids: torch.Tensor, cursor: torch.Tensor, *, n_blocks: int, period: int,
    keep: Optional[torch.Tensor] = None, lo: int = 0,
    n_global: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    return _launch(None, ids, cursor, n_blocks=n_blocks, period=period,
                   keep=keep, lo=lo, n_global=n_global)


def _launch(
    mode: Optional[str], ids: torch.Tensor, cursor: torch.Tensor, *,
    n_blocks: int, period: int, keep: Optional[torch.Tensor] = None,
    lo: int = 0, n_global: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`observe_scatter_cuda` on the table ``mode`` names (``None``:
    :func:`table_mode`'s); the hashed table takes any ``n_blocks``, the
    direct one raises above :func:`shared_limit`."""
    global LAUNCHES, KEEP_LAUNCHES
    if mode not in (None, *MODE_LAUNCHES):
        raise ValueError(f"unknown table mode {mode!r}")
    dev = ids.device
    if dev.type != "cuda":
        raise ValueError(f"observe_scatter_cuda needs CUDA tensors, got {dev}")
    if ids.dtype != torch.int32 or ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError("ids must be a contiguous 1-D int32 tensor")
    if (cursor.device != dev or cursor.dtype != torch.int32
            or cursor.numel() != 1):
        raise ValueError("cursor must be one int32 element on ids' device")
    if keep is not None and (keep.device != dev or keep.dtype != torch.bool
                             or keep.shape != ids.shape
                             or not keep.is_contiguous()):
        raise ValueError("keep must be a contiguous bool tensor shaped "
                         "like ids, on ids' device")
    if not (1 <= n_blocks < 2 ** 31 and 1 <= period < 2 ** 31):
        raise ValueError(f"n_blocks={n_blocks} and period={period} must be "
                         f"positive int32 values")
    n_global = n_blocks if n_global is None else n_global
    if not (0 <= lo and lo + n_blocks <= n_global < 2 ** 31):
        raise ValueError(f"the range [{lo}, {lo + n_blocks}) must lie in "
                         f"an int32 id space of n_global={n_global}")
    mode = mode or table_mode(n_blocks)
    hist = torch.zeros(n_blocks, dtype=torch.int32, device=dev)
    pebs = torch.zeros(n_blocks, dtype=torch.int32, device=dev)
    m = ids.numel()
    if m == 0:
        return hist, pebs
    with torch.cuda.device(dev):
        rc = _lib().observe_scatter_launch(
            ids.data_ptr(), None if keep is None else keep.data_ptr(),
            cursor.data_ptr(), m, n_blocks, lo, n_global, period,
            int(mode == "direct"),
            hist.data_ptr(), pebs.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"observe_scatter launch failed: CUDA error {rc}")
    LAUNCHES += 1
    MODE_LAUNCHES[mode] += 1
    if keep is not None:
        KEEP_LAUNCHES += 1
    return hist, pebs
