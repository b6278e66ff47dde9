"""ctypes wrapper around ``csrc/gather_count.cu`` (see the note there for what
it replaces, what bounds it and how).

The wrapper checks its inputs, allocates the output rows and the new counts
(a copy of the carry-in that the kernel adds into), picks the copy width,
launches on the current stream and raises if the launch failed.
``LAUNCHES`` counts the launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build
from ..dispatch import refuse_grad

__all__ = ["LAUNCHES", "gather_count_cuda"]

LAUNCHES = 0

_P = ctypes.c_void_p
DTYPES = (torch.float32, torch.bfloat16)


def _lib() -> ctypes.CDLL:
    lib = _build.load("gather_count")
    if not getattr(lib, "_typed", False):
        lib.gather_count_launch.argtypes = [
            _P, _P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, _P, _P, _P]
        lib.gather_count_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def copy_unit(row_bytes: int, *ptrs: int) -> int:
    """Widest copy (16, 4 or 2 bytes) dividing the row and every address."""
    for unit in (16, 4, 2):
        if row_bytes % unit == 0 and all(p % unit == 0 for p in ptrs):
            return unit
    raise ValueError(f"rows of {row_bytes} bytes are not 2-byte aligned")


def gather_count_cuda(storage: torch.Tensor, indices: torch.Tensor,
                      counts: torch.Tensor, *, block_rows: int,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, D) storage, (M,) int32 row ids, (n_blocks,) int32 counts ->
    ((M, D) rows, counts + per-block hits)."""
    global LAUNCHES
    refuse_grad("gather_count", storage)
    dev = storage.device
    if dev.type != "cuda":
        raise ValueError(f"gather_count_cuda needs CUDA tensors, got {dev}")
    if storage.dtype not in DTYPES or storage.dim() != 2 \
            or not storage.is_contiguous():
        raise ValueError("storage must be a contiguous (N, D) float32 or "
                         "bfloat16 tensor")
    if indices.device != dev or indices.dtype != torch.int32 \
            or indices.dim() != 1 or not indices.is_contiguous():
        raise ValueError("indices must be a contiguous 1-D int32 tensor on "
                         "storage's device")
    if counts.device != dev or counts.dtype != torch.int32 \
            or counts.dim() != 1:
        raise ValueError("counts must be a 1-D int32 tensor on storage's "
                         "device")
    if not 1 <= block_rows < 2 ** 31:
        raise ValueError(f"block_rows={block_rows} must be a positive int32")
    m, d = indices.shape[0], storage.shape[1]
    out = torch.empty((m, d), dtype=storage.dtype, device=dev)
    new_counts = counts.contiguous().clone()
    row_bytes = d * storage.element_size()
    if m == 0 or d == 0:
        return out, new_counts
    unit = copy_unit(row_bytes, storage.data_ptr(), out.data_ptr())
    with torch.cuda.device(dev):
        rc = _lib().gather_count_launch(
            storage.data_ptr(), indices.data_ptr(), m, row_bytes, unit,
            block_rows, new_counts.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"gather_count launch failed: CUDA error {rc}")
    return out, new_counts
