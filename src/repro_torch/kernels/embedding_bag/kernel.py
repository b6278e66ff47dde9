"""ctypes wrapper around ``csrc/embedding_bag.cu`` (see the note there for
what it replaces, what bounds it and how).

The wrapper checks its inputs, allocates the pooled output and the new
counts (a copy of the carry-in that the kernel adds into), picks the load
width, launches on the current stream and raises if the launch failed.
``LAUNCHES`` counts the launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build

__all__ = ["LAUNCHES", "embedding_bag_cuda"]

LAUNCHES = 0

_P = ctypes.c_void_p
# dtype code and elements per 16-byte load, per storage dtype
_DTYPES = {torch.float32: (0, 4), torch.bfloat16: (1, 8)}


def _lib() -> ctypes.CDLL:
    lib = _build.load("embedding_bag")
    if not getattr(lib, "_typed", False):
        lib.embedding_bag_launch.argtypes = [
            _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P]
        lib.embedding_bag_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def embedding_bag_cuda(storage: torch.Tensor, indices: torch.Tensor,
                       weights: torch.Tensor, counts: torch.Tensor, *,
                       block_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, D) storage, (B, L) int32 ids, (B, L) float32 weights,
    (n_blocks,) int32 counts -> ((B, D) pooled rows, counts + hits)."""
    global LAUNCHES
    dev = storage.device
    if dev.type != "cuda":
        raise ValueError(f"embedding_bag_cuda needs CUDA tensors, got {dev}")
    if storage.dtype not in _DTYPES or storage.dim() != 2 \
            or not storage.is_contiguous():
        raise ValueError("storage must be a contiguous (N, D) float32 or "
                         "bfloat16 tensor")
    if indices.device != dev or indices.dtype != torch.int32 \
            or indices.dim() != 2 or not indices.is_contiguous():
        raise ValueError("indices must be a contiguous (B, L) int32 tensor "
                         "on storage's device")
    if weights.device != dev or weights.dtype != torch.float32 \
            or weights.shape != indices.shape or not weights.is_contiguous():
        raise ValueError("weights must be a contiguous float32 tensor shaped "
                         "like indices, on storage's device")
    if counts.device != dev or counts.dtype != torch.int32 \
            or counts.dim() != 1:
        raise ValueError("counts must be a 1-D int32 tensor on storage's "
                         "device")
    (b, l), d = indices.shape, storage.shape[1]
    if not (1 <= block_rows < 2 ** 31 and l < 2 ** 31 and d < 2 ** 31):
        raise ValueError(f"block_rows={block_rows}, L={l} and D={d} must fit "
                         f"int32")
    out = torch.empty((b, d), dtype=storage.dtype, device=dev)
    new_counts = counts.contiguous().clone()
    if b == 0 or d == 0:
        return out, new_counts
    code, vec = _DTYPES[storage.dtype]
    if d % vec or any(p % 16 for p in (storage.data_ptr(), out.data_ptr())):
        vec = 1
    with torch.cuda.device(dev):
        rc = _lib().embedding_bag_launch(
            storage.data_ptr(), indices.data_ptr(), weights.data_ptr(), b, l,
            d, code, vec, block_rows, new_counts.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"embedding_bag launch failed: CUDA error {rc}")
    return out, new_counts
