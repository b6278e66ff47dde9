"""ctypes wrapper around ``csrc/embedding_bag.cu`` (see the notes there and
in ``csrc/embedding_bag_tiled.cuh`` for what they replace, what bounds them
and how).

Two kernels, one function.  :func:`route` picks one from the dtype, D, L and
alignment, fixed in code: 16-byte aligned storage whose rows are whole
128-byte slices (D a multiple of 32 in float32, of 64 in bfloat16) with
1 <= L <= 1,024 takes the tiled kernel (``"tiled"``: a tile's repeated rows
served from shared memory); everything else the per-bag kernel
(``"per_bag"``).  Both give the same bits where both apply.  A launch that
fails raises; no route stands in for another.

The wrapper checks its inputs, allocates the pooled output and the new
counts (a copy of the carry-in that the kernel adds into), picks the load
width, launches on the current stream and raises if the launch failed.
``LAUNCHES`` counts the launches of both routes, ``ROUTE_LAUNCHES`` each
route's.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build
from ..dispatch import refuse_grad

__all__ = ["LAUNCHES", "ROUTE_LAUNCHES", "TILE_LOOKUPS", "embedding_bag_cuda",
           "route"]

LAUNCHES = 0
ROUTE_LAUNCHES = {"tiled": 0, "per_bag": 0}

TILE_LOOKUPS = 1024     # most lookups a bag may have on the tiled route
SLICE_BYTES = 128       # the tiled route's column slice

_P = ctypes.c_void_p
# dtype code and elements per 16-byte load, per storage dtype
_DTYPES = {torch.float32: (0, 4), torch.bfloat16: (1, 8)}


def route(dtype: torch.dtype, d: int, bag_len: int, aligned: bool) -> str:
    """The kernel that computes an embedding bag of ``dtype`` rows of width
    ``d`` and bags of ``bag_len`` lookups, over a storage whose address is
    16-byte aligned (``aligned``): ``"tiled"`` or ``"per_bag"``."""
    if dtype not in _DTYPES:
        raise ValueError(f"storage must be float32 or bfloat16, got {dtype}")
    row_bytes = d * torch.finfo(dtype).bits // 8
    if aligned and d > 0 and row_bytes % SLICE_BYTES == 0 \
            and 1 <= bag_len <= TILE_LOOKUPS:
        return "tiled"
    return "per_bag"


def _lib() -> ctypes.CDLL:
    lib = _build.load("embedding_bag")
    if not getattr(lib, "_typed", False):
        lib.embedding_bag_launch.argtypes = [
            _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P]
        lib.embedding_bag_launch.restype = ctypes.c_int
        lib.embedding_bag_tiled_launch.argtypes = [
            _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, _P, _P, _P]
        lib.embedding_bag_tiled_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def embedding_bag_cuda(storage: torch.Tensor, indices: torch.Tensor,
                       weights: torch.Tensor, counts: torch.Tensor, *,
                       block_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, D) storage, (B, L) int32 ids, (B, L) float32 weights,
    (n_blocks,) int32 counts -> ((B, D) pooled rows, counts + hits), on
    :func:`route`'s kernel."""
    return _launch(None, storage, indices, weights, counts,
                   block_rows=block_rows)


def _launch(way: Optional[str], storage: torch.Tensor, indices: torch.Tensor,
            weights: torch.Tensor, counts: torch.Tensor, *, block_rows: int,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`embedding_bag_cuda` on the kernel ``way`` names (``"tiled"``
    or ``"per_bag"``), or on :func:`route`'s when it is None.  Naming one
    holds the two routes against each other on the card; ``"tiled"`` still
    fails on a shape that route does not take."""
    global LAUNCHES
    refuse_grad("embedding_bag", storage, weights)
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
    way = way or route(storage.dtype, d, l, storage.data_ptr() % 16 == 0)
    if way not in ROUTE_LAUNCHES:
        raise ValueError(f"no route {way!r}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if way == "tiled":
            rc = _lib().embedding_bag_tiled_launch(
                storage.data_ptr(), indices.data_ptr(), weights.data_ptr(), b,
                l, d, code, block_rows, new_counts.data_ptr(), out.data_ptr(),
                stream)
        else:
            if d % vec or any(p % 16 for p in (storage.data_ptr(),
                                               out.data_ptr())):
                vec = 1
            rc = _lib().embedding_bag_launch(
                storage.data_ptr(), indices.data_ptr(), weights.data_ptr(), b,
                l, d, code, vec, block_rows, new_counts.data_ptr(),
                out.data_ptr(), stream)
    LAUNCHES += 1
    ROUTE_LAUNCHES[way] += 1
    if rc != 0:
        raise RuntimeError(f"embedding_bag launch failed: CUDA error {rc}")
    return out, new_counts
