"""Exact top-k selection without full-length sorts (PyTorch port of
``repro/core/selectk.py``).

* :func:`select_top_k` — ``lax.top_k(key, k)`` on int32 keys (values
  descending, ties lowest-index-first): the k-th largest key as a threshold,
  a prefix-sum + searchsorted compaction of the selected indices, and a
  stable sort of only the k survivors.
* :func:`top_k_mask` / :func:`bottom_k_mask` — membership masks of the same
  selections.
* :func:`stable_rank_sparse` — ``argsort(argsort(x))`` for non-negative
  arrays with a static bound on the number of positives.
* :func:`segment_top_k_mask` — per-segment top-k membership (tenant quotas),
  over a :class:`SegmentLayout` uploaded once by :func:`segment_layout`.

Keys are int32; non-negative float32 scores join through
:func:`sortable_key`.  The ordering work runs in the order-preserving
unsigned image ``u = key + 2**31`` (the reference's uint32 ``_to_u``, held
as int64: PyTorch's uint32 support is partial), so ``~u`` is
``0xFFFFFFFF - u``.

The threshold comes from :func:`repro_torch.kernels.hist_select.kth_key`
whenever ``k`` is a static int — the hand-written kernel on a CUDA tensor,
its plain sort on the CPU — and from the 32-round bitwise search
(:func:`_kth_largest`, torch ops) when ``k`` is a per-row tensor, exactly
as the reference splits them.  Integer sums and prefix sums keep int32
results, as under JAX's default ``x64=False``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import upload
from ..kernels.dispatch import DEFAULT_BACKEND, KernelBackend
from ..kernels.hist_select import kth_key

__all__ = [
    "sortable_key", "select_top_k", "top_k_mask", "bottom_k_mask",
    "stable_rank_sparse", "compact", "SegmentLayout", "segment_layout",
    "segment_top_k_mask", "prefix_sum",
]

_U_OFFSET = 1 << 31
_U_MAX = 0xFFFFFFFF
INT32_MIN = -(1 << 31)
INT32_MAX = (1 << 31) - 1
_CHUNK = 256                    # prefix_sum's row length

# Input-contract checking for sortable_key.  It reads the values on the
# host, so it runs on CPU tensors only: on the card it would be a device->
# host sync inside every epoch (the reference skips it under jit for the
# same reason).
CHECK_SORTABLE_KEYS = True

KLike = Union[int, torch.Tensor]


def sortable_key(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 key with the same ordering (bit reinterpretation).

    Contract: every value is non-negative or equal to one shared negative
    sentinel — order among distinct negatives is reversed."""
    x32 = x.to(torch.float32).contiguous()
    if CHECK_SORTABLE_KEYS and x32.device.type == "cpu":
        neg = x32[x32 < 0]
        if neg.numel() and torch.unique(neg).numel() > 1:
            raise ValueError(
                "sortable_key: negative inputs must all equal one shared "
                f"sentinel; got distinct negatives {torch.unique(neg)[:4]} "
                "— their relative order would be reversed")
    return x32.view(torch.int32)


def _to_u(key: torch.Tensor) -> torch.Tensor:
    """int32 -> order-preserving unsigned image in [0, 2**32), as int64."""
    return key.to(torch.int64) + _U_OFFSET


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum along the last axis, in the reference's
    chunked form: rows of ``_CHUNK`` are scanned, then the chunk totals
    (recursively).  PyTorch's CUDA scan of a long innermost dimension
    spreads the work over rows, so a few 5 M-element rows would run on a
    few blocks; as (n / chunk, chunk) rows they fill the card.  Integer
    results are the same in any association."""
    xi = x.to(torch.int32)
    n = xi.shape[-1]
    if n <= _CHUNK:
        return torch.cumsum(xi, dim=-1, dtype=torch.int32)
    pad = (-n) % _CHUNK
    if pad:
        xi = torch.nn.functional.pad(xi, (0, pad))
    within = torch.cumsum(xi.reshape(xi.shape[:-1] + (-1, _CHUNK)), dim=-1,
                          dtype=torch.int32)
    tot = within[..., -1]
    offs = prefix_sum(tot) - tot
    out = (within + offs.unsqueeze(-1)).reshape(xi.shape)
    return out[..., :n] if pad else out


def _kth_largest(u: torch.Tensor, k: KLike) -> torch.Tensor:
    """Largest ``t`` with ``count(u >= t) >= k`` per leading row: a bitwise
    binary search, 32 compare+sum rounds.  ``k``: int or per-row tensor."""
    t = torch.zeros(u.shape[:-1], dtype=torch.int64, device=u.device)
    for i in range(32):
        cand = t | (1 << (31 - i))
        n_ge = torch.sum(u >= cand.unsqueeze(-1), dim=-1, dtype=torch.int32)
        t = torch.where(n_ge >= k, cand, t)
    return t


def _kth_dispatch(key: Optional[torch.Tensor], u: torch.Tensor, k: KLike,
                  backend: KernelBackend) -> torch.Tensor:
    """k-th-largest threshold (u domain): hist_select for a static ``k``,
    the 32-round search for a per-row ``k`` (or with no int32 ``key``)."""
    if not isinstance(k, int) or key is None:
        return _kth_largest(u, k)
    n = u.shape[-1]
    t = kth_key(key.reshape(-1, n), None, (k,), backend=backend)
    return t.reshape(u.shape[:-1])


def _selection_mask(key: Optional[torch.Tensor], u: torch.Tensor, k: KLike,
                    backend: KernelBackend = DEFAULT_BACKEND):
    """Mask of the k largest of ``u`` (ties lowest-index-first) and its
    inclusive prefix count.  ``key`` is ``u``'s int32 key when the kernel
    may be used."""
    k_b = k.unsqueeze(-1) if isinstance(k, torch.Tensor) else k
    t = _kth_dispatch(key, u, k, backend).unsqueeze(-1)
    gt = u > t
    eq = u == t
    n_gt = torch.sum(gt, dim=-1, keepdim=True, dtype=torch.int32)
    eq_rank = prefix_sum(eq) - 1
    sel = gt | (eq & (eq_rank < (k_b - n_gt)))
    return sel, prefix_sum(sel)


def top_k_mask(key: torch.Tensor, k: int, *,
               backend: KernelBackend = DEFAULT_BACKEND,
               ) -> torch.Tensor:
    """(..., n) bool: membership in ``lax.top_k(key, k)``'s selection."""
    return _selection_mask(key, _to_u(key), min(k, key.shape[-1]),
                           backend)[0]


def bottom_k_mask(key: torch.Tensor, counts: KLike) -> torch.Tensor:
    """(..., n) bool: the per-row ``counts`` smallest keys, ties
    lowest-index-first.  ``counts`` may be a tensor (clipped to [0, n]);
    it always takes the 32-round search, as in the reference."""
    n = key.shape[-1]
    counts = (torch.clamp(counts, 0, n) if isinstance(counts, torch.Tensor)
              else min(max(int(counts), 0), n))
    return _selection_mask(None, _U_MAX - _to_u(key), counts)[0]


def compact(csel: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the first k selected elements in ascending order, given
    the inclusive prefix count of a selection mask along the last axis
    (fewer than k true entries fill with n)."""
    targets = torch.arange(1, k + 1, dtype=csel.dtype, device=csel.device)
    targets = targets.expand(csel.shape[:-1] + (k,)).contiguous()
    return torch.searchsorted(csel.contiguous(), targets, side="left")


def select_top_k(key: torch.Tensor, k: int, return_mask: bool = False, *,
                 backend: KernelBackend = DEFAULT_BACKEND):
    """``lax.top_k(key, k)`` on int32 keys: ``(values, indices)``, values
    descending, ties lowest-index-first (indices int64).  ``return_mask``
    also returns the (..., n) membership mask."""
    n = key.shape[-1]
    k = min(k, n)
    u = _to_u(key)
    sel, csel = _selection_mask(key, u, k, backend)
    ids = compact(csel, k)                         # ascending index order
    u_sel = torch.take_along_dim(u, ids, dim=-1)
    # ascending ~u == descending u; stable keeps ascending-index ties
    order = torch.sort(_U_MAX - u_sel, dim=-1, stable=True).indices
    ids_sorted = torch.take_along_dim(ids, order, dim=-1)
    vals = torch.take_along_dim(key, ids_sorted, dim=-1)
    if return_mask:
        return vals, ids_sorted, sel
    return vals, ids_sorted


def _widths(edges: Tuple[int, ...], caps: Sequence[int]) -> Tuple[int, ...]:
    """Each segment's width: its cap, at most its length."""
    return tuple(min(int(c), b - a)
                 for c, a, b in zip(caps, edges, edges[1:]))


class SegmentLayout(NamedTuple):
    """Static contiguous segments and their widths, on one device.  Built
    once by :func:`segment_layout` and handed to every
    :func:`segment_top_k_mask` call over the same segments, so a select
    inside an epoch copies nothing host->device."""
    edges: Tuple[int, ...]       # segment s is edges[s]:edges[s+1]
    ks: Tuple[int, ...]          # min(caps[s], |segment s|)
    seg: torch.Tensor            # (n,) int32 segment id of every element
    starts: torch.Tensor         # (S,) int64 edges[:-1]
    ends: torch.Tensor           # (S,) int64 edges[1:]
    ks_t: torch.Tensor           # (S,) int32 ks

    def with_caps(self, caps: Sequence[int]) -> "SegmentLayout":
        """The same segments with other caps: only the S widths upload."""
        ks = _widths(self.edges, caps)
        return self._replace(ks=ks, ks_t=upload(np.asarray(ks, np.int32),
                                                self.seg.device))


def segment_layout(bounds: Sequence[int], caps: Sequence[int],
                   device) -> SegmentLayout:
    """Upload the segments ``bounds[s]:bounds[s+1]`` with widths ``caps``
    to ``device``."""
    edges = tuple(int(b) for b in bounds)
    ks = _widths(edges, caps)
    dev = torch.device(device)
    seg, starts, ends, ks_t = (upload(a, dev) for a in (
        np.repeat(np.arange(len(ks), dtype=np.int32), np.diff(edges)),
        np.asarray(edges[:-1], np.int64), np.asarray(edges[1:], np.int64),
        np.asarray(ks, np.int32)))
    return SegmentLayout(edges, ks, seg, starts, ends, ks_t)


def segment_top_k_mask(key: torch.Tensor, bounds: Sequence[int],
                       caps: Sequence[int], *,
                       layout: Optional[SegmentLayout] = None,
                       backend: KernelBackend = DEFAULT_BACKEND,
                       ) -> torch.Tensor:
    """Per-segment top-k membership over static contiguous segments
    ``bounds[s]:bounds[s+1]``, each keeping its ``min(caps[s], len)``
    largest keys (ties lowest-index-first).

    Every segment's threshold comes out of ONE ``kth_key`` call (the caps
    become per-segment widths) and the per-segment tie ranks from global
    prefix sums rebased at the static segment starts.  ``layout`` is
    :func:`segment_layout` of the same bounds and caps on ``key``'s device;
    without it the layout is uploaded for this call."""
    n = key.shape[-1]
    dev = key.device
    if layout is None:
        layout = segment_layout(bounds, caps, dev)
    elif (layout.edges != tuple(int(b) for b in bounds)
          or layout.ks != _widths(layout.edges, caps)):
        raise ValueError("segment_top_k_mask: the layout was built for "
                         "other bounds or caps")
    seg, starts, ends, ks_t = (layout.seg, layout.starts, layout.ends,
                               layout.ks_t)
    key2 = key.reshape(-1, n)
    u = _to_u(key2)
    t = kth_key(key2, seg, layout.ks, backend=backend)    # (B, S)

    def widen(per_seg):             # (B, S) -> (B, n), constant per segment
        return per_seg.index_select(1, seg)

    t_elem = widen(t)
    gt = u > t_elem
    eq = u == t_elem
    zero = torch.zeros(u.shape[:-1] + (1,), dtype=torch.int32, device=dev)
    cgt = torch.cat([zero, prefix_sum(gt)], dim=-1)
    ceq = torch.cat([zero, prefix_sum(eq)], dim=-1)
    n_gt = cgt.index_select(1, ends) - cgt.index_select(1, starts)  # (B, S)
    allow_eq = ks_t[None, :] - n_gt
    eq_rank = ceq[:, 1:] - widen(ceq.index_select(1, starts)) - 1
    sel = gt | (eq & (eq_rank < widen(allow_eq)))
    return sel.reshape(key.shape)


def stable_rank_sparse(x: torch.Tensor, max_positive: int) -> torch.Tensor:
    """``argsort(argsort(x))`` (stable) for a 1-D non-negative int32 array
    with at most ``max_positive`` positive entries (a static bound): the
    zeros rank first in index order, then the positives by (value, index)
    — a prefix sum over the zeros plus a sort of just the positives.
    Returns int32 ranks."""
    n = x.shape[0]
    s = min(max_positive, n)
    dev = x.device
    pos = x > 0
    n_zero = n - torch.sum(pos, dtype=torch.int32)
    rank = prefix_sum(~pos) - 1                          # zero ranks
    cpos = prefix_sum(pos)
    targets = torch.arange(1, s + 1, dtype=cpos.dtype, device=dev)
    ids = torch.searchsorted(cpos, targets, side="left")   # fill -> n
    vals = torch.where(ids < n, x[torch.clamp(ids, max=n - 1)].to(torch.int32),
                       INT32_MAX)
    order = torch.sort(_to_u(vals), stable=True).indices
    ids_sorted = ids[order]
    # ``.at[...].set(mode="drop")``: the fill index n lands in a spare slot
    out = torch.cat([rank, rank.new_zeros(1)])
    out.scatter_(0, torch.where(ids_sorted < n, ids_sorted, n),
                 n_zero + torch.arange(s, dtype=torch.int32, device=dev))
    return out[:n]
