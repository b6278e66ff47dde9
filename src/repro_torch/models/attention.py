"""Attention compute paths (PyTorch port of ``repro/models/attention.py``).

* ``flash_train`` — causal/windowed GQA attention for forward and prefill.
  On a CUDA tensor it runs the hand-written ``flash_attention`` kernel
  (``kernels/flash_attention/csrc/flash_attention.cu``), on a CPU tensor
  the kernel's plain version.  The reference's ``causal_schedule`` and
  ``block_k`` pick how XLA lays out the same function in memory (a masked
  scan over KV blocks, or an unrolled triangular schedule); both compute
  ``softmax(q kᵀ · scale, mask) v`` with f32 scores, so the port accepts
  them and computes that function once, in the kernel, through
  ``FlashAttentionFn``: when q, k or v requires grad (training), its
  backward runs the hand-written backward kernels on a CUDA tensor and the
  plain ``attention_bwd_ref`` on a CPU tensor, which recomputes the scores
  ``block_k`` query rows at a time.
* ``decode_step`` — single-token attention against a KV cache with optional
  sliding window and per-KV-page attention-mass telemetry (feeds the tiered
  KV cache manager).  Plain PyTorch, as the reference computes it outside
  any Pallas kernel.  Over a cache whose sequence is cut over mesh axes
  (sharded serving, ``seq=``) each rank scores its slice and the rows'
  max, their sum and the weighted values meet in all-reduces over those
  axes: the softmax of the whole row, by a log-sum-exp combine.
* ``update_kv_cache`` — insert one token's K/V per batch row.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.flash_attention import FlashAttentionFn

NEG_INF = -1e30

__all__ = ["NEG_INF", "decode_step", "flash_train", "update_kv_cache",
           "write_kv_"]


def flash_train(
    q: torch.Tensor,    # (B, H, S, d)
    k: torch.Tensor,    # (B, KVH, S, d)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    block_k: int = 512,
    sm_scale: float | None = None,
    causal_schedule: str = "masked",   # "masked" | "triangular"
) -> torch.Tensor:
    if causal_schedule not in ("masked", "triangular"):
        raise ValueError(f"causal_schedule {causal_schedule!r}")
    if block_k < 1:
        raise ValueError(f"block_k {block_k}")
    b, h, s, d = q.shape
    kvh = k.shape[1]
    # (B, H) -> B*H rows: query head h of batch row b reads KV row
    # (b*H + h) // (H // KVH) = b*KVH + h // (H // KVH), the reference's
    # group-wise KV head
    q3 = q.reshape(b * h, s, d).contiguous()
    k3 = k.reshape(b * kvh, k.shape[2], d).contiguous()
    v3 = v.reshape(b * kvh, v.shape[2], d).contiguous()
    # the kernel's forward; under grad, the backward kernels (the plain
    # blocked backward over block_k query rows on the CPU)
    out = FlashAttentionFn.apply(q3, k3, v3, h // kvh, causal, window,
                                 sm_scale, block_k)
    return out.reshape(b, h, s, d)


def decode_step(
    q: torch.Tensor,        # (B, H, d) one new token per sequence
    k_cache: torch.Tensor,  # (B, KVH, S, d)
    v_cache: torch.Tensor,
    pos: torch.Tensor,      # (B,) current lengths (the new token's index)
    *,
    window: int | None = None,
    sm_scale: float | None = None,
    page_size: int = 0,     # >0: also return per-page attention mass
    seq=None,
):
    """The attention of one new token a row -> out (B, H, d), and with
    ``page_size`` the per-page mass (B, ceil(S / page_size)) too.

    ``seq``: ``(first, mesh, axes)``, the caches hold positions ``first``
    to ``first + S`` of a sequence cut over the mesh axes ``axes``.  The
    row's max, its sum of exponentials and the weighted values are then
    all-reduced over ``axes``: ``out`` is the whole row's, and the mass
    this slice's pages' (``S`` a multiple of ``page_size``) under the
    whole row's normaliser."""
    if seq is not None:
        return _decode_slice(q, k_cache, v_cache, pos, window, sm_scale,
                             page_size, *seq)
    b, h, d = q.shape
    kvh, s = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    if sm_scale is None:
        sm_scale = d ** -0.5
    # The reference's dots take bf16 operands with f32 results
    # (preferred_element_type=float32); torch's bf16 einsum would round its
    # result to bf16, so the operands go up to f32 on purpose.  A product of
    # two bf16 values is exact in f32, so this is the same dot up to the
    # order of its sum.
    qg = q.reshape(b, kvh, g, d).to(torch.float32)
    scores = torch.einsum("bngd,bnkd->bngk", qg,
                          k_cache.to(torch.float32)) * sm_scale
    kpos = torch.arange(s, device=q.device)[None, :]         # (1, S)
    valid = kpos <= pos[:, None]
    if window is not None:
        valid &= kpos >= (pos[:, None] - window)
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    # the reference rounds p to the cache dtype before its f32-result dot
    out = torch.einsum("bngk,bnkd->bngd",
                       p.to(v_cache.dtype).to(torch.float32),
                       v_cache.to(torch.float32))
    out = out.reshape(b, h, d).to(q.dtype)
    if page_size:
        # ceil-divide: a ragged final page sums its shorter tail; masked
        # positions carry exactly 0 probability, so zero-padding the
        # per-position mass to the page grid is exact
        npages = -(-s // page_size)
        pos_mass = p.sum((1, 2))                                 # (B, S)
        pad = npages * page_size - s
        if pad:
            pos_mass = torch.nn.functional.pad(pos_mass, (0, pad))
        mass = pos_mass.reshape(b, npages, page_size).sum(-1)    # (B, P)
        return out, mass
    return out


def _decode_slice(q, k_cache, v_cache, pos, window, sm_scale, page_size,
                  first: int, mesh, axes):
    """:func:`decode_step` over positions ``first`` to ``first + S`` of a
    sequence cut over mesh ``axes`` (see there): the same dots, the
    softmax's max and sum and the P·V product all-reduced over ``axes``."""
    import torch.distributed as dist
    from ..launch.sharding import all_reduce
    b, h, d = q.shape
    kvh, s = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    if sm_scale is None:
        sm_scale = d ** -0.5
    if page_size and s % page_size:
        raise ValueError(f"a cache slice of {s} positions is not whole "
                         f"pages of {page_size}")
    qg = q.reshape(b, kvh, g, d).to(torch.float32)
    scores = torch.einsum("bngd,bnkd->bngk", qg,
                          k_cache.to(torch.float32)) * sm_scale
    kpos = first + torch.arange(s, device=q.device)[None, :]
    valid = kpos <= pos[:, None]
    if window is not None:
        valid &= kpos >= (pos[:, None] - window)
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    top = scores.amax(-1)
    all_reduce(top, mesh, axes, op=dist.ReduceOp.MAX)
    e = torch.exp(scores - top[..., None])
    total = e.sum(-1)
    all_reduce(total, mesh, axes)
    p = e / total[..., None]
    # the reference rounds p to the cache dtype before its f32-result dot
    out = torch.einsum("bngk,bnkd->bngd",
                       p.to(v_cache.dtype).to(torch.float32),
                       v_cache.to(torch.float32))
    out = all_reduce(out, mesh, axes).reshape(b, h, d).to(q.dtype)
    if page_size:
        mass = p.sum((1, 2)).reshape(b, s // page_size, page_size).sum(-1)
        return out, mass
    return out


def write_kv_(k_cache: torch.Tensor, v_cache: torch.Tensor,
              k_new: torch.Tensor, v_new: torch.Tensor,
              pos: torch.Tensor, first: Optional[int] = None) -> None:
    """In place: row ``b`` of the caches gets ``k_new[b]``/``v_new[b]`` at
    position ``pos[b]``.  k_new: (B, KVH, d).  ``first``: the caches hold
    positions ``first`` on of a sequence cut over ranks; a row whose
    ``pos`` falls outside them keeps its old values (a masked write, the
    same on every rank)."""
    bidx = torch.arange(k_cache.shape[0], device=k_cache.device)
    idx = pos.long()
    k_new, v_new = k_new.to(k_cache.dtype), v_new.to(v_cache.dtype)
    if first is not None:
        idx = idx - first
        here = ((idx >= 0) & (idx < k_cache.shape[2]))[:, None, None]
        idx = idx.clamp(0, k_cache.shape[2] - 1)
        k_new = torch.where(here, k_new, k_cache[bidx, :, idx])
        v_new = torch.where(here, v_new, v_cache[bidx, :, idx])
    k_cache[bidx, :, idx] = k_new
    v_cache[bidx, :, idx] = v_new


def update_kv_cache(k_cache, v_cache, k_new, v_new, pos):
    """Insert one token's K/V at ``pos`` per batch row, into new caches (the
    reference's functional update).  k_new: (B, KVH, d)."""
    k_cache, v_cache = k_cache.clone(), v_cache.clone()
    write_kv_(k_cache, v_cache, k_new, v_new, pos)
    return k_cache, v_cache
