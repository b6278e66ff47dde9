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
  any Pallas kernel.
* ``update_kv_cache`` — insert one token's K/V per batch row.
"""
from __future__ import annotations

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
):
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


def write_kv_(k_cache: torch.Tensor, v_cache: torch.Tensor,
              k_new: torch.Tensor, v_new: torch.Tensor,
              pos: torch.Tensor) -> None:
    """In place: row ``b`` of the caches gets ``k_new[b]``/``v_new[b]`` at
    position ``pos[b]``.  k_new: (B, KVH, d)."""
    bidx = torch.arange(k_cache.shape[0], device=k_cache.device)
    idx = pos.long()
    k_cache[bidx, :, idx] = k_new.to(k_cache.dtype)
    v_cache[bidx, :, idx] = v_new.to(v_cache.dtype)


def update_kv_cache(k_cache, v_cache, k_new, v_new, pos):
    """Insert one token's K/V at ``pos`` per batch row, into new caches (the
    reference's functional update).  k_new: (B, KVH, d)."""
    k_cache, v_cache = k_cache.clone(), v_cache.clone()
    write_kv_(k_cache, v_cache, k_new, v_new, pos)
    return k_cache, v_cache
