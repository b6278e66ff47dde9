"""Gradient compression for the cross-pod all-reduce (the port of
``repro/train/compression.py``).

Within a host, NVLink makes full-precision gradient reduction cheap; across
hosts the network is the bottleneck at scale.  Two standard compressors
with **error feedback** (the residual is carried and re-added next step so
compression bias does not accumulate — Karimireddy et al.):

  * int8 linear quantization (per-leaf absmax scaling; ``torch.round``
    rounds half to even, as ``jnp.round`` does)
  * top-k magnitude sparsification (per leaf; the kept set is
    ``lax.top_k``'s wherever the k-th magnitude is not tied)

These are grad *transforms* plugged into
``make_train_step(grad_transform=...)``; the math and the error-feedback
state are what a transform around the cross-host reduce would carry.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..pytree import leaves, tree_map, unzip


def init_error_feedback(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def int8_compress_grads(grads, ef_state):
    """Error-feedback int8 round trip (what the wire would carry is
    q/scale).  Returns (decompressed grads, new ef_state, wire_bytes_est)."""
    def one(g, e):
        x = g.to(torch.float32) + e
        q, s = quantize_int8(x)
        deq = dequantize_int8(q, s)
        return deq.to(g.dtype), x - deq

    new_g, new_e = unzip(tree_map(one, grads, ef_state), 2)
    wire = sum(x.numel() for x in leaves(grads))  # 1 byte/elem
    return new_g, new_e, wire


def topk_compress_grads(grads, ef_state, k_fraction: float = 0.01):
    """Error-feedback magnitude top-k (per leaf)."""
    def one(g, e):
        x = (g.to(torch.float32) + e).reshape(-1)
        k = max(int(x.numel() * k_fraction), 1)
        _, idx = torch.topk(torch.abs(x), k)
        mask = torch.zeros_like(x).index_fill_(0, idx, 1.0)
        kept = x * mask
        return kept.reshape(g.shape).to(g.dtype), (x - kept).reshape(g.shape)

    new_g, new_e = unzip(tree_map(one, grads, ef_state), 2)
    wire = sum(max(int(x.numel() * k_fraction), 1) * 8
               for x in leaves(grads))   # value+index per entry
    return new_g, new_e, wire
