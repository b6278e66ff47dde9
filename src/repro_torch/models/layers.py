"""Shared building blocks: norms, RoPE/M-RoPE, SwiGLU, attention block
(PyTorch port of ``repro/models/layers.py``; same layouts: activations
``(B, S, D)``, heads ``(B, H, S, hd)``)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import attention as attn_lib


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


# ----------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # a Python scalar base: a tensor made from theta would be a host->device
    # copy, which stalls the host on every layer
    return 1.0 / torch.pow(theta, exps)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, d); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (d/2,)
    angles = positions[..., None].to(torch.float32) * freqs   # (..., S, d/2)
    return _rotate(x, angles)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor,
                sections=(16, 24, 24), theta: float = 10000.0
                ) -> torch.Tensor:
    """Qwen2-VL M-RoPE: the rotary dims are split into (t, h, w) sections,
    each rotated by its own position stream.  x: (B, H, S, d);
    positions_3d: (3, B, S)."""
    d = x.shape[-1]
    half = d // 2
    assert sum(sections) == half, (sections, half)
    freqs = rope_freqs(d, theta, x.device)
    parts, start = [], 0
    for i, sec in enumerate(sections):
        f = freqs[start:start + sec]
        parts.append(positions_3d[i][..., None].to(torch.float32) * f)
        start += sec
    angles = torch.cat(parts, dim=-1)[:, None]               # (B,1,S,half)
    return _rotate(x, angles)


# --------------------------------------------------------------------- SwiGLU
def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    return (F.silu(g) * u) @ w_down.to(x.dtype)


# ------------------------------------------------------------ attention block
class AttnParams(NamedTuple):
    wq: torch.Tensor            # (D, H*hd)
    wk: torch.Tensor            # (D, KVH*hd)
    wv: torch.Tensor            # (D, KVH*hd)
    wo: torch.Tensor            # (H*hd, D)
    bq: Optional[torch.Tensor]  # (H*hd,) or None (qwen2 QKV bias)
    bk: Optional[torch.Tensor]
    bv: Optional[torch.Tensor]


def mrope_sections(head_dim: int):
    half = head_dim // 2
    return (half - 2 * (half * 3 // 8), half * 3 // 8, half * 3 // 8)


def attention_block(
    x: torch.Tensor,             # (B, S, D)
    p: AttnParams,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    positions: torch.Tensor,     # (B, S) or (3, B, S) for mrope
    rope_mode: str = "rope",     # "rope" | "mrope" | "none"
    rope_theta: float = 10000.0,
    window: int | None = None,
    causal_schedule: str = "masked",
    block_k: int = 512,
    return_kv: bool = False,
):
    b, s, _ = x.shape
    dt = x.dtype

    def proj(w, bias, nh):
        y = x @ w.to(dt)
        if bias is not None:
            y = y + bias.to(dt)
        return y.reshape(b, s, nh, head_dim).transpose(1, 2)

    q = proj(p.wq, p.bq, n_heads)          # (B,H,S,hd)
    k = proj(p.wk, p.bk, n_kv_heads)
    v = proj(p.wv, p.bv, n_kv_heads)

    if rope_mode == "rope":
        q = apply_rope(q, positions[:, None], rope_theta)
        k = apply_rope(k, positions[:, None], rope_theta)
    elif rope_mode == "mrope":
        sections = mrope_sections(head_dim)
        q = apply_mrope(q, positions, sections, rope_theta)
        k = apply_mrope(k, positions, sections, rope_theta)

    o = attn_lib.flash_train(q, k, v, causal=True, window=window,
                             causal_schedule=causal_schedule, block_k=block_k)
    o = o.transpose(1, 2).reshape(b, s, n_heads * head_dim)
    out = o @ p.wo.to(dt)
    if return_kv:
        return out, (k, v)
    return out
