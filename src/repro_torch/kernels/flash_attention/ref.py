"""Plain PyTorch version of flash_attention: the reference's ``ref.py``
(``attention_ref``) — repeat each KV head for its query heads, f32 scores,
mask with -1e30, softmax, zero the rows that have no valid key, cast to q's
dtype."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,   # (BH, Sq, D)
    k: torch.Tensor,   # (BKH, Sk, D)
    v: torch.Tensor,
    *,
    q_per_kv: int,
    causal: bool = True,
    window: int | None = None,
    sm_scale: float | None = None,
) -> torch.Tensor:
    _, sq, d = q.shape
    sk = k.shape[1]
    if sm_scale is None:
        sm_scale = d ** -0.5
    kk = torch.repeat_interleave(k, q_per_kv, dim=0).to(torch.float32)
    vv = torch.repeat_interleave(v, q_per_kv, dim=0).to(torch.float32)
    s = torch.einsum("hqd,hkd->hqk", q.to(torch.float32), kk) * sm_scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos >= qpos - window
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # rows with no valid key (can happen with windows) -> zeros
    p = torch.where(mask[None].any(-1, keepdim=True), p, 0.0)
    return torch.einsum("hqk,hkd->hqd", p, vv).to(q.dtype)
