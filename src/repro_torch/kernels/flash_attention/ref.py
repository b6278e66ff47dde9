"""Plain PyTorch versions of flash_attention and of its gradient.

``attention_ref`` is the reference's ``ref.py``: repeat each KV head for its
query heads, f32 scores, mask with -1e30, softmax, zero the rows that have
no valid key, cast to q's dtype.  ``attention_bwd_ref`` is its backward,
blocked over query rows: ``FlashAttentionFn``'s backward on a CPU tensor
(the reference's gradient is XLA's autodiff of its pure-JAX
``flash_train``, computed outside any Pallas kernel), and the plain version
the backward kernels (``csrc/flash_attention_bwd.cuh``) are held to."""
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


def attention_bwd_ref(
    q: torch.Tensor,    # (BH, Sq, D)
    k: torch.Tensor,    # (BKH, Sk, D)
    v: torch.Tensor,
    do: torch.Tensor,   # (BH, Sq, D): the output's gradient
    *,
    q_per_kv: int,
    causal: bool = True,
    window: int | None = None,
    sm_scale: float | None = None,
    block_q: int = 512,
):
    """(dq, dk, dv) of :func:`attention_ref`, in q's, k's and v's dtypes.

    The f32 scores are recomputed ``block_q`` query rows at a time, each
    block reading only the key range its causal mask and window let
    through (the reference's triangular schedule): P in f32, dV += Pᵀ·dO,
    dP = dO·Vᵀ, dS = P ⊙ (dP − rowsum(P ⊙ dP)), dQ = dS·K·scale, dK +=
    dSᵀ·Q·scale, dK and dV summed over each KV head's ``q_per_kv`` query
    heads.  dO is taken in f32 (JAX's VJP of ``astype``).  The rowsum comes
    from P and dP of the same block, never from the saved output, which in
    bfloat16 carries a rounding the reference's f32 autodiff does not.
    Memory: one (BH, block_q, ≤ Sk) f32 block at a time, where autograd of
    :func:`attention_ref` holds (BH, Sq, Sk)."""
    bh, sq, d = q.shape
    bkh, sk, _ = k.shape
    g = q_per_kv
    if sm_scale is None:
        sm_scale = d ** -0.5
    f32 = torch.float32
    # query row bh reads KV row bh // g: (BKH, g) is a view of (BH,)
    qg = q.reshape(bkh, g, sq, d)
    dog = do.reshape(bkh, g, sq, d)
    dq = torch.zeros((bkh, g, sq, d), dtype=f32, device=q.device)
    dk = torch.zeros((bkh, sk, d), dtype=f32, device=q.device)
    dv = torch.zeros((bkh, sk, d), dtype=f32, device=q.device)
    for q0 in range(0, sq, block_q):
        q1 = min(q0 + block_q, sq)
        lo = 0 if window is None else min(max(0, q0 - window), sk)
        hi = min(q1, sk) if causal else sk
        if hi <= lo:        # no key for any row of the block: dq stays 0
            continue
        qb = qg[:, :, q0:q1].to(f32)
        kb, vb = k[:, lo:hi].to(f32), v[:, lo:hi].to(f32)
        dob = dog[:, :, q0:q1].to(f32)
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        kpos = torch.arange(lo, hi, device=q.device)[None, :]
        mask = torch.ones((q1 - q0, hi - lo), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos >= qpos - window
        # in place where it saves a block-sized tensor
        s = torch.einsum("hgqd,hkd->hgqk", qb, kb).mul_(sm_scale)
        p = torch.softmax(s.masked_fill_(~mask, NEG_INF), dim=-1)
        del s
        p.mul_(mask.any(-1, keepdim=True))     # rows with no key -> 0
        dv[:, lo:hi] += torch.einsum("hgqk,hgqd->hkd", p, dob)
        ds = torch.einsum("hgqd,hkd->hgqk", dob, vb)
        ds.sub_((p * ds).sum(-1, keepdim=True)).mul_(p)
        del p
        dq[:, :, q0:q1] = torch.einsum("hgqk,hkd->hgqd", ds, kb) * sm_scale
        dk[:, lo:hi] += torch.einsum("hgqk,hgqd->hkd", ds, qb) * sm_scale
    return (dq.reshape(bh, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
