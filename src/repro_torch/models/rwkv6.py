"""RWKV-6 "Finch" — attention-free time mixing with data-dependent decay
(PyTorch port of ``repro/models/rwkv6.py``).

Exact chunked formulation (GLA-style): within a chunk all pairwise decay
factors are exp(non-positive sums) <= 1, so the math is numerically safe
without rescaling tricks; the inter-chunk state is carried by a Python loop
over chunks (the reference's ``lax.scan``).

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

w_t in (0,1) per channel is data-dependent (lora on the shifted input);
u is the per-channel "bonus" for the current token.  Plain PyTorch on
tensors: the chunk count and padding come from the input's shape, so the
loop never reads the device.

Tensor parallel over "model" (``tp``, a ``layers.TensorParallel``): the
time mix runs the rank's heads (``layers.head_share``; ``tp.mix``), its
state the rank's heads' ``(B, h, hd, hd)``: r / k / v / g on the rank's
columns of ``wr`` / ``wk`` / ``wv`` / ``wg`` (the leaves themselves where
they are the rank's block, else sliced), the decay and bonus on its
channels, the group norm per head, ``wo``'s rows of them, one
all-reduce of the output.  The channel mix (``tp.ffn``) runs on the
rank's blocks of ``f_wk``'s columns and ``f_wv``'s rows; its partial
``kv`` is reduce-scattered over the model dim, each rank gates its
columns with its block of ``f_wr``, and the gated columns are
all-gathered (the bytes of one all-reduce, ``f_wr``'s product split).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .layers import TensorParallel, head_share, pick

__all__ = ["RWKV6FFNParams", "RWKV6Params", "rwkv6_channel_mix",
           "rwkv6_channel_mix_step", "rwkv6_mix", "rwkv6_mix_step"]


class RWKV6Params(NamedTuple):
    # data-dependent token shift (ddlerp): 5 mixes (r,k,v,w,g)
    tm_mu: torch.Tensor        # (5, D)
    tm_lora_a: torch.Tensor    # (D, 32)
    tm_lora_b: torch.Tensor    # (5, 32, D)
    # decay
    w0: torch.Tensor           # (D,)
    w_lora_a: torch.Tensor     # (D, 64)
    w_lora_b: torch.Tensor     # (64, D)
    u: torch.Tensor            # (D,) bonus
    wr: torch.Tensor           # (D, D)
    wk: torch.Tensor           # (D, D)
    wv: torch.Tensor           # (D, D)
    wg: torch.Tensor           # (D, D)
    wo: torch.Tensor           # (D, D)
    ln_x: torch.Tensor         # (D,) per-head group norm scale


class RWKV6FFNParams(NamedTuple):
    mu_k: torch.Tensor   # (D,)
    mu_r: torch.Tensor   # (D,)
    wk: torch.Tensor     # (D, F)
    wv: torch.Tensor     # (F, D)
    wr: torch.Tensor     # (D, D)


def _token_shift(x: torch.Tensor) -> torch.Tensor:
    """x_{t-1} with zero at t=0.  x: (B, S, D)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _ddlerp(x: torch.Tensor, xprev: torch.Tensor, p: RWKV6Params):
    """Data-dependent lerp between x_t and x_{t-1} -> the r, k, v, w, g
    streams.  Works on (B, S, D) and on one token's (B, D)."""
    dt = x.dtype
    base = x + (xprev - x) * p.tm_mu[0].to(dt)   # mu_x feeds the lora
    lora = torch.tanh(base @ p.tm_lora_a.to(dt))
    return [x + (xprev - x) * (p.tm_mu[i].to(dt) + lora @ p.tm_lora_b[i].to(dt))
            for i in range(5)]


def _log_decay(xw: torch.Tensor, p: RWKV6Params) -> torch.Tensor:
    """-exp(w0 + lora(xw)) in float32: the per-channel log decay, <= 0."""
    lora = (xw.to(torch.float32) @ p.w_lora_a.to(torch.float32)) \
        @ p.w_lora_b.to(torch.float32)
    return -torch.exp(p.w0.to(torch.float32) + lora)


def _group_norm(o: torch.Tensor, scale: torch.Tensor, eps: float
                ) -> torch.Tensor:
    """Per-head normalisation over the last dim (population variance, as
    ``jnp.var``), flattened heads times ``scale`` in float32."""
    mean = o.mean(-1, keepdim=True)
    var = o.var(-1, unbiased=False, keepdim=True)
    o = (o - mean) * torch.rsqrt(var + eps)
    return o.flatten(-2) * scale.to(torch.float32)


def _rank_heads(x: torch.Tensor, p: RWKV6Params, n_heads: int,
                tp: Optional[TensorParallel]):
    """(input, params, heads, head dim) of the time mix on this rank: the
    whole mix without ``tp``, else the input through ``to_model`` and the
    params cut to the rank's heads (see the module doc)."""
    hd = x.shape[-1] // n_heads
    if tp is None or not tp.mix:
        return x, p, n_heads, hd
    from ..launch.sharding import to_model
    first, n_heads = head_share(n_heads, tp.size, tp.rank)
    cols = (first * hd, n_heads * hd)
    own = {w: (getattr(p, w) if tp.mix == "local"
               else pick(getattr(p, w), cols))
           for w in ("wr", "wk", "wv", "wg")}
    return to_model(x, tp.mesh), p._replace(
        w0=pick(p.w0, cols), w_lora_b=pick(p.w_lora_b, cols),
        u=pick(p.u, cols), wo=p.wo.narrow(0, *cols), ln_x=pick(p.ln_x, cols),
        **own), n_heads, hd


def _joined(out: torch.Tensor, tp: Optional[TensorParallel]
            ) -> torch.Tensor:
    if tp is None or not tp.mix:
        return out
    from ..launch.sharding import from_model
    return from_model(out, tp.mesh)


def rwkv6_mix(
    x: torch.Tensor,            # (B, S, D)
    p: RWKV6Params,
    state: torch.Tensor | None = None,   # (B, H, dk, dv) carry for decode
    *,
    n_heads: int,
    chunk: int = 64,
    eps: float = 1e-5,
    tp: Optional[TensorParallel] = None,
):
    """Returns (out (B, S, D), final_state (B, H, hd, hd) float32).
    ``tp``: on the rank's heads (the module doc); ``state`` and the final
    state are then the rank's heads'."""
    x, p, n_heads, hd = _rank_heads(x, p, n_heads, tp)
    b, s, d = x.shape
    dt = x.dtype
    f32 = torch.float32

    xr, xk, xv, xw, xg = _ddlerp(x, _token_shift(x), p)
    r = (xr @ p.wr.to(dt)).to(f32).reshape(b, s, n_heads, hd)
    k = (xk @ p.wk.to(dt)).to(f32).reshape(b, s, n_heads, hd)
    v = (xv @ p.wv.to(dt)).to(f32).reshape(b, s, n_heads, hd)
    g = F.silu(xg @ p.wg.to(dt))
    lw = _log_decay(xw, p).reshape(b, s, n_heads, hd)     # (B,S,H,hd) <= 0
    u = p.u.to(f32).reshape(n_heads, hd)

    if state is None:
        state = torch.zeros((b, n_heads, hd, hd), dtype=f32, device=x.device)

    # pad to a chunk multiple: padded steps have log decay 0 and k = 0, so
    # they leave the carried state as it is
    pad = (-s) % chunk
    n_chunks = (s + pad) // chunk

    def chunks(t_):
        t_ = F.pad(t_, (0, 0, 0, 0, 0, pad))
        return t_.reshape(b, n_chunks, chunk, n_heads, hd).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lwc = map(chunks, (r, k, v, lw))          # (nC,B,H,L,hd)
    # strictly lower: P[t, j] = exp(cs_{t-1} - cs_j) for j < t
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril(-1)[:, :, None]
    bonus_u = u[None, :, None, :]
    outs = []
    for c in range(n_chunks):
        rr, kk, vv, ww = rc[c], kc[c], vc[c], lwc[c]        # (B,H,L,hd)
        cs = torch.cumsum(ww, dim=2)                        # inclusive logs
        csm1 = cs - ww                                      # exclusive
        pair = csm1[:, :, :, None, :] - cs[:, :, None, :, :]   # (B,H,L,L,hd)
        # mask before exp: above the diagonal pair is a positive sum, whose
        # exp may overflow (inf * 0 would be NaN)
        pair = torch.exp(torch.where(tri, pair, -torch.inf))
        scores = (rr[:, :, :, None, :] * pair * kk[:, :, None, :, :]).sum(-1)
        o = scores @ vv
        # bonus (current token)
        o = o + (rr * bonus_u * kk).sum(-1, keepdim=True) * vv
        # carried state
        o = o + (rr * torch.exp(csm1)) @ state
        # state update
        last = cs[:, :, -1:, :]                             # (B,H,1,hd)
        state = state * torch.exp(last[:, :, 0, :, None]) + \
            (kk * torch.exp(last - cs)).transpose(-1, -2) @ vv
        outs.append(o)
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(
        b, s + pad, n_heads, hd)[:, :s]

    # per-head group norm, gate, output proj
    o = _group_norm(o, p.ln_x, eps)
    o = o.to(dt) * g
    return _joined(o @ p.wo.to(dt), tp), state


def rwkv6_channel_mix(x: torch.Tensor, p: RWKV6FFNParams,
                      tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """``tp``: on the rank's blocks (the module doc)."""
    if tp is not None and tp.ffn:
        from ..launch.sharding import to_model
        x = to_model(x, tp.mesh)
    return rwkv6_channel_mix_step(x, _token_shift(x), p, tp)


# ----------------------------------------------------------- single-token step
def rwkv6_mix_step(
    x: torch.Tensor,        # (B, D) current (already layer-normed)
    x_prev: torch.Tensor,   # (B, D) previous normed input (token shift state)
    state: torch.Tensor,    # (B, H, dk, dv) f32
    p: RWKV6Params,
    *,
    n_heads: int,
    eps: float = 1e-5,
    tp: Optional[TensorParallel] = None,
):
    """One decode step.  Returns (out (B, D), new_state); ``tp`` as
    :func:`rwkv6_mix`'s."""
    x, p, n_heads, hd = _rank_heads(x, p, n_heads, tp)
    b, d = x.shape
    dt = x.dtype
    f32 = torch.float32

    xr, xk, xv, xw, xg = _ddlerp(x, x_prev, p)
    r = (xr @ p.wr.to(dt)).to(f32).reshape(b, n_heads, hd)
    k = (xk @ p.wk.to(dt)).to(f32).reshape(b, n_heads, hd)
    v = (xv @ p.wv.to(dt)).to(f32).reshape(b, n_heads, hd)
    g = F.silu(xg @ p.wg.to(dt))
    w = torch.exp(_log_decay(xw, p)).reshape(b, n_heads, hd)   # in (0, 1)
    u = p.u.to(f32).reshape(n_heads, hd)

    kv = k[..., :, None] * v[..., None, :]                      # (B,H,hd,hd)
    o = (r[..., None, :] @ (state + u[None, :, :, None] * kv))[..., 0, :]
    state = state * w[..., None] + kv

    o = _group_norm(o, p.ln_x, eps)
    o = o.to(dt) * g
    return _joined(o @ p.wo.to(dt), tp), state


def rwkv6_channel_mix_step(x: torch.Tensor, x_prev: torch.Tensor,
                           p: RWKV6FFNParams,
                           tp: Optional[TensorParallel] = None
                           ) -> torch.Tensor:
    """The channel mix on (B, S, D) with its shifted input, or on one
    token's (B, D) with the previous token's; ``tp``: on the rank's
    blocks (the module doc; a caller under grad passes ``x`` through
    ``to_model`` first, as :func:`rwkv6_channel_mix` does)."""
    dt = x.dtype
    xk = x + (x_prev - x) * p.mu_k.to(dt)
    xr = x + (x_prev - x) * p.mu_r.to(dt)
    k = torch.square(torch.relu(xk @ p.wk.to(dt)))
    kv = k @ p.wv.to(dt)
    if tp is None or not tp.ffn:
        return torch.sigmoid(xr @ p.wr.to(dt)) * kv
    from ..launch.sharding import gather_seq, scatter_sum
    kv = scatter_sum(kv, tp.mesh, "model", -1)
    return gather_seq(torch.sigmoid(xr @ p.wr.to(dt)) * kv, tp.mesh,
                      "model", -1)
