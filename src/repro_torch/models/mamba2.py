"""Mamba-2 (SSD) block — chunked state-space duality formulation (PyTorch
port of ``repro/models/mamba2.py``).

    h_t = a_t h_{t-1} + dt_t * x_t B_t^T      (per head; a_t = exp(-exp(A)dt))
    y_t = C_t h_t + D * x_t

Chunked exactly like the RWKV6 path: intra-chunk pairwise decays are
exp(non-positive sums); the inter-chunk state (H, P, N) is carried by a
Python loop over chunks (the reference's ``lax.scan``).  Used inside the
Zamba2 hybrid blocks.  Plain PyTorch on tensors.

Tensor parallel over "model" (``tp``, a ``layers.TensorParallel`` with
``tp.mix``): the rank runs its heads (``layers.head_share``), its state
``(B, h, P, N)``.  ``in_proj`` is whole on the rank (the rules' blocks of
its fused ``[z | x | B C | dt]`` columns straddle the segments), and the
rank projects its heads' ``z``, ``x`` and ``dt`` columns and all of ``B``
and ``C`` (one group); the conv, ``a_log``, ``d_skip``, ``dt_bias`` and
``norm`` on its channels and heads; ``out_proj``'s rows of them (the
leaf itself where it is the rank's block).  The gated RMSNorm runs over
the whole ``d_inner``: each position's float32 sum of squares is summed
over "model" (one all-reduce, and one in the backward), then divided by
``d_inner``.  The input enters through ``to_model``, the partial output
leaves through ``from_model``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .layers import TensorParallel, head_share, pick

__all__ = ["Mamba2Params", "channels", "mamba2_mix", "mamba2_mix_step"]


class Mamba2Params(NamedTuple):
    in_proj: torch.Tensor    # (D, 2*d_inner + 2*N + H)   [z, x, B, C, dt] (1 group)
    conv_w: torch.Tensor     # (4, d_inner + 2*N)         depthwise conv kernel
    conv_b: torch.Tensor     # (d_inner + 2*N,)
    a_log: torch.Tensor      # (H,)
    d_skip: torch.Tensor     # (H,)
    dt_bias: torch.Tensor    # (H,)
    norm: torch.Tensor       # (d_inner,) gated RMSNorm scale
    out_proj: torch.Tensor   # (d_inner, D)


def _depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                    ) -> torch.Tensor:
    """Causal depthwise conv, kernel 4.  x: (B, S, C)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + s] * w[i] for i in range(k))
    return out + b


def _split_in_proj(zxbcdt: torch.Tensor, d_inner: int, n: int):
    """[z, x, B C, dt] along the last dim (the reference's ``jnp.split`` at
    indices d_inner, 2 d_inner, 2 d_inner + 2 n)."""
    return torch.split(zxbcdt, [d_inner, d_inner, 2 * n,
                                zxbcdt.shape[-1] - 2 * d_inner - 2 * n], -1)


def _dt(dt_raw: torch.Tensor, p: Mamba2Params) -> torch.Tensor:
    return F.softplus(dt_raw.to(torch.float32) + p.dt_bias.to(torch.float32))


def _gated_out(o: torch.Tensor, z: torch.Tensor, p: Mamba2Params,
               dt_, eps: float, tp: Optional[TensorParallel] = None,
               d_inner: int = 0) -> torch.Tensor:
    """o * silu(z), RMS-normed with ``norm``, through ``out_proj``; under
    ``tp`` the rank's channels of the ``d_inner`` the norm runs over."""
    o = o * F.silu(z.to(torch.float32))
    if tp is None:
        var = torch.mean(o * o, dim=-1, keepdim=True)
    else:
        from ..launch.sharding import from_model, to_model
        squares = to_model(torch.sum(o * o, dim=-1, keepdim=True), tp.mesh)
        var = from_model(squares, tp.mesh) / d_inner
    o = o * torch.rsqrt(var + eps) * p.norm.to(torch.float32)
    out = o.to(dt_) @ p.out_proj.to(dt_)
    if tp is None:
        return out
    from ..launch.sharding import from_model
    return from_model(out, tp.mesh)


def channels(d_inner: int, n_heads: int, d_state: int, first: int,
             count: int, device) -> torch.Tensor:
    """The ``[x | B C]`` channels (of the conv and its state) that heads
    ``first .. first + count`` read: their x channels and all of B and
    C."""
    hp = d_inner // n_heads
    return torch.cat([torch.arange(first * hp, (first + count) * hp,
                                   device=device),
                      torch.arange(d_inner, d_inner + 2 * d_state,
                                   device=device)])


def _rank_heads(x: torch.Tensor, p: Mamba2Params, d_inner: int,
                n_heads: int, d_state: int, tp: Optional[TensorParallel]):
    """(input, params, d_inner, heads) of the mix on this rank: the whole
    mix without ``tp``, else the input through ``to_model`` and the
    params cut to the rank's heads (the module doc): ``in_proj``'s
    columns ``[z_r | x_r | B C | dt_r]``, the conv's ``[x_r | B C]``."""
    if tp is None or not tp.mix:
        return x, p, d_inner, n_heads
    from ..launch.sharding import to_model
    hp = d_inner // n_heads
    first, count = head_share(n_heads, tp.size, tp.rank)
    conv = channels(d_inner, n_heads, d_state, first, count, x.device)
    cols = torch.cat([conv[:count * hp], conv + d_inner,
                      torch.arange(2 * d_inner + 2 * d_state + first,
                                   2 * d_inner + 2 * d_state + first + count,
                                   device=x.device)])
    own = (first * hp, count * hp)
    return to_model(x, tp.mesh), Mamba2Params(
        in_proj=pick(p.in_proj, cols), conv_w=pick(p.conv_w, conv),
        conv_b=pick(p.conv_b, conv), a_log=pick(p.a_log, (first, count)),
        d_skip=pick(p.d_skip, (first, count)),
        dt_bias=pick(p.dt_bias, (first, count)), norm=pick(p.norm, own),
        out_proj=(p.out_proj if tp.mix == "local"
                  else p.out_proj.narrow(0, *own))), count * hp, count


def mamba2_mix(
    x: torch.Tensor,              # (B, S, D)
    p: Mamba2Params,
    state: torch.Tensor | None = None,   # (B, H, P, N)
    *,
    d_inner: int,
    n_heads: int,
    d_state: int,
    chunk: int = 64,
    eps: float = 1e-5,
    tp: Optional[TensorParallel] = None,
):
    """Returns (out (B, S, D), final_state (B, H, P, N) float32).
    ``tp``: on the rank's heads (the module doc); ``state`` and the final
    state are then the rank's heads'."""
    b, s, _ = x.shape
    hp = d_inner // n_heads  # head dim P
    whole = d_inner
    x, p, d_inner, n_heads = _rank_heads(x, p, d_inner, n_heads, d_state,
                                         tp)
    n = d_state
    dt_ = x.dtype
    f32 = torch.float32

    z, xin, bc, dt_raw = _split_in_proj(x @ p.in_proj.to(dt_), d_inner, n)
    xbc = F.silu(_depthwise_conv(torch.cat([xin, bc], -1),
                                 p.conv_w.to(dt_), p.conv_b.to(dt_)))
    xin, bmat, cmat = torch.split(xbc, [d_inner, n, n], -1)

    dt = _dt(dt_raw, p)                                   # (B,S,H)
    loga = -torch.exp(p.a_log.to(f32))                    # (H,) negative
    lw = dt * loga                                        # log decay <= 0

    xh = xin.reshape(b, s, n_heads, hp).to(f32)
    bmat = bmat.to(f32)                                   # (B,S,N) one group
    cmat = cmat.to(f32)

    if state is None:
        state = torch.zeros((b, n_heads, hp, n), dtype=f32, device=x.device)

    # pad to a chunk multiple: padded steps have log decay 0 and dt = 0, so
    # they leave the carried state as it is
    pad = (-s) % chunk
    nc = (s + pad) // chunk
    xc = F.pad(xh, (0, 0, 0, 0, 0, pad)).reshape(
        b, nc, chunk, n_heads, hp).permute(1, 0, 3, 2, 4)   # (nc,B,H,L,P)
    bc_, cc_ = (F.pad(t_, (0, 0, 0, pad)).reshape(b, nc, chunk, n)
                .transpose(0, 1) for t_ in (bmat, cmat))    # (nc,B,L,N)
    lc, dc = (F.pad(t_, (0, 0, 0, pad)).reshape(b, nc, chunk, n_heads)
              .permute(1, 0, 3, 2) for t_ in (lw, dt))     # (nc,B,H,L)

    # lower with the diagonal: scores[t, j] for j <= t
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    outs = []
    for c in range(nc):
        xx, bb, cc, ll, dd = xc[c], bc_[c], cc_[c], lc[c], dc[c]
        cs = torch.cumsum(ll, dim=-1)                       # inclusive
        # intra: scores[t,j] = C_t.B_j * exp(cs_t - cs_j) * dt_j,  j <= t;
        # masked before exp (above the diagonal the sum is positive)
        pair = cs[:, :, :, None] - cs[:, :, None, :]        # (B,H,L,L)
        pair = torch.exp(torch.where(tri, pair, -torch.inf))
        cb = cc @ bb.transpose(-1, -2)                      # (B,L,L)
        scores = pair * cb[:, None] * dd[:, :, None, :]
        o = scores @ xx
        # carried state: y_t += C_t (exp(cs_t) S)
        o = o + (cc[:, None] @ state.transpose(-1, -2)) * torch.exp(cs)[..., None]
        # state update
        last = cs[:, :, -1:]
        state = state * torch.exp(last)[..., None] + \
            ((torch.exp(last - cs) * dd)[..., None] * xx).transpose(-1, -2) \
            @ bb[:, None]
        outs.append(o)
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(
        b, s + pad, n_heads, hp)[:, :s]

    # D skip + gated RMSNorm + out proj
    o = o + xh * p.d_skip.to(f32)[:, None]
    return _gated_out(o.reshape(b, s, d_inner), z, p, dt_, eps,
                      tp if tp is not None and tp.mix else None,
                      whole), state


# ----------------------------------------------------------- single-token step
def mamba2_mix_step(
    x: torch.Tensor,            # (B, D) current (already layer-normed)
    conv_state: torch.Tensor,   # (B, k-1, conv_ch) previous pre-conv inputs
    state: torch.Tensor,        # (B, H, P, N) f32
    p: Mamba2Params,
    *,
    d_inner: int,
    n_heads: int,
    d_state: int,
    eps: float = 1e-5,
    tp: Optional[TensorParallel] = None,
):
    """One decode step.  Returns (out (B, D), new_conv_state, new_state).
    ``tp``: on the rank's heads (the module doc); ``conv_state`` and
    ``state`` are then the rank's (its ``channels`` and heads), and so
    are the new ones."""
    b, _ = x.shape
    hp = d_inner // n_heads
    whole = d_inner
    x, p, d_inner, n_heads = _rank_heads(x, p, d_inner, n_heads, d_state,
                                         tp)
    n = d_state
    dt_ = x.dtype
    f32 = torch.float32

    z, xin, bc, dt_raw = _split_in_proj(x @ p.in_proj.to(dt_), d_inner, n)
    xbc = torch.cat([xin, bc], -1)                          # (B, conv_ch)

    window = torch.cat([conv_state, xbc[:, None]], 1)       # (B, k, C)
    # the reference's dot: exact products summed in float32, one rounding
    conv_out = (window.to(f32) * p.conv_w.to(dt_).to(f32)).sum(1).to(dt_) \
        + p.conv_b.to(dt_)
    xin2, bmat, cmat = torch.split(F.silu(conv_out), [d_inner, n, n], -1)
    dt = _dt(dt_raw, p)                                     # (B,H)
    a = torch.exp(dt * -torch.exp(p.a_log.to(f32)))

    xh = xin2.reshape(b, n_heads, hp).to(f32)
    bmf = bmat.to(f32)                                      # (B, N)
    cmf = cmat.to(f32)

    state = state * a[..., None, None] + \
        (dt[..., None] * xh)[..., None] * bmf[:, None, None, :]
    o = (state @ cmf[:, None, :, None])[..., 0]             # (B,H,P)
    o = o + xh * p.d_skip.to(f32)[:, None]
    return _gated_out(o.reshape(b, d_inner), z, p, dt_, eps,
                      tp if tp is not None and tp.mix else None, whole), \
        window[:, 1:], state
