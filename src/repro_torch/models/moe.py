"""Top-k routed Mixture-of-Experts with capacity dropping and expert
telemetry (PyTorch port of ``repro/models/moe.py``, its single-program
path).

The router runs in float32; each token goes to its ``top_k`` most probable
experts (ties to the lowest expert id, as ``lax.top_k``: a stable sort over
the expert axis, which is 8 to 384 wide), its weights renormalised over
those ``k``.  Tokens are dispatched by a stable sort of their expert ids:
a token's slot in its expert's buffer is its rank among the tokens routed
there, and tokens past the expert's ``capacity`` are dropped (their output
is 0), exactly as the reference's ``.at[...].set(mode="drop")`` scatter.
The three expert products are batched matmuls in the activation dtype.
Capacity comes from shapes, never from values, so nothing here reads the
device back.

Expert activation counters come out of the router for free — the MoE
analogue of the paper's HMU telemetry — and :func:`expert_access_batch`
turns them into the tiering runtime's access stream.

The reference's expert-parallel path (``groups`` across devices, experts
sharded over a mesh axis, explicit all-to-alls) is distribution, ROADMAP
Queue 1 item 15; asking for it raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["MoEParams", "expert_access_batch", "moe_block"]


def expert_access_batch(counts) -> np.ndarray:
    """Router telemetry -> the tiering runtime's access-batch format.

    ``counts`` is ``aux["counts"]`` of :func:`moe_block` on the host —
    ``(E,)`` for one layer or ``(L, E)`` stacked over layers (layers are
    summed: an expert bank is placed per expert id, one block spanning its
    weights in every layer).  Returns the flat int32 stream of expert ids
    with multiplicity, ``tokens * top_k * n_layers`` long however the
    routing falls, so every batch of an epoch has the same size."""
    c = np.asarray(counts)
    if c.ndim == 2:
        c = c.sum(0)
    if c.ndim != 1:
        raise ValueError(f"counts must be (E,) or (L, E), got {c.shape}")
    return np.repeat(np.arange(c.shape[0], dtype=np.int32), c)


class MoEParams(NamedTuple):
    router: torch.Tensor                  # (D, E)
    w_gate: torch.Tensor                  # (E, D, Fe)
    w_up: torch.Tensor                    # (E, D, Fe)
    w_down: torch.Tensor                  # (E, Fe, D)
    shared_w_gate: Optional[torch.Tensor]  # (D, Fs) or None
    shared_w_up: Optional[torch.Tensor]
    shared_w_down: Optional[torch.Tensor]


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: values descending, equal values
    lowest index first (a stable descending sort)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _dispatch_local(xf: torch.Tensor, flat_e: torch.Tensor, k: int, e: int,
                    capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slot assignment and scatter.  xf: (T, D); flat_e: (T*k,) expert ids.
    Returns (x_buf (E, C, D), pos (T*k,)): ``pos`` is each routed token's
    rank among the tokens sent to its expert (stable in token order)."""
    t_k = flat_e.shape[0]
    dev = flat_e.device
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first_occ = torch.searchsorted(
        sorted_e, torch.arange(e, dtype=sorted_e.dtype, device=dev))
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(t_k, dtype=flat_e.dtype, device=dev) \
        - first_occ[sorted_e]
    # dropped tokens (pos >= capacity) land in one spare slot per expert,
    # cut off below: the reference's mode="drop" without a host-side mask
    slot = torch.clamp(pos, max=capacity)
    token_of = torch.arange(t_k, device=dev) // k
    x_buf = torch.zeros((e, capacity + 1, xf.shape[1]), dtype=xf.dtype,
                        device=dev)
    x_buf[flat_e, slot] = xf[token_of]
    return x_buf[:, :capacity], pos


def _combine_local(y_buf: torch.Tensor, pos: torch.Tensor,
                   flat_e: torch.Tensor, topw: torch.Tensor,
                   capacity: int) -> torch.Tensor:
    """Gather each routed token's expert output (0 where dropped), weight
    it and sum over the token's k experts -> (T, D)."""
    t, k = topw.shape
    dropped = pos >= capacity
    y = y_buf[flat_e, torch.clamp(pos, max=capacity - 1)]
    y = torch.where(dropped[:, None], torch.zeros((), dtype=y.dtype,
                                                  device=y.device), y)
    y = y.reshape(t, k, -1) * topw.reshape(t, k, 1).to(y.dtype)
    return y.sum(1)


def _expert_ffn(x_buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor) -> torch.Tensor:
    dt = x_buf.dtype
    g = torch.bmm(x_buf, wg.to(dt))
    u = torch.bmm(x_buf, wu.to(dt))
    return torch.bmm(F.silu(g) * u, wd.to(dt))


def _shared_ffn(x: torch.Tensor, p: MoEParams) -> torch.Tensor:
    dt = x.dtype
    gs = x @ p.shared_w_gate.to(dt)
    us = x @ p.shared_w_up.to(dt)
    return (F.silu(gs) * us) @ p.shared_w_down.to(dt)


def moe_block(x: torch.Tensor, p: MoEParams, *, top_k: int,
              capacity_factor: float = 1.25,
              groups: Tuple[int, int] = (1, 1),
              expert_sharded: bool = False):
    """x: (B, S, D).  Returns (out (B, S, D), aux) with ``aux["counts"]``
    (E,) int32 — the expert activation telemetry — and ``aux["aux_loss"]``,
    the switch-style load-balance loss (a float32 scalar)."""
    gd, gm = groups
    if gd * gm > 1 and expert_sharded:
        raise NotImplementedError(
            "the expert-parallel MoE path (groups across devices, experts "
            "sharded over a mesh axis) is not ported to repro_torch yet "
            "(ROADMAP Queue 1, item 15)")
    b, s, d = x.shape
    e = p.router.shape[1]
    t = b * s
    dev = x.device

    # ---- router (float32) + telemetry + balance loss
    logits = torch.einsum("bsd,de->bse", x.to(torch.float32),
                          p.router.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    topw, tope = _top_k(probs, top_k)                     # (B, S, k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    flat_e = tope.reshape(-1)
    # a comparison sum, not bincount: CUDA's bincount reads its input's
    # maximum back to the host
    counts = torch.sum(flat_e[:, None] == torch.arange(e, device=dev),
                       dim=0, dtype=torch.int32)
    routed = counts.to(torch.float32)
    f_e = routed / torch.full_like(routed, float(max(t * top_k, 1)))
    aux_loss = e * torch.sum(f_e.detach() * probs.mean((0, 1)))
    aux = {"counts": counts, "aux_loss": aux_loss}

    # ---- single-program path
    capacity = max(int(t * top_k * capacity_factor / e), 4)
    x_buf, pos = _dispatch_local(x.reshape(t, d), flat_e, top_k, e, capacity)
    y_buf = _expert_ffn(x_buf, p.w_gate, p.w_up, p.w_down)
    out = _combine_local(y_buf, pos, flat_e, topw.reshape(t, top_k),
                         capacity).reshape(b, s, d)
    if p.shared_w_gate is not None:
        out = out + _shared_ffn(x, p)
    return out, aux
