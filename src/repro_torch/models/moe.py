"""Top-k routed Mixture-of-Experts with capacity dropping and expert
telemetry (PyTorch port of ``repro/models/moe.py``).

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

Under the sharded train step (``batch_axes`` and ``mesh``) the block sees
one rank's slice of a batch split over mesh axes and computes the whole
batch's function on it: the capacity is the whole batch's, and a routed
token's rank counts the tokens routed to its expert on the slices before
this one (one (E,) int32 all-gather of the slices' counts), so the same
tokens drop as in the single-device step.

Expert activation counters come out of the router for free — the MoE
analogue of the paper's HMU telemetry — and :func:`expert_access_batch`
turns them into the tiering runtime's access stream.

With ``groups=(gd, gm)`` of more than one member and ``expert_sharded``
the block takes the reference's expert-parallel path (its
``_moe_shard_map``) on a ("data", "model")-style ``mesh``: ``x`` is this
rank's batch slice (one of ``gd``), the rank of "model" j takes slice j of
its sequence (one of ``gm``), and that group of ``T / (gd gm)`` tokens is
dispatched on its own at a LOCAL capacity (tokens past it drop, per
group).  A tiled all-to-all over "model" sends each expert's rows to the
rank that holds it (``p.w_*`` hold this rank's ``E / gm`` experts), the
expert products run there, the reverse all-to-all brings the rows back,
and the group's output is combined and all-gathered over "model" again.
The router, ``counts`` and the balance loss are the whole batch's as on
the single-program path, the shared expert runs on all of ``x``.  The
collectives are ``launch.sharding``'s (``all_to_all``, ``split_seq``,
``gather_seq``): differentiable, and counted.

With ``tp`` (a ``layers.TensorParallel`` whose ``experts`` is set: the
rules put ``expert_mlp`` on "model", the reference's expert tensor
parallelism, Mixtral's layout) the single-program path runs each expert's
FFN on this rank's block of its ``d_expert`` (``p.w_gate`` / ``p.w_up``
hold its ``Fe / m`` columns, ``p.w_down`` its rows).  The router,
``counts``, the balance loss, the capacity, the slots and the dropped
pairs are the whole batch's, the same on every rank of "model" (they see
the same rows); the expert products give a partial ``(E, C, D)`` buffer,
the combine a partial ``(T, D)`` output, and the partial outputs meet in
one all-reduce over "model" (``launch.sharding.from_model``; never the
``(E, C, D)`` buffer).  The dispatched rows and the routing weights enter
through ``to_model``, so their gradients, partial on each rank, are summed
over "model" in the backward (two all-reduces: ``(T, D)`` and
``(T, k)``); the router's input does not, so the router's gradient (the
weights' part summed, the balance loss's part whole) comes out whole and
the same on every rank.

Where the expert weights hold fewer than ``E`` experts on the
single-program path (sharded serving's decode, the rules' experts on
"model"), they are this rank's block of ``E / m`` over the mesh axis
"model": every rank of "model" routes the same tokens into the same
dispatch (its capacity and slot order the single program's), runs its
experts' slots alone, and the combined outputs meet in one all-reduce
over "model".  No gradient is taken on that path.
"""
from __future__ import annotations

import math
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


def _route(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """The float32 router -> (probs (B, S, E), topw (B, S, k) renormalised
    over the k, tope (B, S, k) expert ids)."""
    logits = torch.einsum("bsd,de->bse", x.to(torch.float32),
                          router.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    topw, tope = _top_k(probs, top_k)
    return probs, topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9), \
        tope


def _dispatch_local(xf: torch.Tensor, flat_e: torch.Tensor, k: int, e: int,
                    capacity: int, before: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slot assignment and scatter.  xf: (T, D); flat_e: (T*k,) expert ids.
    Returns (x_buf (E, C, D), pos (T*k,)): ``pos`` is each routed token's
    rank among the tokens sent to its expert (stable in token order), plus
    ``before[e]``, the tokens routed to e ahead of this slice, if given."""
    t_k = flat_e.shape[0]
    dev = flat_e.device
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first_occ = torch.searchsorted(
        sorted_e, torch.arange(e, dtype=sorted_e.dtype, device=dev))
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(t_k, dtype=flat_e.dtype, device=dev) \
        - first_occ[sorted_e]
    if before is not None:
        pos = pos + before.to(pos.dtype)[flat_e]
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


def _expert_slots(x_buf: torch.Tensor, p: MoEParams, mesh) -> torch.Tensor:
    """The expert products of the slots of this rank's block of experts
    over "model" (``p.w_*`` hold its ``E / m``), zeros in the other
    experts' slots: (E, C, D), whose combine the caller sums over
    "model"."""
    from ..launch.sharding import mesh_axes
    e, n = x_buf.shape[0], p.w_gate.shape[0]
    m = mesh_axes(mesh).get("model", 1) if mesh is not None else 1
    if n * m != e:
        raise ValueError(f"the expert weights hold {n} experts, not this "
                         f"rank's block of {e} over {m} \"model\" ranks")
    if torch.is_grad_enabled() and x_buf.requires_grad:
        raise ValueError("the experts' slots over \"model\" take no "
                         "gradient (sharded serving's decode)")
    j = mesh.get_local_rank("model")
    y_buf = torch.zeros_like(x_buf)
    y_buf[j * n:(j + 1) * n] = _expert_ffn(x_buf[j * n:(j + 1) * n],
                                           p.w_gate, p.w_up, p.w_down)
    return y_buf


def _shared_ffn(x: torch.Tensor, p: MoEParams) -> torch.Tensor:
    dt = x.dtype
    gs = x @ p.shared_w_gate.to(dt)
    us = x @ p.shared_w_up.to(dt)
    return (F.silu(gs) * us) @ p.shared_w_down.to(dt)


def moe_block(x: torch.Tensor, p: MoEParams, *, top_k: int,
              capacity_factor: float = 1.25,
              groups: Tuple[int, int] = (1, 1),
              batch_axes: Optional[Tuple[str, ...]] = None, mesh=None,
              expert_sharded: bool = False, tp=None):
    """x: (B, S, D).  Returns (out (B, S, D), aux) with ``aux["counts"]``
    (E,) int32 — the expert activation telemetry — ``aux["aux_loss"]``,
    the switch-style load-balance loss (a float32 scalar), and
    ``aux["dropped"]``, (B, S, k) bool: the routed (token, expert) pairs
    past their expert's capacity (on the expert-parallel path this rank's
    group's, (B, S / gm, k)).

    With ``batch_axes`` and a ``mesh``, ``x`` is this rank's slice of a
    batch split over those mesh axes (major first): ``counts`` and the
    loss's routed fractions are the whole batch's, the loss's probability
    mean this slice's (so the mean of the slices' losses is the whole
    batch's).  On the single-program path the capacity and the slot order
    are the whole batch's too; on the expert-parallel path (``groups``
    ``(gd, gm)`` of more than one member and ``expert_sharded``; see the
    module doc) they are each group's, ``gd`` the batch axes' size and
    ``gm`` the size of the mesh's "model" axis.  ``tp`` (with ``mesh``):
    the single-program path tensor parallel over "model" on this rank's
    block of ``d_expert`` (the module doc)."""
    gd, gm = groups
    ep = gd * gm > 1 and expert_sharded
    if ep and mesh is None:
        raise ValueError(
            f"the expert-parallel MoE path (groups {groups}, experts "
            f"sharded) needs the mesh its groups live on: pass mesh=")
    b, s, d = x.shape
    e = p.router.shape[1]
    t = b * s
    dev = x.device

    # ---- router (float32) + telemetry + balance loss
    probs, topw, tope = _route(x, p.router, top_k)
    flat_e = tope.reshape(-1)
    # a comparison sum, not bincount: CUDA's bincount reads its input's
    # maximum back to the host
    counts = torch.sum(flat_e[:, None] == torch.arange(e, device=dev),
                       dim=0, dtype=torch.int32)
    before, t_all = None, t
    if batch_axes and mesh is not None:
        from ..launch.sharding import gather_slices
        per, i = gather_slices(counts, mesh, batch_axes)    # (n, E)
        before = per[:i].sum(0)
        counts = per.sum(0, dtype=torch.int32)
        t_all = t * per.shape[0]
    routed = counts.to(torch.float32)
    f_e = routed / torch.full_like(routed, float(max(t_all * top_k, 1)))
    aux_loss = e * torch.sum(f_e.detach() * probs.mean((0, 1)))
    aux = {"counts": counts, "aux_loss": aux_loss}

    if ep:
        out, dropped = _moe_expert_parallel(x, p, tope, topw, top_k,
                                            capacity_factor, groups,
                                            batch_axes, mesh)
    else:
        # ---- single-program path
        capacity = max(int(t_all * top_k * capacity_factor / e), 4)
        xf, wf = x.reshape(t, d), topw.reshape(t, top_k)
        if tp is not None:
            from ..launch.sharding import to_model
            xf, wf = to_model(xf, mesh), to_model(wf, mesh)
        x_buf, pos = _dispatch_local(xf, flat_e, top_k, e, capacity, before)
        slots = p.w_gate.shape[0] != e
        y_buf = (_expert_slots(x_buf, p, mesh) if slots
                 else _expert_ffn(x_buf, p.w_gate, p.w_up, p.w_down))
        out = _combine_local(y_buf, pos, flat_e, wf,
                             capacity).reshape(b, s, d)
        if slots or tp is not None:
            from ..launch.sharding import from_model
            out = from_model(out, mesh)
        dropped = (pos >= capacity).reshape(b, s, top_k)
    aux["dropped"] = dropped
    if p.shared_w_gate is not None:
        out = out + _shared_ffn(x, p)
    return out, aux


def _moe_expert_parallel(x: torch.Tensor, p: MoEParams, tope: torch.Tensor,
                         topw: torch.Tensor, top_k: int,
                         capacity_factor: float, groups: Tuple[int, int],
                         batch_axes, mesh
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts' output on the expert-parallel path (the
    reference's ``_moe_shard_map`` without its shared expert) -> (out
    (B, S, D), this rank's group's dropped pairs (B, S / gm, k)).

    The local capacity is the reference's: ``max(int(t_l k cf / E), 2)``
    rounded up to a multiple of ``gm``, ``t_l = T / (gd gm)``; so each
    all-to-all moves ``E C D`` elements a direction a rank."""
    from ..launch.sharding import (all_to_all, gather_seq, mesh_axes,
                                   split_seq)
    b, s, d = x.shape
    e = p.router.shape[1]
    gd, gm = groups
    sizes = mesh_axes(mesh)
    axes = (batch_axes,) if isinstance(batch_axes, str) else \
        tuple(batch_axes or ())
    n_slices = math.prod(sizes[a] for a in axes)
    if "model" not in sizes or groups != (n_slices, sizes["model"]):
        raise ValueError(
            f"groups {groups} are not (the batch axes {axes}' size "
            f"{n_slices}, the mesh's \"model\" size {sizes.get('model')}): "
            f"the batch of {b * n_slices} must split into gd slices over "
            f"the batch axes and the experts over \"model\"")
    for what, n, by in (("sequence", s, gm), ("experts", e, gm)):
        if n % by:
            raise ValueError(f"the {what} ({n}) does not split into "
                             f"{by} groups over \"model\"")
    if p.w_gate.shape[0] != e // gm:
        raise ValueError(f"the expert weights hold {p.w_gate.shape[0]} "
                         f"experts, not this rank's block of {e} / {gm}")
    t_l = b * (s // gm)
    capacity = max(int(t_l * top_k * capacity_factor / e), 2)
    capacity = -(-capacity // gm) * gm
    j = mesh.get_local_rank("model")
    x_l = split_seq(x, mesh, "model")
    w_l = split_seq(topw, mesh, "model").reshape(t_l, top_k)
    flat_e = tope.chunk(gm, 1)[j].reshape(-1)
    x_buf, pos = _dispatch_local(x_l.reshape(t_l, d), flat_e, top_k, e,
                                 capacity)
    x_recv = all_to_all(x_buf, mesh, "model")        # (E/gm, gm C, D)
    y_recv = _expert_ffn(x_recv, p.w_gate, p.w_up, p.w_down)
    y_buf = all_to_all(y_recv, mesh, "model", split=1, concat=0)
    out = _combine_local(y_buf, pos, flat_e, w_l, capacity)
    out = gather_seq(out.reshape(b, s // gm, d), mesh, "model")
    return out, (pos >= capacity).reshape(b, s // gm, top_k)
