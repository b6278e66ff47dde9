"""The sharded train step: params, optimizer state and batch laid out on a
device mesh by the reference's rules (``launch.sharding``), one step the
single-device :func:`repro_torch.train.steps.make_train_step`'s function.

At rest every leaf is a DTensor whose placements are
``named(mesh, spec).placements``: params by ``model_pspecs`` (FSDP over
"data", the head / mlp / vocab dims over "model"), optimizer state by
``opt_pspecs``, the batch by ``batch_specs``.  A step, on every rank of
the mesh (the caller's process group; this module never starts one):

1. all-gathers each parameter leaf into the full tensor, once a step;
2. runs forward and backward on plain local tensors (the rank's slice of
   the batch over the batch axes), so the kernels launch as they do
   without a mesh;
3. sums what is a statistic of the whole batch over the batch axes before
   the backward: the loss's token count (each rank backpropagates its own
   NLL sum over the global count) and, for MoE, the balance loss (each
   rank its share; the routing itself follows the whole batch, see
   ``models.moe``);
4. all-reduces the gradients over the batch axes, takes the gradient norm
   once from the reduced gradient and clips;
5. updates each leaf's local block (AdamW: an elementwise update), or, for
   an optimizer whose update reads across a leaf (Adafactor's factored
   means and update RMS), the full leaf and keeps its block.

Ranks that differ only on "model" compute the same batch slice: splitting
that compute over "model" is later work.  The layout helpers and the
collectives (counted in ``launch.sharding.COLLECTIVES``) are
``launch.sharding``'s.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..launch.sharding import (all_reduce, batch_specs, distribute,
                               entry_axes, gather, local_block, mesh_axes,
                               model_pspecs, named, opt_pspecs, wrap)
from ..models.model import ModelConfig, forward, loss_terms
from ..optim.optimizers import OptState, Optimizer, clip_by_global_norm
from ..pytree import flatten, leaves, tree_map, unflatten

__all__ = ["make_sharded_train_step", "sharded_loss_and_grads",
           "state_shardings"]


def state_shardings(mesh, cfg: ModelConfig, opt_state: OptState,
                    overrides: Optional[dict] = None):
    """(param shardings, optimizer-state shardings): ``named`` of
    ``model_pspecs`` and of ``opt_pspecs`` (``opt_state`` gives the
    structure only)."""
    pspecs = model_pspecs(mesh, cfg, overrides)
    return named(mesh, (pspecs, opt_pspecs(pspecs, opt_state)))


def _check_layout(tree, shardings, what: str) -> None:
    from torch.distributed.tensor import DTensor
    bad = []

    def one(x, sh):
        if not (isinstance(x, DTensor) and x.device_mesh == sh.mesh
                and tuple(x.placements) == sh.placements):
            bad.append(getattr(x, "placements", type(x).__name__))
    tree_map(one, tree, shardings)
    if bad:
        raise ValueError(f"the {what} is not laid out by its specs (first "
                         f"off: {bad[0]}); lay it out with "
                         f"launch.sharding.distribute()")


# ------------------------------------------------------------- the step
def _batch_axes(mesh, spec) -> Tuple[str, ...]:
    names = set(mesh.mesh_dim_names)
    return tuple(a for a in entry_axes(spec[0]) if a in names)


def sharded_loss_and_grads(params, cfg: ModelConfig, batch: Dict[str, Any],
                           mesh, axes: Tuple[str, ...]):
    """(loss, aux, grads) of the GLOBAL batch from a rank's slice ``batch``
    (plain tensors, split over the mesh axes ``axes``; ``()``: the whole
    batch on every rank) and the full ``params``: the loss and
    ``aux["expert_counts"]`` are the whole batch's; ``grads`` is this
    rank's share, whose sum over ``axes`` is the whole batch's
    gradient."""
    n_ranks = math.prod(mesh_axes(mesh)[a] for a in axes)
    cfg = dataclasses.replace(cfg, act_batch_axes=axes)
    flat, skeleton = flatten(params)
    leaves_ = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        p = unflatten(skeleton, leaves_)
        hidden, aux = forward(p, cfg, tokens=batch.get("tokens"),
                              embeds=batch.get("embeds"),
                              positions=batch.get("positions"), mesh=mesh)
        tot, cnt = loss_terms(p, cfg, hidden, batch["labels"],
                              batch.get("mask"))
        moe = "moe_aux_loss" in aux
        parts = [tot.detach(), cnt]
        if moe:
            # this rank's share: the balance loss is the mean of the
            # slices' (each from the whole batch's routed fractions)
            share = aux["moe_aux_loss"] / n_ranks
            parts.append(share.detach())
        packed = torch.stack([x.to(torch.float64) for x in parts])
        all_reduce(packed, mesh, axes)
        denom = torch.clamp(packed[1].to(torch.float32), min=1.0)
        loss, value = tot / denom, packed[0].to(torch.float32) / denom
        if moe:
            loss = loss + 0.01 * share
            value = value + 0.01 * packed[2].to(torch.float32)
        grads = torch.autograd.grad(loss, leaves_)
    aux = {"expert_counts": aux["expert_counts"]} if moe else {}
    return value.detach(), aux, unflatten(skeleton, list(grads))


def make_sharded_train_step(
    cfg: ModelConfig,
    optimizer: Optimizer,
    lr_schedule: Callable[[torch.Tensor], torch.Tensor],
    mesh,
    overrides: Optional[dict] = None,
):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics) on ``mesh``: params and optimizer state laid out by
    :func:`state_shardings` (with ``overrides``), the batch by
    ``named(mesh, batch_specs(...))``, each through
    ``launch.sharding.distribute`` (checked every call), and the new state
    laid out as the old.  Every rank of the mesh calls it with its own
    DTensors; ``metrics`` (loss, grad_norm, lr, and expert_counts for MoE)
    are plain tensors, the same on every rank.  Gradients clip at a global
    norm of 1.0, as ``make_train_step``'s default.  MoE configs run the
    single-program route (``moe_groups`` None).  A batch that does not
    split runs whole on every rank."""
    pspecs = model_pspecs(mesh, cfg, overrides)
    p_sh = named(mesh, pspecs)

    def train_step(params, opt_state: OptState, batch: Dict[str, Any]):
        o_sh = named(mesh, opt_pspecs(pspecs, opt_state))
        b_specs = batch_specs(mesh, cfg, batch)
        _check_layout(params, p_sh, "params")
        _check_layout(opt_state, o_sh, "optimizer state")
        _check_layout(batch, named(mesh, b_specs), "batch")
        l_params, l_state, l_batch = tree_map(lambda x: x.to_local(),
                                              (params, opt_state, batch))
        full_p = gather(params)
        axes = _batch_axes(mesh, b_specs["labels"])
        loss, aux, grads = sharded_loss_and_grads(full_p, cfg, l_batch,
                                                  mesh, axes)
        for g in leaves(grads):
            all_reduce(g, mesh, axes)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        lr = lr_schedule(l_state.step + 1)
        if optimizer.elementwise:
            blocks = tree_map(lambda g, sh: local_block(g, sh).contiguous(),
                              grads, p_sh)
            new_p, new_s = optimizer.update(blocks, l_state, l_params, lr)
            new_p = tree_map(lambda x, sh, old: wrap(x, sh, old.shape),
                             new_p, p_sh, params)
            new_s = tree_map(lambda x, sh, old: wrap(x, sh, old.shape),
                             new_s, o_sh, opt_state)
        else:
            new_p, new_s = optimizer.update(grads, gather(opt_state),
                                            full_p, lr)
            new_p, new_s = distribute((new_p, new_s), (p_sh, o_sh))
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        if "expert_counts" in aux:
            metrics["expert_counts"] = aux["expert_counts"]
        return new_p, new_s, metrics

    return train_step
