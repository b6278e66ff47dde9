"""The sharded train step: params, optimizer state and batch laid out on a
device mesh by the reference's rules (``launch.sharding``), one step the
single-device :func:`repro_torch.train.steps.make_train_step`'s function.

At rest every leaf is a DTensor whose placements are
``named(mesh, spec).placements``: params by ``model_pspecs`` (FSDP over
"data", the head / mlp / vocab dims over "model"), optimizer state by
``opt_pspecs``, the batch by ``batch_specs``.  A step, on every rank of
the mesh (the caller's process group; this module never starts one):

1. all-gathers each parameter leaf into the full tensor, once a step (an
   expert leaf under expert parallelism over every axis but "model": the
   rank keeps its block of experts);
2. runs forward and backward on plain local tensors (the rank's slice of
   the batch over the batch axes), so the kernels launch as they do
   without a mesh;
3. sums what is a statistic of the whole batch over the batch axes before
   the backward: the loss's token count (each rank backpropagates its own
   NLL sum over the global count) and, for MoE, the balance loss (each
   rank its share; the routing itself follows the whole batch, see
   ``models.moe``);
4. all-reduces the gradients over the batch axes, takes the gradient norm
   once from the reduced gradient (an expert leaf's block's squares summed
   over "model" too) and clips;
5. updates each leaf's local block (AdamW: an elementwise update), or, for
   an optimizer whose update reads across a leaf (Adafactor's factored
   means and update RMS), the full leaf and keeps its block (an expert
   leaf's gradient all-gathered over "model" for it).

Ranks that differ only on "model" compute the same batch slice and the
same loss, except for the MoE layers of a config with ``moe_groups`` and
``moe_expert_sharded`` (expert parallelism, the reference's
``_moe_shard_map``): there each rank of "model" routes its sequence slice
to the experts it holds (``models.moe``), and an expert leaf (one whose
spec puts "model" on its experts dim) is a distinct block a rank of
"model", its gradient summed over the batch axes only.  The layout
helpers and the collectives (counted in ``launch.sharding.COLLECTIVES``)
are ``launch.sharding``'s.  Under remat every block's forward, its
collectives with it, runs again in the backward, in the same order on
every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..launch.sharding import (NamedSharding, PartitionSpec, all_reduce,
                               batch_specs, distribute, entry_axes, full,
                               gather, gather_except, local_block, map_specs,
                               mesh_axes, model_pspecs, named, opt_pspecs,
                               wrap)
from ..models.model import ModelConfig, forward, loss_terms
from ..optim.optimizers import OptState, Optimizer
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
def _expert_leaves(cfg: ModelConfig, pspecs) -> Any:
    """A tree of bools like the params: True at an expert leaf under
    expert parallelism (``cfg.moe_groups`` of more than one member and
    ``cfg.moe_expert_sharded``), one whose spec puts "model" on the
    experts dim (dim 1 of the stacked ``e_gate`` / ``e_up`` /
    ``e_down``)."""
    tree = map_specs(lambda spec: False, pspecs)
    groups = cfg.moe_groups or (1, 1)
    if cfg.moe is None or not cfg.moe_expert_sharded \
            or groups[0] * groups[1] == 1:
        return tree
    for k in ("e_gate", "e_up", "e_down"):
        tree["blocks"][k] = "model" in entry_axes(pspecs["blocks"][k][1])
    return tree


def _only(spec: PartitionSpec, keep: bool) -> PartitionSpec:
    """``spec`` with only its "model" entries (``keep``) or without
    them."""
    return PartitionSpec(*(tuple(a for a in entry_axes(e)
                                 if (a == "model") == keep) for e in spec))


def _clip(grads, experts, mesh, max_norm: float = 1.0):
    """``clip_by_global_norm`` of the whole gradient, an expert leaf's
    block's squares summed over "model" (without expert leaves, the same
    operations in the same order)."""
    sq = [(torch.sum(torch.square(g.to(torch.float32))), ex)
          for g, ex in zip(leaves(grads), leaves(experts))]
    total = sum(q for q, ex in sq if not ex)
    blocks = [q for q, ex in sq if ex]
    if blocks:
        part = sum(blocks)
        all_reduce(part, mesh, ("model",))
        total = total + part
    norm = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


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
    norm of 1.0, as ``make_train_step``'s default.  A MoE config runs the
    single-program route, or with ``moe_groups`` and
    ``moe_expert_sharded`` the expert-parallel one (see the module doc).
    A batch that does not split runs whole on every rank."""
    pspecs = model_pspecs(mesh, cfg, overrides)
    p_sh = named(mesh, pspecs)
    experts = _expert_leaves(cfg, pspecs)

    def block(g, sh, ex):
        # an expert leaf's gradient is already this rank's block of experts
        if ex:
            sh = NamedSharding(mesh, _only(sh.spec, keep=False))
        return local_block(g, sh).contiguous()

    def whole(g, x, sh, ex):
        if not ex:
            return g
        return full(wrap(g, NamedSharding(mesh, _only(sh.spec, keep=True)),
                         x.shape))

    def train_step(params, opt_state: OptState, batch: Dict[str, Any]):
        o_sh = named(mesh, opt_pspecs(pspecs, opt_state))
        b_specs = batch_specs(mesh, cfg, batch)
        _check_layout(params, p_sh, "params")
        _check_layout(opt_state, o_sh, "optimizer state")
        _check_layout(batch, named(mesh, b_specs), "batch")
        l_params, l_state, l_batch = tree_map(lambda x: x.to_local(),
                                              (params, opt_state, batch))
        full_p = tree_map(lambda x, ex: gather_except(x, "model") if ex
                          else full(x), params, experts)
        axes = _batch_axes(mesh, b_specs["labels"])
        loss, aux, grads = sharded_loss_and_grads(full_p, cfg, l_batch,
                                                  mesh, axes)
        for g in leaves(grads):
            all_reduce(g, mesh, axes)
        grads, gnorm = _clip(grads, experts, mesh)
        lr = lr_schedule(l_state.step + 1)
        if optimizer.elementwise:
            blocks = tree_map(block, grads, p_sh, experts)
            new_p, new_s = optimizer.update(blocks, l_state, l_params, lr)
            new_p = tree_map(lambda x, sh, old: wrap(x, sh, old.shape),
                             new_p, p_sh, params)
            new_s = tree_map(lambda x, sh, old: wrap(x, sh, old.shape),
                             new_s, o_sh, opt_state)
        else:
            full_p = tree_map(lambda fp, x, ex: full(x) if ex else fp,
                              full_p, params, experts)
            new_p, new_s = optimizer.update(
                tree_map(whole, grads, params, p_sh, experts),
                gather(opt_state), full_p, lr)
            new_p, new_s = distribute((new_p, new_s), (p_sh, o_sh))
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        if "expert_counts" in aux:
            metrics["expert_counts"] = aux["expert_counts"]
        return new_p, new_s, metrics

    return train_step
