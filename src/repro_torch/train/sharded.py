"""The sharded train step: params, optimizer state and batch laid out on a
device mesh by the reference's rules (``launch.sharding``), one step the
single-device :func:`repro_torch.train.steps.make_train_step`'s function.

At rest every leaf is a DTensor whose placements are
``named(mesh, spec).placements``: params by ``model_pspecs`` (FSDP over
"data", the head / mlp / vocab dims over "model"), optimizer state by
``opt_pspecs``, the batch by ``batch_specs``.  A step, on every rank of
the mesh (the caller's process group; this module never starts one):

1. all-gathers each parameter leaf into the full tensor, once a step,
   but a leaf local to "model" over every axis but "model" (the rank
   keeps its block: see below);
2. runs forward and backward on plain local tensors (the rank's slice of
   the batch over the batch axes), so the kernels launch as they do
   without a mesh;
3. sums what is a statistic of the whole batch over the batch axes before
   the backward: the loss's token count (each rank backpropagates its own
   NLL sum over the global count) and, for MoE, the balance loss (each
   rank its share; the routing itself follows the whole batch, see
   ``models.moe``);
4. all-reduces the gradients over the batch axes (a whole leaf whose
   gradient is a partial sum on each rank over "model" too), takes the
   gradient norm once from the reduced gradient (the squares of the local
   leaves' blocks summed over "model") and clips;
5. updates each leaf's local block (AdamW: an elementwise update), or, for
   an optimizer whose update reads across a leaf (Adafactor's factored
   means and update RMS), the full leaf and keeps its block (a local
   leaf's gradient all-gathered over "model" for it).

Ranks that differ only on "model" compute the same batch slice, each its
part of it.  At more than one "model" rank the step is tensor parallel
over "model" as the rules lay the leaves out: the config's ``tp_axes``
names the logical axes the rules put on "model" (heads, kv_heads, mlp,
vocab), and ``models.model.tp_roles`` the leaves whose module runs on its
rank's block: the attention's q / o (and k / v where they split), the
dense MLP, the embedding and the loss's head (``models.layers``' module
doc has the forms, and the fallback where the rule cuts through a head).
Those leaves stay this rank's block over "model", their gradients that
block's; the activations' partial sums meet in two all-reduces over
"model" a block (``launch.sharding.to_model`` / ``from_model``).  The MoE
layers keep their route: the single program, or with ``moe_groups`` and
``moe_expert_sharded`` expert parallelism (the reference's
``_moe_shard_map``), where each rank of "model" routes its sequence slice
to the experts it holds (``models.moe``) and an expert leaf (one whose
spec puts "model" on its experts dim) is local to "model" too.
rwkv6's and Mamba2's blocks run whole on every rank.  At one "model"
rank, or without a mesh, every op is the single-device step's.  The
layout helpers and the collectives (counted in
``launch.sharding.COLLECTIVES``) are ``launch.sharding``'s.  Under remat
every block's forward, its collectives with it, runs again in the
backward, in the same order on every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..launch.sharding import (NamedSharding, PartitionSpec, all_reduce,
                               apply_overrides, batch_specs, default_rules,
                               distribute, entry_axes, full, gather,
                               gather_except, local_block, map_specs,
                               mesh_axes, model_pspecs, named, opt_pspecs,
                               wrap)
from ..models.model import ModelConfig, forward, loss_terms, tp_roles
from ..optim.optimizers import OptState, Optimizer
from ..pytree import flatten, leaves, tree_map, unflatten

__all__ = ["gather_local", "make_sharded_train_step", "sharded_grads",
           "sharded_loss_and_grads", "state_shardings", "tp_config"]

# the logical axes whose leaves a module can use as its block over "model"
TP_AXES = ("heads", "kv_heads", "mlp", "vocab")


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
def tp_config(cfg: ModelConfig, mesh, overrides: Optional[dict] = None
              ) -> ModelConfig:
    """``cfg`` with ``tp_axes``: the logical axes of ``TP_AXES`` that the
    rules (with ``overrides``) put on "model", at more than one "model"
    rank of ``mesh`` (else ``cfg`` itself)."""
    if mesh_axes(mesh).get("model", 1) == 1:
        return cfg
    rules = apply_overrides(default_rules(mesh, cfg), overrides or {})
    return dataclasses.replace(cfg, tp_axes=tuple(
        a for a in TP_AXES if rules.get(a) == "model"))


def _roles(cfg: ModelConfig, mesh, pspecs) -> Tuple[Any, Any]:
    """(local, partial): trees of bools like the params.  Local: a leaf
    handed over as this rank's block over "model" (an expert leaf under
    expert parallelism, ``cfg.moe_groups`` of more than one member and
    ``cfg.moe_expert_sharded``, whose spec puts "model" on its experts dim;
    a leaf of ``tp_roles``).  Partial: a whole leaf whose gradient is a
    partial sum on each rank of "model"."""
    local = map_specs(lambda spec: False, pspecs)
    partial = map_specs(lambda spec: False, pspecs)
    groups = cfg.moe_groups or (1, 1)
    if cfg.moe is not None and cfg.moe_expert_sharded \
            and groups[0] * groups[1] > 1:
        for k in ("e_gate", "e_up", "e_down"):
            local["blocks"][k] = "model" in entry_axes(
                pspecs["blocks"][k][1])
    if cfg.tp_axes:
        size = mesh_axes(mesh)["model"]
        for path, role in tp_roles(cfg, size).items():
            *parents, leaf = path.split(".")
            node = local if role == "local" else partial
            for p in parents:
                node = node[p]
            node[leaf] = True
    return local, partial


def _only(spec: PartitionSpec, keep: bool) -> PartitionSpec:
    """``spec`` with only its "model" entries (``keep``) or without
    them."""
    return PartitionSpec(*(tuple(a for a in entry_axes(e)
                                 if (a == "model") == keep) for e in spec))


def _clip(grads, local, mesh, max_norm: float = 1.0):
    """``clip_by_global_norm`` of the whole gradient, a local leaf's
    block's squares summed over "model" (without local leaves, the same
    operations in the same order)."""
    sq = [(torch.sum(torch.square(g.to(torch.float32))), ex)
          for g, ex in zip(leaves(grads), leaves(local))]
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
    batch on every rank) and the full ``params`` (with ``cfg.tp_axes``,
    the leaves of ``tp_roles`` this rank's blocks over "model"): the loss
    and ``aux["expert_counts"]`` are the whole batch's; ``grads`` is this
    rank's share, whose sum over ``axes`` (and over "model" for a partial
    leaf) is the whole batch's gradient (a local leaf's block of it)."""
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
                              batch.get("mask"), mesh=mesh)
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
        # a leaf the loss does not read gets a zero gradient (jax.grad's)
        grads = torch.autograd.grad(loss, leaves_, allow_unused=True,
                                    materialize_grads=True)
    aux = {"expert_counts": aux["expert_counts"]} if moe else {}
    return value.detach(), aux, unflatten(skeleton, list(grads))


def sharded_grads(cfg: ModelConfig, mesh, params, batch: Dict[str, Any],
                  overrides: Optional[dict] = None):
    """(loss, aux, grads, local, full params) of one sharded step before
    its update, from DTensor ``params`` and ``batch`` laid out as
    :func:`make_sharded_train_step` takes them: ``grads`` the whole
    batch's gradient, reduced (a local leaf's as this rank's block over
    "model"; ``local`` marks those leaves), not yet clipped; the full
    params as the step used them."""
    pspecs = model_pspecs(mesh, cfg, overrides)
    step_cfg = tp_config(cfg, mesh, overrides)
    local, partial = _roles(step_cfg, mesh, pspecs)
    axes = _batch_axes(mesh, batch_specs(mesh, cfg, batch)["labels"])
    full_p = tree_map(lambda x, loc: gather_except(x, "model") if loc
                      else full(x), params, local)
    l_batch = tree_map(lambda x: x.to_local(), batch)
    loss, aux, grads = sharded_loss_and_grads(full_p, step_cfg, l_batch,
                                              mesh, axes)
    for g, part in zip(leaves(grads), leaves(partial)):
        all_reduce(g, mesh, axes + ("model",) if part else axes)
    return loss, aux, grads, local, full_p


def gather_local(grads, local, params, shardings):
    """``grads`` as :func:`sharded_grads` gives them, each local leaf's
    block (``local``) all-gathered over "model" into the whole leaf's
    gradient: the whole gradient of every leaf.  ``params``: the DTensor
    params of the step, ``shardings`` their ``named`` layouts."""
    def one(g, loc, x, sh):
        if not loc:
            return g
        return full(wrap(g, NamedSharding(sh.mesh, _only(sh.spec, keep=True)),
                         x.shape))
    return tree_map(one, grads, local, params, shardings)


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
    norm of 1.0, as ``make_train_step``'s default.  Tensor parallel over
    "model", and a MoE config on the single-program route or with
    ``moe_groups`` and ``moe_expert_sharded`` the expert-parallel one (see
    the module doc).  A batch that does not split runs whole on every
    rank."""
    pspecs = model_pspecs(mesh, cfg, overrides)
    p_sh = named(mesh, pspecs)

    def block(g, sh, loc):
        # a local leaf's gradient is already this rank's block over "model"
        if loc:
            sh = NamedSharding(mesh, _only(sh.spec, keep=False))
        return local_block(g, sh).contiguous()

    def train_step(params, opt_state: OptState, batch: Dict[str, Any]):
        o_sh = named(mesh, opt_pspecs(pspecs, opt_state))
        _check_layout(params, p_sh, "params")
        _check_layout(opt_state, o_sh, "optimizer state")
        _check_layout(batch, named(mesh, batch_specs(mesh, cfg, batch)),
                      "batch")
        l_params, l_state = tree_map(lambda x: x.to_local(),
                                     (params, opt_state))
        loss, aux, grads, local, full_p = sharded_grads(cfg, mesh, params,
                                                        batch, overrides)
        grads, gnorm = _clip(grads, local, mesh)
        lr = lr_schedule(l_state.step + 1)
        if optimizer.elementwise:
            blocks = tree_map(block, grads, p_sh, local)
            new_p, new_s = optimizer.update(blocks, l_state, l_params, lr)
            new_p = tree_map(lambda x, sh, old: wrap(x, sh, old.shape),
                             new_p, p_sh, params)
            new_s = tree_map(lambda x, sh, old: wrap(x, sh, old.shape),
                             new_s, o_sh, opt_state)
        else:
            full_p = tree_map(lambda fp, x, loc: full(x) if loc else fp,
                              full_p, params, local)
            new_p, new_s = optimizer.update(
                gather_local(grads, local, params, p_sh),
                gather(opt_state), full_p, lr)
            new_p, new_s = distribute((new_p, new_s), (p_sh, o_sh))
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        if "expert_counts" in aux:
            metrics["expert_counts"] = aux["expert_counts"]
        return new_p, new_s, metrics

    return train_step
