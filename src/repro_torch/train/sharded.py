"""The sharded train step: params, optimizer state and batch laid out on a
device mesh by the reference's rules (``launch.sharding``), one step the
single-device :func:`repro_torch.train.steps.make_train_step`'s function.

At rest every leaf is a DTensor whose placements are
``named(mesh, spec).placements``: params by ``model_pspecs`` (FSDP over
"data", the head / mlp / vocab dims over "model"), optimizer state by
``opt_pspecs``, the batch by ``batch_specs``.  A step, on every rank of
the mesh (the caller's process group; this module never starts one),
holds no whole leaf, gradient or optimizer state beyond the block that
reads it (the reference's FSDP, "embed" on "data": gather at use):

1. hands each parameter leaf to the model as this rank's block
   (``launch.sharding.AtUse``); each block of the model all-gathers the
   leaves it reads inside itself (a stacked leaf sliced to its layer
   first; the embedding, the loss's head and the final norm where they
   are read), over every axis that cuts them but "model" for a leaf the
   rank keeps as its block over "model" (see below), and gathers again
   when remat recomputes the block;
2. runs forward and backward on plain local tensors (the rank's slice of
   the batch over the batch axes), so the kernels launch as they do
   without a mesh;
3. sums what is a statistic of the whole batch over the batch axes before
   the backward: the loss's token count (each rank backpropagates its own
   NLL sum over the global count) and, for MoE, the balance loss (each
   rank its share; the routing itself follows the whole batch, see
   ``models.moe``);
4. gets each leaf's gradient as this rank's block: each gather's backward
   reduce-scatters over "data" where "data" is a batch axis (and over
   "model" for a leaf whose gradient is a partial sum there), else keeps
   this rank's slice (a batch that does not split: every "data" rank holds
   the same gradient, which a sum would count once a rank); then
   all-reduces over the batch axes no gather summed ("pod") and over
   "model" for a partial leaf "model" does not cut;
5. takes the gradient norm once from the blocks (each block's squares
   summed over the axes that cut it) and clips;
6. updates each leaf's block: AdamW elementwise, Adafactor with its
   factored means and update RMS over a cut dim summed locally,
   all-reduced over the axes that cut it and divided by the whole length
   (a leaf whole on the rank takes the single-device update as it is).

Ranks that differ only on "model" compute the same batch slice, each its
part of it.  At more than one "model" rank the step is tensor parallel
over "model" as the rules lay the leaves out: the config's ``tp_axes``
names the logical axes the rules put on "model" (heads, kv_heads, mlp,
vocab, expert_mlp), and ``models.model.tp_roles`` the leaves whose module
runs on its rank's block: the attention's q / o (and k / v where they
split), the dense MLP, the embedding and the loss's head
(``models.layers``' module doc has the forms, and the fallback where the
rule cuts through a head), and where the rules put ``expert_mlp`` on
"model" (Mixtral's override, the reference's expert tensor parallelism)
the MoE experts' ``e_gate`` / ``e_up`` columns and ``e_down`` rows of
``d_expert``.  Those leaves stay this rank's block over "model" (still
gathered over "data" at use), their gradients that block's; the
activations' partial sums meet in two all-reduces over "model" a dense
block (``launch.sharding.to_model`` / ``from_model``).  A MoE layer on
expert tensor parallelism routes the whole batch on every rank of
"model" (the same router, counts, balance loss, capacity, slots and
dropped pairs), runs every expert on its block of ``d_expert`` and sums
the combined ``(T, D)`` outputs in one all-reduce over "model" (never
the ``(E, C, D)`` buffer); its backward all-reduces the gradients of the
dispatched rows and of the routing weights (two), so the router's
gradient comes out whole on every rank.  With the dense layer's
attention that is 6 all-reduces over "model" a MoE layer and step (the
recompute under remat stops before the experts').  Otherwise the MoE
layers keep their route: the single program with the layer's experts
gathered at use, or with ``moe_groups`` and ``moe_expert_sharded``
expert parallelism (the reference's ``_moe_shard_map``), where each rank
of "model" routes its sequence slice to the experts it holds
(``models.moe``) and an expert leaf (one whose spec puts "model" on its
experts dim) is local to "model" too.  RWKV-6's time mix and Mamba2's
mix run the rank's heads (``layers.head_share``: the first ``H mod m``
ranks one more, a rank may take none and still joins every
collective): the leaves whose rules' block is the rank's heads' slice
stay that block (RWKV-6's ``wr`` / ``wk`` / ``wv`` / ``wg`` where its
heads divide "model", Mamba2's ``out_proj`` where its heads do), the
others the mix reads are gathered at use and sliced to the rank's heads,
their gradients partial (``models.model.tp_roles``); one all-reduce of
each mix's output, one more of Mamba2's sums of squares (its gated norm
runs over the whole ``d_inner``).  RWKV-6's channel mix runs on the
rank's blocks of ``f_wk`` / ``f_wv`` / ``f_wr`` (a reduce-scatter and an
all-gather).  At one rank on every axis, or without a mesh, every op is
the single-device step's.  The layout helpers and the collectives (counted in
``launch.sharding.COLLECTIVES``) are ``launch.sharding``'s.  Under remat
every block's forward, its gathers and collectives with it, runs again
in the backward, in the same order on every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..launch.sharding import (TP_AXES, AtUse, all_reduce,  # noqa: F401
                               batch_specs, cut_axes, entry_axes, full,
                               hand_over, leaf_roles, mesh_axes,
                               model_pspecs, named, opt_pspecs, tp_config,
                               wrap)
from ..models.model import ModelConfig, forward, loss_terms
from ..optim.optimizers import OptState, Optimizer
from ..pytree import flatten, leaves, tree_map, unflatten

__all__ = ["block_means", "gather_local", "leaf_roles",
           "make_sharded_train_step", "sharded_grads",
           "sharded_loss_and_grads", "state_shardings", "tp_config"]


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
def _clip(grads, cuts, mesh, max_norm: float = 1.0):
    """``clip_by_global_norm`` of the whole gradient from the rank's blocks
    (``cuts``: each leaf's :func:`launch.sharding.cut_axes`, in leaf
    order): the squares of the blocks of the leaves each set of axes cuts
    summed over those axes, a leaf no axis cuts counted once (without cut
    leaves, the same operations in the same order)."""
    sq = [(torch.sum(torch.square(g.to(torch.float32))), ax)
          for g, ax in zip(leaves(grads), cuts)]
    total = sum(q for q, ax in sq if not ax)
    for axes in dict.fromkeys(ax for _, ax in sq if ax):
        part = sum(q for q, ax in sq if ax == axes)
        all_reduce(part, mesh, axes)
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
    batch on every rank) and ``params`` as the model reads them (each leaf
    a tensor or a ``launch.sharding.AtUse`` of this rank's block, gathered
    at use; with ``cfg.tp_axes``, the leaves of ``tp_roles`` this rank's
    blocks over "model"): the loss and ``aux["expert_counts"]`` are the
    whole batch's; ``grads`` holds each leaf's gradient as the shape it
    was handed over in (an ``AtUse``'s as its block), this rank's share:
    what the gathers' backward did not sum is summed by the caller."""
    n_ranks = math.prod(mesh_axes(mesh)[a] for a in axes)
    cfg = dataclasses.replace(cfg, act_batch_axes=axes)
    flat, skeleton = flatten(params)
    leaves_ = [(p.local if isinstance(p, AtUse) else p).detach()
               .requires_grad_(True) for p in flat]
    with torch.enable_grad():
        p = unflatten(skeleton, [AtUse(x, f.cuts) if isinstance(f, AtUse)
                                 else x for x, f in zip(leaves_, flat)])
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
    """(loss, aux, grads) of one sharded step before its update, from
    DTensor ``params`` and ``batch`` laid out as
    :func:`make_sharded_train_step` takes them: ``grads`` the whole
    batch's gradient, reduced, each leaf's as this rank's block of it (the
    local block of ``params``' leaf), not yet clipped.

    Each leaf goes to the model as an ``AtUse`` over the axes that cut it
    (but "model" for a leaf of ``leaf_roles``' local ones): where "data"
    is a batch axis the gathers' backward reduce-scatters over it, else it
    keeps this rank's slice (each "data" rank then holds the same whole
    gradient); over "model" it reduce-scatters a partial leaf's and keeps
    the slice of any other's.  What is left is all-reduced: over the batch
    axes no gather summed, and over "model" for a partial leaf "model"
    does not cut."""
    step_cfg = tp_config(cfg, mesh, overrides)
    _, partial = leaf_roles(cfg, mesh, overrides)
    axes = _batch_axes(mesh, batch_specs(mesh, cfg, batch)["labels"])
    handed = hand_over(params, cfg, mesh, overrides,
                       sums=tuple(a for a in axes if a == "data"))
    l_batch = tree_map(lambda x: x.to_local(), batch)
    loss, aux, grads = sharded_loss_and_grads(handed, step_cfg, l_batch,
                                              mesh, axes)
    for g, x, part in zip(leaves(grads), leaves(params), leaves(partial)):
        cut = cut_axes(x)
        rest = tuple(a for a in axes if a not in cut)
        all_reduce(g, mesh, rest + ("model",) if part and "model" not in cut
                   else rest)
    return loss, aux, grads


def gather_local(grads, params, shardings):
    """``grads`` as :func:`sharded_grads` gives them (each leaf's block)
    all-gathered into the whole gradient of every leaf.  ``params``: the
    DTensor params of the step, ``shardings`` their ``named`` layouts."""
    return tree_map(lambda g, x, sh: full(wrap(g, sh, x.shape)), grads,
                    params, shardings)


def block_means(params, mesh):
    """The optimizers' ``means`` for the ranks' blocks of DTensor
    ``params`` (``optim.optimizers.adafactor``'s; AdamW reads none): each
    leaf's None where no axis cuts it, else ``mean(t, dim, of)``, which
    sums ``t`` over its ``dim`` (all of it for None), all-reduces the sum
    over the axes that cut the leaf's dims ``of`` (every dim for None) and
    divides by their whole length."""
    def one(x):
        if not cut_axes(x):
            return None
        shape = tuple(x.shape)

        def mean(t, dim, of):
            dims = range(len(shape)) if of is None else of
            total = t.sum() if dim is None else t.sum(dim)
            all_reduce(total, mesh, cut_axes(x, dims))
            return total / math.prod(shape[d] for d in dims)
        return mean
    return tree_map(one, params)


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
    rank.  FSDP over "data": each leaf gathered where a block reads it,
    its gradient reduce-scattered, Adafactor on the rank's blocks (the
    module doc)."""
    pspecs = model_pspecs(mesh, cfg, overrides)
    p_sh = named(mesh, pspecs)

    def train_step(params, opt_state: OptState, batch: Dict[str, Any]):
        o_sh = named(mesh, opt_pspecs(pspecs, opt_state))
        _check_layout(params, p_sh, "params")
        _check_layout(opt_state, o_sh, "optimizer state")
        _check_layout(batch, named(mesh, batch_specs(mesh, cfg, batch)),
                      "batch")
        l_params, l_state = tree_map(lambda x: x.to_local(),
                                     (params, opt_state))
        loss, aux, grads = sharded_grads(cfg, mesh, params, batch, overrides)
        grads, gnorm = _clip(grads, [cut_axes(x) for x in leaves(params)],
                             mesh)
        lr = lr_schedule(l_state.step + 1)
        new_p, new_s = optimizer.update(grads, l_state, l_params, lr,
                                        means=block_means(params, mesh))
        new_p = tree_map(lambda x, sh, old: wrap(x, sh, old.shape),
                         new_p, p_sh, params)
        new_s = tree_map(lambda x, sh, old: wrap(x, sh, old.shape),
                         new_s, o_sh, opt_state)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        if "expert_counts" in aux:
            metrics["expert_counts"] = aux["expert_counts"]
        return new_p, new_s, metrics

    return train_step
