"""Train-step functions (the port of ``repro/train/steps.py``): loss ->
grad -> (optional accumulation / compression) -> clip -> optimizer update.

A step is a plain function of (params, opt_state, batch), the batch a dict
of device tensors.  It takes the gradient of :func:`compute_loss` with
``torch.autograd.grad`` over detached leaf views of the params (so the
caller's tensors are never marked), and returns new params and optimizer
state, as the reference's pure step does.  Nothing in a step reads a value
back to the host: the loss, the gradient norm and the learning rate come
back as device tensors in ``metrics``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..models.model import ModelConfig, forward, loss_fn
from ..optim.optimizers import Optimizer, clip_by_global_norm
from ..pytree import flatten, tree_map, unflatten

__all__ = ["compute_loss", "loss_and_grads", "make_train_step"]


def compute_loss(params, cfg: ModelConfig, batch: Dict[str, Any]):
    """batch: {"tokens" (B,S)} or {"embeds" (B,S,D)}, plus "labels" (B,S),
    optional "positions", "mask"."""
    hidden, aux = forward(
        params, cfg,
        tokens=batch.get("tokens"),
        embeds=batch.get("embeds"),
        positions=batch.get("positions"),
    )
    loss = loss_fn(params, cfg, hidden, batch["labels"], batch.get("mask"))
    if "moe_aux_loss" in aux:
        loss = loss + 0.01 * aux["moe_aux_loss"]
    return loss, aux


def loss_and_grads(params, cfg: ModelConfig, batch: Dict[str, Any]):
    """(loss, aux, grads): the loss and aux of :func:`compute_loss`
    (detached) and its gradient, a tree like ``params``.  A leaf the loss
    does not read (``embed`` under the embeddings frontend) gets a zero
    gradient, as ``jax.grad`` gives it."""
    flat, skeleton = flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss, aux = compute_loss(unflatten(skeleton, leaves), cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    aux = tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor)
                   else t, aux)
    return loss.detach(), aux, unflatten(skeleton, list(grads))


def make_train_step(
    cfg: ModelConfig,
    optimizer: Optimizer,
    lr_schedule: Callable[[torch.Tensor], torch.Tensor],
    grad_accum: int = 1,
    max_grad_norm: float = 1.0,
    grad_transform: Optional[Callable] = None,   # e.g. compression hook
):
    """Returns train_step(params, opt_state, batch) ->
    (params, opt_state, metrics).  With grad_accum > 1 the batch's leading
    dim is split into microbatches taken one after another (activation
    memory divided by grad_accum), their losses and gradients averaged."""

    def accumulated(params, batch):
        def micro(i):
            return loss_and_grads(params, cfg, {
                k: t.reshape((grad_accum, t.shape[0] // grad_accum)
                             + t.shape[1:])[i] for k, t in batch.items()})

        tot_loss, _, tot_grads = micro(0)
        for i in range(1, grad_accum):
            loss, _, grads = micro(i)
            tot_grads = tree_map(torch.add, tot_grads, grads)
            tot_loss = tot_loss + loss
        scale = 1.0 / grad_accum
        return tot_loss * scale, {}, tree_map(lambda g: g * scale, tot_grads)

    def train_step(params, opt_state, batch):
        if grad_accum > 1:
            loss, aux, grads = accumulated(params, batch)
        else:
            loss, aux, grads = loss_and_grads(params, cfg, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr = lr_schedule(opt_state.step + 1)  # 1-based: step 0 is warmup's first
        params, opt_state = optimizer.update(grads, opt_state, params, lr)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        if "expert_counts" in aux:
            metrics["expert_counts"] = aux["expert_counts"]
        return params, opt_state, metrics

    return train_step
