"""Optimizers (the port of ``repro/optim/optimizers.py``): AdamW and
Adafactor as functions over nested dicts of tensors.

Adafactor (factored second moment, no momentum by default) exists for the
1T-parameter config: float32 AdamW state for Kimi-K2 would be 12 TB;
factored statistics cut optimizer state to about params / 1000.

Everything a step computes stays on the parameters' device: the step count
is an int32 device tensor, and the bias corrections, the learning rate and
the clip scale are device tensor ops, never Python floats, so an update
makes no host sync.  Updates are functional, as the reference's: they return
new tensors and leave their inputs as they were.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

import torch

from ..pytree import leaves, tree_map, unzip

__all__ = ["OptState", "Optimizer", "adafactor", "adamw",
           "clip_by_global_norm", "get_optimizer", "global_norm"]


class OptState(NamedTuple):
    step: torch.Tensor      # int32, on the parameters' device
    inner: Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], OptState]
    # update(grads, state, params, lr, means=None): ``means`` (see
    # :func:`adafactor`) lets an update that reads across a leaf run on
    # blocks of it; AdamW's reads each element alone and ignores it
    update: Callable[..., Tuple[Any, OptState]]


def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].device)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (in float32), the leaves
    summed in the reference's order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, tree), norm


# ------------------------------------------------------------------- AdamW
def adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    def init(params):
        inner = {"m": tree_map(lambda p: _zeros(p.shape, p), params),
                 "v": tree_map(lambda p: _zeros(p.shape, p), params)}
        return OptState(_step0(params), inner)

    @torch.no_grad()
    def update(grads, state, params, lr, means=None):
        step = state.step + 1
        t = step.to(torch.float32)
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t

        def upd(g, m, v, p):
            g = g.to(torch.float32)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mh = m / c1
            vh = v / c2
            pf = p.to(torch.float32)
            delta = mh / (torch.sqrt(vh) + eps) + weight_decay * pf
            return (pf - lr * delta).to(p.dtype), m, v

        out = tree_map(upd, grads, state.inner["m"], state.inner["v"],
                       params)
        new_p, new_m, new_v = unzip(out, 3)
        return new_p, OptState(step, {"m": new_m, "v": new_v})

    return Optimizer(init, update)


# ---------------------------------------------------------------- Adafactor
def adafactor(eps=1e-30, clip_threshold=1.0, decay=0.8,
              weight_decay=0.0) -> Optimizer:
    """Factored second-moment estimator (Shazeer & Stern 2018), no
    momentum.

    ``update(..., means=)`` updates blocks of leaves (the sharded train
    step's): ``means`` a tree like the params whose leaf is None for a leaf
    whole on the rank, else ``mean(t, dim, of)``, the whole leaf's mean
    over ``dim`` of ``t`` from this block's (``of``: the leaf's dims that
    ``dim`` stands for, None for all of them)."""

    def _factored(p):
        return p.dim() >= 2 and p.shape[-1] >= 8 and p.shape[-2] >= 8

    def init(params):
        def one(p):
            if _factored(p):
                return {"vr": _zeros(p.shape[:-1], p),
                        "vc": _zeros(p.shape[:-2] + p.shape[-1:], p)}
            return {"v": _zeros(p.shape, p)}
        return OptState(_step0(params), tree_map(one, params))

    @torch.no_grad()
    def update(grads, state, params, lr, means=None):
        step = state.step + 1
        t = step.to(torch.float32)
        beta = 1.0 - t ** (-decay)

        def upd(p, g, s, mean):
            mean = mean or (lambda t, dim, of: torch.mean(t) if dim is None
                            else t.mean(dim))
            g = g.to(torch.float32)
            g2 = g * g + eps
            if "vr" in s:
                vr = beta * s["vr"] + (1 - beta) * mean(g2, -1, (-1,))
                vc = beta * s["vc"] + (1 - beta) * mean(g2, -2, (-2,))
                denom = (vr[..., None] * vc[..., None, :]) / torch.clamp(
                    mean(vr, -1, (-2,))[..., None, None], min=eps)
                u = g * torch.rsqrt(denom + eps)
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v + eps)
                new_s = {"v": v}
            # update clipping (RMS)
            rms = torch.sqrt(mean(u * u, None, None))
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            pf = p.to(torch.float32)
            new_p = pf - lr * u
            if weight_decay:
                new_p = new_p - lr * weight_decay * pf
            return new_p.to(p.dtype), new_s

        if means is None:
            means = tree_map(lambda p: None, params)
        new_p, new_s = unzip(tree_map(upd, params, grads, state.inner,
                                      means), 2)
        return new_p, OptState(step, new_s)

    return Optimizer(init, update)


def get_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise KeyError(name)
