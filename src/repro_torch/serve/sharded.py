"""Sharded serving: ``serve.engine.prefill`` and ``decode_step`` on a
device mesh, as one rank of the caller's process group (this module never
starts one), on the reference's layouts (its dry run's ``in_shardings`` /
``out_shardings``, ``repro/launch/dryrun.py``):

* params by ``launch.sharding.model_pspecs``: FSDP over "data" (each leaf
  the rank's block, gathered inside the block that reads it), the heads,
  the MLP's columns, the vocabulary and, on an arch's override, the
  experts' ``d_expert`` over "model" (the attention, the dense MLP, the
  embedding, the head and the MoE expert FFN on the rank's blocks, and
  RWKV-6's and Mamba2's mixes on the rank's heads);
* the cache by ``launch.sharding.cache_pspecs``: the batch over the batch
  axes, the KV heads over "model" where they divide it, else the sequence
  over "model" (and over the batch axes too when the batch does not
  split), the recurrent states' heads and channels over "model";
* the batch by ``batch_specs``.

Each rank computes its part of the single-device function (see
``serve.engine``'s module doc for how).  This module makes the serving
config, lays params and caches out, and gathers a rank's outputs whole
(tests and ``chip_smoke.py``)::

    cfg_s = serve_config(cfg, mesh, batch=B, seq_len=S, kind="prefill")
    p = lay_out_params(params, mesh, cfg)
    logits, cache = engine.prefill(p, cfg_s, tokens=batch_block(toks, mesh,
                                   cfg_s), max_len=M, mesh=mesh)
    cfg_d = serve_config(cfg, mesh, batch=B, seq_len=M, kind="decode")
    logits, cache, aux = engine.decode_step(p, cfg_d, cache, next_tok,
                                            mesh=mesh)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..launch.sharding import (apply_overrides, default_rules, full,
                               local_block, mesh_axes, model_pspecs, named,
                               tp_config, wrap)
from ..models.model import ModelConfig
from ..pytree import tree_map

__all__ = ["batch_block", "gather_outputs", "lay_out_params",
           "serve_config"]


def serve_config(cfg: ModelConfig, mesh, batch: int, seq_len: int,
                 kind: str, overrides: Optional[dict] = None) -> ModelConfig:
    """``cfg`` as a sharded ``kind`` ("prefill" / "decode") call of a
    global ``batch`` runs it on ``mesh`` (``overrides``: the arch's
    sharding overrides): the batch axes and, for prefill, the MoE groups
    and expert route of ``launch.dryrun.step_config``; a decode routes the
    whole batch with no groups, each rank running its experts' slots where
    the rules put the experts on "model" (the reference's decode calls
    ``moe_block`` without groups); ``tp_axes`` of
    ``launch.sharding.tp_config``."""
    from ..launch.dryrun import step_config
    from ..launch.shapes import ShapeSpec
    if kind not in ("prefill", "decode"):
        raise ValueError(f"serving kind {kind!r}")
    overrides = overrides or {}
    cfg = step_config(cfg, ShapeSpec(kind, seq_len, batch, kind), mesh,
                      overrides)
    if kind == "decode" and cfg.moe is not None:
        rules = apply_overrides(default_rules(mesh, cfg), overrides)
        cfg = dataclasses.replace(
            cfg, moe_groups=None,
            moe_expert_sharded=rules.get("experts") == "model"
            and mesh_axes(mesh).get("model", 1) > 1)
    return tp_config(cfg, mesh, overrides)


def lay_out_params(params, mesh, cfg: ModelConfig,
                   overrides: Optional[dict] = None):
    """Whole ``params`` (the same on every rank) -> DTensors laid out by
    ``model_pspecs``: each rank keeps a copy of its block (no collective),
    so the whole tensors can be freed."""
    def one(x, sh):
        block = local_block(x, sh).clone(memory_format=torch.contiguous_format)
        return wrap(block, sh, x.shape)
    return tree_map(one, params, named(mesh, model_pspecs(mesh, cfg,
                                                          overrides)))


def batch_block(x: torch.Tensor, mesh, cfg: ModelConfig,
                name: str = "tokens") -> torch.Tensor:
    """This rank's slice of the whole batch input ``name`` ("tokens",
    "embeds", "positions") as ``batch_specs`` lays it out."""
    from ..launch.sharding import batch_specs
    spec = batch_specs(mesh, cfg, {name: x})[name]
    return local_block(x, named(mesh, spec))


def gather_outputs(tree):
    """A rank's outputs (DTensor leaves; plain tensors stay as they are)
    -> the whole tensors on every rank (one all-gather for each mesh axis
    that cuts a leaf)."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda x: full(x) if isinstance(x, DTensor) else x,
                    tree)
