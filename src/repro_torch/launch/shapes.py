"""Assigned input shapes and per-arch applicability (the port of
``repro/launch/shapes.py``, the 40-cell grid).

  train_4k     seq 4,096   global_batch 256   -> train_step
  prefill_32k  seq 32,768  global_batch 32    -> serve prefill
  decode_32k   seq 32,768  global_batch 128   -> serve decode (1 new token)
  long_500k    seq 524,288 global_batch 1     -> serve decode, sub-quadratic
                                                 archs only
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.model import ModelConfig

__all__ = ["SHAPES", "ShapeSpec", "applicable", "input_specs"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str           # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    """long_500k only for sub-quadratic archs (SSM / hybrid / SWA) — the
    7 pure full-attention archs skip it."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Stand-ins for every model input: tensors on the ``meta`` device (a
    shape and a dtype, no storage), where the reference has
    ``jax.ShapeDtypeStruct``."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32

    if shape.kind == "train":
        specs = {"labels": _meta((b, s), i32)}
        if cfg.frontend == "embeddings":
            specs["embeds"] = _meta((b, s, cfg.d_model), torch.bfloat16)
            if cfg.rope == "mrope":
                specs["positions"] = _meta((3, b, s), i32)
        else:
            specs["tokens"] = _meta((b, s), i32)
        return specs

    if shape.kind == "prefill":
        if cfg.frontend == "embeddings":
            specs = {"embeds": _meta((b, s, cfg.d_model), torch.bfloat16)}
            if cfg.rope == "mrope":
                specs["positions"] = _meta((3, b, s), i32)
            return specs
        return {"tokens": _meta((b, s), i32)}

    if shape.kind == "decode":
        # one new token against a seq_len-deep cache
        return {"tokens": _meta((b,), i32)}

    raise ValueError(shape.kind)
