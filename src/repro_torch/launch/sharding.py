"""Logical-axis -> mesh-axis rules and input/cache/opt-state shardings (the
port of ``repro/launch/sharding.py``).

The model schema labels every parameter dim with a *logical* axis
("embed", "heads", "mlp", "vocab", "experts", ...).  One rules table maps
those to mesh axes; per-arch overrides (e.g. Mixtral's experts) come from
the config module.  Batch/cache shardings are derived here too, so the
sharded train step and its checkpoints agree.

A :class:`PartitionSpec` is the reference's: a tuple with one entry per
tensor dim, each ``None`` (replicated), one mesh axis name, or a tuple of
names (the dim split over their product, the FIRST name the major one).
The rule functions read only ``mesh.shape`` as a ``{name: size}`` mapping,
as the reference's do, so they take a stand-in with only ``.shape``; a
:class:`torch.distributed.device_mesh.DeviceMesh` is read through
:func:`mesh_axes`.  :func:`named` turns specs into DTensor placements on a
mesh.

The layout helpers and the collectives of the sharded path live here too
(:func:`distribute`, :func:`gather`, :func:`all_reduce`,
:func:`gather_slices`), so the train step, the MoE block and checkpoints
share them.  Each collective is counted in :data:`COLLECTIVES` as plain
integers (calls and bytes), as ``core.shard`` counts the telemetry
path's.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..models.model import ModelConfig, param_pspecs
from ..pytree import tree_map

__all__ = ["COLLECTIVES", "NamedSharding", "PartitionSpec", "all_reduce",
           "apply_overrides", "batch_axes", "batch_pspec", "batch_specs",
           "cache_pspecs", "default_rules", "distribute", "entry_axes",
           "full", "gather", "gather_slices", "local_block", "map_specs",
           "mesh_axes", "model_pspecs", "named", "opt_pspecs", "placements",
           "wrap"]


class PartitionSpec(tuple):
    """``PartitionSpec(*entries)``: one entry per tensor dim, each None, an
    axis name or a tuple of names (major first).  A one-name tuple reads
    as the name and an empty one as None, as ``jax.sharding.PartitionSpec``
    normalises them."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in mesh-dim order: ``mesh.shape`` itself when
    it is a mapping (a stand-in), else a DeviceMesh's names and sizes."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def default_rules(mesh, cfg: ModelConfig) -> Dict[Optional[str], object]:
    """FSDP over "data", tensor parallel over "model", DP over "pod"+"data".

    kv_heads shard over "model" only when divisible; experts shard over
    "model" when divisible (EP), else expert-TP via the d_expert axis.
    """
    model_size = mesh_axes(mesh).get("model", 1)
    rules: Dict[Optional[str], object] = {
        None: None,
        "layers": None,
        "embed": "data",          # FSDP / ZeRO-3: gather at use
        "heads": "model",
        "kv_heads": "model" if cfg.n_kv_heads % model_size == 0 else None,
        "mlp": "model",
        "vocab": "model",
        "experts": None,
        "expert_mlp": "model",
    }
    if cfg.moe is not None and cfg.moe.n_experts % model_size == 0:
        rules["experts"] = "model"     # expert parallelism
        rules["expert_mlp"] = None
    # heads not divisible by model axis (e.g. qwen2 14H, musicgen 24H on 16):
    # fall back to FSDP-only sharding for head-dims
    if (cfg.n_heads * cfg.head_dim) % model_size != 0:
        rules["heads"] = None
    if (cfg.n_heads % model_size != 0
            and (cfg.n_heads * cfg.head_dim) % model_size == 0):
        # shard the fused head*dim axis anyway (it is a single matrix dim)
        rules["heads"] = "model"
    return rules


def apply_overrides(rules: dict, overrides: dict) -> dict:
    out = dict(rules)
    out.update(overrides)
    return out


def batch_axes(mesh, batch_size: int | None = None):
    """Mesh axes the batch dim shards over: the largest suffix of
    ("pod","data") whose size divides the batch (None if nothing fits —
    e.g. long_500k's global_batch=1)."""
    sizes = mesh_axes(mesh)
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    if batch_size is not None:
        while axes:
            prod = 1
            for a in axes:
                prod *= sizes[a]
            if batch_size % prod == 0:
                break
            axes = axes[1:]
        if not axes:
            return None
    return axes if len(axes) > 1 else axes[0]


def _maybe(axis, dim_size, sizes):
    """axis if it divides dim_size else None."""
    if axis is None:
        return None
    sz = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        sz *= sizes[a]
    return axis if dim_size % sz == 0 else None


def batch_pspec(mesh, batch_size: int | None = None) -> PartitionSpec:
    return P(batch_axes(mesh, batch_size))


def batch_specs(mesh, cfg: ModelConfig, batch_shapes: dict) -> dict:
    """PartitionSpecs for a training batch dict (leading dim = batch)."""
    specs = {}
    for k, v in batch_shapes.items():
        nd = len(v.shape)
        if k == "positions" and nd == 3:      # mrope (3, B, S): batch is dim 1
            b = batch_axes(mesh, v.shape[1])
            specs[k] = P(None, b, None)
        else:
            b = batch_axes(mesh, v.shape[0])
            specs[k] = P(b, *((None,) * (nd - 1)))
    return specs


def cache_pspecs(mesh, cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """Shardings for the serving cache.

    KV caches: batch over ("pod","data") when divisible; KV heads over
    "model" when divisible, else the sequence dim takes "model".  When the
    batch cannot shard (long_500k, B=1) the sequence dim also absorbs the
    data axes."""
    sizes = mesh_axes(mesh)
    b = batch_axes(mesh, batch)
    kvh_ax = _maybe("model", cfg.n_kv_heads, sizes)
    hd_ax = None
    seq_candidates = []
    if kvh_ax is None:
        seq_candidates.append("model")
    if b is None:
        seq_candidates.extend(a for a in ("pod", "data") if a in sizes)
    seq_ax = _maybe(tuple(seq_candidates) if len(seq_candidates) > 1
                    else (seq_candidates[0] if seq_candidates else None),
                    max_len, sizes)
    pos = P(b)

    if cfg.family in ("attn", "moe"):
        kv = P(None, b, kvh_ax, seq_ax, hd_ax)
        return {"k": kv, "v": kv, "pos": pos}
    if cfg.family == "rwkv6":
        h_ax = _maybe("model", cfg.d_model // 64, sizes)
        return {
            "wkv": P(None, b, h_ax, None, None),
            "sh_mix": P(None, b, None),
            "sh_ffn": P(None, b, None),
            "pos": pos,
        }
    if cfg.family == "zamba2":
        kv = P(None, b, kvh_ax, seq_ax, hd_ax)
        return {
            "ssm": P(None, b, _maybe("model", cfg.mamba_heads, sizes),
                     None, None),
            "conv": P(None, b, None,
                      _maybe("model", cfg.d_inner + 2 * cfg.ssm_state,
                             sizes)),
            "k": kv, "v": kv, "pos": pos,
        }
    raise ValueError(cfg.family)


# ------------------------------------------------------------ placements
def entry_axes(entry) -> Tuple[str, ...]:
    """A spec entry's axis names, major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(mesh, spec: PartitionSpec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where the mesh axis shards tensor dim ``d``, else
    ``Replicate()``.

    A dim split over several axes is split major-first in the ENTRY's
    order, while DTensor splits it in mesh-dim order.  Where the two
    differ, an axis that the entry puts below axes that come after it on
    the mesh is a ``_StridedShard`` whose split factor is those axes'
    product (so ``("pod", "data")`` on a mesh ordered ("data", "pod")
    still gives rank (pod p, data q) block ``p * |data| + q``).  An axis
    the mesh lacks is size 1 (the rules read ``mesh.shape.get("model",
    1)``): it shards nothing."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    sizes = mesh_axes(mesh)
    order = list(sizes)
    where: Dict[str, Tuple[int, Tuple[str, ...]]] = {}
    for d, entry in enumerate(spec):
        for a in entry_axes(entry):
            if a in where:
                raise ValueError(f"{spec}: mesh axis {a!r} shards two dims")
            where[a] = (d, entry_axes(entry))
    out = []
    for a in order:
        if a not in where:
            out.append(Replicate())
            continue
        d, axes = where[a]
        factor = 1
        for b in axes[:axes.index(a)]:
            if b in sizes and order.index(b) > order.index(a):
                factor *= sizes[b]
        out.append(Shard(d) if factor == 1
                   else _StridedShard(d, split_factor=factor))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``): what
    :func:`distribute` and ``CheckpointManager.restore(shardings=)`` lay a
    leaf out by."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def map_specs(fn, tree):
    """``fn`` on every :class:`PartitionSpec` of a tree of dicts, lists,
    tuples and namedtuples (a spec is a tuple, so a plain tree map would
    walk into it)."""
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, v) for v in tree)
    raise TypeError(f"not a spec tree leaf: {tree!r}")


def named(mesh, tree_pspecs):
    return map_specs(lambda s: NamedSharding(mesh, s), tree_pspecs)


def model_pspecs(mesh, cfg: ModelConfig, overrides: Optional[dict] = None):
    rules = apply_overrides(default_rules(mesh, cfg), overrides or {})
    return param_pspecs(cfg, rules)


def opt_pspecs(param_specs, opt_state):
    """Optimizer state mirrors parameter sharding (m/v same shape; adafactor
    factored stats drop the last/second-to-last dim)."""
    inner = opt_state.inner
    # adamw: {"m": tree, "v": tree} same structure as params
    if isinstance(inner, dict) and set(inner) == {"m", "v"}:
        return type(opt_state)(P(), {"m": param_specs, "v": param_specs})

    # adafactor: per-leaf dict {"vr","vc"} or {"v"}
    def factored(spec, state_leaf):
        if "v" in state_leaf:
            return {"v": spec}
        vr = P(*spec[:-1]) if len(spec) else P()
        vc = P(*(spec[:-2] + spec[-1:])) if len(spec) >= 2 else P()
        return {"vr": vr, "vc": vc}

    def walk(spec, state):
        if isinstance(spec, PartitionSpec):
            return factored(spec, state)
        return {k: walk(spec[k], state[k]) for k in spec}

    return type(opt_state)(P(), walk(param_specs, inner))


# ------------------------------------------------ layout and collectives
COLLECTIVES = {"all_gather": 0, "all_gather_bytes": 0,
               "all_reduce": 0, "all_reduce_bytes": 0}


def local_block(x, sh: NamedSharding) -> torch.Tensor:
    """The calling rank's block of the full tensor (or numpy array) ``x``
    laid out by ``sh``, on ``sh``'s mesh's device.  No collective: every
    rank holds ``x`` whole and keeps its own block
    (``distribute_tensor(src_data_rank=None)``); a replicated leaf's block
    may be ``x`` itself."""
    return _distribute(x, sh).to_local()


def _distribute(x, sh: NamedSharding):
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(torch.as_tensor(x), sh.mesh, sh.placements,
                             src_data_rank=None)


def distribute(tree, shardings):
    """Full tensors (or numpy arrays), the same on every rank, -> DTensors
    on ``shardings``' meshes, each rank holding its own block (see
    :func:`local_block`; no collective)."""
    return tree_map(_distribute, tree, shardings)


def wrap(local: torch.Tensor, sh: NamedSharding, shape) -> Any:
    """``local``, this rank's block, as the DTensor of global ``shape``
    laid out by ``sh`` (no collective, no check)."""
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, sh.mesh, sh.placements,
                              run_check=False, shape=shape, stride=stride)


def full(x) -> torch.Tensor:
    """The full tensor of DTensor ``x`` on every rank (``full_tensor``),
    counted as one all-gather for each mesh dim of more than one rank that
    shards ``x`` (gathered last to first, each at the bytes it returns); a
    leaf sharded nowhere comes back as its local tensor, no collective."""
    mesh, size = x.device_mesh, x.to_local()
    size = size.numel() * size.element_size()
    for m in reversed(range(mesh.ndim)):
        if not x.placements[m].is_replicate() and mesh.size(m) > 1:
            size *= mesh.size(m)
            COLLECTIVES["all_gather"] += 1
            COLLECTIVES["all_gather_bytes"] += size
    return x.full_tensor()


def gather(tree):
    """DTensor leaves -> their full tensors on every rank (the inverse of
    :func:`distribute`, through :func:`full`)."""
    return tree_map(full, tree)


def all_reduce(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """In-place SUM of ``x`` over the mesh axes ``axes`` (one call an
    axis); returns ``x``.  A non-contiguous ``x`` (a gradient of a
    transposed use) is reduced in a contiguous copy and copied back, since
    NCCL refuses it, so it keeps its strides."""
    names = list(mesh.mesh_dim_names)
    buf = x.contiguous()
    for a in axes:
        dist.all_reduce(buf, group=mesh.get_group(names.index(a)))
        COLLECTIVES["all_reduce"] += 1
        COLLECTIVES["all_reduce_bytes"] += buf.numel() * buf.element_size()
    if buf is not x:
        x.copy_(buf)
    return x


def gather_slices(x: torch.Tensor, mesh, axes: Sequence[str]
                  ) -> Tuple[torch.Tensor, int]:
    """(every batch slice's ``x``, stacked -> ``(n,) + x.shape``, and the
    calling rank's index among them): the slices of a batch split over the
    mesh axes ``axes``, major first, as ``batch_specs`` lays it out (ranks
    that differ on another axis hold the same slice)."""
    axes = tuple(axes)
    sizes = mesh_axes(mesh)
    n, index = 1, 0
    for a in axes:
        index = index * sizes[a] + mesh.get_local_rank(a)
        n *= sizes[a]
    spec = PartitionSpec(axes, *([None] * x.ndim))
    return full(wrap(x[None], NamedSharding(mesh, spec),
                     (n,) + tuple(x.shape))), index
