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
(:func:`distribute`, :func:`gather`, :func:`gather_except`,
:func:`all_reduce`, :func:`gather_slices`, and the expert-parallel MoE's
differentiable :func:`all_to_all`, :func:`split_seq` and
:func:`gather_seq`), so the train step, the MoE block and checkpoints
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
           "all_to_all", "apply_overrides", "batch_axes", "batch_pspec",
           "batch_specs", "cache_pspecs", "default_rules", "distribute",
           "entry_axes", "full", "gather", "gather_except", "gather_seq",
           "gather_slices", "local_block", "map_specs", "mesh_axes",
           "model_pspecs", "named", "opt_pspecs", "placements", "split_seq",
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
               "all_reduce": 0, "all_reduce_bytes": 0,
               "all_to_all": 0, "all_to_all_bytes": 0}


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


def _chunks(length: int, n: int) -> list:
    """The lengths of a dim of ``length`` cut ``n`` ways as DTensor's
    ``Shard`` cuts it (``torch.chunk``, padded with empty chunks)."""
    c = -(-length // n)
    return [max(0, min(c, length - i * c)) for i in range(n)]


def _all_gather(x: torch.Tensor, group, n: int) -> list:
    """Every rank's ``x`` of ``group`` (``n`` ranks), in rank order: the
    list all-gather of ``torch.distributed``, which gloo takes on a CUDA
    tensor too (DTensor's own gathers go through the functional
    collectives, whose wait crashes gloo on a CUDA tensor)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    COLLECTIVES["all_gather"] += 1
    COLLECTIVES["all_gather_bytes"] += n * x.numel() * x.element_size()
    return parts


def _gathered(x, keep: Optional[str] = None) -> torch.Tensor:
    """DTensor ``x``'s local block gathered over each mesh dim of more than
    one rank that shards it, last to first, but the mesh axis ``keep``:
    one all-gather a dim, the parts joined as ``full_tensor`` joins them (a
    ``_StridedShard``'s parts cut ``split_factor`` ways and taken piece
    major)."""
    mesh, pls = x.device_mesh, tuple(x.placements)
    names = mesh.mesh_dim_names
    # the length of the dim each mesh dim cuts, before that cut (at this
    # rank's coordinates; the ranks of that mesh dim's group share it)
    shape, parent = list(x.shape), []
    for m, pl in enumerate(pls):
        if pl.is_replicate():
            parent.append(None)
            continue
        parent.append(shape[pl.dim])
        shape[pl.dim] = _chunks(shape[pl.dim],
                                mesh.size(m))[mesh.get_local_rank(m)]
    if keep is not None:
        k = names.index(keep)
        cut = [pl.dim for m, pl in enumerate(pls)
               if m != k and not pl.is_replicate() and mesh.size(m) > 1]
        if not pls[k].is_replicate() and pls[k].dim in cut:
            raise ValueError(f"mesh axis {keep!r} cuts a dim that another "
                             f"axis cuts too ({pls}): it cannot stay cut "
                             f"alone")
    local = x.to_local()
    for m in reversed(range(mesh.ndim)):
        pl, n = pls[m], mesh.size(m)
        if pl.is_replicate() or n == 1 or names[m] == keep:
            continue
        d, sizes = pl.dim, _chunks(parent[m], n)
        split = getattr(pl, "split_factor", 1)
        if split > 1 and parent[m] % (n * split):
            raise ValueError(f"{pl} of a dim of {parent[m]}: an uneven "
                             f"strided split is not gathered")
        if local.shape[d] < sizes[0]:
            pad = list(local.shape)
            pad[d] = sizes[0] - local.shape[d]
            local = torch.cat([local, local.new_zeros(pad)], d)
        parts = _all_gather(local, mesh.get_group(m), n)
        if split > 1:
            local = torch.cat([q.chunk(split, d)[i] for i in range(split)
                               for q in parts], d)
        else:
            local = torch.cat([q.narrow(d, 0, sizes[i])
                               for i, q in enumerate(parts)], d)
    return local


def full(x) -> torch.Tensor:
    """The full tensor of DTensor ``x`` on every rank (``full_tensor``'s
    value), one all-gather for each mesh dim of more than one rank that
    shards ``x`` (gathered last to first, each counted at the bytes it
    returns); a leaf sharded nowhere comes back as its local tensor, no
    collective."""
    return _gathered(x)


def gather_except(x, keep: str) -> torch.Tensor:
    """DTensor ``x`` gathered over every mesh axis but ``keep``: this
    rank's block of ``x`` along the dim ``keep`` shards (the whole of that
    dim if it shards none), full along every other; counted as
    :func:`full` counts."""
    return _gathered(x, keep)


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


# ------------------------------- the expert-parallel MoE's collectives
def _axis_group(mesh, axis: str):
    """(the process group of mesh axis ``axis``, its size, this rank's
    index on it)."""
    m = list(mesh.mesh_dim_names).index(axis)
    return mesh.get_group(m), mesh.size(m), mesh.get_local_rank(m)


def _tiled_all_to_all(x: torch.Tensor, group, n: int, split: int,
                      concat: int) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)``: dim ``split`` of ``x`` cut into
    ``n`` chunks, chunk i sent to rank i of ``group``; the chunks received
    concatenated along dim ``concat`` in source-rank order."""
    send = x.unflatten(split, (n, -1)).movedim(split, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    COLLECTIVES["all_to_all"] += 1
    COLLECTIVES["all_to_all_bytes"] += send.numel() * send.element_size()
    return recv.movedim(0, concat).flatten(concat, concat + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split, concat):
        ctx.args = (group, n, split, concat)
        return _tiled_all_to_all(x, group, n, split, concat)

    @staticmethod
    def backward(ctx, g):
        group, n, split, concat = ctx.args
        return _tiled_all_to_all(g, group, n, concat, split), None, None, \
            None, None


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, j, dim):
        ctx.args = (group, n, dim)
        return x.chunk(n, dim)[j].clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        group, n, dim = ctx.args
        return torch.cat(_all_gather(g, group, n), dim), None, None, None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, j, dim):
        ctx.args = (n, j, dim)
        return torch.cat(_all_gather(x, group, n), dim)

    @staticmethod
    def backward(ctx, g):
        n, j, dim = ctx.args
        return (g.chunk(n, dim)[j].clone(memory_format=torch.contiguous_format),
                None, None, None, None)


def all_to_all(x: torch.Tensor, mesh, axis: str = "model", split: int = 0,
               concat: int = 1) -> torch.Tensor:
    """The tiled all-to-all of the reference's expert-parallel MoE over
    mesh axis ``axis``: dim ``split`` cut into one chunk a rank of the
    axis, the chunks received concatenated along dim ``concat`` in
    source-rank order; ``(E, C, D)`` -> ``(E / n, n * C, D)`` by default,
    back with ``split=1, concat=0``.  Differentiable: the backward is the
    reverse all-to-all.  Counted at the bytes this rank sends."""
    group, n, _ = _axis_group(mesh, axis)
    return _AllToAll.apply(x, group, n, split, concat)


def split_seq(x: torch.Tensor, mesh, axis: str = "model", dim: int = 1
              ) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim``, cut evenly over mesh axis
    ``axis`` (``x`` the same on every rank of the axis).  The backward
    all-gathers the slices' gradients, so the gradient of ``x`` is the
    whole one on every rank of the axis: the ranks that differ only on
    ``axis`` compute the same loss, and a stock all-gather's
    reduce-scatter would sum that gradient once a rank."""
    group, n, j = _axis_group(mesh, axis)
    return _SplitSeq.apply(x, group, n, j, dim)


def gather_seq(x: torch.Tensor, mesh, axis: str = "model", dim: int = 1
               ) -> torch.Tensor:
    """The inverse of :func:`split_seq`: the slices of the ranks of mesh
    axis ``axis`` concatenated along ``dim``; the backward keeps this
    rank's slice of the (replicated) gradient."""
    group, n, j = _axis_group(mesh, axis)
    return _GatherSeq.apply(x, group, n, j, dim)
