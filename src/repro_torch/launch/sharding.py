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
:func:`gather_slices`, FSDP's :func:`at_use` (a leaf gathered where a
block reads it, its gradient reduce-scattered) and :func:`hand_over` (a
param tree as the sharded train step and sharded serving hand it to the
model), a rank's :func:`block` of a cut dim (the serving cache's blocks,
:func:`cache_shardings`), the expert-parallel MoE's
differentiable :func:`all_to_all`, :func:`split_seq` and
:func:`gather_seq`, and tensor parallelism's :func:`to_model` and
:func:`from_model`), so the train step, the model's blocks and
checkpoints share them.  Each collective is counted in
:data:`COLLECTIVES` as plain integers (calls and bytes), as
``core.shard`` counts the telemetry path's; inside a :func:`recording`
block each is also logged with its group's size (the dry run's wire
bytes) and its mesh axis.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections.abc import Mapping
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..models.model import ModelConfig, param_pspecs
from ..pytree import tree_map

__all__ = ["AtUse", "Block", "COLLECTIVES", "NamedSharding",
           "PartitionSpec", "TP_AXES", "all_reduce", "all_to_all",
           "apply_overrides", "at_use", "batch_axes", "batch_pspec",
           "batch_specs", "block", "block_shape", "cache_pspecs",
           "cache_shardings", "cut_axes", "default_rules", "distribute",
           "entry_axes", "experts_local", "from_model", "full", "gather",
           "gather_seq", "gather_slices", "hand_over", "leaf_roles",
           "local_block", "map_specs", "mesh_axes", "model_pspecs", "named",
           "opt_pspecs", "placements", "recording", "split_seq", "to_model",
           "tp_config", "wrap"]


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


def cache_shardings(mesh, cfg: ModelConfig, batch: int, max_len: int
                    ) -> dict:
    """:func:`cache_pspecs` on ``mesh``: the serving cache's layouts."""
    return named(mesh, cache_pspecs(mesh, cfg, batch, max_len))


class Block(NamedTuple):
    """A rank's block of one tensor dim of ``length``: ``count`` entries
    from ``first``, cut over ``axes``, the mesh axes of more than one rank
    the spec entry names (major first; ``()``: whole)."""
    first: int
    count: int
    axes: Tuple[str, ...]


def block(mesh, entry, length: int) -> Block:
    """The calling rank's :class:`Block` of a dim of ``length`` that the
    spec entry ``entry`` cuts evenly (the rules' ``_maybe``): its index is
    its coordinates on the entry's axes, major first, as :func:`placements`
    lays the dim out."""
    sizes = mesh_axes(mesh)
    index, n = 0, 1
    for a in entry_axes(entry):
        index = index * sizes[a] + mesh.get_local_rank(a)
        n *= sizes[a]
    if length % n:
        raise ValueError(f"a dim of {length} does not cut evenly over "
                         f"{entry!r} ({n} ranks)")
    count = length // n
    return Block(index * count, count,
                 tuple(a for a in entry_axes(entry) if sizes[a] > 1))


def block_shape(mesh, spec, shape) -> Tuple[int, ...]:
    """A rank's block's shape of a tensor of ``shape`` laid out by
    ``spec`` (every cut even, as the cache's specs cut)."""
    return tuple(block(mesh, e, n).count for e, n in zip(spec, shape))


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
               "all_to_all": 0, "all_to_all_bytes": 0,
               "reduce_scatter": 0, "reduce_scatter_bytes": 0}
_LOGS: list = []


@contextlib.contextmanager
def recording():
    """Yields a list that gets ``(kind, bytes, group size, axis)`` of every
    collective counted in :data:`COLLECTIVES` inside the block, ``kind`` a
    key of it ("all_gather", "all_reduce", "all_to_all",
    "reduce_scatter"), ``bytes`` as
    counted there (the bytes the call returns) and ``axis`` the mesh axis
    whose group it ran over."""
    log: list = []
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


def _count(kind: str, nbytes: int, group_size: int, axis: str) -> None:
    COLLECTIVES[kind] += 1
    COLLECTIVES[kind + "_bytes"] += nbytes
    for log in _LOGS:
        log.append((kind, nbytes, group_size, axis))


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
    laid out by ``sh`` (no collective, no check).  Its contiguous strides
    are worked out, not read off a tensor of ``shape``: a meta tensor of
    the whole leaf would count as live in the dry run's trace."""
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    stride, step = [], 1
    for n in reversed(shape):
        stride.append(step)
        step *= max(n, 1)
    return DTensor.from_local(local, sh.mesh, sh.placements,
                              run_check=False, shape=shape,
                              stride=tuple(reversed(stride)))


def _chunks(length: int, n: int) -> list:
    """The lengths of a dim of ``length`` cut ``n`` ways as DTensor's
    ``Shard`` cuts it (``torch.chunk``, padded with empty chunks)."""
    c = -(-length // n)
    return [max(0, min(c, length - i * c)) for i in range(n)]


def _all_gather(x: torch.Tensor, group, n: int, axis: str) -> list:
    """Every rank's ``x`` of ``group`` (``n`` ranks of mesh axis ``axis``),
    in rank order: the
    list all-gather of ``torch.distributed``, which gloo takes on a CUDA
    tensor too (DTensor's own gathers go through the functional
    collectives, whose wait crashes gloo on a CUDA tensor)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    _count("all_gather", n * x.numel() * x.element_size(), n, axis)
    return parts


def _reduce_scatter(parts: list, group, n: int, axis: str) -> torch.Tensor:
    """The sum over the ``n`` ranks of ``group`` (mesh axis ``axis``) of
    their ``parts[r]``, on rank ``r``: the list reduce-scatter of
    ``torch.distributed`` (not DTensor's functional one, as
    :func:`_all_gather`), counted at the bytes it returns.  A backend
    that cannot reduce-scatter raises."""
    parts = [q.contiguous() for q in parts]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    _count("reduce_scatter", out.numel() * out.element_size(), n, axis)
    return out


class _Cut(NamedTuple):
    """One mesh dim's cut of a leaf: mesh axis ``axis`` (its ``group`` of
    ``n`` ranks, this one ``rank``) cuts tensor dim ``dim``, whose length
    before the cut is ``sum(sizes)``, into chunks of ``sizes`` (a
    ``_StridedShard``'s pieces ``split`` ways, taken piece major).
    ``sums``: the gather's backward sums the ranks' gradients
    (reduce-scatter) rather than keeping this rank's slice of its own."""
    axis: str
    group: Any
    n: int
    rank: int
    dim: int
    sizes: Tuple[int, ...]
    split: int
    sums: bool


def _cuts(x, keep: Optional[str] = None, sums: Sequence[str] = ()
          ) -> Tuple[_Cut, ...]:
    """DTensor ``x``'s cuts over each mesh dim of more than one rank that
    shards it, but the mesh axis ``keep``, last mesh dim first (the order
    :func:`_join` undoes them in); ``sums`` the axes whose gather's
    backward reduce-scatters."""
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
    out = []
    for m in reversed(range(mesh.ndim)):
        pl, n = pls[m], mesh.size(m)
        if pl.is_replicate() or n == 1 or names[m] == keep:
            continue
        split = getattr(pl, "split_factor", 1)
        if split > 1 and parent[m] % (n * split):
            raise ValueError(f"{pl} of a dim of {parent[m]}: an uneven "
                             f"strided split is not gathered")
        out.append(_Cut(names[m], mesh.get_group(m), n,
                        mesh.get_local_rank(m), pl.dim,
                        tuple(_chunks(parent[m], n)), split,
                        names[m] in sums))
    return tuple(out)


def cut_axes(x, dims: Optional[Sequence[int]] = None) -> Tuple[str, ...]:
    """The mesh axes of more than one rank that shard DTensor ``x`` (those
    that cut one of its dims ``dims``, negative ones counted from the end;
    None: any), in mesh order."""
    want = None if dims is None else {d % x.ndim for d in dims}
    return tuple(c.axis for c in reversed(_cuts(x))
                 if want is None or c.dim in want)


def _pad(t: torch.Tensor, d: int, length: int) -> torch.Tensor:
    """``t`` padded with zeros along dim ``d`` to ``length``."""
    if t.shape[d] >= length:
        return t
    pad = list(t.shape)
    pad[d] = length - t.shape[d]
    return torch.cat([t, t.new_zeros(pad)], d)


def _join(t: torch.Tensor, c: _Cut) -> torch.Tensor:
    """Cut ``c`` undone: this rank's block ``t`` all-gathered over
    ``c.axis`` (an uneven chunk padded to the first's length) and the
    parts joined as ``full_tensor`` joins them."""
    d = c.dim
    parts = _all_gather(_pad(t, d, c.sizes[0]), c.group, c.n, c.axis)
    if c.split > 1:
        return torch.cat([q.chunk(c.split, d)[i] for i in range(c.split)
                          for q in parts], d)
    return torch.cat([q.narrow(d, 0, c.sizes[i])
                      for i, q in enumerate(parts)], d)


def _block(g: torch.Tensor, c: _Cut, q: int) -> torch.Tensor:
    """Rank ``q``'s block, along ``c.dim``, of ``g`` joined as
    :func:`_join` joins (a view where it is one piece)."""
    if c.split > 1:
        pieces = g.chunk(c.split * c.n, c.dim)
        return torch.cat([pieces[i * c.n + q] for i in range(c.split)],
                         c.dim)
    return g.narrow(c.dim, sum(c.sizes[:q]), c.sizes[q])


def _part(g: torch.Tensor, c: _Cut) -> torch.Tensor:
    """The backward of :func:`_join`: this rank's block of the gradient
    ``g`` of the joined tensor, summed over ``c.axis`` where ``c.sums``
    (one reduce-scatter, every rank's block padded to the first's length
    and the padding stripped after), else taken from ``g`` alone."""
    if not c.sums:
        return _block(g, c, c.rank).clone(
            memory_format=torch.contiguous_format)
    blocks = [_pad(_block(g, c, q), c.dim, c.sizes[0]) for q in range(c.n)]
    return _reduce_scatter(blocks, c.group, c.n, c.axis).narrow(
        c.dim, 0, c.sizes[c.rank])


def _gathered(x) -> torch.Tensor:
    """DTensor ``x``'s local block gathered over each mesh dim of more than
    one rank that shards it, last to first: one all-gather a dim, the parts
    joined as ``full_tensor`` joins them."""
    local = x.to_local()
    for c in _cuts(x):
        local = _join(local, c)
    return local


def full(x) -> torch.Tensor:
    """The full tensor of DTensor ``x`` on every rank (``full_tensor``'s
    value), one all-gather for each mesh dim of more than one rank that
    shards ``x`` (gathered last to first, each counted at the bytes it
    returns); a leaf sharded nowhere comes back as its local tensor, no
    collective."""
    return _gathered(x)


# ----------------------------------------- FSDP: gather at use ("data")
class _GatherAtUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, cuts):
        ctx.cuts = cuts
        for c in cuts:
            local = _join(local, c)
        return local

    @staticmethod
    def backward(ctx, g):
        for c in reversed(ctx.cuts):
            g = _part(g, c)
        return g, None


class AtUse:
    """A parameter leaf as the sharded train step hands it to the model:
    ``local``, this rank's block of it (the tensor the gradient is taken
    of), and its ``cuts``.  A block gathers it where it reads it
    (:meth:`gather`, differentiable: one all-gather a cut, and in the
    backward this rank's block of the gradient, reduce-scattered over an
    axis whose ranks each hold a part of the gradient); under remat the
    recompute gathers again, so the whole leaf lives only inside the block
    that reads it.  ``at[i]`` is layer ``i``'s slice of a stacked leaf
    (its leading dim whole), gathered alone."""
    __slots__ = ("local", "cuts")

    def __init__(self, local: torch.Tensor, cuts: Tuple[_Cut, ...]):
        self.local, self.cuts = local, cuts

    def __getitem__(self, i: int) -> "AtUse":
        if any(c.dim == 0 for c in self.cuts):
            raise ValueError("a leaf cut on its leading dim is not sliced "
                             "before it is gathered")
        return AtUse(self.local[i], tuple(c._replace(dim=c.dim - 1)
                                          for c in self.cuts))

    def gather(self) -> torch.Tensor:
        return _GatherAtUse.apply(self.local, self.cuts)


def at_use(x, keep: Optional[str] = None, sums: Sequence[str] = ()):
    """DTensor ``x`` as the sharded step hands it to the model: an
    :class:`AtUse` of its local block, gathered at use over every mesh
    axis of more than one rank that cuts it but ``keep`` (the gradient
    reduce-scattered over the axes of ``sums``, this rank's slice of it
    taken over the others), or the local block itself where no such axis
    cuts it."""
    cuts = _cuts(x, keep, sums)
    local = x.to_local()
    return AtUse(local, cuts) if cuts else local


# ----------------------- the leaves a step hands over, and how ("model")
# the logical axes whose leaves a module can use as its block over "model"
TP_AXES = ("heads", "kv_heads", "mlp", "vocab")


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


def experts_local(cfg: ModelConfig) -> bool:
    """Whether a step of ``cfg`` keeps the expert leaves as each rank's
    block of experts over "model": the expert-parallel path
    (``cfg.moe_groups`` of more than one member and
    ``cfg.moe_expert_sharded``), or ``moe_expert_sharded`` without groups,
    the serving decode's (each rank runs its experts' slots of the whole
    batch's dispatch, ``models.moe``)."""
    if cfg.moe is None or not cfg.moe_expert_sharded:
        return False
    return cfg.moe_groups is None or cfg.moe_groups[0] * cfg.moe_groups[1] > 1


def leaf_roles(cfg: ModelConfig, mesh, overrides: Optional[dict] = None
               ) -> Tuple[Any, Any]:
    """(local, partial) of the step on ``mesh`` (rules with
    ``overrides``): trees of bools like the params.  Local: a leaf handed
    over as this rank's block over "model" (an expert leaf where
    :func:`experts_local` and its spec puts "model" on its experts dim; a
    leaf of ``tp_roles``).  Partial: a whole leaf whose gradient is a
    partial sum on each rank of "model"."""
    from ..models.model import tp_roles
    pspecs = model_pspecs(mesh, cfg, overrides)
    cfg = tp_config(cfg, mesh, overrides)
    local = map_specs(lambda spec: False, pspecs)
    partial = map_specs(lambda spec: False, pspecs)
    if experts_local(cfg):
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


def hand_over(params, cfg: ModelConfig, mesh,
              overrides: Optional[dict] = None, sums: Sequence[str] = ()):
    """DTensor ``params`` (laid out by :func:`model_pspecs` with
    ``overrides``) as a step of ``cfg`` on ``mesh`` hands them to the
    model: each leaf an :func:`at_use` of this rank's block, gathered
    where a block reads it over every axis that cuts it but "model" for a
    leaf of :func:`leaf_roles`' local ones; the gather's backward
    reduce-scatters over the axes of ``sums`` and over "model" for a
    partial leaf.  A leaf that is no DTensor (already a rank's own) goes
    over as it is.  The sharded train step and sharded serving both call
    it; under ``torch.no_grad()`` (serving) a gather has no backward."""
    from torch.distributed.tensor import DTensor
    local, partial = leaf_roles(cfg, mesh, overrides)

    def one(x, loc, part):
        if not isinstance(x, DTensor):
            return x
        return at_use(x, "model" if loc else None,
                      tuple(sums) + (("model",) if part else ()))
    return tree_map(one, params, local, partial)


def gather(tree):
    """DTensor leaves -> their full tensors on every rank (the inverse of
    :func:`distribute`, through :func:`full`)."""
    return tree_map(full, tree)


def all_reduce(x: torch.Tensor, mesh, axes: Sequence[str],
               op=None) -> torch.Tensor:
    """In-place SUM (or ``op``, a ``dist.ReduceOp``) of ``x`` over the mesh
    axes ``axes`` (one call an axis); returns ``x``.  A non-contiguous
    ``x`` (a gradient of a transposed use) is reduced in a contiguous copy
    and copied back, since NCCL refuses it, so it keeps its strides."""
    names = list(mesh.mesh_dim_names)
    buf = x.contiguous()
    for a in axes:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM if op is None else op,
                        group=mesh.get_group(names.index(a)))
        _count("all_reduce", buf.numel() * buf.element_size(),
               mesh.size(names.index(a)), a)
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
                      concat: int, axis: str) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)``: dim ``split`` of ``x`` cut into
    ``n`` chunks, chunk i sent to rank i of ``group``; the chunks received
    concatenated along dim ``concat`` in source-rank order."""
    send = x.unflatten(split, (n, -1)).movedim(split, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    _count("all_to_all", send.numel() * send.element_size(), n, axis)
    return recv.movedim(0, concat).flatten(concat, concat + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split, concat, axis):
        ctx.args = (group, n, split, concat, axis)
        return _tiled_all_to_all(x, group, n, split, concat, axis)

    @staticmethod
    def backward(ctx, g):
        group, n, split, concat, axis = ctx.args
        return _tiled_all_to_all(g, group, n, concat, split, axis), None, \
            None, None, None, None


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group, n, j, dim):
        ctx.args = (axis, group, n, dim)
        return x.chunk(n, dim)[j].clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        axis, group, n, dim = ctx.args
        return (torch.cat(_all_gather(g, group, n, axis), dim), None, None,
                None, None, None)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group, n, j, dim):
        ctx.args = (n, j, dim)
        return torch.cat(_all_gather(x, group, n, axis), dim)

    @staticmethod
    def backward(ctx, g):
        n, j, dim = ctx.args
        return (g.chunk(n, dim)[j].clone(memory_format=torch.contiguous_format),
                None, None, None, None, None)


def all_to_all(x: torch.Tensor, mesh, axis: str = "model", split: int = 0,
               concat: int = 1) -> torch.Tensor:
    """The tiled all-to-all of the reference's expert-parallel MoE over
    mesh axis ``axis``: dim ``split`` cut into one chunk a rank of the
    axis, the chunks received concatenated along dim ``concat`` in
    source-rank order; ``(E, C, D)`` -> ``(E / n, n * C, D)`` by default,
    back with ``split=1, concat=0``.  Differentiable: the backward is the
    reverse all-to-all.  Counted at the bytes this rank sends."""
    group, n, _ = _axis_group(mesh, axis)
    return _AllToAll.apply(x, group, n, split, concat, axis)


def split_seq(x: torch.Tensor, mesh, axis: str = "model", dim: int = 1
              ) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim``, cut evenly over mesh axis
    ``axis`` (``x`` the same on every rank of the axis).  The backward
    all-gathers the slices' gradients, so the gradient of ``x`` is the
    whole one on every rank of the axis: the ranks that differ only on
    ``axis`` compute the same loss, and a stock all-gather's
    reduce-scatter would sum that gradient once a rank."""
    group, n, j = _axis_group(mesh, axis)
    return _SplitSeq.apply(x, axis, group, n, j, dim)


def gather_seq(x: torch.Tensor, mesh, axis: str = "model", dim: int = 1
               ) -> torch.Tensor:
    """The inverse of :func:`split_seq`: the slices of the ranks of mesh
    axis ``axis`` concatenated along ``dim``; the backward keeps this
    rank's slice of the (replicated) gradient."""
    group, n, j = _axis_group(mesh, axis)
    return _GatherSeq.apply(x, axis, group, n, j, dim)


# ------------------------------ tensor parallelism's collectives ("model")
class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        g = g.clone(memory_format=torch.contiguous_format)
        return all_reduce(g, mesh, (axis,)), None, None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x.clone(memory_format=torch.contiguous_format),
                          mesh, (axis,))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def to_model(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """Where a tensor the same on every rank of mesh axis ``axis`` enters
    a block each rank computes a part of: the identity forward; the
    backward sums the ranks' partial gradients (one all-reduce)."""
    return _ToModel.apply(x, mesh, axis)


def from_model(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """Where such a block's partial results join: their sum over the ranks
    of mesh axis ``axis`` (one all-reduce); the backward is the identity
    (the gradient of the sum is the same on every rank)."""
    return _FromModel.apply(x, mesh, axis)
