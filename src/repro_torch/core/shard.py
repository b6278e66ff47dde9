"""Block-axis sharding of the epoch runtime's per-block state.

Under a mesh (``EpochRuntime(mesh=, mesh_axis=)``) every rank of the mesh
axis holds a contiguous range ``[lo, hi)`` of the global block ids: each
split is ``ceil(n_global / W)`` blocks long and the last rank's range is
shorter (SMALL's 5,000 pages at W 3: 1,667 / 1,667 / 1,666).  Every rank
receives the whole epoch batch and keeps every replicated scalar itself, so
the ranks only meet where a result spans the block axis.

This module holds the only collective call sites of that path:

* :func:`all_gather` — a ``(..., n_local)`` leaf into ``(..., n_global)``;
  the last rank's slice is padded to the common width for the call and the
  padding cut after it.  Gathering moves values, never adds them, so any
  dtype comes back bit for bit;
* :func:`all_reduce` — an integer SUM or MAX, in place.  Floats are
  refused: a float reduced over the block axis would depend on the order
  of its partial sums.

Each counts its calls and bytes in :data:`COLLECTIVES`, plain integers, as
the kernel wrappers count ``LAUNCHES``.  Without a mesh nothing here runs.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["BlockShard", "COLLECTIVES", "all_gather", "all_reduce",
           "from_mesh", "lookup", "split", "sum_parts"]

COLLECTIVES = {"all_gather": 0, "all_gather_bytes": 0,
               "all_reduce": 0, "all_reduce_bytes": 0}

_INT32_MIN = -(1 << 31)
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def split(n_global: int, world: int, rank: int) -> Tuple[int, int]:
    """``[lo, hi)`` of ``rank``: contiguous ranges of ``ceil(n / W)``
    blocks, the last one shorter.  Every rank must own at least one
    block."""
    width = -(-n_global // world)
    lo, hi = rank * width, min((rank + 1) * width, n_global)
    if lo >= hi:
        raise ValueError(f"{n_global} blocks over {world} ranks leave rank "
                         f"{rank} no block (ranges of {width})")
    return lo, hi


@dataclasses.dataclass(frozen=True)
class BlockShard:
    """One rank's block range ``[lo, hi)`` of ``n_global`` blocks, and the
    process group of its mesh axis."""
    lo: int
    hi: int
    n_global: int
    world: int
    group: object = dataclasses.field(compare=False, repr=False)

    @property
    def n_local(self) -> int:
        return self.hi - self.lo

    @property
    def width(self) -> int:
        """The common split width, ``ceil(n_global / world)``."""
        return -(-self.n_global // self.world)

    def local(self, x):
        """The rank's slice of a host array or tensor whose last axis is
        the global block axis."""
        return x[..., self.lo:self.hi]

    def owned(self, gids: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (mask of global ids in the rank's range, local int64 index
        clamped into it)."""
        g = gids.to(torch.int64)
        own = (g >= self.lo) & (g < self.hi)
        return own, torch.clamp(g - self.lo, 0, self.n_local - 1)


def from_mesh(mesh, axis: str, n_global: int) -> BlockShard:
    """The calling rank's :class:`BlockShard` over ``mesh``'s ``axis``."""
    world = mesh.size(mesh.mesh_dim_names.index(axis))
    lo, hi = split(int(n_global), world, mesh.get_local_rank(axis))
    return BlockShard(lo=lo, hi=hi, n_global=int(n_global), world=world,
                      group=mesh.get_group(axis))


def _gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    fn = getattr(dist, "all_gather_single", None)
    if fn is None:      # releases before the rename
        fn = dist.all_gather_into_tensor
    fn(out, x, group=group)


def all_gather(shard: BlockShard, x: torch.Tensor) -> torch.Tensor:
    """``(..., n_local)`` -> ``(..., n_global)``, every rank's slice in
    rank order."""
    lead, w = x.shape[:-1], shard.width
    pad = x
    if x.shape[-1] != w:
        pad = torch.cat([x, x.new_zeros(lead + (w - x.shape[-1],))], dim=-1)
    flat = pad.reshape(-1).contiguous()
    out = flat.new_empty((shard.world * flat.numel(),))
    _gather_into(out, flat, shard.group)
    COLLECTIVES["all_gather"] += 1
    COLLECTIVES["all_gather_bytes"] += out.numel() * out.element_size()
    full = out.view((shard.world,) + lead + (w,)).movedim(0, -2)
    return full.reshape(lead + (shard.world * w,))[..., :shard.n_global]


def all_reduce(shard: BlockShard, x: torch.Tensor,
               op: str = "sum") -> torch.Tensor:
    """In-place integer SUM or MAX over the mesh axis; returns ``x``."""
    if x.is_floating_point() or x.dtype == torch.bool:
        raise TypeError(f"all_reduce takes integer tensors (an exact "
                        f"reduction in any order), got {x.dtype}")
    dist.all_reduce(x, op=_OPS[op], group=shard.group)
    COLLECTIVES["all_reduce"] += 1
    COLLECTIVES["all_reduce_bytes"] += x.numel() * x.element_size()
    return x


def sum_parts(shard: BlockShard, parts: Sequence[torch.Tensor]
              ) -> Tuple[torch.Tensor, ...]:
    """Per-rank int64 partial sums of any shapes, summed over the mesh axis
    in ONE all-reduce and split back."""
    flat = torch.cat([p.reshape(-1).to(torch.int64) for p in parts])
    all_reduce(shard, flat)
    out, at = [], 0
    for p in parts:
        out.append(flat[at:at + p.numel()].reshape(p.shape))
        at += p.numel()
    return tuple(out)


def lookup(shard: BlockShard,
           pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
           ) -> Tuple[torch.Tensor, ...]:
    """``leaf[..., gid]`` by GLOBAL id for every ``(leaf, gids)`` pair, in
    one all-reduce: the rank that owns a gid sends the leaf's 32 bits
    there, every other rank int32 min, and a MAX keeps the owner's bits
    whatever they are.  A gid nobody owns (-1 padding) reads int32 min.
    Returns int32 (a float32 leaf's bits: ``.view(torch.float32)``)."""
    cols = []
    for leaf, g in pairs:
        bits = (leaf.view(torch.int32) if leaf.dtype == torch.float32
                else leaf.to(torch.int32))
        own, idx = shard.owned(g)
        val = torch.take_along_dim(bits, idx, dim=-1)
        cols.append(torch.where(own, val, _INT32_MIN))
    stacked = torch.stack(cols)
    all_reduce(shard, stacked, op="max")
    return tuple(stacked.unbind(0))
