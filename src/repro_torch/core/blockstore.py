"""Two-tier block store with an indirection map (PyTorch port of
``repro/core/blockstore.py``).

One tiered address space:

  ``storage[0 : fast_rows)``                  -- fast tier (slots)
  ``storage[fast_rows : fast_rows + n_rows)`` -- slow tier, backing every block

Data moves in blocks of ``block_rows`` rows (the 4 KiB page analogue).  A
promoted block has a copy in a fast slot and the indirection map resolves
its rows there; promotion and demotion are block copies plus a map update,
``migrate_pages()`` semantics.  The maps are the port's
:class:`~repro_torch.core.placement.Placement`.

The reference's ``_promote``/``_demote`` are sequential ``fori_loop``\\ s over
the ids.  Here both are vectorised on the device (no Python loop over
ids), with the loop's semantics kept bit for bit; see :func:`_promote`.

``promote``, ``demote`` and ``migrate`` update ``storage`` in place and
return a store that shares it: the reference donates the store to them, so
the store a call was made on is dead afterwards either way, and at the
paper's width (22.3 GB of storage) a functional copy would not fit beside
the table.  ``scatter_update`` returns a copy, as the reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .placement import Placement

__all__ = ["TieredStore"]


@dataclasses.dataclass(frozen=True)
class TieredStore:
    """Two-tier row store with block-granular promotion."""

    # (fast_rows + n_rows, dim): fast region followed by the slow backing
    storage: torch.Tensor
    # slot<->block indirection (-1 = free / slow-only)
    placement: Placement
    block_rows: int
    n_rows: int

    # ------------------------------------------------------------------ sizes
    @property
    def block_to_slot(self) -> torch.Tensor:
        return self.placement.block_to_slot

    @property
    def slot_to_block(self) -> torch.Tensor:
        return self.placement.slot_to_block

    @property
    def n_blocks(self) -> int:
        return self.block_to_slot.shape[0]

    @property
    def n_slots(self) -> int:
        return self.slot_to_block.shape[0]

    @property
    def fast_rows(self) -> int:
        return self.n_slots * self.block_rows

    @property
    def dim(self) -> int:
        return self.storage.shape[-1]

    # ------------------------------------------------------------ construction
    @staticmethod
    def create(data: torch.Tensor, block_rows: int,
               n_slots: int) -> "TieredStore":
        """All blocks start in the slow tier, on ``data``'s device."""
        n_rows, dim = data.shape
        if n_rows % block_rows:
            raise ValueError(f"n_rows {n_rows} not a multiple of block_rows "
                             f"{block_rows}")
        n_blocks = n_rows // block_rows
        if n_slots > n_blocks:
            raise ValueError("fast tier larger than dataset; nothing to tier")
        storage = torch.empty((n_slots * block_rows + n_rows, dim),
                              dtype=data.dtype, device=data.device)
        storage[: n_slots * block_rows].zero_()
        storage[n_slots * block_rows:].copy_(data)
        return TieredStore(
            storage=storage,
            placement=Placement.create(n_blocks, n_slots, device=data.device),
            block_rows=int(block_rows), n_rows=int(n_rows))

    # ------------------------------------------------------------- resolution
    def resolve(self, rows) -> torch.Tensor:
        """Logical row ids -> int32 physical addresses in the tiered space."""
        rows = torch.as_tensor(rows, device=self.storage.device).to(
            torch.int64)
        block = torch.div(rows, self.block_rows, rounding_mode="floor")
        slot = self.block_to_slot[block].to(torch.int64)
        fast_addr = slot * self.block_rows + (rows - block * self.block_rows)
        slow_addr = self.fast_rows + rows
        return torch.where(slot >= 0, fast_addr, slow_addr).to(torch.int32)

    def is_fast(self, rows) -> torch.Tensor:
        rows = torch.as_tensor(rows, device=self.storage.device).to(
            torch.int64)
        return self.block_to_slot[
            torch.div(rows, self.block_rows, rounding_mode="floor")] >= 0

    def gather(self, rows) -> torch.Tensor:
        """Tier-aware gather: a plain ``index_select``, as the reference's
        is ``jnp.take`` outside any kernel (the ``gather_count`` kernel
        fuses it with the block counters)."""
        return self.storage.index_select(0, self.resolve(rows))

    # ------------------------------------------------------------- migration
    def promote(self, block_ids) -> "TieredStore":
        """Promote ``block_ids`` (padded with -1) into fast slots: free
        slots first, then the occupants of the lowest-index used slots are
        evicted (written back).  Blocks already fast are skipped."""
        return _promote(self, self._ids(block_ids))

    def demote(self, block_ids) -> "TieredStore":
        """Write fast copies back to the slow region and free the slots."""
        return _demote(self, self._ids(block_ids))

    def migrate(self, promote_ids, demote_ids=None) -> "TieredStore":
        """Explicit demotions first, so promotions land in the freed slots."""
        st = self if demote_ids is None else self.demote(demote_ids)
        return st.promote(promote_ids)

    # ---------------------------------------------------------------- updates
    def scatter_update(self, rows, values: torch.Tensor) -> "TieredStore":
        """Write-through update at whatever tier each row resides in."""
        storage = self.storage.clone()
        storage[self.resolve(rows).to(torch.int64)] = values.to(
            device=storage.device, dtype=storage.dtype)
        return dataclasses.replace(self, storage=storage)

    def fast_occupancy(self) -> torch.Tensor:
        return torch.sum(self.slot_to_block >= 0)

    def _ids(self, block_ids) -> torch.Tensor:
        return torch.as_tensor(block_ids, device=self.storage.device).reshape(
            -1).to(torch.int64)


def _first_occurrence(ids: torch.Tensor) -> torch.Tensor:
    """True at the first position of each distinct value of ``ids``."""
    sorted_ids, order = torch.sort(ids, stable=True)
    head = torch.ones_like(sorted_ids, dtype=torch.bool)
    head[1:] = sorted_ids[1:] != sorted_ids[:-1]
    first = torch.empty_like(head)
    first[order] = head
    return first


def _block_rows(blocks: torch.Tensor, br: int, base: int = 0) -> torch.Tensor:
    """Row addresses ``base + block * br + j`` (j < br) of each block, flat."""
    j = torch.arange(br, dtype=torch.int64, device=blocks.device)
    return (base + blocks.unsqueeze(-1) * br + j).reshape(-1)


def _move_blocks(storage: torch.Tensor, src: torch.Tensor,
                 dst: torch.Tensor) -> None:
    """``storage[dst] = storage[src]`` row by row (src, dst disjoint)."""
    if src.numel():
        storage.index_copy_(0, dst, storage.index_select(0, src))


def _promote(store: TieredStore, ids: torch.Tensor) -> TieredStore:
    """The reference's sequential ``fori_loop``, vectorised.

    Per id, in order, the reference assigns the i-th *needed* id (valid and
    not fast at the start of the call) to ``slot_order[i]``: free slots
    ascending, then occupied slots ascending (stable ``argsort(~free)``).
    Ranks past ``n_slots`` are dropped.  A duplicate id consumes a rank too,
    but its ``fresh`` re-check fails (the first copy already promoted it),
    so it does nothing and the slot it targeted keeps its occupant.  An
    executed id first writes its slot's occupant (the victim) back to that
    block's slow copy, then copies the new block's slow rows into the slot.

    Hence: the ids that execute are exactly the needed first occurrences
    with rank < n_slots; each targets a distinct slot; every victim was
    resident at the start of the call and no promoted id was.  So no copy
    reads a row that an earlier copy of the loop wrote, and writing every
    victim back first, then copying every new block in, gives the same
    storage as the loop's interleaved order."""
    s2b, b2s = store.slot_to_block, store.block_to_slot
    n_slots, br = store.n_slots, store.block_rows
    valid = ids >= 0
    need = valid & (b2s[torch.clamp(ids, min=0)] < 0)
    slot_order = torch.sort((s2b >= 0).to(torch.int8), stable=True).indices
    rank = torch.cumsum(need, 0) - 1
    run = need & (rank < n_slots) & _first_occurrence(ids)

    sel = torch.nonzero(run).squeeze(-1)       # the one host sync of a call
    blk = ids[sel]
    slot = slot_order[rank[sel]]
    vic = s2b[slot].to(torch.int64)
    has_vic = vic >= 0
    vslot, vblk = slot[has_vic], vic[has_vic]

    storage = store.storage
    _move_blocks(storage, _block_rows(vslot, br),
                 _block_rows(vblk, br, store.fast_rows))
    _move_blocks(storage, _block_rows(blk, br, store.fast_rows),
                 _block_rows(slot, br))
    b2s = b2s.clone()
    b2s[vblk] = -1
    b2s[blk] = slot.to(torch.int32)
    s2b = s2b.clone()
    s2b[slot] = blk.to(torch.int32)
    return dataclasses.replace(
        store, storage=storage,
        placement=Placement(slot_to_block=s2b, block_to_slot=b2s))


def _demote(store: TieredStore, ids: torch.Tensor) -> TieredStore:
    """The reference's sequential demote loop, vectorised: the first
    occurrence of each resident id writes its slot back and frees it (a
    repeat finds the block already slow and does nothing)."""
    s2b, b2s = store.slot_to_block, store.block_to_slot
    br = store.block_rows
    slot_of = torch.where(ids >= 0, b2s[torch.clamp(ids, min=0)], -1)
    sel = torch.nonzero((slot_of >= 0) & _first_occurrence(ids)).squeeze(-1)
    blk, slot = ids[sel], slot_of[sel].to(torch.int64)

    storage = store.storage
    _move_blocks(storage, _block_rows(slot, br),
                 _block_rows(blk, br, store.fast_rows))
    b2s = b2s.clone()
    b2s[blk] = -1
    s2b = s2b.clone()
    s2b[slot] = -1
    return dataclasses.replace(
        store, storage=storage,
        placement=Placement(slot_to_block=s2b, block_to_slot=b2s))
