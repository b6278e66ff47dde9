"""Placement — the bounded-fast-tier indirection maps (PyTorch port of
``repro/core/placement.py``).

A placement is the pair of mutually inverse maps

  ``slot_to_block``  (..., n_slots)   block id in each fast slot, -1 = free
  ``block_to_slot``  (..., n_blocks)  fast slot of each block,   -1 = slow-only

plus the bounded-promotion invariant: a plan fills free slots first in
priority order; when slots run out the epoch-coldest residents are demoted,
never a block the plan still wants ahead of an empty slot.  Everything
works on one placement or lane-stacked ((L, n_slots) / (L, n_blocks)).

``.at[...].set(mode="drop")`` scatters become writes into one spare column
past the end, which is cut off again (:func:`_scatter_ids`), so no step
reads a count back to the host.

Under a :class:`~repro_torch.core.shard.BlockShard` ``block_to_slot`` holds
the rank's block range and ``slot_to_block`` (global ids) is replicated:
a read of a per-block leaf by a slot's or a plan's block id is answered by
the rank that owns the id (:func:`repro_torch.core.shard.lookup`, one
integer all-reduce), everything on the ``(L, k)`` slot side then runs the
same on every rank, and each rank writes ``block_to_slot`` only in its
range.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import upload
from . import policy, selectk
from . import shard as shd

__all__ = ["Placement", "apply_plan", "demote_idle", "plan_promotion"]

# Free fast slots sort at this heat in eviction order: after every finite
# resident but before +inf-guarded still-wanted residents.
_FREE_HEAT = float((1 << 31) - 1)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Bounded fast-tier indirection maps (optionally lane-stacked)."""

    slot_to_block: torch.Tensor     # (..., n_slots) int32, -1 = free
    block_to_slot: torch.Tensor     # (..., n_blocks) int32, -1 = slow-only

    @staticmethod
    def create(n_blocks: int, n_slots: int, lanes: Optional[int] = None,
               device="cpu") -> "Placement":
        lead = () if lanes is None else (int(lanes),)
        return Placement(
            slot_to_block=torch.full(lead + (int(n_slots),), -1,
                                     dtype=torch.int32, device=device),
            block_to_slot=torch.full(lead + (int(n_blocks),), -1,
                                     dtype=torch.int32, device=device))

    @property
    def n_slots(self) -> int:
        return self.slot_to_block.shape[-1]

    @property
    def n_blocks(self) -> int:
        return self.block_to_slot.shape[-1]

    @property
    def fast_mask(self) -> torch.Tensor:
        return self.block_to_slot >= 0

    def resident(self) -> torch.Tensor:
        """Occupied-slot count (per lane, if stacked), int32."""
        return torch.sum(self.slot_to_block >= 0, dim=-1, dtype=torch.int32)


def _scatter_ids(arr: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
                 val: torch.Tensor) -> torch.Tensor:
    """Batched last-axis ``arr[..., idx] = val`` where ``valid``; invalid
    entries go to a spare column past the end, which is dropped."""
    n = arr.shape[-1]
    pad = torch.cat([arr, arr.new_zeros(arr.shape[:-1] + (1,))], dim=-1)
    where = torch.where(valid, idx.to(torch.int64), n)
    pad.scatter_(-1, where, val.to(arr.dtype))
    return pad[..., :n]


def _by_block(leaf: torch.Tensor, gids: torch.Tensor) -> torch.Tensor:
    """``leaf[..., gids]`` on a whole block axis, -1 ids reading block 0
    (the callers mask them)."""
    return torch.take_along_dim(
        leaf, torch.clamp(gids, min=0).to(torch.int64), dim=-1)


def _scatter_owned(arr: torch.Tensor, gids: torch.Tensor, valid: torch.Tensor,
                   val: torch.Tensor,
                   shard: Optional[shd.BlockShard]) -> torch.Tensor:
    """:func:`_scatter_ids` by global block id into a per-block leaf: under
    a shard only the ids in the rank's range land."""
    if shard is None:
        return _scatter_ids(arr, gids, valid, val)
    own, idx = shard.owned(gids)
    return _scatter_ids(arr, idx, valid & own, val)


def demote_idle(p: Placement, est: torch.Tensor, enable,
                shard: Optional[shd.BlockShard] = None,
                ) -> Tuple[Placement, torch.Tensor]:
    """Watermark demotion: free every resident block whose epoch estimate
    is zero, where ``enable`` (scalar or per-lane bool).  Returns
    (placement, count)."""
    idle = p.fast_mask & (est == 0) & enable
    b2s = torch.where(idle, -1, p.block_to_slot)
    occ = p.slot_to_block >= 0
    if shard is None:
        slot_idle = occ & _by_block(idle, p.slot_to_block)
        count = torch.sum(idle, dim=-1, dtype=torch.int32)
    else:
        slot_idle = occ & (shd.lookup(shard, [(idle, p.slot_to_block)])[0]
                           > 0)
        # an idle block is resident: one idle slot each
        count = torch.sum(slot_idle, dim=-1, dtype=torch.int32)
    s2b = torch.where(slot_idle, -1, p.slot_to_block)
    return Placement(slot_to_block=s2b, block_to_slot=b2s), count


def apply_plan(p: Placement, want: torch.Tensor, est: torch.Tensor,
               shard: Optional[shd.BlockShard] = None,
               ) -> Tuple[Placement, torch.Tensor, torch.Tensor]:
    """Promote ``want`` (priority-ordered unique block ids, -1 padding) into
    the bounded fast tier, demoting the coldest residents by ``est`` when
    free slots run short (plan-guarded victims).  Returns (placement,
    promoted, demoted) counts."""
    k = p.n_slots
    s2b, b2s = p.slot_to_block, p.block_to_slot

    valid = want >= 0
    wanted = _scatter_owned(torch.zeros(b2s.shape, dtype=torch.bool,
                                        device=b2s.device),
                            want, valid, torch.ones_like(valid), shard)
    occ = s2b >= 0
    if shard is None:
        b2s_want = _by_block(b2s, want)
        blk = torch.clamp(s2b, min=0).to(torch.int64)
        wanted_at = torch.take_along_dim(wanted, blk, dim=-1)
        est_at = torch.take_along_dim(est.to(torch.float32), blk, dim=-1)
    else:
        b2s_want, wanted_at, est_bits = shd.lookup(shard, [
            (b2s, want), (wanted, s2b), (est.to(torch.float32), s2b)])
        wanted_at = wanted_at > 0
        est_at = est_bits.view(torch.float32)
    new = valid & (b2s_want < 0)
    n_new = torch.sum(new, dim=-1, keepdim=True, dtype=torch.int32)
    n_free = torch.sum(s2b < 0, dim=-1, keepdim=True, dtype=torch.int32)
    need = n_new - n_free

    # eviction order: finite-heat residents coldest-first, then free slots,
    # then +inf-guarded wanted residents; the `need` coldest slots come from
    # a threshold selection with lowest-slot-first ties — no sort
    heat = torch.where(occ, torch.where(wanted_at, torch.inf, est_at),
                       _FREE_HEAT)
    victim = occ & selectk.bottom_k_mask(selectk.sortable_key(heat),
                                         need.squeeze(-1))
    demoted = torch.sum(victim, dim=-1, dtype=torch.int32)

    b2s = _scatter_owned(b2s, s2b, victim, torch.full_like(s2b, -1), shard)
    s2b = torch.where(victim, -1, s2b)

    # fill free slots (ascending slot index) with new blocks in plan order:
    # the j-th new block lands in the j-th free slot, found by prefix count
    free = s2b < 0
    cfree = selectk.prefix_sum(free)
    n_free = cfree[..., -1:]
    new_rank = selectk.prefix_sum(new) - 1
    assign = new & (new_rank < n_free)
    free_slot = selectk.compact(cfree, k)            # (..., k), fill -> k
    slot_for = torch.take_along_dim(
        free_slot, torch.clamp(new_rank, 0, k - 1).to(torch.int64), dim=-1)
    s2b = _scatter_ids(s2b, slot_for, assign, want)
    b2s = _scatter_owned(b2s, want, assign, slot_for, shard)
    promoted = torch.sum(assign, dim=-1, dtype=torch.int32)
    return Placement(slot_to_block=s2b, block_to_slot=b2s), promoted, demoted


def plan_promotion(p: Placement, want, est,
                   ) -> Tuple[np.ndarray, Optional[torch.Tensor]]:
    """Host-side control-plane variant for payload-carrying stores: given a
    plan's ids (tensor or array, -1 padding) and the epoch estimate, return
    ``(want_ids, victims)`` where ``victims`` (or None) are the demotions
    that make the promotions fit — the sequence ``TieredStore.migrate``
    expects, chosen by the same ``policy.plan_eviction``."""
    if isinstance(want, torch.Tensor):
        want = want.cpu().numpy()
    want = np.asarray(want).reshape(-1)
    want = want[want >= 0]
    b2s = p.block_to_slot.cpu().numpy()
    n_new = int(np.sum(b2s[want] < 0)) if want.size else 0
    free = p.n_slots - int(torch.sum(p.slot_to_block >= 0))
    need = n_new - free
    victims = None
    if need > 0:
        dev = p.slot_to_block.device
        victims = policy.plan_eviction(
            upload(np.asarray(est, np.float32), dev), upload(want, dev),
            p.slot_to_block, int(need))
    return want, victims
