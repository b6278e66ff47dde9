"""TieredEmbedding — the paper's technique wired into an embedding table
(PyTorch port of ``repro/core/tiered_embedding.py``).

The table is a :class:`~repro_torch.core.blockstore.TieredStore` (hot rows
in the fast tier, cold rows in the capacity tier) managed by HMU-style
telemetry:

  * **telemetry**: exact per-block access counts of the token stream (host
    numpy, as in the reference);
  * **policy**: oracle top-K / reactive / proactive from
    :mod:`repro_torch.core.policy`, driven per *epoch* (rebalance snapshots
    the counters, so reactive/proactive see epoch-delta hotness);
  * **placement**: explicit ``coldest_victims`` demotions followed by
    promotions via ``TieredStore.migrate`` (``placement.plan_promotion``);
  * **accounting**: the cost model converts the per-tier access mix into
    modeled lookup time, with a per-epoch history.

The store lives on the table's device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..device import upload
from . import placement as placement_lib
from . import policy as policy_lib
from .blockstore import TieredStore
from .costmodel import TPU_V5E_SYSTEM, MemSystem

__all__ = ["TieredEmbedding"]


@dataclasses.dataclass
class TieredEmbedding:
    store: TieredStore
    counts: np.ndarray                   # exact per-block access counts (HMU)
    system: MemSystem = TPU_V5E_SYSTEM
    policy: str = "oracle"               # oracle | proactive | reactive
    ewma_alpha: float = 0.5
    reactive_threshold: int = 2
    _pred: Optional[np.ndarray] = None   # EWMA state for proactive
    _last_counts: Optional[np.ndarray] = None   # epoch-delta snapshot
    history: List[dict] = dataclasses.field(default_factory=list)

    @staticmethod
    def create(table: torch.Tensor, block_rows: int = 8,
               fast_fraction: float = 0.1, **kw) -> "TieredEmbedding":
        n_rows = table.shape[0]
        n_blocks = n_rows // block_rows
        n_slots = max(int(n_blocks * fast_fraction), 1)
        store = TieredStore.create(table, block_rows=block_rows,
                                   n_slots=n_slots)
        return TieredEmbedding(store=store,
                               counts=np.zeros(n_blocks, np.int64), **kw)

    # ------------------------------------------------------------- telemetry
    def observe_tokens(self, tokens) -> None:
        """Feed the step's token ids (any shape) — memory-side counting."""
        if isinstance(tokens, torch.Tensor):
            tokens = tokens.cpu().numpy()
        blocks = np.asarray(tokens).reshape(-1) // self.store.block_rows
        np.add.at(self.counts, blocks, 1)

    def _epoch_counts(self) -> np.ndarray:
        """Counts accumulated since the last rebalance (epoch-local)."""
        if self._last_counts is None:
            return self.counts.copy()
        return self.counts - self._last_counts

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return upload(arr, self.store.storage.device)

    # --------------------------------------------------------------- control
    def rebalance(self) -> int:
        """Run the promotion policy; returns #blocks moved this epoch."""
        k = self.store.n_slots
        delta = self._epoch_counts()
        clipped = np.minimum(delta, np.iinfo(np.int32).max).astype(np.int32)
        if self.policy == "proactive":
            if self._pred is None:
                self._pred = np.zeros(self.counts.shape, np.float32)
            pred, plan = policy_lib.proactive_ewma(
                self._dev(self._pred),
                self._dev(clipped.astype(np.float32)), k,
                alpha=self.ewma_alpha)
            self._pred = pred.cpu().numpy()
        elif self.policy == "reactive":
            # watermark demotion first: free residents this epoch never
            # touched, else the store fills once and reactive freezes
            b2s = self.store.block_to_slot.cpu().numpy()
            resident = np.nonzero(b2s >= 0)[0]
            idle = resident[delta[resident] == 0]
            if idle.size:
                self.store = self.store.demote(self._dev(
                    idle.astype(np.int32)))
            free = k - int(self.store.fast_occupancy())
            plan = policy_lib.reactive_watermark(
                self._dev(clipped), self.reactive_threshold, free,
                max_moves=k)
        else:
            plan = policy_lib.oracle_top_k(self._dev(
                np.minimum(self.counts, np.iinfo(np.int32).max)
                .astype(np.int32)), k)
        self._last_counts = self.counts.copy()

        # explicit demotion: when promotions exceed free slots, evict the
        # epoch-coldest residents (never blocks the plan still wants)
        _, victims = placement_lib.plan_promotion(
            self.store.placement, plan.promote, delta)
        before = int(self.store.fast_occupancy())
        self.store = self.store.migrate(plan.promote, victims)
        return int(self.store.fast_occupancy()) - before + (
            0 if victims is None else int(torch.sum(victims >= 0)))

    def epoch(self, tokens) -> dict:
        """One online epoch: observe the step's tokens, account the modeled
        lookup time under the placement that served them, then rebalance."""
        prev_delta_base = (self._last_counts.copy()
                           if self._last_counts is not None else
                           np.zeros_like(self.counts))
        self.observe_tokens(tokens)
        epoch_counts = self.counts - prev_delta_base
        rep = self.modeled_lookup_time_s(epoch_counts)
        moved = self.rebalance()
        rep = dict(rep, epoch=len(self.history), moved=moved,
                   policy=self.policy)
        self.history.append(rep)
        return rep

    # ------------------------------------------------------------ accounting
    def modeled_lookup_time_s(self, n_lookups_by_block: Optional[np.ndarray]
                              = None) -> dict:
        counts = (n_lookups_by_block if n_lookups_by_block is not None
                  else self.counts)
        fast_mask = self.store.block_to_slot.cpu().numpy() >= 0
        n_fast = float(counts[fast_mask].sum())
        n_slow = float(counts.sum() - n_fast)
        bpa = self.store.dim * self.store.storage.element_size()
        return {
            "tiered_s": self.system.access_time_s(n_fast, n_slow, bpa),
            "all_fast_s": self.system.access_time_s(n_fast + n_slow, 0, bpa),
            "all_slow_s": self.system.access_time_s(0, n_fast + n_slow, bpa),
            "fast_hit_rate": n_fast / max(n_fast + n_slow, 1.0),
            "fast_bytes": int(fast_mask.sum()) * self.store.block_rows * bpa,
        }
