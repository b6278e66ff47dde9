"""TieringManager — the paper's "Tiering Agent" (Fig. 2) as a runtime object
(PyTorch port of ``repro/core/manager.py``).

Access stream -> telemetry collectors -> promotion policy -> cost
accounting, in the paper's three phases: profile (allocations in the slow
tier, collectors observe), promote (each collector's top-K), measure (the
stream is replayed against each placement and the cost model turns the
per-tier access mix into time).

The collector state is one :class:`~repro_torch.core.telemetry.TelemetryBundle`
on the manager's device.  ``observe(batch)`` goes through the per-collector
entry points (four ``observe_scatter`` launches per batch), and
``observe_epoch(batches)`` through ``observe_all`` (one per batch); both
give the same state bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..device import upload
from ..kernels.dispatch import resolve_device
from . import metrics, policy
from . import telemetry as tel
from .costmodel import MemSystem, split_accesses_by_tier

__all__ = ["StrategyResult", "TieringManager"]


@dataclasses.dataclass
class StrategyResult:
    name: str
    promoted: np.ndarray           # block ids promoted (>=0, unique)
    est_counts: np.ndarray         # collector's hotness estimate
    accuracy: float                # vs true top-K
    coverage: float                # fraction of true top-K promoted
    host_events: int               # host-side work the collector cost
    time_s: Optional[float] = None
    fast_bytes: Optional[float] = None
    slow_bytes: Optional[float] = None


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class TieringManager:
    """Runs the three telemetry strategies side-by-side over one stream, on
    ``device`` (default ``"cuda"``: raises without a CUDA device; pass
    ``device="cpu"`` for the plain versions on the CPU)."""

    def __init__(
        self,
        n_blocks: int,
        k_hot: int,
        pebs_period: int = 10007,
        nb_scan_rate: Optional[int] = None,
        hmu_log_capacity: int = 1 << 33,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.n_blocks = n_blocks
        self.k_hot = min(k_hot, n_blocks)
        # default: one full NB scan pass every ~16 observe calls
        scan = nb_scan_rate if nb_scan_rate is not None else max(
            n_blocks // 16, 1)
        self.bundle = tel.bundle_init(
            n_blocks, pebs_period=pebs_period, nb_scan_rate=scan,
            hmu_log_capacity=hmu_log_capacity, device=self.device)

    # ------------------------------------------------- collector accessors
    @property
    def hmu(self) -> tel.HMUState:
        return self.bundle.hmu

    @hmu.setter
    def hmu(self, state: tel.HMUState) -> None:
        self.bundle = dataclasses.replace(self.bundle, hmu=state)

    @property
    def pebs(self) -> tel.PEBSState:
        return self.bundle.pebs

    @pebs.setter
    def pebs(self, state: tel.PEBSState) -> None:
        self.bundle = dataclasses.replace(self.bundle, pebs=state)

    @property
    def nb(self) -> tel.NBState:
        return self.bundle.nb

    @nb.setter
    def nb(self, state: tel.NBState) -> None:
        self.bundle = dataclasses.replace(self.bundle, nb=state)

    @property
    def true_counts(self) -> np.ndarray:
        """Exact access histogram (host copy, int64 for downstream sums)."""
        return _np(self.bundle.true_counts).astype(np.int64)

    def _ids(self, block_ids) -> torch.Tensor:
        if isinstance(block_ids, torch.Tensor):
            return block_ids.to(self.device, torch.int32)
        return upload(np.asarray(block_ids).astype(np.int32, copy=False),
                      self.device)

    # ---------------------------------------------------------------- observe
    def observe(self, block_ids) -> None:
        """Feed one batch of the access stream to all collectors (one
        ``observe_scatter`` launch per collector)."""
        arr = self._ids(block_ids)
        self.bundle = tel.TelemetryBundle(
            hmu=tel.hmu_observe(self.bundle.hmu, arr),
            pebs=tel.pebs_observe(self.bundle.pebs, arr),
            nb=tel.nb_observe(self.bundle.nb, arr),
            true_counts=tel.count_observe(self.bundle.true_counts, arr))

    def observe_epoch(self, batches) -> None:
        """Observe ``(n_batches, batch_size)`` through ``observe_all``."""
        arr = self._ids(batches)
        if arr.dim() != 2:
            raise ValueError(f"observe_epoch wants (n_batches, batch), got "
                             f"{tuple(arr.shape)}")
        self.bundle = tel.observe_all(self.bundle, arr)

    def observe_stream(self, stream: Iterable) -> None:
        for batch in stream:
            self.observe(batch)

    # ---------------------------------------------------------------- decide
    def decide(self, nb_rate_limit: Optional[int] = None,
               ) -> Dict[str, policy.MigrationPlan]:
        self.hmu = tel.hmu_drain_cost(self.hmu)
        return {
            "hmu": policy.oracle_top_k(tel.hmu_estimate(self.hmu),
                                       self.k_hot),
            "pebs": policy.oracle_top_k(tel.pebs_estimate(self.pebs),
                                        self.k_hot),
            "nb": policy.nb_two_touch(tel.nb_estimate(self.nb), self.k_hot,
                                      nb_rate_limit),
        }

    # --------------------------------------------------------------- evaluate
    def evaluate(
        self,
        system: MemSystem,
        bytes_per_access: float,
        eval_counts: Optional[np.ndarray] = None,
        compute_base_s: float = 0.0,
        nb_rate_limit: Optional[int] = None,
    ) -> Dict[str, StrategyResult]:
        """Promote per strategy, replay the (eval) stream, model the time.

        ``eval_counts`` defaults to the profiled counts (the paper replays
        the same workload); ``compute_base_s`` is the non-memory time."""
        true_counts = self.true_counts
        true = eval_counts if eval_counts is not None else true_counts
        true_hot = metrics.true_top_k(true_counts, self.k_hot)
        plans = self.decide(nb_rate_limit=nb_rate_limit)
        ests = {
            "hmu": _np(tel.hmu_estimate(self.hmu)),
            "pebs": _np(tel.pebs_estimate(self.pebs)),
            "nb": _np(tel.nb_estimate(self.nb)),
        }
        host = {
            "hmu": int(float(self.hmu.host_events)),
            "pebs": int(float(self.pebs.host_events)),
            "nb": int(float(self.nb.host_events)),
        }
        out: Dict[str, StrategyResult] = {}
        for name, plan in plans.items():
            promoted = _np(plan.promote)
            promoted = np.unique(promoted[promoted >= 0])
            is_fast = np.zeros((self.n_blocks,), bool)
            is_fast[promoted] = True
            n_fast, n_slow = split_accesses_by_tier(true, is_fast)
            t = compute_base_s + system.access_time_s(n_fast, n_slow,
                                                      bytes_per_access)
            out[name] = StrategyResult(
                name=name, promoted=promoted, est_counts=ests[name],
                accuracy=metrics.accuracy(promoted, true_hot),
                coverage=metrics.coverage(promoted, true_hot, self.k_hot),
                host_events=host[name], time_s=t,
                fast_bytes=n_fast * bytes_per_access,
                slow_bytes=n_slow * bytes_per_access)
        # reference placements
        for name, mask in (
            ("dram-only", np.ones((self.n_blocks,), bool)),
            ("slow-only", np.zeros((self.n_blocks,), bool)),
        ):
            n_fast, n_slow = split_accesses_by_tier(true, mask)
            out[name] = StrategyResult(
                name=name, promoted=np.nonzero(mask)[0],
                est_counts=true_counts,
                accuracy=1.0 if mask.any() else 0.0,
                coverage=1.0 if mask.any() else 0.0,
                host_events=0,
                time_s=compute_base_s + system.access_time_s(
                    n_fast, n_slow, bytes_per_access),
                fast_bytes=n_fast * bytes_per_access,
                slow_bytes=n_slow * bytes_per_access)
        return out
