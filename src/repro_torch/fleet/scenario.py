"""FleetScenario — many workloads co-located in one block space (PyTorch
port of ``repro/fleet/scenario.py``).

``TenantSpec`` wraps any :class:`~repro_torch.scenarios.AccessScenario`
with a fleet identity (name, quota weight); ``FleetScenario`` concatenates
N tenants' block spaces into one global id space and is *itself* an
``AccessScenario``, so the whole fleet runs through the unmodified
:func:`~repro_torch.scenarios.run_scenario` packaging.

The fleet owns exactly the plumbing the runtime must never learn:

* **id space** — tenant ``t``'s local block ``b`` is global block
  ``offsets[t] + b`` (:meth:`FleetScenario.to_global` /
  :meth:`~FleetScenario.to_local` round-trip);
* **stream interleave** — per epoch, every tenant's epoch batches are
  flattened, offset, concatenated and shuffled by a per-epoch seeded numpy
  permutation, then cut into fixed-length batch rows (byte-identical to the
  reference's stream);
* **merged geometry** — access/block byte sizes are averaged weighted by
  each tenant's traffic/block share (the runtime models one device); the
  per-tenant accounting (``fleet.accounting``) re-prices each tenant's
  rows with its OWN byte sizes;
* **hint composition** — each tenant's static hint layout is analysed with
  its own prior and scattered into the global rank space
  (:meth:`~repro_torch.hints.HintPipeline.for_fleet`);
* **capacity** — the chosen policy (shared / partition / weighted) compiles
  into the :class:`~repro_torch.core.runtime.Tenancy` the fused epoch step
  enforces on the device.

:func:`run_fleet` is the packaging: one six-lane run over the mix, global
summary plus per-tenant coverage/accuracy/epoch-time rows, optional
per-tenant solo baselines, and per-tenant fault profiles
(:meth:`FleetScenario.build_faults`, ``faults=``), and the export plane
(``export=``: epoch, tenant, lane-summary and tenant-lane-summary wire
records).  ``fused=False`` runs the fleet on the per-lane reference path;
``mesh=`` shards all per-block state, the tenant layout's included.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core import runtime as rtmod
from ..core.costmodel import MemSystem
from ..core.runtime import ALL_POLICIES, EpochRuntime, Tenancy
from ..faults import FaultModel
from ..hints import HintPipeline
from ..scenarios.base import run_scenario, scenario_summary
from . import accounting
from .capacity import make_tenancy

__all__ = ["TenantSpec", "FleetScenario", "run_fleet"]


@dataclasses.dataclass
class TenantSpec:
    """One workload's seat in the fleet: its scenario, its quota weight
    (the ``"weighted"`` capacity policy's knob), and its row name."""
    scenario: object                    # an AccessScenario
    weight: float = 1.0
    name: Optional[str] = None
    offset: int = dataclasses.field(default=0, init=False)

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant weight must be positive, "
                             f"got {self.weight}")
        if self.name is None:
            self.name = self.scenario.name

    @property
    def n_blocks(self) -> int:
        return self.scenario.n_blocks

    @property
    def k_hot(self) -> int:
        """The tenant's solo fast-tier target — its coverage denominator
        and its demand under the ``"partition"`` policy."""
        return min(self.scenario.k_hot, self.scenario.n_blocks)


class FleetScenario:
    """N tenants, one block space, one bounded fast tier.

    ``k_hot`` defaults to the sum of the tenants' solo targets (no
    scarcity); pass something smaller to study contention.  ``capacity``
    selects the quota policy (see :mod:`repro_torch.fleet.capacity`);
    ``"weighted"`` reads the tenant specs' ``weight``.  The fleet runs
    ``min(tenant n_epochs)`` epochs of ``max(tenant batches_per_epoch)``
    interleaved batch rows.
    """

    name = "fleet"

    def __init__(
        self,
        tenants: Sequence[TenantSpec],
        k_hot: Optional[int] = None,
        capacity: str = "shared",
        system: Optional[MemSystem] = None,
        pebs_period: Optional[int] = None,
        seed: int = 0,
    ):
        if len(tenants) < 2:
            raise ValueError("a fleet needs at least two tenants")
        # shallow-copy the specs (scenario objects stay shared so cached
        # model-backed streams replay): the fleet assigns offsets, and two
        # fleets over the same spec objects must not fight over them
        self.tenants: List[TenantSpec] = [dataclasses.replace(t)
                                          for t in tenants]
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"tenant names must be unique, got {names}")
        off = 0
        for t in self.tenants:
            t.offset = off
            off += t.n_blocks
        self.n_blocks = off
        self.offsets: Tuple[int, ...] = tuple(
            [t.offset for t in self.tenants] + [off])
        self.k_hot = (sum(t.k_hot for t in self.tenants) if k_hot is None
                      else min(int(k_hot), self.n_blocks))
        self.capacity = capacity
        self.tenancy: Tenancy = make_tenancy(
            self.offsets, [t.k_hot for t in self.tenants], self.k_hot,
            capacity=capacity, weights=[t.weight for t in self.tenants])
        self.seed = int(seed)
        self.n_epochs = min(t.scenario.n_epochs for t in self.tenants)
        self.batches_per_epoch = max(t.scenario.batches_per_epoch
                                     for t in self.tenants)
        self.shift_at = min(max(t.scenario.shift_at for t in self.tenants),
                            max(self.n_epochs - 1, 0))
        # merged cost-model geometry: the runtime models ONE memory device,
        # so scalar byte sizes are traffic/block-share weighted means; the
        # per-tenant accounting re-prices each tenant with its own sizes
        self.system = system if system is not None \
            else self.tenants[0].scenario.system
        traffic = np.array([self._epoch_accesses(t) for t in self.tenants],
                           np.float64)
        blocks = np.array([t.n_blocks for t in self.tenants], np.float64)
        self.bytes_per_access = float(np.average(
            [t.scenario.bytes_per_access for t in self.tenants],
            weights=traffic))
        self.block_bytes = float(np.average(
            [t.scenario.block_bytes for t in self.tenants], weights=blocks))
        self.pebs_period = (min(t.scenario.pebs_period for t in self.tenants)
                            if pebs_period is None else int(pebs_period))
        self.nb_scan_rate = max(self.n_blocks // self.batches_per_epoch, 1)

    @staticmethod
    def _epoch_accesses(t: TenantSpec) -> float:
        """Per-epoch access volume a tenant contributes (weighting only)."""
        s = t.scenario
        for attr in ("accesses_per_batch", "batch_len"):
            if hasattr(s, attr):
                return s.batches_per_epoch * float(getattr(s, attr))
        if hasattr(s, "spec") and hasattr(s.spec, "lookups_per_batch"):
            return s.batches_per_epoch * float(s.spec.lookups_per_batch)
        return float(s.n_blocks)

    # ------------------------------------------------------------- id space
    def tenant_index(self, name: str) -> int:
        for i, t in enumerate(self.tenants):
            if t.name == name:
                return i
        raise KeyError(name)

    def to_global(self, tenant: int, local_ids) -> np.ndarray:
        """Tenant-local block ids -> global fleet ids."""
        local = np.asarray(local_ids)
        n_t = self.tenants[tenant].n_blocks
        if local.size and (local.min() < 0 or local.max() >= n_t):
            raise ValueError(f"local ids out of range [0, {n_t}) for "
                             f"tenant {tenant}")
        return (local + self.offsets[tenant]).astype(np.int64)

    def to_local(self, global_ids) -> Tuple[np.ndarray, np.ndarray]:
        """Global fleet ids -> (tenant index, tenant-local id) pairs."""
        g = np.asarray(global_ids)
        if g.size and (g.min() < 0 or g.max() >= self.n_blocks):
            raise ValueError(f"global ids out of range [0, {self.n_blocks})")
        tenant = np.searchsorted(np.asarray(self.offsets), g,
                                 side="right") - 1
        return (tenant.astype(np.int64),
                (g - np.asarray(self.offsets)[tenant]).astype(np.int64))

    # ------------------------------------------------------------- protocol
    def epochs(self) -> Iterator[np.ndarray]:
        """Interleaved fleet stream, deterministic per call: epoch e of every
        tenant, offset into global id space, concatenated, shuffled by the
        per-epoch seed, and cut into ``batches_per_epoch`` equal rows (the
        tail shorter than one row — at most batches_per_epoch-1 accesses —
        is dropped deterministically)."""
        streams = [iter(t.scenario.epochs()) for t in self.tenants]
        for e in range(self.n_epochs):
            parts = [np.asarray(next(it)).ravel().astype(np.int64) + t.offset
                     for t, it in zip(self.tenants, streams)]
            flat = np.concatenate(parts).astype(np.int32)
            rng = np.random.default_rng([self.seed, e])
            rng.shuffle(flat)
            rows = self.batches_per_epoch
            batch = flat.size // rows
            yield flat[: batch * rows].reshape(rows, batch)

    def hint_layout(self):
        """No single flat layout exists for a fleet (each tenant has its own
        prior); hint composition happens in :meth:`build_pipeline`."""
        return None

    def build_pipeline(self, depth: int = 1, clip_rank: Optional[int] = None,
                       detector: bool = True) -> HintPipeline:
        """Composed fleet pipeline (what ``run_scenario(..., hints=True)``
        and :func:`run_fleet` attach): every tenant's static layout analysed
        with its own prior, scattered at its offset —
        :meth:`HintPipeline.for_fleet`."""
        return HintPipeline.for_fleet(
            self.n_blocks,
            [(t.offset, t.scenario.hint_layout()) for t in self.tenants],
            depth=depth, clip_rank=clip_rank, detector=detector)

    def build_faults(self, profiles: Dict[str, dict],
                     **global_kwargs) -> FaultModel:
        """Per-tenant fault profiles -> one fleet-wide
        :class:`~repro_torch.faults.FaultModel`, keyed by tenant name.  Each
        profile sets the per-block knobs (``pebs_drop_p``,
        ``hmu_counter_bits`` / ``hmu_counter_max``) on that tenant's block
        segment; collector-wide knobs (``reset_p``, ``nb_stall_p``,
        ``stale_epochs``, ``seed``) go in ``global_kwargs`` — a reset drains
        the shared collector, it cannot hit one tenant's blocks alone."""
        unknown = set(profiles) - {t.name for t in self.tenants}
        if unknown:
            raise KeyError(f"unknown tenant names {sorted(unknown)}; "
                           f"tenants are {[t.name for t in self.tenants]}")
        segs = [profiles.get(t.name) for t in self.tenants]
        return FaultModel.for_segments(self.offsets, segs, **global_kwargs)


def run_fleet(
    fleet: FleetScenario,
    policies: Sequence[str] = ALL_POLICIES,
    hints=True,
    lookahead_depth: int = 1,
    prefetch_overlap: float = 1.0,
    fused: bool = True,
    mesh=None,
    mesh_axis: str = "blocks",
    sync_every: int = 1,
    epochs=None,
    solo: bool = False,
    faults=None,
    hardening=None,
    export=None,
    device="cuda",
    **runtime_overrides,
) -> dict:
    """Place the whole fleet online and slice the result per tenant, on
    ``device`` (default ``"cuda"``: raises without a CUDA device; pass
    ``device="cpu"`` for the plain versions on the CPU).

    Mirrors :func:`~repro_torch.scenarios.run_scenario` (the fleet IS a
    scenario; the runtime inherits its :class:`Tenancy` through
    ``EpochRuntime.for_scenario``) but keeps the runtime in hand so the
    per-tenant accounting can be sliced from ``EpochRuntime.
    tenant_records``.  Returns ``{"trajectory", "summary", "tenants"}``.

    ``sync_every=K`` batches the runtime's record pulls — the per-tenant
    ``(n_lanes, n_tenants)`` rows ride the same every-K transfer as the
    global records, identical for every K.

    ``solo=True`` additionally runs every tenant's scenario alone (fresh
    pipelines, same policies, same device) for interference-vs-isolation
    comparisons, each under a nested :func:`~repro_torch.core.runtime.
    counting` scope whose view stamps the solo row's own
    ``dispatches_per_epoch``.

    ``faults=`` takes a fleet-wide :class:`~repro_torch.faults.FaultModel`
    or a ``{tenant_name: profile}`` dict handed to
    :meth:`FleetScenario.build_faults` (per-tenant degradation; for
    collector-wide knobs call ``build_faults`` yourself).  ``hardening=``
    passes through to the runtime.  Solo baselines always run fault-free:
    the comparison is this tenant under the fleet's faults against this
    tenant alone on healthy telemetry.

    ``export=`` (a :class:`repro_torch.export.ExportClient`) is bound to
    the fleet's name and receives the epoch records, each lane's summary,
    and every tenant row and tenant-lane summary; solo baselines export
    nothing.  ``fused=False`` runs the per-lane reference path (its quotas
    by numpy stable sorts).  ``mesh`` shards all per-block state over its
    ``mesh_axis`` (every rank of the mesh calls this with the same
    arguments); the solo baselines run without it, as in the reference.
    """
    if hints is True:
        hints = fleet.build_pipeline(depth=lookahead_depth)
    if isinstance(faults, dict):
        faults = fleet.build_faults(faults)
    exp = export.bind(scenario=fleet.name) if export is not None else None
    rt = EpochRuntime.for_scenario(
        fleet, policies=tuple(policies), hints=hints or None,
        prefetch_overlap=prefetch_overlap, fused=fused, mesh=mesh,
        mesh_axis=mesh_axis, sync_every=sync_every, faults=faults, hardening=hardening,
        export=exp, device=device, **runtime_overrides)
    traj = rt.run(fleet.epochs() if epochs is None else epochs)
    summary = scenario_summary(rt, traj, policies, fleet.shift_at)
    if exp is not None:
        for name in policies:
            exp.export_lane_summary(name, summary[name])
    out = {
        "trajectory": json.loads(traj.to_json(
            scenario=fleet.name, shift_at=fleet.shift_at,
            capacity=fleet.capacity)),
        "summary": summary,
        "tenants": accounting.tenant_summary(rt, fleet, policies,
                                             export=exp),
    }
    if solo:
        solos: Dict[str, dict] = {}
        for t in fleet.tenants:
            with rtmod.counting() as c:
                solos[t.name] = run_scenario(
                    t.scenario, policies=policies, hints=bool(hints),
                    lookahead_depth=lookahead_depth,
                    prefetch_overlap=prefetch_overlap, device=device)
            solos[t.name]["dispatches_per_epoch"] = (
                c.dispatch["observe_all"] + c.dispatch["epoch_step"]
            ) / t.scenario.n_epochs
        out["solo"] = solos
    return out
