"""Per-tenant accounting — slicing the fleet's epoch records by tenant
(PyTorch port of ``repro/fleet/accounting.py``).

The runtime's per-tenant raw counts (``EpochRuntime.tenant_records``: one
``(n_lanes, n_tenants)`` int64 row set per epoch, summed over each tenant's
id range inside the fused epoch step and pulled with the global records —
with ``sync_every=K`` they ride the same every-K transfer) become
:class:`TenantRecord` rows here, re-priced with each tenant's OWN cost-model
geometry: a tenant's access time uses its own ``bytes_per_access``, its
migration time its own ``block_bytes``.

Definitions (per tenant t, lane l, epoch e):

* ``coverage``  = |fast ∩ hot_t| / hot_k[t] where ``hot_t`` is the tenant's
  own top-``hot_k[t]`` blocks by epoch count *within its id range* — the
  same denominator the tenant's solo run uses.
* ``accuracy``  = |fast ∩ hot_t| / resident_t.
* ``host_tax_s`` = the lane's global host tax apportioned by the tenant's
  share of the epoch's accesses (collectors are device-global).
* ``time_s`` = access + tax + migration, stop-the-world migration charging
  for every lane (the prefetch lane's overlap stays on the global record).

Conservation: ``n_fast``/``n_slow``/``resident``/``promoted``/``demoted``
sum across tenants to the global :class:`~repro_torch.core.runtime.
EpochRecord` exactly (tested); ``coverage`` does not, by construction.

``export=`` (a :class:`repro_torch.export.ExportClient`) emits every row as
a ``tenant`` wire record and every per-lane summary as a
``tenant_lane_summary`` record, both already on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from ..core.runtime import EpochRuntime

__all__ = ["TenantRecord", "tenant_trajectories", "tenant_summary"]


@dataclasses.dataclass
class TenantRecord:
    """One tenant's slice of one lane's accounting for one epoch."""
    epoch: int
    lane: str
    tenant: str
    time_s: float
    access_s: float
    host_tax_s: float
    migration_s: float
    accuracy: float
    coverage: float
    resident: int
    promoted: int
    demoted: int
    n_fast: int
    n_slow: int
    hot_k: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def tenant_trajectories(rt: EpochRuntime, fleet, export=None,
                        ) -> Dict[str, Dict[str, List[TenantRecord]]]:
    """``{tenant: {lane: [TenantRecord per epoch]}}`` from a fleet run.

    Flushes the runtime's batched record sync first, so a caller that
    stepped by hand with ``sync_every > 1`` never reads a partial
    ``tenant_records`` history.  ``export=`` emits every row as a
    ``tenant`` wire record tagged by tenant name (the rows rode the same
    record pull as the global records: no extra transfer)."""
    rt.flush()                      # sync_every=K partial tail, if any
    if rt.tenancy is None or not rt.tenant_records:
        raise ValueError("runtime has no tenant accounting; build it via "
                         "EpochRuntime.for_scenario on a FleetScenario")
    lanes = list(rt.records)
    hot_k = rt.tenancy.hot_k
    out: Dict[str, Dict[str, List[TenantRecord]]] = {
        t.name: {lane: [] for lane in lanes} for t in fleet.tenants}
    for e, raw in enumerate(rt.tenant_records):
        for i, lane in enumerate(lanes):
            g = rt.records[lane][e]
            total = float(raw["n_fast"][i].sum() + raw["n_slow"][i].sum())
            for t_idx, spec in enumerate(fleet.tenants):
                n_fast = int(raw["n_fast"][i][t_idx])
                n_slow = int(raw["n_slow"][i][t_idx])
                inter = int(raw["inter"][i][t_idx])
                resident = int(raw["resident"][i][t_idx])
                promoted = int(raw["promoted"][i][t_idx])
                demoted = int(raw["demoted"][i][t_idx])
                access_s = rt.system.access_time_s(
                    n_fast, n_slow, spec.scenario.bytes_per_access)
                migration_s = rt.system.migration_time_s(
                    promoted + demoted, spec.scenario.block_bytes)
                share = (n_fast + n_slow) / total if total else 0.0
                host_tax_s = g.host_tax_s * share
                rec = TenantRecord(
                    epoch=e, lane=lane, tenant=spec.name,
                    time_s=access_s + host_tax_s + migration_s,
                    access_s=access_s, host_tax_s=host_tax_s,
                    migration_s=migration_s,
                    accuracy=(inter / resident) if resident else 0.0,
                    coverage=inter / hot_k[t_idx],
                    resident=resident, promoted=promoted, demoted=demoted,
                    n_fast=n_fast, n_slow=n_slow, hot_k=hot_k[t_idx],
                )
                out[spec.name][lane].append(rec)
                if export is not None:
                    export.export_tenant_record(rec)
    return out


def tenant_summary(rt: EpochRuntime, fleet,
                   policies: Sequence[str], export=None) -> dict:
    """Headline per-tenant numbers: quota, hot-set size, and per-lane
    mean/final coverage + accuracy, mean epoch time, move totals — plus the
    full per-epoch rows (the machine-readable trajectory).

    The per-lane dicts are wire-conformant ``tenant_lane_summary`` records
    minus the envelope (units in field names); ``export=`` emits them."""
    trajs = tenant_trajectories(rt, fleet, export=export)
    caps = rt.tenancy.caps
    summary: Dict[str, dict] = {}
    for t_idx, spec in enumerate(fleet.tenants):
        lanes = {}
        for lane in policies:
            recs = trajs[spec.name][lane]
            covs = np.array([r.coverage for r in recs])
            accs = np.array([r.accuracy for r in recs])
            lanes[lane] = {
                "mean_coverage": float(covs.mean()),
                "final_coverage": float(covs[-1]),
                "mean_accuracy": float(accs.mean()),
                "final_accuracy": float(accs[-1]),
                "mean_time_us": float(np.mean(
                    [r.time_s for r in recs]) * 1e6),
                "promoted_total_blocks": int(sum(r.promoted for r in recs)),
                "demoted_total_blocks": int(sum(r.demoted for r in recs)),
            }
            if export is not None:
                export.export_tenant_lane_summary(spec.name, lane,
                                                  lanes[lane])
        summary[spec.name] = {
            "n_blocks": spec.n_blocks,
            "hot_k": rt.tenancy.hot_k[t_idx],
            "cap": None if caps is None else caps[t_idx],
            "weight": spec.weight,
            "lanes": lanes,
            "records": {lane: [r.to_dict() for r in trajs[spec.name][lane]]
                        for lane in policies},
        }
    return summary
