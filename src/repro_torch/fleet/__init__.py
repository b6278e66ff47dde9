"""repro_torch.fleet — multi-tenant telemetry: many workloads, one fast tier
(PyTorch port of ``repro/fleet``).

Device-level telemetry pays off when *many* workloads contend for one
bounded fast tier.  This package co-locates several
:class:`~repro_torch.scenarios.AccessScenario`\\ s in one block space and
drives the six-lane :class:`~repro_torch.core.runtime.EpochRuntime` over
the mix:

* :class:`TenantSpec` / :class:`FleetScenario` (``fleet/scenario.py``) —
  the global<->local id-space mapping, the deterministic per-epoch stream
  interleave, merged cost-model geometry, composed per-tenant hint layouts.
  The fleet is itself an ``AccessScenario``: the runtime never learns it is
  placing several workloads instead of one.
* :mod:`~repro_torch.fleet.capacity` — shared pool / static partition /
  weighted-fair quotas, compiled into the :class:`~repro_torch.core.
  runtime.Tenancy` the fused epoch step enforces on the device
  (segment-capped selection; the epoch stays one ``observe_all`` and one
  epoch step).
* :mod:`~repro_torch.fleet.accounting` — per-tenant coverage / accuracy /
  epoch-time rows from the runtime's per-tenant counts (which ride the one
  record pull), re-priced in each tenant's own byte geometry.
* :func:`run_fleet` — the packaging; ``repro_torch.examples.fleet_mix``
  shows the headline: under a shared pool a scanning noisy neighbour
  craters a DLRM tenant's coverage, while weighted-fair quotas hold it near
  its solo run.
"""
from .accounting import TenantRecord, tenant_summary, tenant_trajectories
from .capacity import CAPACITY_POLICIES, fair_quotas, make_tenancy
from .scenario import FleetScenario, TenantSpec, run_fleet

__all__ = [
    "CAPACITY_POLICIES", "FleetScenario", "TenantRecord", "TenantSpec",
    "fair_quotas", "make_tenancy", "run_fleet", "tenant_summary",
    "tenant_trajectories",
]
