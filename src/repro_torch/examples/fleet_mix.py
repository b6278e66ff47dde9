"""Multi-tenant fleet: four workloads, one fast tier, two capacity policies
(PyTorch counterpart of ``examples/fleet_mix.py``).

Device-level telemetry matters most when many workloads contend for one
bounded fast tier.  This walkthrough co-locates four tenants in one
:class:`~repro_torch.fleet.FleetScenario`:

* **dlrm**    — the §III.B embedding-page trace (the tenant worth protecting),
* **kv**      — a tiered LLM KV cache fed by decode-time attention mass,
* **moe**     — MoE expert banks placed from router counters,
* **scanner** — mmap-bench (§III.A) cranked into a noisy neighbour: a wide,
  internally-uniform region scanned at high volume, whose loud counters
  out-rank everyone else's hot sets.

The sizes, ``K_HOT = 340`` and the weights are the reference's; the KV and
MoE streams come from the port's own models on ``device``.  The six-lane
EpochRuntime runs the interleaved mix twice:

* ``capacity="shared"``   — one pool, no quotas: the scanner's counters crowd
  the DLRM hot set out of every lane's top-k selection and its coverage
  craters;
* ``capacity="weighted"`` — weighted-fair quotas sized so the DLRM quota
  covers its solo hot set: every lane's selection is segment-capped per
  tenant on the device, and DLRM holds within a few points of its solo run.

    python -m repro_torch.examples.fleet_mix                 # on the GPU
    python -m repro_torch.examples.fleet_mix --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional

from ..dlrm import datagen
from ..fleet import FleetScenario, TenantSpec, run_fleet
from ..scenarios import (DLRMScenario, KVCacheScenario, MmapBenchScenario,
                         MoEExpertScenario)
from ..workloads import mmap_bench

__all__ = ["K_HOT", "LANE", "TENANTS", "fleet", "make_scenarios",
           "margins_met", "run"]

N_EPOCHS, LANE = 6, "hmu_oracle"
K_HOT = 340                           # < combined demand: contention is real
TENANTS = ("dlrm", "kv", "moe", "scanner")


def make_scenarios(device="cuda") -> Dict[str, object]:
    """One scenario per tenant, shared by every fleet built over them, so
    the model-backed streams (KV decode, MoE routing; run on ``device``)
    generate once and replay."""
    return {
        "dlrm": DLRMScenario(
            spec=dataclasses.replace(datagen.SMALL, lookups_per_batch=30_000),
            n_epochs=N_EPOCHS, batches_per_epoch=2, shift_at=0),  # stationary
        "kv": KVCacheScenario(batch=2, n_epochs=N_EPOCHS, batches_per_epoch=2,
                              accesses_per_batch=2_048, device=device),
        "moe": MoEExpertScenario(n_epochs=N_EPOCHS, batches_per_epoch=2,
                                 batch=2, shift_at=3, device=device),
        "scanner": MmapBenchScenario(
            spec=mmap_bench.MmapBenchSpec(total_bytes=640 * 4096,
                                          hot_bytes=512 * 4096),
            n_epochs=N_EPOCHS, batches_per_epoch=2,
            accesses_per_batch=60_000),
    }


def tenants(scenarios: Dict[str, object]) -> List[TenantSpec]:
    # weights are the operator's SLO knob: demand-sized for the protected
    # tenants, deliberately small for the scanner
    kv, moe = scenarios["kv"], scenarios["moe"]
    return [
        TenantSpec(scenarios["dlrm"], weight=250.0, name="dlrm"),
        TenantSpec(kv, weight=float(kv.k_hot), name="kv"),
        TenantSpec(moe, weight=float(moe.k_hot), name="moe"),
        TenantSpec(scenarios["scanner"], weight=60.0, name="scanner"),
    ]


def fleet(scenarios: Dict[str, object], capacity: str) -> FleetScenario:
    return FleetScenario(tenants(scenarios), k_hot=K_HOT, capacity=capacity)


def run(device="cuda",
        scenarios: Optional[Dict[str, object]] = None) -> dict:
    """The shared-pool and weighted-fair runs (the latter with every
    tenant's solo run), and the headline coverages of the ``LANE`` lane."""
    sc = make_scenarios(device) if scenarios is None else scenarios
    runs = {capacity: run_fleet(fleet(sc, capacity), hints=True,
                                sync_every=1,
                                solo=(capacity == "weighted"), device=device)
            for capacity in ("shared", "weighted")}

    def cov(capacity, name):
        return runs[capacity]["tenants"][name]["lanes"][LANE][
            "final_coverage"]

    solo = runs["weighted"]["solo"]
    return {
        "runs": runs,
        "scenarios": sc,
        "solo_cov": {n: solo[n]["summary"][LANE]["final_coverage"]
                     for n in TENANTS},
        "shared_cov": {n: cov("shared", n) for n in TENANTS},
        "fair_cov": {n: cov("weighted", n) for n in TENANTS},
        "caps": {n: runs["weighted"]["tenants"][n]["cap"] for n in TENANTS},
    }


def margins_met(res: dict) -> Dict[str, bool]:
    """The reference example's headline margins, by name."""
    solo = res["solo_cov"]["dlrm"]
    return {
        "dlrm quota >= its solo hot set":
            res["caps"]["dlrm"] >= res["scenarios"]["dlrm"].k_hot,
        "shared < solo - 0.3 (the scanner craters the shared pool)":
            res["shared_cov"]["dlrm"] < solo - 0.3,
        "weighted > solo - 0.05 (weighted-fair holds DLRM near solo)":
            res["fair_cov"]["dlrm"] > solo - 0.05,
    }


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.device)
    sc = res["scenarios"]
    fleet_blocks = sum(s.n_blocks for s in sc.values())
    print(f"fleet: {fleet_blocks} blocks across {len(TENANTS)} tenants, "
          f"k_hot={K_HOT} shared slots, {N_EPOCHS} interleaved epochs; "
          f"'{LANE}' lane shown\n")
    print(f"{'tenant':>8s} {'solo cov':>9s} | {'shared cov':>10s} "
          f"{'weighted cov':>12s} {'quota':>6s}")
    for name in TENANTS:
        print(f"{name:>8s} {res['solo_cov'][name]:>9.2f} | "
              f"{res['shared_cov'][name]:>10.2f} "
              f"{res['fair_cov'][name]:>12.2f} {res['caps'][name]:>6d}")
    weighted = res["runs"]["weighted"]["tenants"]
    print("\nper-tenant mean epoch time (weighted, native byte geometry): "
          + "  ".join(f"{n}={weighted[n]['lanes'][LANE]['mean_time_us']:.0f}"
                      f"us" for n in TENANTS))
    bad = [m for m, ok in margins_met(res).items() if not ok]
    if bad:
        raise SystemExit(f"margins missed: {bad}")
    print(f"\nmargins met: DLRM coverage {res['solo_cov']['dlrm']:.2f} (solo)"
          f" -> {res['shared_cov']['dlrm']:.2f} (shared) -> "
          f"{res['fair_cov']['dlrm']:.2f} (weighted, quota "
          f"{res['caps']['dlrm']} >= {sc['dlrm'].k_hot})")


if __name__ == "__main__":
    main()
