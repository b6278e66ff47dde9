"""Degraded telemetry: fault injection and the hardened runtime (PyTorch
counterpart of ``examples/degraded_telemetry.py``).

The paper measures telemetry limits on healthy collectors.  At rack scale
the collectors themselves fail: HMU drain races wipe counter state, PEBS
sheds samples under interrupt pressure, the NB scan thread stalls.  A
tiering daemon that trusts a degraded signal keeps migrating on noise.

This walkthrough injects the worst HMU fault — a collector reset every
epoch (``reset_p = [1, 0, 0]``: every drain races, the deltas turn to
garbage) — into the §III.B DLRM trace with a phase shift at epoch 5, and
runs the oracle lane three ways:

* **healthy**  — no faults: the ceiling;
* **naive**    — faults on, runtime unchanged: the lane keeps ranking the
  wrecked HMU deltas and its coverage collapses;
* **hardened** — the same faults plus :class:`~repro_torch.faults.Hardening`:
  the on-device quality estimate (observed mass over expected, smoothed)
  watches the HMU signal crater and swaps the lane's input, by
  ``torch.where``, to the healthy PEBS collector; demotion hysteresis stops
  one garbage epoch from flushing the resident hot set.

Injection, quality and fallback all run inside the same epoch: one
``observe_all``, one ``epoch_step`` and one record pull an epoch.  The
draws are the reference's own, so each run is byte-identical to the
reference example's, and a fault-free model equals the healthy run.

    python -m repro_torch.examples.degraded_telemetry                # GPU
    python -m repro_torch.examples.degraded_telemetry --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Optional

import numpy as np

from ..core import runtime as rtmod
from ..dlrm import datagen
from ..faults import FaultModel, Hardening
from ..scenarios import DLRMScenario, run_scenario

__all__ = ["LANE", "N_EPOCHS", "SHIFT", "margins_met", "run", "scenario"]

LANE = "hmu_oracle"
N_EPOCHS, SHIFT = 10, 5
SPEC = dataclasses.replace(datagen.SMALL, lookups_per_batch=30_000)
# pebs_period sized so the fallback target resolves the hot set (~2.6k
# samples an epoch for k_hot = 250): the point is degraded HMU against
# healthy PEBS, not PEBS undersampling
RUN_KW = dict(policies=(LANE, "hinted"), hints=False, pebs_period=23)


def scenario() -> DLRMScenario:
    return DLRMScenario(spec=SPEC, n_epochs=N_EPOCHS, batches_per_epoch=2,
                        shift_at=SHIFT)


def hmu_resets() -> FaultModel:
    """Every epoch's drain races: HMU counts wiped before the observes."""
    return FaultModel.create(reset_p=np.array([1.0, 0.0, 0.0], np.float32),
                             seed=7, n_blocks=scenario().n_blocks)


def run(device="cuda") -> dict:
    """The healthy, neutral-model, naive and hardened runs; the hardened
    run's dispatch counts; and the headline coverages and final quality."""
    kw = dict(RUN_KW, device=device)
    healthy = run_scenario(scenario(), **kw)
    neutral = run_scenario(scenario(), faults=FaultModel.create(
        n_blocks=scenario().n_blocks), **kw)
    naive = run_scenario(scenario(), faults=hmu_resets(), **kw)
    with rtmod.counting() as counts:
        hard = run_scenario(
            scenario(), faults=hmu_resets(),
            hardening=Hardening.make(fallback={LANE: "pebs"},
                                     demote_hysteresis=2), **kw)
    lanes = {name: out["trajectory"]["lanes"][LANE]
             for name, out in (("healthy", healthy), ("naive", naive),
                               ("hardened", hard))}
    # post-warmup means, shift epochs excluded (coverage is 0 there by
    # construction: the hot set moved under every variant)
    steady = [e for e in range(2, N_EPOCHS) if e not in (SHIFT, SHIFT + 1)]
    return {
        "lanes": lanes,
        "neutral_equals_healthy":
            neutral["trajectory"] == healthy["trajectory"],
        "cov": {name: float(np.mean([rows[e]["coverage"] for e in steady]))
                for name, rows in lanes.items()},
        "q_final": lanes["hardened"][-1]["quality"],
        "dispatch": {kind: counts.dispatch[kind]
                     for kind in ("observe_all", "epoch_step",
                                  "record_sync")},
    }


def margins_met(res: dict) -> Dict[str, bool]:
    """The reference example's asserts, by name: its three margins, its
    neutral-model identity, and its "2 dispatches an epoch" as one
    observe_all, one epoch_step and one record pull an epoch."""
    cov, d = res["cov"], res["dispatch"]
    return {
        "naive < healthy - 0.3 (the fault really bites)":
            cov["naive"] < cov["healthy"] - 0.3,
        "hardened > naive + 0.1 (the fallback really helps)":
            cov["hardened"] > cov["naive"] + 0.1,
        "final quality < 0.2 (the estimator saw it)": res["q_final"] < 0.2,
        "one observe_all, one epoch_step and one record pull an epoch":
            d["observe_all"] == d["epoch_step"] == d["record_sync"]
            == N_EPOCHS,
        "a fault-free model equals the healthy run":
            res["neutral_equals_healthy"],
    }


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.device)
    sc, lanes, cov = scenario(), res["lanes"], res["cov"]
    print(f"DLRM {sc.n_blocks} pages, k_hot={sc.k_hot}, phase shift at epoch "
          f"{SHIFT}; HMU collector reset every epoch (drain race, "
          f"reset_p=1.0); '{LANE}' lane\n")
    print(f"{'epoch':>5s} {'healthy':>8s} {'naive':>8s} {'hardened':>9s} "
          f"{'quality':>8s}")
    for e in range(N_EPOCHS):
        print(f"{e:>5d} {lanes['healthy'][e]['coverage']:>8.2f} "
              f"{lanes['naive'][e]['coverage']:>8.2f} "
              f"{lanes['hardened'][e]['coverage']:>9.2f} "
              f"{lanes['hardened'][e]['quality']:>8.2f}")
    d = res["dispatch"]
    print(f"\nsteady coverage: healthy {cov['healthy']:.2f}, naive "
          f"{cov['naive']:.2f}, hardened {cov['hardened']:.2f}; final HMU "
          f"quality {res['q_final']:.2f} (floor 0.5)")
    print(f"hardened run: {d['observe_all']} observe_all, {d['epoch_step']} "
          f"epoch_step, {d['record_sync']} record pulls over {N_EPOCHS} "
          f"epochs")
    bad = [m for m, ok in margins_met(res).items() if not ok]
    if bad:
        raise SystemExit(f"margins missed: {bad}")
    print("margins met: " + "; ".join(margins_met(res)))


if __name__ == "__main__":
    main()
