"""Telemetry export plane: stream a fleet run's records to JSONL +
Prometheus (PyTorch counterpart of ``examples/telemetry_export.py``).

Device telemetry only pays off if ops tooling can consume it, so this
walkthrough runs a two-tenant KV-cache fleet (the reference example's
sizes) with a :class:`repro_torch.export.ExportClient` attached and shows
all three sink styles:

* **JSONL** — one schema-validated wire record per line, written to a
  temporary directory (every record conforms to the frozen
  ``telemetry.schema.json``, units encoded in field names),
* **Prometheus text exposition** — last-value gauges for
  coverage/accuracy/quality/epoch-time labelled by scenario/lane/tenant,
  plus the runtime's dispatch counters published as monotone counters,
* **circuit breaker** — the same run against a sink that fails every
  write: the breaker trips, the client degrades to noop, and the run's
  trajectory is still identical — export can never hurt the epoch loop.

    python -m repro_torch.examples.telemetry_export                # GPU
    python -m repro_torch.examples.telemetry_export --device cpu
"""
from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path
from typing import Optional

from ..core import runtime as rtmod
from ..export import (CircuitBreaker, ExportClient, JsonlSink, MemorySink,
                      PrometheusTextSink)
from ..fleet import FleetScenario, TenantSpec, run_fleet
from ..scenarios import KVCacheScenario

__all__ = ["N_EPOCHS", "make_fleet", "run", "main"]

N_EPOCHS = 4


def make_fleet(device="cuda") -> FleetScenario:
    return FleetScenario([
        TenantSpec(KVCacheScenario(batch=2, n_epochs=N_EPOCHS,
                                   batches_per_epoch=2,
                                   accesses_per_batch=2_048, device=device),
                   name="kv_a"),
        TenantSpec(KVCacheScenario(batch=2, n_epochs=N_EPOCHS,
                                   batches_per_epoch=2,
                                   accesses_per_batch=2_048, seed=7,
                                   device=device),
                   name="kv_b"),
    ], capacity="weighted")


def run(device="cuda", out_dir: Optional[Path] = None) -> dict:
    """The three sink styles over the same fleet; the JSONL goes under
    ``out_dir`` (a fresh temporary directory by default)."""
    out_dir = Path(tempfile.mkdtemp(prefix="repro_export_")
                   if out_dir is None else out_dir)
    jsonl_path = out_dir / "telemetry.jsonl"
    kw = dict(hints=False, sync_every=2, device=device)

    # --- 1. fleet run exporting to JSONL ---------------------------------
    client = ExportClient(JsonlSink(jsonl_path))
    with rtmod.counting() as c:
        run_fleet(make_fleet(device), export=client, **kw)
        dispatches = dict(c.dispatch.items())
    client.flush()
    stats = client.stats()
    client.close()
    lines = jsonl_path.read_text().splitlines()

    # --- 2. Prometheus-style exposition ----------------------------------
    prom = PrometheusTextSink()
    client = ExportClient(prom)
    run_fleet(make_fleet(device), export=client, **kw)
    client.flush()
    for name, count in rtmod.DISPATCH_COUNTS.items():
        prom.set_counter("repro_dispatch_total", count, kind=name)
    client.close()

    # --- 3. dead sink: breaker -> noop, run unharmed ---------------------
    baseline = run_fleet(make_fleet(device), **kw)
    dead = ExportClient(
        MemorySink(fail_always=True), batch_size=1,
        breaker=CircuitBreaker(failure_threshold=1, cooldown_s=0.0),
        degrade_after_trips=2)
    broken = run_fleet(make_fleet(device), export=dead, **kw)
    dead.flush()
    dead_stats = dead.stats()
    dead.close()
    return {
        "jsonl_path": jsonl_path, "lines": lines, "stats": stats,
        "dispatches": dispatches, "prometheus": prom.render(),
        "dead_stats": dead_stats,
        "identical": (json.dumps(baseline["trajectory"], sort_keys=True)
                      == json.dumps(broken["trajectory"], sort_keys=True)),
    }


def checks(res: dict) -> dict:
    """The reference example's assert, by name."""
    return {"export must never change the run": res["identical"]}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.device)
    st, d = res["stats"], res["dispatches"]
    print(f"exported {st['exported']} records -> {res['jsonl_path']}")
    print(f"  dropped={st['dropped_queue_full']} "
          f"breaker={st['breaker_state']} "
          f"dispatches={d['observe_all'] + d['epoch_step']}"
          f" ({N_EPOCHS} epochs x 2)")
    kinds: dict = {}
    for line in res["lines"]:
        kinds.setdefault(json.loads(line)["record_type"], []).append(line)
    for kind, rows in sorted(kinds.items()):
        print(f"  {kind}: {len(rows)} records")
    print("  sample:", res["lines"][0][:100], "...")
    print("\nPrometheus exposition (first 12 lines):")
    for line in res["prometheus"].splitlines()[:12]:
        print(" ", line)
    ds = res["dead_stats"]
    print(f"\ndead sink: breaker_trips={ds['breaker_trips']} "
          f"degraded={ds['degraded']} exported={ds['exported']} "
          f"run_bit_identical={res['identical']}")
    bad = [m for m, good in checks(res).items() if not good]
    if bad:
        raise SystemExit(f"checks failed: {bad}")
    return res


if __name__ == "__main__":
    main()
