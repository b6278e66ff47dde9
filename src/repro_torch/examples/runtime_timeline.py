"""Runtime self-observability: trace the epoch loop, render the timeline
(PyTorch counterpart of ``examples/runtime_timeline.py``).

The fused runtime claims its ``sync_every=K`` record pull is *pipelined* —
the host keeps launching new epochs while a previous window's records are
still being pulled off the device.  :mod:`repro_torch.obs` makes that
claim visible instead of argued: span-trace a run, write a Chrome trace,
and open it in chrome://tracing or Perfetto to watch the ``record_sync``
span overlap the next epoch's ``observe_all`` on the synthesized device
track.  This walkthrough, at the reference example's sizes:

* runs the same workload obs-off and obs-on (tracing + metrics registry
  + runtime_span/runtime_metric export) and checks nothing changed —
  dispatch counts equal, records bit-identical,
* prints the span accounting (exactly one observe_all + one epoch_step
  per epoch, ceil(n_epochs/K) record_syncs),
* writes the Chrome trace to a temporary directory and checks the
  pipelining is structurally visible in it,
* renders the metrics registry as Prometheus text exposition.

    python -m repro_torch.examples.runtime_timeline                # GPU
    python -m repro_torch.examples.runtime_timeline --device cpu
"""
from __future__ import annotations

import argparse
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from ..core import runtime as rtmod
from ..core.runtime import EpochRuntime
from ..export import ExportClient, MemorySink, PrometheusTextSink
from ..obs import chrometrace
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace

__all__ = ["N_EPOCHS", "SYNC_EVERY", "run", "main"]

N_BLOCKS, K_HOT, N_EPOCHS, SYNC_EVERY = 2_000, 200, 6, 3
POLICIES = ("hmu_oracle", "hinted", "nb_two_touch")


def epochs():
    """The reference example's Zipf stream, from its seed."""
    rng = np.random.default_rng(31)
    return [(rng.zipf(1.3, size=(2, 8_000)) % N_BLOCKS).astype(np.int32)
            for _ in range(N_EPOCHS)]


def _run(eps, device, export=None):
    rt = EpochRuntime(N_BLOCKS, K_HOT, policies=POLICIES, pebs_period=16,
                      nb_scan_rate=N_BLOCKS // 4, sync_every=SYNC_EVERY,
                      export=export, device=device)
    with rtmod.counting() as c:
        rt.run(iter(eps))
        return rt, dict(c.dispatch.items())


def run(device="cuda", trace_dir: Optional[Path] = None) -> dict:
    """Obs off, then obs on, over the same stream; writes the Chrome trace
    under ``trace_dir`` (a fresh temporary directory by default) and
    returns what the checks read."""
    eps = epochs()
    # --- 1. obs off: the baseline the watcher must not perturb -----------
    _run(eps, device)                              # build and warm up
    off_rt, off_disp = _run(eps, device)

    # --- 2. obs on: tracing + registry mirror + export --------------------
    registry = obs_metrics.MetricsRegistry()
    sink = MemorySink()
    client = ExportClient(sink)
    with obs_trace.tracing(metrics=registry) as tracer:
        on_rt, on_disp = _run(eps, device, export=client)
    for span in tracer.spans:
        client.export_runtime_span(span)
    client.export_metrics(registry)
    client.flush()
    stats = client.stats()
    client.close()

    # --- 3. the timeline ---------------------------------------------------
    trace_dir = Path(tempfile.mkdtemp(prefix="repro_obs_")
                     if trace_dir is None else trace_dir)
    trace_path = trace_dir / "trace.json"
    doc = chrometrace.write_chrome_trace(
        trace_path, tracer.spans,
        metadata={"example": "runtime_timeline", "sync_every": SYNC_EVERY})

    # --- 4. the registry as a Prometheus scrape ---------------------------
    prom = PrometheusTextSink()
    registry.publish(prom)
    spans_by_name: dict = {}
    for s in tracer.spans:
        spans_by_name[s.name] = spans_by_name.get(s.name, 0) + 1
    records = sink.snapshot()
    return {
        "dispatch_off": off_disp, "dispatch_on": on_disp,
        "identical": all([a.to_dict() for a in off_rt.records[lane]]
                         == [b.to_dict() for b in on_rt.records[lane]]
                         for lane in POLICIES),
        "spans": spans_by_name, "stats": stats,
        "n_span_records": sum(r["record_type"] == "runtime_span"
                              for r in records),
        "n_metric_records": sum(r["record_type"] == "runtime_metric"
                                for r in records),
        "trace_path": trace_path, "trace": doc,
        "pipelining_visible": chrometrace.pipelining_visible(tracer.spans),
        "prometheus": prom.render(),
    }


def checks(res: dict) -> dict:
    """The reference example's asserts, by name."""
    return {
        "observability changed the run":
            res["dispatch_on"] == res["dispatch_off"] and res["identical"],
        "sync_every>1 must make record_sync overlap dispatch":
            res["pipelining_visible"],
    }


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.device)
    ok = checks(res)
    d = res["dispatch_on"]
    print(f"non-interference: "
          f"dispatches_equal={res['dispatch_on'] == res['dispatch_off']} "
          f"records_bit_identical={res['identical']} "
          f"({(d['observe_all'] + d['epoch_step']) // N_EPOCHS}"
          f" dispatches/epoch)")
    print("span accounting:", dict(sorted(res["spans"].items())))
    print(f"exported {res['stats']['exported']} records "
          f"({res['n_span_records']} runtime_span, "
          f"{res['n_metric_records']} runtime_metric)")
    doc = res["trace"]
    device_spans = [e for e in doc["traceEvents"] if e["tid"] == "device"]
    print(f"\nchrome trace -> {res['trace_path']}")
    print(f"  {len(doc['traceEvents'])} events, device windows: "
          f"{[e['name'] for e in device_spans]}")
    print(f"  pipelining visible (sync_every={SYNC_EVERY}): "
          f"{res['pipelining_visible']}")
    print("  open in chrome://tracing or https://ui.perfetto.dev")
    print("\nPrometheus exposition (span-duration histogram excerpt):")
    wanted = [ln for ln in res["prometheus"].splitlines()
              if "repro_span_duration_s" in ln]
    for line in wanted[:10]:
        print(" ", line)
    bad = [m for m, good in ok.items() if not good]
    if bad:
        raise SystemExit(f"checks failed: {bad}")
    return res


if __name__ == "__main__":
    main()
