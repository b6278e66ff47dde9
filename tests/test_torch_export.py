"""repro_torch.export — the port's wire schema, sinks and non-blocking
client, against the reference's ``repro.export``.

Three parts:

* **Schema** — the port's ``telemetry.schema.json`` is the reference's
  document byte for byte; the same hand-made bad records are rejected by
  both validators with the same ``SchemaError`` message (the offending
  path), and the good ones by neither; the wire converters give the
  reference's records for the same inputs.
* **Client and sinks** — the port's counterparts of
  ``tests/test_export.py``'s unit cases: the circuit breaker on an
  injected clock, the bounded queue that drops and never blocks, invalid
  records dropped and counted, a dead sink degrading the client to noop,
  ``bind``, ``close`` and the interpreter-exit drain, the JSONL and
  Prometheus sinks, and the ``tracemalloc`` budget of the export path.
* **Parity and non-interference** — the records a ``MemorySink`` collects
  equal the reference's, field for field and in order, on the SMALL DLRM
  run (hints on, ``sync_every`` 1 and 4), on the 3-tenant fleet (DLRM +
  scanner + the reference's MoE replayed, every capacity policy), and on a
  faulty hardened run at ``quality_beta`` 0.7 (its ``quality`` fields);
  export and tracing add no launch step and no record pull and leave the
  trajectory byte-identical; a dead sink never stalls or changes a run.

Tolerance: exact everywhere — records and messages compare with ``==``
(their floats come from the same float64 host arithmetic)."""
import dataclasses
import json
import subprocess
import sys
import textwrap
import threading
import time
import tracemalloc
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402
_torch_threads.limit()

from repro.dlrm import datagen as jdata  # noqa: E402
from repro.export import ExportClient as JExportClient  # noqa: E402
from repro.export import MemorySink as JMemorySink  # noqa: E402
from repro.export import schema as jschema  # noqa: E402
from repro.faults import FaultModel as JFaultModel  # noqa: E402
from repro.faults import Hardening as JHardening  # noqa: E402
from repro.fleet import run_fleet as jrun_fleet  # noqa: E402
from repro.scenarios import DLRMScenario as JDLRM  # noqa: E402
from repro.scenarios import MoEExpertScenario  # noqa: E402
from repro.scenarios import run_scenario as jrun_scenario  # noqa: E402
from repro_torch.core import runtime as rtmod  # noqa: E402
from repro_torch.core.runtime import ALL_POLICIES, EpochRuntime  # noqa: E402
from repro_torch.dlrm import datagen as tdata  # noqa: E402
from repro_torch.examples import telemetry_export  # noqa: E402
from repro_torch.export import (CircuitBreaker, ExportClient, JsonlSink,  # noqa: E402
                                MemorySink, NoopClient, PrometheusTextSink,
                                SchemaError, epoch_record_wire,
                                lane_summary_wire, load_schema,
                                runtime_metric_wire, runtime_span_wire,
                                tenant_lane_summary_wire, tenant_record_wire,
                                validate_record)
from repro_torch.export import schema as tschema  # noqa: E402
from repro_torch.faults import FaultModel, Hardening  # noqa: E402
from repro_torch.faults.model import LANE_COLLECTOR, collector_for_lane  # noqa: E402
from repro_torch.fleet import run_fleet  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.obs.trace import Span  # noqa: E402
from repro_torch.scenarios import DLRMScenario, run_scenario  # noqa: E402
from test_torch_fleet import MIX_KW, MoEReplay, reference_fleet, small_fleet  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
J_SPEC = dataclasses.replace(jdata.SMALL, lookups_per_batch=8_000)
T_SPEC = dataclasses.replace(tdata.SMALL, lookups_per_batch=8_000)
N_EPOCHS, SHIFT = 6, 3
HARD = dict(fallback={"hmu_oracle": "pebs", "hinted": "hmu",
                      "nb_two_touch": "hmu"}, demote_hysteresis=2)
ALL_FAULTS = dict(pebs_drop_p=0.3, reset_p=(0.5, 0.5, 0.5), nb_stall_p=0.5,
                  hmu_counter_bits=12, stale_epochs=1, seed=7)


class Rec:
    """A duck-typed EpochRecord."""
    epoch = 3
    lane = "hinted"
    time_s = 1.5
    access_s = 1.0
    host_tax_s = 0.25
    migration_s = 0.25
    hidden_s = 0.0
    accuracy = 0.9
    coverage = 0.8
    quality = 1.0
    resident = 64
    promoted = 2
    demoted = 1
    host_events = 100.0


class TenantRec:
    epoch = 0
    lane = "hinted"
    tenant = "kv_a"
    time_s = 1.0
    access_s = 1.0
    host_tax_s = 0.0
    migration_s = 0.0
    accuracy = 0.25
    coverage = 0.75
    resident = 8
    promoted = 0
    demoted = 0
    n_fast = 10
    n_slow = 2
    hot_k = 8


def sample_epoch_record():
    return epoch_record_wire(Rec(), scenario="unit")


class SlowSink:
    """Sink that blocks in write() until released — forces queue pressure."""

    def __init__(self):
        self.release = threading.Event()
        self.records = []

    def write(self, records):
        self.release.wait(timeout=30)
        self.records.extend(records)


class DiscardSink:
    def write(self, records):
        pass


def collect(client_cls, sink_cls, run):
    """Run ``run(client)`` against a fresh client on a MemorySink; returns
    (run's result, the records in order, the client's stats)."""
    sink = sink_cls()
    client = client_cls(sink)
    try:
        out = run(client)
        client.flush(timeout=60)
        stats = client.stats()
    finally:
        client.close()
    return out, sink.snapshot(), stats


# =====================================================================
# schema + validator
# =====================================================================
def test_schema_copy_is_byte_identical():
    assert tschema.SCHEMA_PATH.read_bytes() == jschema.SCHEMA_PATH.read_bytes()
    assert tschema.SCHEMA_PATH.parent == \
        REPO / "src" / "repro_torch" / "export"
    assert tschema.SCHEMA_VERSION == jschema.SCHEMA_VERSION
    assert load_schema() == jschema.load_schema()


def test_schema_document_is_frozen_shape():
    doc = load_schema()
    for name in ("epoch", "tenant", "lane_summary", "tenant_lane_summary"):
        node = doc["$defs"][name]
        assert node["additionalProperties"] is False
        assert node["properties"]["schema_version"]["const"] == 1


def test_units_in_field_names():
    rec = sample_epoch_record()
    assert validate_record(rec) is rec
    assert "time_s" in rec and "resident_blocks" in rec
    assert "host_events_count" in rec
    assert not any(k in rec for k in ("time", "resident", "host_events"))


BAD_EPOCH = {
    "missing": lambda r: r.pop("coverage"),
    "extra": lambda r: r.__setitem__("surprise_field", 1),
    "ratio_cap": lambda r: r.__setitem__("coverage", 1.5),
    "ratio_floor": lambda r: r.__setitem__("coverage", -0.1),
    "integer": lambda r: r.__setitem__("resident_blocks", 1.5),
    "bool_int": lambda r: r.__setitem__("resident_blocks", True),
    "lane_enum": lambda r: r.__setitem__("lane", "surprise_lane"),
    "collector_enum": lambda r: r.__setitem__("collector", "ebpf"),
    "version": lambda r: r.__setitem__("schema_version", 2),
    "epoch_floor": lambda r: r.__setitem__("epoch", -1),
    "number": lambda r: r.__setitem__("time_s", "fast"),
    "scenario_type": lambda r: r.__setitem__("scenario", 3),
    "record_type": lambda r: r.__setitem__("record_type", "mystery"),
    "not_a_shape": lambda r: r.__setitem__("record_type", "ratio"),
    "no_record_type": lambda r: r.pop("record_type"),
}


@pytest.mark.parametrize("mutation", sorted(BAD_EPOCH))
def test_bad_records_rejected_by_both_validators_alike(mutation):
    rec = sample_epoch_record()
    BAD_EPOCH[mutation](rec)
    with pytest.raises(SchemaError) as got:
        validate_record(dict(rec))
    with pytest.raises(jschema.SchemaError) as want:
        jschema.validate_record(dict(rec))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("bad", [
    [{"record_type": "epoch"}],
    {"record_type": "runtime_metric", "schema_version": 1, "metric": "m",
     "kind": "timer"},
    {"record_type": "runtime_metric", "schema_version": 1, "metric": "m",
     "kind": "counter", "labels": {"k": 3}},
    {"record_type": "tenant_lane_summary", "schema_version": 1,
     "tenant": "t", "lane": "hinted"},
], ids=["not_a_dict", "metric_kind", "label_type", "summary_missing"])
def test_other_bad_records_rejected_by_both_alike(bad):
    with pytest.raises(SchemaError) as got:
        validate_record(bad)
    with pytest.raises(jschema.SchemaError) as want:
        jschema.validate_record(bad)
    assert str(got.value) == str(want.value)


def test_collector_field_tracks_lane():
    for lane, col in LANE_COLLECTOR.items():
        rec = sample_epoch_record()
        rec["lane"] = lane
        rec["collector"] = collector_for_lane(lane)
        assert rec["collector"] == col
        validate_record(rec)
        if col is not None:
            rec["collector"] = "bogus"
            with pytest.raises(SchemaError):
                validate_record(rec)
    rec = sample_epoch_record()
    del rec["scenario"]
    validate_record(rec)


def test_native_validator_agrees_with_jsonschema():
    jsonschema = pytest.importorskip("jsonschema")
    doc = load_schema()
    good = sample_epoch_record()
    jsonschema.validate(good, doc)
    validate_record(good)
    for name in ("missing", "extra", "ratio_cap"):
        bad = sample_epoch_record()
        BAD_EPOCH[name](bad)
        with pytest.raises(jsonschema.ValidationError):
            jsonschema.validate(bad, doc)
        with pytest.raises(SchemaError):
            validate_record(bad)


def test_wire_converters_equal_the_reference():
    span = Span(name="record_sync", t0_s=1.5, dur_s=0.25, tid="host",
                depth=1, epoch=None, args={"epoch_base": 4, "n_epochs": 2})
    summary = {"mean_coverage": 0.5, "final_coverage": 0.5,
               "mean_accuracy": 0.25, "final_accuracy": 0.25,
               "mean_time_us": 3.0, "promoted_total_blocks": 4,
               "demoted_total_blocks": 2}
    pairs = [
        (epoch_record_wire(Rec(), "s"), jschema.epoch_record_wire(Rec(), "s")),
        (tenant_record_wire(TenantRec(), "f"),
         jschema.tenant_record_wire(TenantRec(), "f")),
        (tenant_lane_summary_wire("t", "hinted", summary),
         jschema.tenant_lane_summary_wire("t", "hinted", summary)),
        (runtime_span_wire(span, "kv"), jschema.runtime_span_wire(span, "kv")),
        (runtime_metric_wire("repro_d_s", "histogram", labels={"span": 1},
                             bucket_le=[0.1], bucket_counts=[3, 1],
                             sum_value=0.6, observations=4),
         jschema.runtime_metric_wire("repro_d_s", "histogram",
                                     labels={"span": 1}, bucket_le=[0.1],
                                     bucket_counts=[3, 1], sum_value=0.6,
                                     observations=4)),
    ]
    for got, want in pairs:
        assert json.dumps(got) == json.dumps(want)
        validate_record(got)
    assert pairs[3][0]["t_start_us"] == 1.5e6
    assert (pairs[3][0]["epoch_base"], pairs[3][0]["n_epochs_count"]) == (4, 2)


def test_summaries_are_schema_conformant():
    out = run_scenario(DLRMScenario(spec=T_SPEC, n_epochs=N_EPOCHS,
                                    shift_at=SHIFT),
                       hints=True, device="cpu")
    for lane in ALL_POLICIES:
        validate_record(lane_summary_wire(lane, out["summary"][lane],
                                          scenario="dlrm"))
    assert "pending_migration_us" in out["summary"]["prefetch"]


# =====================================================================
# circuit breaker
# =====================================================================
def test_breaker_trip_half_open_recover_cycle():
    t = [0.0]
    b = CircuitBreaker(failure_threshold=2, cooldown_s=1.0,
                       clock=lambda: t[0])
    assert b.state == "closed" and b.allow()
    b.record_failure()
    assert b.state == "closed"            # below threshold
    b.record_failure()
    assert b.state == "open" and not b.allow() and b.trips == 1
    t[0] = 0.5
    assert not b.allow()                  # still cooling down
    t[0] = 1.0
    assert b.state == "half_open" and b.allow()
    b.record_failure()                    # probe fails -> re-open
    assert b.state == "open" and b.trips == 2
    t[0] = 2.5
    assert b.allow()                      # next probe
    b.record_success()
    assert b.state == "closed" and b.consecutive_trips == 0
    b.record_failure()                    # threshold counter was reset
    assert b.state == "closed"
    with pytest.raises(ValueError, match="failure_threshold"):
        CircuitBreaker(failure_threshold=0)


def test_breaker_success_resets_failure_streak():
    b = CircuitBreaker(failure_threshold=3)
    b.record_failure()
    b.record_failure()
    b.record_success()
    b.record_failure()
    b.record_failure()
    assert b.state == "closed"


# =====================================================================
# client edge cases
# =====================================================================
def test_happy_path_batched_delivery():
    sink = MemorySink()
    client = ExportClient(sink, flush_interval_s=0.005)
    for _ in range(100):
        assert client.emit(sample_epoch_record())
    client.flush(timeout=10)
    st = client.stats()
    assert st["emitted"] == 100 and st["exported"] == 100
    assert len(sink.snapshot()) == 100 and sink.write_calls <= 100
    client.close()


def test_queue_full_drops_and_never_blocks():
    sink = SlowSink()
    client = ExportClient(sink, queue_size=8, flush_interval_s=0.005)
    t0 = time.monotonic()
    for _ in range(200):
        client.emit(sample_epoch_record())
    emit_elapsed = time.monotonic() - t0
    st = client.stats()
    assert st["dropped_queue_full"] > 0
    assert st["dropped_queue_full"] + st["emitted"] == 200
    assert emit_elapsed < 5.0
    sink.release.set()
    client.flush(timeout=10)
    assert client.stats()["exported"] == client.stats()["emitted"]
    client.close()


def test_invalid_record_dropped_counted_not_raised():
    sink = MemorySink()
    client = ExportClient(sink, flush_interval_s=0.005)
    client.emit({"record_type": "epoch", "schema_version": 1})
    client.emit(sample_epoch_record())
    client.flush(timeout=10)
    st = client.stats()
    assert st["dropped_invalid"] == 1 and st["exported"] == 1
    client.close()


def test_breaker_trips_on_sink_failure_then_recovers():
    sink = MemorySink(fail_until=2)
    client = ExportClient(
        sink, batch_size=1, flush_interval_s=0.005,
        breaker=CircuitBreaker(failure_threshold=2, cooldown_s=0.0),
        degrade_after_trips=100)
    client.emit(sample_epoch_record())
    client.emit(sample_epoch_record())
    client.flush(timeout=10)
    st = client.stats()
    assert st["sink_failures"] == 2 and st["breaker_trips"] == 1
    assert st["dropped_sink_failure"] == 2
    client.emit(sample_epoch_record())    # half-open probe
    client.flush(timeout=10)
    st = client.stats()
    assert st["breaker_state"] == "closed" and st["exported"] == 1
    assert not st["degraded"]
    client.close()


def test_open_breaker_sheds_at_emit():
    t = [0.0]
    sink = MemorySink()
    breaker = CircuitBreaker(failure_threshold=1, cooldown_s=100.0,
                             clock=lambda: t[0])
    client = ExportClient(sink, flush_interval_s=0.005, breaker=breaker)
    breaker.record_failure()              # force open
    assert not client.emit(sample_epoch_record())
    st = client.stats()
    assert st["dropped_breaker_open"] == 1 and st["emitted"] == 0
    t[0] = 200.0                          # cooldown elapsed: accept again
    assert client.emit(sample_epoch_record())
    client.flush(timeout=10)
    assert client.stats()["exported"] == 1
    client.close()


def test_dead_sink_degrades_to_noop():
    client = ExportClient(
        MemorySink(fail_always=True), batch_size=1, flush_interval_s=0.005,
        breaker=CircuitBreaker(failure_threshold=1, cooldown_s=0.0),
        degrade_after_trips=3)
    for _ in range(50):
        client.emit(sample_epoch_record())
    client.flush(timeout=10)
    st = client.stats()
    assert st["degraded"] is True and client.degraded
    assert st["breaker_trips"] >= 3 and st["exported"] == 0
    assert client.emit(sample_epoch_record()) is False
    assert client.stats()["dropped_degraded"] >= 1
    client.close()


def test_bind_labels_scenario_and_shares_counters():
    sink = MemorySink()
    client = ExportClient(sink, flush_interval_s=0.005)
    bound = client.bind(scenario="bound_name")
    bound.emit(sample_epoch_record())
    bound.export_epoch_record(Rec())
    client.flush(timeout=10)
    assert bound.stats()["exported"] == 2
    assert sink.snapshot()[1]["scenario"] == "bound_name"
    assert sink.snapshot()[0]["scenario"] == "unit"
    with pytest.raises(TypeError):
        client.bind(region="us-east-1")
    client.close()


def test_close_idempotent_and_noop_client_inert():
    client = ExportClient(MemorySink())
    client.close()
    client.close()
    assert client.emit(sample_epoch_record()) is False
    noop = NoopClient()
    assert noop.emit(sample_epoch_record()) is False
    assert noop.bind(scenario="x") is noop
    assert noop.export_metrics(None) == 0
    noop.flush()
    noop.close()
    assert noop.stats()["emitted"] == 0


def test_interpreter_exit_drains_queue(tmp_path):
    """A process that exits without close() still lands every emitted
    record in the JSONL sink (the client's atexit hook)."""
    out = tmp_path / "telemetry.jsonl"
    code = f"""
    import json, sys
    from repro_torch.export import ExportClient, JsonlSink

    rec = {json.dumps(sample_epoch_record())}
    client = ExportClient(JsonlSink({str(out)!r}), flush_interval_s=0.01)
    for i in range(250):
        r = dict(rec); r["epoch"] = i
        assert client.emit(r)
    assert not any(m.split(".")[0] in ("jax", "repro")
                   for m in sys.modules)
    """
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO, env={"PYTHONPATH": str(REPO / "src"),
                                        "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    lines = out.read_text().splitlines()
    assert sorted(json.loads(ln)["epoch"] for ln in lines) == \
        list(range(250))
    for ln in lines:
        validate_record(json.loads(ln))


def test_export_spans_are_host_spans_only():
    """The client's enqueue/write/flush spans land on the tracer (the
    flusher's on its own thread) and never become records themselves."""
    sink = MemorySink()
    client = ExportClient(sink, flush_interval_s=0.01)
    try:
        with obs_trace.tracing() as tr:
            client.export_runtime_metric("repro_x_total", "counter", 1)
            client.flush(timeout=10)
    finally:
        client.close()
    names = {s.name for s in tr.spans}
    assert {"export.enqueue", "export.write_batch", "export.flush"} <= names
    (wb,) = [s for s in tr.spans if s.name == "export.write_batch"]
    assert wb.tid == "repro-export-flusher" and wb.args == {"batch": 1}
    assert [r["record_type"] for r in sink.snapshot()] == ["runtime_metric"]


# =====================================================================
# sinks
# =====================================================================
def test_jsonl_sink_round_trip(tmp_path):
    path = tmp_path / "t.jsonl"
    sink = JsonlSink(path)
    recs = [sample_epoch_record() for _ in range(3)]
    sink.write(recs[:2])
    sink.write(recs[2:])
    sink.close()
    assert [json.loads(ln) for ln in path.read_text().splitlines()] == recs


def test_prometheus_text_exposition():
    sink = PrometheusTextSink()
    rec = sample_epoch_record()
    sink.write([rec])
    tenant = tenant_record_wire(TenantRec(), scenario="fleet")
    validate_record(tenant)
    sink.write([tenant])
    sink.set_counter("repro_dispatch_total", 12, kind="epoch_step")
    text = sink.render()
    assert "# TYPE repro_coverage_ratio gauge" in text
    assert ('repro_coverage_ratio{lane="hinted",scenario="unit",'
            'tenant=""} 0.8') in text
    assert ('repro_coverage_ratio{lane="hinted",scenario="fleet",'
            'tenant="kv_a"} 0.75') in text
    assert 'repro_dispatch_total{kind="epoch_step"} 12' in text
    sink.write([dict(rec, coverage=0.5)])         # last write wins
    assert ('repro_coverage_ratio{lane="hinted",scenario="unit",'
            'tenant=""} 0.5') in sink.render()


def test_prometheus_hostile_labels_help_and_histograms():
    sink = PrometheusTextSink()
    hostile = 'a\\b"c\nd'
    sink.set_counter("repro_x_total", 1, help="line1\nline2", kind=hostile)
    sink.set_gauge("repro_g", 2)
    sink.set_histogram("repro_h_s", (0.1, 1.0), (2, 3, 1), 2.5,
                       span="observe_all")
    text = sink.render()
    assert 'repro_x_total{kind="a\\\\b\\"c\\nd"} 1' in text
    assert "# HELP repro_x_total line1\\nline2" in text
    assert "# TYPE repro_g gauge" in text
    assert 'repro_h_s_bucket{span="observe_all",le="1"} 5' in text
    assert 'repro_h_s_bucket{span="observe_all",le="+Inf"} 6' in text
    assert 'repro_h_s_count{span="observe_all"} 6' in text
    with pytest.raises(ValueError, match="len\\(bounds\\)\\+1"):
        sink.set_histogram("repro_h_s", (0.1,), (1,), 0.0)


def test_drop_counters_published_to_prometheus_sink():
    sink = PrometheusTextSink()
    client = ExportClient(sink, flush_interval_s=0.01)
    try:
        assert client.emit({"record_type": "nonsense"})
        client.export_runtime_metric("repro_x_total", "counter", 1)
        client.flush(timeout=10)
        text = sink.render()
    finally:
        client.close()
    assert 'repro_export_dropped_total{reason="invalid"} 1' in text
    assert "repro_export_emitted_total 2" in text
    assert "repro_export_exported_total 1" in text


# =====================================================================
# parity with the reference
# =====================================================================
def _dlrm_pair():
    return (JDLRM(spec=J_SPEC, n_epochs=N_EPOCHS, shift_at=SHIFT),
            DLRMScenario(spec=T_SPEC, n_epochs=N_EPOCHS, shift_at=SHIFT))


@pytest.mark.parametrize("sync_every", [1, 4])
def test_scenario_records_equal_the_reference(sync_every):
    js, ts = _dlrm_pair()
    t_out, t_recs, t_st = collect(ExportClient, MemorySink, lambda c: (
        run_scenario(ts, hints=True, sync_every=sync_every, device="cpu",
                     export=c)))
    j_out, j_recs, _ = collect(JExportClient, JMemorySink, lambda c: (
        jrun_scenario(js, hints=True, sync_every=sync_every, export=c)))
    assert json.dumps(t_out) == json.dumps(j_out)
    assert json.dumps(t_recs) == json.dumps(j_recs)
    assert len(t_recs) == N_EPOCHS * len(ALL_POLICIES) + len(ALL_POLICIES)
    assert {r["scenario"] for r in t_recs} == {"dlrm"}
    assert t_st["dropped_invalid"] == t_st["dropped_queue_full"] == 0


@pytest.fixture(scope="module")
def moe_pair():
    ref = MoEExpertScenario(shift_at=2, batch=2, **MIX_KW)
    return ref, MoEReplay(ref)


@pytest.mark.parametrize("capacity", ["shared", "partition", "weighted"])
def test_fleet_records_equal_the_reference(moe_pair, capacity):
    """Epoch, lane-summary, tenant and tenant-lane-summary records of the
    3-tenant mix, in order, field for field."""
    jmoe, tmoe = moe_pair
    t_out, t_recs, _ = collect(ExportClient, MemorySink, lambda c: run_fleet(
        small_fleet(tmoe, capacity), hints=True, sync_every=2, device="cpu",
        export=c))
    j_out, j_recs, _ = collect(JExportClient, JMemorySink, lambda c: (
        jrun_fleet(reference_fleet(jmoe, capacity), hints=True, sync_every=2,
                   export=c)))
    assert json.dumps(t_out["trajectory"]) == json.dumps(j_out["trajectory"])
    assert json.dumps(t_recs) == json.dumps(j_recs)
    kinds = {r["record_type"] for r in t_recs}
    assert kinds == {"epoch", "lane_summary", "tenant",
                     "tenant_lane_summary"}


def test_faulty_hardened_quality_records_equal_the_reference():
    """A faulty, hardened run at quality_beta 0.7 (every fault on): the
    exported records, their ``quality`` fields among them, equal the
    reference's, and the quality really moves."""
    js, ts = _dlrm_pair()
    har = dict(HARD, quality_beta=0.7)
    t_out, t_recs, _ = collect(ExportClient, MemorySink, lambda c: (
        run_scenario(ts, hints=True, device="cpu", export=c,
                     faults=FaultModel.create(n_blocks=ts.n_blocks,
                                              **ALL_FAULTS),
                     hardening=Hardening.make(**har))))
    j_out, j_recs, _ = collect(JExportClient, JMemorySink, lambda c: (
        jrun_scenario(js, hints=True, export=c,
                      faults=JFaultModel.create(n_blocks=js.n_blocks,
                                                **ALL_FAULTS),
                      hardening=JHardening.make(**har))))
    tq = [(r["lane"], r["epoch"], r["quality"]) for r in t_recs
          if r["record_type"] == "epoch"]
    jq = [(r["lane"], r["epoch"], r["quality"]) for r in j_recs
          if r["record_type"] == "epoch"]
    assert tq == jq
    assert min(q for _, _, q in tq) < 1.0
    assert json.dumps(t_recs) == json.dumps(j_recs)


# =====================================================================
# non-interference
# =====================================================================
@pytest.mark.parametrize("sync_every", [1, 4])
def test_export_and_tracing_add_no_launch_and_no_pull(sync_every):
    ts = _dlrm_pair()[1]
    with rtmod.counting() as c_off:
        base = run_scenario(ts, hints=True, sync_every=sync_every,
                            device="cpu")
        off = dict(c_off.dispatch.items())

    def traced(client):
        with obs_trace.tracing():
            with rtmod.counting() as c_on:
                out = run_scenario(ts, hints=True, sync_every=sync_every,
                                   device="cpu", export=client)
                return out, dict(c_on.dispatch.items())

    (on, on_counts), recs, st = collect(ExportClient, MemorySink, traced)
    assert on_counts == off
    assert on_counts["observe_all"] == on_counts["epoch_step"] == N_EPOCHS
    assert on_counts["record_sync"] == -(-N_EPOCHS // sync_every)
    assert json.dumps(on) == json.dumps(base)
    assert st["exported"] == len(recs) == st["emitted"]


def test_dead_sink_never_stalls_or_corrupts_run():
    ts = _dlrm_pair()[1]
    base = run_scenario(ts, hints=False, sync_every=3, device="cpu")
    client = ExportClient(
        MemorySink(fail_always=True), batch_size=1, flush_interval_s=0.005,
        breaker=CircuitBreaker(failure_threshold=1, cooldown_s=0.0),
        degrade_after_trips=2)
    t0 = time.monotonic()
    on = run_scenario(ts, hints=False, sync_every=3, device="cpu",
                      export=client)
    elapsed = time.monotonic() - t0
    client.flush(timeout=30)
    assert json.dumps(base) == json.dumps(on)
    st = client.stats()
    assert st["exported"] == 0
    assert st["degraded"] or st["breaker_trips"] >= 1
    assert elapsed < 120
    client.close()


def test_midstream_exception_still_flushes_and_exports_tail():
    """A run killed mid-stream flushes the partial record buffer: no
    launched epoch's record is lost, in-process or on the wire."""
    class Boom(RuntimeError):
        pass

    def dying_stream(epochs, die_after):
        for i, e in enumerate(epochs):
            if i == die_after:
                raise Boom()
            yield e

    rng = np.random.default_rng(0)
    eps = [rng.integers(0, 400, (3, 2000)).astype(np.int32)
           for _ in range(10)]
    sink = MemorySink()
    client = ExportClient(sink, flush_interval_s=0.005)
    rt = EpochRuntime(400, 40, policies=("hmu_oracle", "hinted"),
                      pebs_period=101, nb_scan_rate=90, sync_every=4,
                      export=client, device="cpu")
    with pytest.raises(Boom):
        rt.run(dying_stream(eps, die_after=6))
    assert all(len(recs) == 6 for recs in rt.records.values())
    client.flush(timeout=30)
    recs = sink.snapshot()
    assert len(recs) == 6 * 2
    assert sorted({r["epoch"] for r in recs}) == list(range(6))
    client.close()


def test_tracemalloc_budget():
    """The export path's peak host allocation is O(queue_size), not
    O(records): 20,000 records through a 1,024-deep queue stay under 8
    MiB."""
    rec = sample_epoch_record()
    client = ExportClient(DiscardSink(), queue_size=1024,
                          flush_interval_s=0.002)
    tracemalloc.start()
    try:
        for i in range(20_000):
            r = dict(rec)
            r["epoch"] = i
            client.emit(r)
        client.flush(timeout=60)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    st = client.stats()
    assert st["emitted"] + st["dropped_queue_full"] == 20_000
    assert peak < 8 * 1024 * 1024, f"export path peaked at {peak} bytes"
    client.close()


def test_telemetry_export_example_checks_pass(tmp_path):
    res = telemetry_export.run("cpu", out_dir=tmp_path)
    assert all(telemetry_export.checks(res).values())
    assert res["stats"]["exported"] == len(res["lines"]) > 0
    for line in res["lines"]:
        validate_record(json.loads(line))
    assert res["dead_stats"]["degraded"]
    assert 'repro_dispatch_total{kind="observe_all"}' in res["prometheus"]
