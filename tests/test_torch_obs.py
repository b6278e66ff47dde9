"""repro_torch.obs — the port's metrics registry, span tracer and Chrome
trace writer, against the reference's ``repro.obs``.

Two halves:

* **Units** — the port's counterparts of ``tests/test_obs.py``: registry
  families and their kind/bucket checks, the ``CounterDict`` bridge behind
  ``DISPATCH_COUNTS`` (nested ``counting()`` scopes included), the tracer
  over an injected clock (exact durations, nesting depth, ``max_spans``
  drops, the disabled tracer allocating nothing under ``tracemalloc``),
  ``profiler_annotations`` ranges in ``torch.profiler``, ``elapsed_s``,
  and the Chrome trace's events, device track and ``pipelining_visible``.
* **Parity with repro** — the same SMALL DLRM run (hints on, 8,000 lookups
  a batch, 6 epochs, ``sync_every`` 1 and 4) through both packages under
  tracing: the span sequence (name, epoch, args, depth, thread), the
  Chrome events under a clock that counts its reads (so every timestamp
  is the ordinal of a clock read), and the ``repro_dispatch_total`` deltas
  kind by kind.  The surfaces' ``__all__`` lists equal the reference's.

Tolerance: exact everywhere (spans, events and counts compare with
``==``; the counting clock makes timestamps integers)."""
import dataclasses
import json
import tracemalloc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402
_torch_threads.limit()

import repro.export as jexport  # noqa: E402
import repro.obs as jobs  # noqa: E402
from repro.dlrm import datagen as jdata  # noqa: E402
from repro.obs import chrometrace as jchrome  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro.scenarios import DLRMScenario as JDLRM  # noqa: E402
from repro.scenarios import run_scenario as jrun_scenario  # noqa: E402
import repro_torch.export as texport  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro_torch.core import runtime as rtmod  # noqa: E402
from repro_torch.core.runtime import EpochRuntime  # noqa: E402
from repro_torch.dlrm import datagen as tdata  # noqa: E402
from repro_torch.examples import runtime_timeline  # noqa: E402
from repro_torch.obs import chrometrace  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.obs.metrics import CounterDict, MetricsRegistry  # noqa: E402
from repro_torch.obs.trace import (NOOP_SPAN, NULL_TRACER, Clock, Span,  # noqa: E402
                                   SpanTracer, tracing)
from repro_torch.scenarios import DLRMScenario, run_scenario  # noqa: E402

J_SPEC = dataclasses.replace(jdata.SMALL, lookups_per_batch=8_000)
T_SPEC = dataclasses.replace(tdata.SMALL, lookups_per_batch=8_000)
N_EPOCHS, SHIFT = 6, 3


class FakeClock(Clock):
    """Deterministic clock: each read returns the next scripted instant."""

    def __init__(self, start=0.0, step=1.0):
        self.t = start
        self.step = step
        super().__init__(self._tick)

    def _tick(self):
        t, self.t = self.t, self.t + self.step
        return t


def counting_clock(clock_cls):
    """A clock of ``clock_cls`` whose n-th read returns float(n)."""
    reads = [0]

    def now():
        reads[0] += 1
        return float(reads[0])
    return clock_cls(now)


# ---------------------------------------------------------------- registry
def test_counter_gauge_histogram_basics():
    reg = MetricsRegistry()
    c = reg.counter("repro_x_total", help="h").labels(kind="a")
    c.inc()
    c.inc(3)
    assert c.value == 4
    g = reg.gauge("repro_g").labels()
    g.set(2.5)
    assert g.value == 2.5
    h = reg.histogram("repro_d_s", buckets=(0.1, 1.0)).labels(span="s")
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    assert h.bucket_counts == [1, 1, 1]     # <=0.1, <=1.0, overflow
    assert h.count == 3 and h.sum == pytest.approx(5.55)


def test_default_histogram_buckets_equal_the_reference():
    assert obs_metrics.DEFAULT_LATENCY_BUCKETS_S == \
        jmetrics.DEFAULT_LATENCY_BUCKETS_S
    h = MetricsRegistry().histogram("repro_d_s").labels()
    jh = jmetrics.MetricsRegistry().histogram("repro_d_s").labels()
    for v in (0.0, 1e-5, 3e-5, 0.5, 2.62144, 100.0):
        h.observe(v)
        jh.observe(v)
    assert h.bucket_counts == jh.bucket_counts and h.sum == jh.sum


def test_get_or_create_is_idempotent_but_kind_checked():
    reg = MetricsRegistry()
    fam = reg.counter("repro_x_total")
    assert reg.counter("repro_x_total") is fam
    with pytest.raises(ValueError, match="already registered as counter"):
        reg.gauge("repro_x_total")


def test_bad_buckets_rejected():
    reg = MetricsRegistry()
    with pytest.raises(ValueError, match="strictly increasing"):
        reg.histogram("repro_bad_s", buckets=(1.0, 1.0, 2.0))
    with pytest.raises(ValueError, match="strictly increasing"):
        reg.histogram("repro_bad2_s", buckets=(2.0, 1.0))
    with pytest.raises(ValueError, match="only apply to histograms"):
        obs_metrics.MetricFamily("repro_c_total", "counter", buckets=(1.0,))
    with pytest.raises(ValueError, match="unknown metric kind"):
        obs_metrics.MetricFamily("repro_t", "timer")


def test_counter_rejects_negative_increment():
    c = MetricsRegistry().counter("repro_x_total").labels(kind="a")
    with pytest.raises(ValueError, match=">= 0"):
        c.inc(-1)


def test_label_children_are_distinct_and_cached():
    fam = MetricsRegistry().counter("repro_x_total")
    a, b = fam.labels(kind="a"), fam.labels(kind="b")
    assert a is not b and fam.labels(kind="a") is a
    a.inc()
    assert (a.value, b.value) == (1, 0)
    assert len(fam.children()) == 2


def test_counterdict_dict_api():
    fam = MetricsRegistry().counter("repro_x_total")
    view = CounterDict(fam, "kind", keys=("a", "b"))
    view["a"] += 2
    view["c"] = 7                        # new keys appear on assignment
    assert view["a"] == 2 and view["b"] == 0 and view["c"] == 7
    assert dict(view.items()) == {"a": 2, "b": 0, "c": 7}
    assert dict(view) == {"a": 2, "b": 0, "c": 7}
    assert view == {"a": 2, "b": 0, "c": 7}
    assert "a" in view and "z" not in view and len(view) == 3
    assert view.get("z", -1) == -1
    with pytest.raises(KeyError):
        view["z"]
    assert fam.labels(kind="a").value == 2
    with pytest.raises(ValueError, match="counter family"):
        CounterDict(MetricsRegistry().gauge("repro_g"), "kind")


def test_runtime_counts_are_a_registry_view_with_the_reference_keys():
    from repro.core import runtime as jrt
    assert isinstance(rtmod.DISPATCH_COUNTS, CounterDict)
    assert rtmod.DISPATCH_COUNTS.keys() == jrt.DISPATCH_COUNTS.keys()
    assert not hasattr(rtmod, "TRACE_COUNTS")
    fams = {f.name for f in obs_metrics.REGISTRY.families()}
    assert "repro_dispatch_total" in fams


def test_counting_nests_over_registry_views():
    with rtmod.counting() as outer:
        rtmod.DISPATCH_COUNTS["observe_all"] += 1
        with rtmod.counting() as inner:
            rtmod.DISPATCH_COUNTS["observe_all"] += 2
            assert inner.dispatch["observe_all"] == 2
            assert outer.dispatch["observe_all"] == 3
        assert outer.dispatch["observe_all"] == 3
        assert dict(inner.dispatch)["observe_all"] == 2
        with pytest.raises(KeyError):
            outer.dispatch["observe"]


def test_registry_publishes_what_the_reference_publishes():
    """The same families, filled the same way, render the same Prometheus
    text through both packages' sinks."""
    texts = []
    for metrics, export in ((obs_metrics, texport), (jmetrics, jexport)):
        reg = metrics.MetricsRegistry()
        reg.counter("repro_x_total", help="things").labels(kind="a").inc(4)
        reg.gauge("repro_depth").labels(lane="l").set(3)
        reg.histogram("repro_d_s", help="dur",
                      buckets=(0.1, 1.0)).labels(span="s").observe(0.5)
        sink = export.PrometheusTextSink()
        reg.publish(sink)
        texts.append(sink.render())
    assert texts[0] == texts[1]
    assert 'repro_d_s_bucket{span="s",le="+Inf"} 1' in texts[0]


# ------------------------------------------------------------------ tracer
def test_noop_span_is_a_singleton():
    assert NULL_TRACER.span("observe_all", epoch=3) is NOOP_SPAN
    assert NULL_TRACER.span("epoch_step") is NOOP_SPAN
    assert not NULL_TRACER.enabled and NULL_TRACER.spans == ()
    assert obs_trace.get_tracer() is NULL_TRACER


def test_disabled_hot_loop_allocates_nothing():
    tr = obs_trace.get_tracer()
    assert not tr.enabled

    def loop(tracer, iters):
        for step in range(iters):
            cm = (tracer.span("observe_all", epoch=step)
                  if tracer.enabled else NOOP_SPAN)
            with cm:
                pass

    loop(tr, 256)                        # warm interning
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        loop(tr, 4096)
        grown = tracemalloc.get_traced_memory()[0] - base
    finally:
        tracemalloc.stop()
    assert grown == 0


def test_fake_clock_gives_exact_durations():
    tr = SpanTracer(clock=FakeClock(start=10.0, step=1.0))
    with tr.span("observe_all", epoch=2):
        pass
    (s,) = tr.spans
    assert (s.name, s.epoch) == ("observe_all", 2)
    assert s.t0_s == 10.0 and s.dur_s == 1.0 and s.depth == 0


def test_nesting_depth_and_args():
    tr = SpanTracer(clock=FakeClock())
    with tr.span("outer"):
        with tr.span("inner", epoch=1, arrays="a,b"):
            pass
    inner, outer = tr.spans            # inner closes first
    assert (inner.name, inner.depth, outer.depth) == ("inner", 1, 0)
    assert inner.args == {"arrays": "a,b"} and inner.epoch == 1
    assert outer.args is None


def test_max_spans_drops_are_counted():
    tr = SpanTracer(clock=FakeClock(), max_spans=2)
    for _ in range(5):
        with tr.span("x"):
            pass
    assert len(tr.spans) == 2 and tr.dropped_spans == 3
    tr.clear()
    assert tr.spans == [] and tr.dropped_spans == 0


def test_tracing_scope_installs_and_restores():
    before = obs_trace.get_tracer()
    with tracing(clock=FakeClock()) as tr:
        assert obs_trace.get_tracer() is tr and tr.enabled
        with tr.span("x"):
            pass
    assert obs_trace.get_tracer() is before
    assert [s.name for s in tr.spans] == ["x"]
    tr = obs_trace.enable(clock=FakeClock())
    try:
        assert obs_trace.get_tracer() is tr
    finally:
        assert obs_trace.disable() is tr
    assert obs_trace.get_tracer() is NULL_TRACER


def test_metrics_mirror_records_span_durations():
    reg = MetricsRegistry()
    tr = SpanTracer(clock=FakeClock(), metrics=reg)
    with tr.span("observe_all"):
        pass
    (fam,) = [f for f in reg.families() if f.name == "repro_span_duration_s"]
    (child,) = fam.children()
    assert dict(child.labels) == {"span": "observe_all"}
    assert child.count == 1 and child.sum == pytest.approx(1.0)


def test_elapsed_s_uses_injected_clock_and_passes_cpu_tensors():
    assert obs_trace.elapsed_s(2.0, clock=FakeClock(start=5.0)) == 3.0
    t = torch.ones(4)
    assert obs_trace.elapsed_s(2.0, t, 7, clock=FakeClock(start=5.0)) == 3.0


def test_profiler_annotations_name_the_launches_they_wrap():
    """With ``profiler_annotations`` each span is a ``record_function``
    range in ``torch.profiler``, around the operations it wraps; without it
    the profile holds no such range."""
    x = torch.arange(64, dtype=torch.float32)
    for on in (True, False):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with tracing(clock=FakeClock(), profiler_annotations=on) as tr:
                with tr.span("epoch_step", epoch=0):
                    torch.cumsum(x, 0)
        names = {e.key for e in prof.key_averages()}
        assert ("epoch_step" in names) == on
        assert [s.name for s in tr.spans] == ["epoch_step"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs_trace.named_scope("observe_all"):
            torch.cumsum(x, 0)
    assert "observe_all" in {e.key for e in prof.key_averages()}


# ---------------------------------------------------------------- timeline
def span(name, t0, dur, *, tid="host", epoch=None, args=None, depth=0):
    return Span(name=name, t0_s=t0, dur_s=dur, tid=tid, depth=depth,
                epoch=epoch, args=args)


def pipelined_spans(cls=Span):
    """sync_every=2 shape: epoch 2's observe_all dispatches before the
    record_sync draining epochs [0, 2) begins."""
    rows = [("observe_all", 0.0, 0.1, 0, None),
            ("epoch_step", 0.1, 0.1, 0, None),
            ("observe_all", 1.0, 0.1, 1, None),
            ("epoch_step", 1.1, 0.1, 1, None),
            ("observe_all", 2.0, 0.1, 2, None),
            ("record_sync", 2.2, 0.5, None, {"epoch_base": 0, "n_epochs": 2}),
            ("epoch_step", 2.8, 0.1, 2, None)]
    return [cls(name=n, t0_s=t0, dur_s=d, tid="host", depth=0, epoch=e,
                args=a) for n, t0, d, e, a in rows]


def test_event_shape_and_normalisation():
    (e,) = chrometrace.chrome_trace_events(
        [span("observe_all", 3.0, 0.25, epoch=7, args={"arrays": "x"})])
    assert e["ph"] == "X" and e["cat"] == "runtime"
    assert e["ts"] == 0.0 and e["dur"] == pytest.approx(0.25e6)
    assert e["pid"] == 1 and e["tid"] == "host"
    assert e["args"] == {"epoch": 7, "arrays": "x"}


def test_pipelining_visible_for_k_gt_1_only():
    assert chrometrace.pipelining_visible(pipelined_spans())
    serial = [
        span("observe_all", 0.0, 0.1, epoch=0),
        span("record_sync", 0.2, 0.1, args={"epoch_base": 0, "n_epochs": 1}),
        span("observe_all", 1.0, 0.1, epoch=1),
        span("record_sync", 1.2, 0.1, args={"epoch_base": 1, "n_epochs": 1}),
    ]
    assert not chrometrace.pipelining_visible(serial)


def test_device_track_covers_sync_window():
    (e,) = chrometrace.device_track_events(pipelined_spans())
    assert e["tid"] == "device" and e["name"] == "device epochs [0,2)"
    assert e["ts"] == 0.0 and e["dur"] == pytest.approx(2.7e6)


def test_write_chrome_trace_equals_the_reference(tmp_path):
    doc = chrometrace.write_chrome_trace(
        tmp_path / "t.json", pipelined_spans(), metadata={"bench": "test"})
    want = jchrome.write_chrome_trace(
        tmp_path / "j.json", pipelined_spans(jtrace.Span),
        metadata={"bench": "test"})
    assert json.loads((tmp_path / "t.json").read_text()) == doc == want
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    assert {e["tid"] for e in doc["traceEvents"]} == {"host", "device"}


def test_public_surfaces_equal_the_reference():
    assert tobs.__all__ == jobs.__all__
    assert texport.__all__ == jexport.__all__
    for mod, ref in ((obs_metrics, jmetrics), (obs_trace, jtrace),
                     (chrometrace, jchrome)):
        assert mod.__all__ == ref.__all__, mod.__name__


# ------------------------------------------------- parity on a whole run
def _scenarios():
    return (JDLRM(spec=J_SPEC, n_epochs=N_EPOCHS, shift_at=SHIFT),
            DLRMScenario(spec=T_SPEC, n_epochs=N_EPOCHS, shift_at=SHIFT))


def _dispatch_totals(registry):
    (fam,) = [f for f in registry.families()
              if f.name == "repro_dispatch_total"]
    return {dict(c.labels)["kind"]: c.value for c in fam.children()}


@pytest.fixture(scope="module", params=[1, 4], ids=["K1", "K4"])
def traced_pair(request):
    """One SMALL DLRM run through each package (hints on) under tracing on
    a counting clock: (port, reference) x (trajectory JSON, spans,
    repro_dispatch_total deltas)."""
    k = request.param
    js, ts = _scenarios()
    out = []
    for run, trace, metrics, kw, sc in (
            (run_scenario, obs_trace, obs_metrics, dict(device="cpu"), ts),
            (jrun_scenario, jtrace, jmetrics, {}, js)):
        before = _dispatch_totals(metrics.REGISTRY)
        with trace.tracing(clock=counting_clock(trace.Clock)) as tr:
            res = run(sc, hints=True, sync_every=k, **kw)
        after = _dispatch_totals(metrics.REGISTRY)
        out.append((json.dumps(res), tr.spans,
                    {kind: after[kind] - before.get(kind, 0)
                     for kind in after}))
    return k, out[0], out[1]


def _span_key(s):
    return (s.name, s.epoch, s.args, s.depth, s.tid)


def test_span_sequence_equals_the_reference(traced_pair):
    k, (tj, tspans, _), (jj, jspans, _) = traced_pair
    assert [_span_key(s) for s in tspans] == [_span_key(s) for s in jspans]
    names = [s.name for s in tspans]
    assert names.count("observe_all") == names.count("epoch_step") == \
        N_EPOCHS
    assert names.count("record_sync") == -(-N_EPOCHS // k)
    assert names.count("hint_refresh") > 0
    assert chrometrace.pipelining_visible(tspans) == (k > 1)


def test_chrome_events_on_a_counting_clock_equal_the_reference(traced_pair):
    _, (_, tspans, _), (_, jspans, _) = traced_pair
    assert chrometrace.chrome_trace_events(tspans) == \
        jchrome.chrome_trace_events(jspans)
    assert chrometrace.device_track_events(tspans) == \
        jchrome.device_track_events(jspans)


def test_dispatch_deltas_equal_the_reference(traced_pair):
    k, (_, _, tdelta), (_, _, jdelta) = traced_pair
    assert tdelta == jdelta
    assert tdelta["observe_all"] == tdelta["epoch_step"] == N_EPOCHS
    assert tdelta["record_sync"] == -(-N_EPOCHS // k)
    assert tdelta["reference"] == 0


def test_traced_trajectory_equals_the_reference_and_the_untraced(
        traced_pair):
    k, (tj, _, _), (jj, _, _) = traced_pair
    assert tj == jj
    untraced = run_scenario(_scenarios()[1], hints=True, sync_every=k,
                            device="cpu")
    assert json.dumps(untraced) == tj


def test_runtime_records_spans_without_a_scenario():
    """A bare EpochRuntime under tracing: one observe_all and epoch_step an
    epoch, record_sync args naming the drained window, durations read off
    the injected clock."""
    rng = np.random.default_rng(7)
    eps = [(rng.zipf(1.2, size=(2, 512)) % 512).astype(np.int32)
           for _ in range(4)]
    rt = EpochRuntime(512, 64, policies=("hmu_oracle", "nb_two_touch"),
                      pebs_period=8, nb_scan_rate=128, sync_every=2,
                      device="cpu")
    with tracing(clock=FakeClock()) as tr:
        rt.run(iter(eps))
    syncs = [s for s in tr.spans if s.name == "record_sync"]
    assert [s.args for s in syncs] == [{"epoch_base": 0, "n_epochs": 2},
                                       {"epoch_base": 2, "n_epochs": 2}]
    assert all(s.dur_s == 1.0 for s in tr.spans)
    assert tr.dropped_spans == 0


def test_runtime_timeline_example_checks_pass(tmp_path):
    res = runtime_timeline.run("cpu", trace_dir=tmp_path)
    assert all(runtime_timeline.checks(res).values())
    assert res["spans"]["observe_all"] == runtime_timeline.N_EPOCHS
    assert res["spans"]["record_sync"] == 2
    assert res["trace_path"].exists()
    assert any(e["tid"] == "device" for e in res["trace"]["traceEvents"])
