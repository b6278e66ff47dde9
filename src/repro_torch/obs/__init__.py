"""repro_torch.obs — runtime self-observability (PyTorch port of
``repro.obs``).

Three pieces, one contract (non-interference with the 2-dispatch epoch
loop):

* :mod:`repro_torch.obs.metrics` — labeled metrics registry (counters,
  gauges, bounded-bucket histograms).  ``core.runtime``'s
  ``DISPATCH_COUNTS`` is a :class:`~repro_torch.obs.metrics.CounterDict`
  view over it, keeping the dict API and ``counting()`` semantics.
* :mod:`repro_torch.obs.trace` — host-side span tracer with an injectable
  monotonic clock and a zero-allocation disabled mode, optionally mirrored
  into ``torch.profiler`` ranges; also the audited ``now_s`` /
  ``elapsed_s`` timing helpers.
* :mod:`repro_torch.obs.chrometrace` — Chrome trace-event JSON writer +
  ``pipelining_visible``, turning the pipelined record pull into a
  timeline artifact.

Span names: ``hint_refresh``, ``observe_all``, ``epoch_step`` and
``record_sync`` from the runtime, ``export.enqueue``,
``export.write_batch`` and ``export.flush`` from the export client.
"""
from __future__ import annotations

from .metrics import (                                      # noqa: F401
    Counter, CounterDict, Gauge, Histogram, MetricFamily, MetricsRegistry,
    REGISTRY, DEFAULT_LATENCY_BUCKETS_S,
)
from .trace import (                                        # noqa: F401
    Clock, CLOCK, NOOP_SPAN, NULL_TRACER, NullTracer, Span, SpanTracer,
    disable, elapsed_s, enable, get_tracer, named_scope, now_s, set_tracer,
    tracing,
)
from .chrometrace import (                                  # noqa: F401
    chrome_trace_events, device_track_events, pipelining_visible,
    write_chrome_trace,
)

__all__ = [
    "Counter", "CounterDict", "Gauge", "Histogram", "MetricFamily",
    "MetricsRegistry", "REGISTRY", "DEFAULT_LATENCY_BUCKETS_S",
    "Clock", "CLOCK", "NOOP_SPAN", "NULL_TRACER", "NullTracer", "Span",
    "SpanTracer", "disable", "elapsed_s", "enable", "get_tracer",
    "named_scope", "now_s", "set_tracer", "tracing",
    "chrome_trace_events", "device_track_events", "pipelining_visible",
    "write_chrome_trace",
]
