"""Host-side span tracer — nestable begin/end spans over an injectable clock
(PyTorch port of ``repro/obs/trace.py``).

The runtime's hot loop is 2 dispatches per epoch; the tracer must never
change that.  Two tracers implement the same surface:

* :class:`SpanTracer` (``enabled = True``) records a :class:`Span` per
  ``with tracer.span(name, ...):`` block — wall-clock from an injectable
  monotonic clock, thread name (the chrome-trace track), nesting depth, and
  optional args such as the epoch index.  When
  ``profiler_annotations=True`` each span also enters
  ``torch.profiler.record_function(name)``, so the span names appear in
  ``torch.profiler`` traces around the kernels they launch (and, under
  ``torch.autograd.profiler.emit_nvtx``, as NVTX ranges).
* :class:`NullTracer` (``enabled = False``, module default) returns one
  shared no-op context manager from every ``span()`` call — zero
  allocations per epoch, no clock reads, nothing retained.

Hot-path call sites keep the disabled cost at a single attribute check by
guarding the kwargs build::

    _tr = obs_trace.get_tracer()
    cm = _tr.span("observe_all", epoch=e) if _tr.enabled else obs_trace.NOOP_SPAN
    with cm:
        ...dispatch...

The module also owns the port's one audited timing path (`now_s` /
`elapsed_s` on the injectable :class:`Clock`): span durations and timings
read the same clock.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "Span", "SpanTracer", "NullTracer", "NOOP_SPAN", "NULL_TRACER",
    "get_tracer", "set_tracer", "enable", "disable", "tracing",
    "Clock", "CLOCK", "now_s", "elapsed_s", "named_scope",
]


# ---------------------------------------------------------------------------
# injectable clock (satellite: bench + spans share one audited code path)
# ---------------------------------------------------------------------------
class Clock:
    """Monotonic clock in seconds; ``now`` is injectable for tests."""

    __slots__ = ("now_s",)

    def __init__(self, now: Callable[[], float] = time.perf_counter) -> None:
        self.now_s = now


#: Process-default clock.  Tests swap ``CLOCK.now_s`` (or build their own
#: Clock and pass it to SpanTracer / elapsed_s) to make time deterministic.
CLOCK = Clock()


def now_s() -> float:
    """Current monotonic time in seconds from the default clock."""
    return CLOCK.now_s()


def elapsed_s(t0: float, *sync, clock: Optional[Clock] = None) -> float:
    """Seconds since ``t0``, after waiting for any CUDA tensors in ``sync``.

    This is the audited timer: for each CUDA tensor in ``sync`` a
    ``torch.cuda.Event`` is recorded on its device's current stream and
    synchronized, so asynchronous launches cannot make work look free
    (CPU tensors and other values are already done); then one clock read.
    """
    for value in sync:
        if getattr(value, "is_cuda", False):
            import torch
            with torch.cuda.device(value.device):
                ev = torch.cuda.Event()
                ev.record()
            ev.synchronize()
    return (clock or CLOCK).now_s() - t0


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------
@dataclass
class Span:
    """One closed begin/end interval on a host thread."""

    name: str
    t0_s: float                       # clock reading at __enter__
    dur_s: float                      # t1 - t0
    tid: str = "host"                 # thread name -> chrome-trace track
    depth: int = 0                    # nesting depth at __enter__
    epoch: Optional[int] = None       # epoch attribution, when known
    args: Optional[Dict[str, object]] = field(default=None)


class _NoopSpan:
    """Shared do-nothing context manager — the disabled-mode span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


#: The singleton no-op span.  Identity-stable: every disabled ``span()``
#: call returns exactly this object, so the hot loop allocates nothing.
NOOP_SPAN = _NoopSpan()


class NullTracer:
    """Disabled tracer: ``span()`` always returns :data:`NOOP_SPAN`."""

    enabled = False
    spans: Tuple[Span, ...] = ()

    def span(self, name, **kw):
        return NOOP_SPAN

    def clear(self) -> None:
        pass


#: Shared disabled tracer (also the module default current tracer).
NULL_TRACER = NullTracer()


class _SpanCtx:
    """Context manager recording one Span into its tracer."""

    __slots__ = ("_tracer", "_name", "_epoch", "_args", "_t0", "_ann")

    def __init__(self, tracer: "SpanTracer", name: str,
                 epoch: Optional[int], args: Optional[dict]) -> None:
        self._tracer = tracer
        self._name = name
        self._epoch = epoch
        self._args = args
        self._t0 = 0.0
        self._ann = None

    def __enter__(self):
        tr = self._tracer
        if tr.profiler_annotations:
            import torch
            self._ann = torch.profiler.record_function(self._name)
            self._ann.__enter__()
        tr._local.depth = getattr(tr._local, "depth", 0) + 1
        self._t0 = tr.clock.now_s()
        return self

    def __exit__(self, *exc):
        tr = self._tracer
        t1 = tr.clock.now_s()
        depth = getattr(tr._local, "depth", 1)
        tr._local.depth = depth - 1
        if self._ann is not None:
            self._ann.__exit__(*exc)
        tr._record(Span(
            name=self._name, t0_s=self._t0, dur_s=t1 - self._t0,
            tid=threading.current_thread().name, depth=depth - 1,
            epoch=self._epoch, args=self._args))
        return False


class SpanTracer:
    """Enabled tracer: records spans; optionally mirrors them into a
    metrics registry as ``repro_span_duration_s{span=...}`` histograms and
    into ``torch.profiler`` traces via ``record_function``."""

    enabled = True

    def __init__(self, clock: Optional[Clock] = None,
                 metrics=None,                      # MetricsRegistry | None
                 profiler_annotations: bool = False,
                 max_spans: int = 1_000_000) -> None:
        self.clock = clock or CLOCK
        self.profiler_annotations = profiler_annotations
        self.max_spans = max_spans
        self.dropped_spans = 0
        self.spans: List[Span] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._hist = None
        if metrics is not None:
            self._hist = metrics.histogram(
                "repro_span_duration_s",
                help="Host wall-clock per runtime span", unit="s")

    def span(self, name: str, *, epoch: Optional[int] = None,
             **args) -> _SpanCtx:
        return _SpanCtx(self, name, epoch, args or None)

    def _record(self, span: Span) -> None:
        with self._lock:
            if len(self.spans) >= self.max_spans:
                self.dropped_spans += 1
                return
            self.spans.append(span)
        if self._hist is not None:
            self._hist.labels(span=span.name).observe(span.dur_s)

    def clear(self) -> None:
        with self._lock:
            self.spans = []
            self.dropped_spans = 0


def named_scope(name: str):
    """A ``torch.profiler.record_function`` range named ``name``: eager
    PyTorch has no traced function to scope, so this names the launches
    made inside it in ``torch.profiler`` traces, without touching
    numerics."""
    import torch
    return torch.profiler.record_function(name)


# ---------------------------------------------------------------------------
# current-tracer plumbing
# ---------------------------------------------------------------------------
_CURRENT: List[object] = [NULL_TRACER]


def get_tracer():
    """The tracer hot-path call sites consult (NullTracer when disabled)."""
    return _CURRENT[0]


def set_tracer(tracer):
    """Install ``tracer`` as current; returns the previous one."""
    prev = _CURRENT[0]
    _CURRENT[0] = tracer
    return prev


def enable(clock: Optional[Clock] = None, metrics=None,
           profiler_annotations: bool = False,
           max_spans: int = 1_000_000) -> SpanTracer:
    """Install and return a fresh :class:`SpanTracer`."""
    tracer = SpanTracer(clock=clock, metrics=metrics,
                        profiler_annotations=profiler_annotations,
                        max_spans=max_spans)
    set_tracer(tracer)
    return tracer


def disable():
    """Restore the shared :class:`NullTracer`; returns the previous tracer
    (whose recorded spans stay readable)."""
    return set_tracer(NULL_TRACER)


@contextmanager
def tracing(clock: Optional[Clock] = None, metrics=None,
            profiler_annotations: bool = False,
            max_spans: int = 1_000_000):
    """``with tracing() as tracer:`` — scoped enable/restore."""
    prev = get_tracer()
    tracer = enable(clock=clock, metrics=metrics,
                    profiler_annotations=profiler_annotations,
                    max_spans=max_spans)
    try:
        yield tracer
    finally:
        set_tracer(prev)
