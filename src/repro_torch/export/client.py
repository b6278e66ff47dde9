"""Non-blocking telemetry export client (PyTorch port of
``repro/export/client.py``).

The one invariant everything here serves: **export must never cost the
observed runtime anything**.  The epoch loop's side of the client is a
single ``queue.put_nowait`` on records it already materialised for its own
bookkeeping — no added dispatch, no blocking, no exception escapes.  All
real work (schema validation, batching, sink I/O) happens on a daemon
flusher thread, and every way that work can go wrong is absorbed:

* queue full -> the record is dropped and counted (``dropped_queue_full``);
  the producer never waits.
* record invalid against the frozen schema -> dropped and counted
  (``dropped_invalid``); validation runs in the flusher, off the hot path.
* sink raises -> the :class:`CircuitBreaker` counts consecutive failures
  and trips open; while open, records are dropped at ``emit`` time
  (``dropped_breaker_open``) without touching the queue.  After a cooldown
  the breaker goes half-open and lets one probe batch through: success
  closes it, failure re-opens it.  ``degrade_after_trips`` consecutive
  trips with no intervening success declares the sink dead and the client
  permanently degrades to noop behaviour (:class:`NoopClient` semantics) —
  the run finishes at full speed with export silently off.

``stats()`` surfaces every counter so nothing is dropped silently, and
``close()`` (idempotent, also registered via ``atexit``) drains the queue
and joins the flusher so short-lived processes don't lose the tail.
"""
from __future__ import annotations

import atexit
import queue
import threading
import time
from typing import Dict, List, Optional

from ..obs import trace as obs_trace
from .schema import (SchemaError, epoch_record_wire, lane_summary_wire,
                     runtime_metric_wire, runtime_span_wire,
                     tenant_lane_summary_wire, tenant_record_wire,
                     validate_record)

__all__ = ["CircuitBreaker", "ExportClient", "NoopClient"]

_SENTINEL = object()


class CircuitBreaker:
    """Consecutive-failure circuit breaker (closed -> open -> half-open).

    Closed: everything flows.  ``failure_threshold`` consecutive sink
    failures trip it open; while open, ``allow()`` is False until
    ``cooldown_s`` has elapsed, at which point the breaker goes half-open
    and ``allow()`` admits a probe.  ``record_success()`` closes it again;
    ``record_failure()`` in half-open re-opens immediately.  ``clock`` is
    injectable so tests drive the cooldown without sleeping.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 0.25,
                 clock=time.monotonic) -> None:
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self.trips = 0                 # total times tripped open
        self.consecutive_trips = 0     # trips since the last success

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        if (self._state == self.OPEN
                and self._clock() - self._opened_at >= self.cooldown_s):
            self._state = self.HALF_OPEN

    def allow(self) -> bool:
        """May a write proceed right now?  (Open + cooldown elapsed counts
        as yes — that IS the half-open probe.)"""
        with self._lock:
            self._maybe_half_open()
            return self._state != self.OPEN

    def record_success(self) -> None:
        with self._lock:
            self._state = self.CLOSED
            self._failures = 0
            self.consecutive_trips = 0

    def record_failure(self) -> None:
        with self._lock:
            self._maybe_half_open()
            self._failures += 1
            if (self._state == self.HALF_OPEN
                    or self._failures >= self.failure_threshold):
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._failures = 0
                self.trips += 1
                self.consecutive_trips += 1


class NoopClient:
    """The do-nothing client: same surface as :class:`ExportClient`, zero
    state, zero threads.  Also the behaviour a degraded ExportClient
    converges to once its breaker declares the sink dead."""

    degraded = False

    def emit(self, record: dict) -> bool:
        return False

    def export_epoch_record(self, rec) -> bool:
        return False

    def export_tenant_record(self, rec) -> bool:
        return False

    def export_lane_summary(self, lane: str, summary: dict) -> bool:
        return False

    def export_tenant_lane_summary(self, tenant: str, lane: str,
                                   summary: dict) -> bool:
        return False

    def export_runtime_span(self, span) -> bool:
        return False

    def export_runtime_metric(self, metric: str, kind: str, value=None,
                              **kw) -> bool:
        return False

    def export_metrics(self, registry) -> int:
        return 0

    def bind(self, **labels: str) -> "NoopClient":
        return self

    def flush(self, timeout: Optional[float] = None) -> None:
        pass

    def close(self, timeout: Optional[float] = None) -> None:
        pass

    def stats(self) -> Dict[str, object]:
        return {"emitted": 0, "exported": 0, "dropped_queue_full": 0,
                "dropped_invalid": 0, "dropped_breaker_open": 0,
                "dropped_sink_failure": 0, "dropped_degraded": 0,
                "sink_failures": 0, "breaker_state": "closed",
                "breaker_trips": 0, "degraded": False}


class ExportClient:
    """Bounded-queue, background-flushed, breaker-guarded export client.

    Parameters
    ----------
    sink : object with ``write(List[dict])`` (see
        ``repro_torch.export.sinks``)
    queue_size : producer-side bound; overflow drops (never blocks)
    batch_size : max records per ``sink.write`` call
    flush_interval_s : flusher wakeup period when the queue is idle
    validate : check every record against the frozen schema in the
        flusher thread (invalid records are dropped + counted, not raised)
    breaker : injectable :class:`CircuitBreaker` (tests pass a fake clock)
    degrade_after_trips : consecutive breaker trips with no successful
        write before the client permanently degrades to noop
    scenario : default scenario label stamped on every wire record
    """

    def __init__(self, sink, *, queue_size: int = 2048, batch_size: int = 256,
                 flush_interval_s: float = 0.05, validate: bool = True,
                 breaker: Optional[CircuitBreaker] = None,
                 degrade_after_trips: int = 3,
                 scenario: Optional[str] = None) -> None:
        self.sink = sink
        self.batch_size = int(batch_size)
        self.validate = bool(validate)
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self.degrade_after_trips = int(degrade_after_trips)
        self.scenario = scenario
        self._queue: "queue.Queue" = queue.Queue(maxsize=int(queue_size))
        self._flush_interval_s = float(flush_interval_s)
        self._lock = threading.Lock()          # guards the counters below
        self._emitted = 0
        self._exported = 0
        self._dropped_queue_full = 0
        self._dropped_invalid = 0
        self._dropped_breaker_open = 0
        self._dropped_sink_failure = 0
        self._dropped_degraded = 0
        self._sink_failures = 0
        self._degraded = False
        self._closed = False
        self._idle = threading.Event()         # queue drained & written
        self._idle.set()
        self._thread = threading.Thread(target=self._flusher_loop,
                                        name="repro-export-flusher",
                                        daemon=True)
        self._thread.start()
        self._atexit = atexit.register(self.close)

    # ------------------------------------------------------------ producers
    @property
    def degraded(self) -> bool:
        return self._degraded

    def emit(self, record: dict) -> bool:
        """Enqueue one wire record.  Never blocks, never raises; returns
        whether the record was accepted."""
        _tr = obs_trace.get_tracer()
        if not _tr.enabled:
            return self._emit(record)
        with _tr.span("export.enqueue"):
            return self._emit(record)

    def _emit(self, record: dict) -> bool:
        if self._degraded or self._closed:
            with self._lock:
                self._dropped_degraded += 1
            return False
        if not self.breaker.allow():
            # breaker open and cooling down: shed load at the door instead
            # of queueing records the flusher would only throw away
            with self._lock:
                self._dropped_breaker_open += 1
            return False
        try:
            self._queue.put_nowait(record)
        except queue.Full:
            with self._lock:
                self._dropped_queue_full += 1
            return False
        self._idle.clear()
        with self._lock:
            self._emitted += 1
        return True

    def export_epoch_record(self, rec) -> bool:
        return self.emit(epoch_record_wire(rec, self.scenario))

    def export_tenant_record(self, rec) -> bool:
        return self.emit(tenant_record_wire(rec, self.scenario))

    def export_lane_summary(self, lane: str, summary: dict) -> bool:
        return self.emit(lane_summary_wire(lane, summary, self.scenario))

    def export_tenant_lane_summary(self, tenant: str, lane: str,
                                   summary: dict) -> bool:
        return self.emit(
            tenant_lane_summary_wire(tenant, lane, summary, self.scenario))

    def export_runtime_span(self, span) -> bool:
        """One closed :class:`repro_torch.obs.trace.Span` -> wire record."""
        return self.emit(runtime_span_wire(span, self.scenario))

    def export_runtime_metric(self, metric: str, kind: str, value=None,
                              **kw) -> bool:
        """One metric sample -> wire record (see ``runtime_metric_wire``)."""
        return self.emit(runtime_metric_wire(metric, kind, value,
                                             scenario=self.scenario, **kw))

    def export_metrics(self, registry) -> int:
        """Emit one ``runtime_metric`` record per labeled child of every
        family in a :class:`repro_torch.obs.metrics.MetricsRegistry`; returns how
        many records were accepted.  Call at run boundaries — a registry
        dump is a snapshot, not a stream."""
        accepted = 0
        for fam in registry.families():
            for child in fam.children():
                labels = dict(child.labels) or None
                if fam.kind == "histogram":
                    ok = self.export_runtime_metric(
                        fam.name, "histogram", labels=labels,
                        bucket_le=fam.buckets,
                        bucket_counts=child.bucket_counts,
                        sum_value=child.sum, observations=child.count)
                else:
                    ok = self.export_runtime_metric(
                        fam.name, fam.kind, child.value, labels=labels)
                accepted += bool(ok)
        return accepted

    def bind(self, **labels: str) -> "_BoundClient":
        """A lightweight view of this client with a different scenario
        label — lets ``run_scenario`` tag records without mutating a
        caller-owned client."""
        unknown = set(labels) - {"scenario"}
        if unknown:
            raise TypeError(f"unknown bind labels {sorted(unknown)}; the "
                            f"frozen schema only carries 'scenario'")
        return _BoundClient(self, labels.get("scenario", self.scenario))

    # -------------------------------------------------------------- flusher
    def _flusher_loop(self) -> None:
        while True:
            try:
                item = self._queue.get(timeout=self._flush_interval_s)
            except queue.Empty:
                self._idle.set()
                if self._closed:
                    break
                continue
            closing = item is _SENTINEL
            batch: List[dict] = [] if closing else [item]
            while len(batch) < self.batch_size:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is _SENTINEL:
                    closing = True
                    continue
                batch.append(nxt)
            if batch:
                self._write_batch(batch)
            if closing and self._queue.empty():
                break
        # final drain: whatever raced in after the sentinel
        tail: List[dict] = []
        while True:
            try:
                nxt = self._queue.get_nowait()
            except queue.Empty:
                break
            if nxt is not _SENTINEL:
                tail.append(nxt)
        if tail:
            self._write_batch(tail)
        try:
            if hasattr(self.sink, "flush"):
                self.sink.flush()
        except Exception:
            pass
        self._idle.set()

    def _write_batch(self, batch: List[dict]) -> None:
        # runs on the flusher thread -> its own track in the chrome trace;
        # stats are (re)published after every attempt (even all-dropped
        # ones) so a dropping exporter is visible from a scrape.
        _tr = obs_trace.get_tracer()
        cm = (_tr.span("export.write_batch", batch=len(batch))
              if _tr.enabled else obs_trace.NOOP_SPAN)
        try:
            with cm:
                self._write_batch_inner(batch)
        finally:
            self._publish_stats()

    _PUBLISHED_STAT_KEYS = ("emitted", "exported", "sink_failures")
    _PUBLISHED_DROP_KEYS = ("dropped_queue_full", "dropped_invalid",
                            "dropped_breaker_open", "dropped_sink_failure",
                            "dropped_degraded")

    def _publish_stats(self) -> None:
        """Mirror the client's own counters into the sink's ``set_counter``
        path (when it has one): ``repro_export_{emitted,exported,
        sink_failures}_total`` plus ``repro_export_dropped_total`` labelled
        by reason.  Best-effort — a sink that throws here must not take the
        flusher down with it."""
        set_counter = getattr(self.sink, "set_counter", None)
        if set_counter is None:
            return
        st = self.stats()
        try:
            for key in self._PUBLISHED_STAT_KEYS:
                set_counter(f"repro_export_{key}_total", st[key],
                            help=f"Export client {key.replace('_', ' ')}")
            for key in self._PUBLISHED_DROP_KEYS:
                set_counter("repro_export_dropped_total", st[key],
                            help="Records dropped by the export client, "
                                 "by reason",
                            reason=key[len("dropped_"):])
        except Exception:
            pass

    def _write_batch_inner(self, batch: List[dict]) -> None:
        if self.validate:
            good: List[dict] = []
            bad = 0
            for rec in batch:
                try:
                    good.append(validate_record(rec))
                except SchemaError:
                    bad += 1
            if bad:
                with self._lock:
                    self._dropped_invalid += bad
        else:
            good = batch
        if not good:
            return
        if self._degraded or not self.breaker.allow():
            with self._lock:
                self._dropped_breaker_open += len(good)
            return
        try:
            self.sink.write(good)
        except Exception:
            self.breaker.record_failure()
            with self._lock:
                self._sink_failures += 1
                self._dropped_sink_failure += len(good)
                if self.breaker.consecutive_trips >= self.degrade_after_trips:
                    self._degraded = True
        else:
            self.breaker.record_success()
            with self._lock:
                self._exported += len(good)

    # ------------------------------------------------------------ lifecycle
    def flush(self, timeout: Optional[float] = None) -> None:
        """Block (the CALLER, never the epoch loop — call between runs)
        until everything enqueued so far has been offered to the sink."""
        _tr = obs_trace.get_tracer()
        cm = (_tr.span("export.flush") if _tr.enabled else obs_trace.NOOP_SPAN)
        with cm:
            deadline = None if timeout is None else time.monotonic() + timeout
            while not (self._queue.empty() and self._idle.is_set()):
                if not self._thread.is_alive():
                    break
                if deadline is not None and time.monotonic() >= deadline:
                    break
                time.sleep(0.005)
        # emit-time drops (queue_full / breaker_open / degraded) may never
        # reach _write_batch; a flush is the natural scrape boundary
        self._publish_stats()

    def close(self, timeout: Optional[float] = 5.0) -> None:
        """Stop accepting records, drain the queue, join the flusher, and
        close the sink.  Idempotent; also runs at interpreter exit."""
        if self._closed:
            return
        self._closed = True
        try:
            atexit.unregister(self.close)
        except Exception:
            pass
        try:
            self._queue.put_nowait(_SENTINEL)
        except queue.Full:
            pass  # flusher sees _closed on its next idle wakeup
        self._thread.join(timeout=timeout)
        try:
            if hasattr(self.sink, "close"):
                self.sink.close()
        except Exception:
            pass

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "emitted": self._emitted,
                "exported": self._exported,
                "dropped_queue_full": self._dropped_queue_full,
                "dropped_invalid": self._dropped_invalid,
                "dropped_breaker_open": self._dropped_breaker_open,
                "dropped_sink_failure": self._dropped_sink_failure,
                "dropped_degraded": self._dropped_degraded,
                "sink_failures": self._sink_failures,
                "breaker_state": self.breaker.state,
                "breaker_trips": self.breaker.trips,
                "degraded": self._degraded,
            }


class _BoundClient:
    """A scenario-labelled view over an :class:`ExportClient`.  Shares the
    parent's queue, flusher, breaker, and counters; only the label differs.
    """

    def __init__(self, parent: ExportClient, scenario: Optional[str]) -> None:
        self._parent = parent
        self.scenario = scenario

    @property
    def degraded(self) -> bool:
        return self._parent.degraded

    def emit(self, record: dict) -> bool:
        return self._parent.emit(record)

    def export_epoch_record(self, rec) -> bool:
        return self.emit(epoch_record_wire(rec, self.scenario))

    def export_tenant_record(self, rec) -> bool:
        return self.emit(tenant_record_wire(rec, self.scenario))

    def export_lane_summary(self, lane: str, summary: dict) -> bool:
        return self.emit(lane_summary_wire(lane, summary, self.scenario))

    def export_tenant_lane_summary(self, tenant: str, lane: str,
                                   summary: dict) -> bool:
        return self.emit(
            tenant_lane_summary_wire(tenant, lane, summary, self.scenario))

    def export_runtime_span(self, span) -> bool:
        return self.emit(runtime_span_wire(span, self.scenario))

    def export_runtime_metric(self, metric: str, kind: str, value=None,
                              **kw) -> bool:
        return self.emit(runtime_metric_wire(metric, kind, value,
                                             scenario=self.scenario, **kw))

    def export_metrics(self, registry) -> int:
        return ExportClient.export_metrics(self, registry)

    def bind(self, **labels: str):
        return self._parent.bind(**labels)

    def flush(self, timeout: Optional[float] = None) -> None:
        self._parent.flush(timeout)

    def close(self, timeout: Optional[float] = 5.0) -> None:
        self._parent.close(timeout)

    def stats(self) -> Dict[str, object]:
        return self._parent.stats()
