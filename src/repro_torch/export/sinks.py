"""Pluggable export sinks — where validated wire records actually land
(PyTorch port's copy of ``repro/export/sinks.py``; standard library only,
so the copy is the reference's code).

A sink is anything with ``write(records)`` taking a batch (list) of wire
dicts, plus optional ``flush()`` / ``close()``.  Sinks are called ONLY from
the :class:`~repro_torch.export.client.ExportClient` flusher thread, never
from the epoch loop, so a slow or dead sink costs the observed runtime
nothing: the client's circuit breaker absorbs every exception a sink
raises.

Three sinks:

* :class:`JsonlSink` — newline-delimited JSON to a file; the durable
  cross-run format.
* :class:`MemorySink` — collects records in a list; the test double, with a
  ``fail_until``/``fail_always`` knob to script sink failures for circuit-
  breaker tests.
* :class:`PrometheusTextSink` — maintains last-value gauges keyed by
  (scenario, lane, tenant) from incoming records and renders Prometheus
  text exposition format v0.0.4 on demand (``render()``); for scrape-style
  ops integration of coverage/accuracy/quality/epoch-time and the
  runtime's dispatch counters.
"""
from __future__ import annotations

import io
import json
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["JsonlSink", "MemorySink", "PrometheusTextSink", "SinkError"]


class SinkError(RuntimeError):
    """A sink refused a batch (used by MemorySink's scripted failures)."""


class JsonlSink:
    """Appends one JSON object per line to ``path``.

    The file handle opens lazily on first write so constructing a client
    with a JSONL sink costs nothing until telemetry actually flows, and a
    sink pointed at an unwritable path fails in the flusher thread (where
    the breaker catches it), not in user code.
    """

    def __init__(self, path) -> None:
        self.path = str(path)
        self._fh: Optional[io.TextIOBase] = None

    def write(self, records: List[dict]) -> None:
        if self._fh is None:
            self._fh = open(self.path, "a", encoding="utf-8")
        self._fh.write("".join(
            json.dumps(rec, separators=(",", ":"), sort_keys=True) + "\n"
            for rec in records))

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class MemorySink:
    """In-memory sink for tests; thread-safe.

    ``fail_until`` makes the first N ``write`` calls raise (then recover) —
    the shape circuit-breaker recovery tests need.  ``fail_always`` models
    a permanently dead sink.
    """

    def __init__(self, fail_until: int = 0, fail_always: bool = False) -> None:
        self.records: List[dict] = []
        self.write_calls = 0
        self.failed_calls = 0
        self.fail_until = fail_until
        self.fail_always = fail_always
        self._lock = threading.Lock()

    def write(self, records: List[dict]) -> None:
        with self._lock:
            self.write_calls += 1
            if self.fail_always or self.write_calls <= self.fail_until:
                self.failed_calls += 1
                raise SinkError(f"scripted failure #{self.failed_calls}")
            self.records.extend(records)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self.records)


# Prometheus metric name -> (wire field, help text).  Only gauge-shaped
# fields; monotone totals come in via set_counter().
_GAUGE_FIELDS = (
    ("repro_coverage_ratio", "coverage",
     "Fraction of true-hot blocks resident in the fast tier"),
    ("repro_accuracy_ratio", "accuracy",
     "Fraction of fast-tier accesses that hit resident blocks"),
    ("repro_quality_ratio", "quality",
     "Collector telemetry quality (observed access mass fraction)"),
    ("repro_epoch_time_seconds", "time_s",
     "Modelled epoch execution time"),
)


def _escape_label_value(value: str) -> str:
    """Label-value escaping per the text exposition format v0.0.4:
    backslash, double-quote, and line feed."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    """HELP-line escaping: backslash and line feed (quotes are legal)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


class PrometheusTextSink:
    """Last-value gauges rendered as Prometheus text exposition.

    ``write`` folds each record's ratio/time fields into gauges labelled
    ``{scenario, lane, tenant}`` (absent labels rendered as empty strings
    so series stay distinct); ``set_counter`` / ``set_gauge`` publish
    externally-owned samples (the runtime's ``DISPATCH_COUNTS``, the
    export client's own drop counters, registry gauges); ``set_histogram``
    publishes a bounded-bucket histogram rendered cumulatively with the
    standard ``_bucket{le=...}`` / ``_sum`` / ``_count`` triplet;
    ``render`` produces the scrape body — every family gets ``# HELP`` and
    ``# TYPE`` metadata, and label values are escaped (backslash, double
    quote, newline) per format v0.0.4.  Thread-safe: ``write`` runs on the
    flusher thread while ``render`` is called from a scrape/test thread.
    """

    def __init__(self) -> None:
        # metric -> label-tuple -> value
        self._gauges: Dict[str, Dict[Tuple[str, str, str], float]] = {
            name: {} for name, _, _ in _GAUGE_FIELDS}
        self._counters: Dict[str, Dict[Tuple[Tuple[str, str], ...], float]] = {}
        self._ext_gauges: Dict[str, Dict[Tuple[Tuple[str, str], ...], float]] = {}
        # name -> label-tuple -> (bounds, bucket_counts, sum, count)
        self._hists: Dict[str, Dict[Tuple[Tuple[str, str], ...], tuple]] = {}
        self._help: Dict[str, str] = {}
        self._lock = threading.Lock()

    def write(self, records: List[dict]) -> None:
        with self._lock:
            for rec in records:
                labels = (rec.get("scenario", ""), rec.get("lane", ""),
                          rec.get("tenant", ""))
                for name, field, _ in _GAUGE_FIELDS:
                    if field in rec:
                        self._gauges[name][labels] = float(rec[field])

    def _remember_help(self, name: str, help: Optional[str]) -> None:
        if help:
            self._help[name] = str(help)

    def set_counter(self, name: str, value: float, help: Optional[str] = None,
                    **labels: str) -> None:
        """Publish a monotone counter sample (e.g. ``repro_dispatch_total``
        from ``DISPATCH_COUNTS``, labelled by kind)."""
        with self._lock:
            self._remember_help(name, help)
            self._counters.setdefault(name, {})[
                tuple(sorted(labels.items()))] = float(value)

    def set_gauge(self, name: str, value: float, help: Optional[str] = None,
                  **labels: str) -> None:
        """Publish an externally-owned last-value gauge sample."""
        with self._lock:
            self._remember_help(name, help)
            self._ext_gauges.setdefault(name, {})[
                tuple(sorted(labels.items()))] = float(value)

    def set_histogram(self, name: str, bounds, bucket_counts, sum_value,
                      count=None, help: Optional[str] = None,
                      **labels: str) -> None:
        """Publish one bounded-bucket histogram: ``bounds`` are the finite
        ``le`` upper bounds, ``bucket_counts`` the per-bucket (NOT
        cumulative) counts with one trailing overflow bucket."""
        bounds = tuple(float(b) for b in bounds)
        bucket_counts = tuple(int(c) for c in bucket_counts)
        if len(bucket_counts) != len(bounds) + 1:
            raise ValueError(
                f"{name}: need len(bounds)+1 bucket counts, got "
                f"{len(bucket_counts)} for {len(bounds)} bounds")
        if count is None:
            count = sum(bucket_counts)
        with self._lock:
            self._remember_help(name, help)
            self._hists.setdefault(name, {})[
                tuple(sorted(labels.items()))] = (
                    bounds, bucket_counts, float(sum_value), int(count))

    @staticmethod
    def _fmt_labels(pairs) -> str:
        if not pairs:
            return ""
        body = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in pairs)
        return "{" + body + "}"

    def _meta(self, out: List[str], name: str, kind: str,
              default_help: str) -> None:
        out.append(f"# HELP {name} "
                   f"{_escape_help(self._help.get(name, default_help))}")
        out.append(f"# TYPE {name} {kind}")

    def render(self) -> str:
        """Prometheus text exposition format v0.0.4."""
        out: List[str] = []
        with self._lock:
            for name, field, help_text in _GAUGE_FIELDS:
                series = self._gauges[name]
                if not series:
                    continue
                out.append(f"# HELP {name} {_escape_help(help_text)}")
                out.append(f"# TYPE {name} gauge")
                for (scenario, lane, tenant), val in sorted(series.items()):
                    pairs = [("lane", lane), ("scenario", scenario),
                             ("tenant", tenant)]
                    out.append(f"{name}{self._fmt_labels(pairs)} {val:g}")
            for name in sorted(self._ext_gauges):
                self._meta(out, name, "gauge", "Last-value gauge")
                for pairs, val in sorted(self._ext_gauges[name].items()):
                    out.append(f"{name}{self._fmt_labels(pairs)} {val:g}")
            for name in sorted(self._counters):
                self._meta(out, name, "counter", "Monotone counter")
                for pairs, val in sorted(self._counters[name].items()):
                    out.append(f"{name}{self._fmt_labels(pairs)} {val:g}")
            for name in sorted(self._hists):
                self._meta(out, name, "histogram", "Latency histogram")
                for pairs, (bounds, counts, sum_v, count) in sorted(
                        self._hists[name].items()):
                    cum = 0
                    for bound, c in zip(bounds, counts):
                        cum += c
                        bpairs = list(pairs) + [("le", f"{bound:g}")]
                        out.append(f"{name}_bucket"
                                   f"{self._fmt_labels(bpairs)} {cum}")
                    bpairs = list(pairs) + [("le", "+Inf")]
                    out.append(f"{name}_bucket{self._fmt_labels(bpairs)} "
                               f"{cum + counts[-1]}")
                    out.append(f"{name}_sum{self._fmt_labels(pairs)} "
                               f"{sum_v:g}")
                    out.append(f"{name}_count{self._fmt_labels(pairs)} "
                               f"{count}")
        return "\n".join(out) + ("\n" if out else "")
