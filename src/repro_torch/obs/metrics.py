"""Labeled metrics registry — counters, gauges, bounded-bucket histograms
(PyTorch port's copy of ``repro/obs/metrics.py``; standard library
only, so the copy is the reference's code).

One process-wide :class:`MetricsRegistry` (module default: :data:`REGISTRY`)
owns every metric family.  A *family* is a named metric plus a fixed kind
(``counter`` / ``gauge`` / ``histogram``); ``family.labels(**labels)``
returns (creating on demand) the *child* for one label combination.  All
mutation goes through a single registry lock, so families are safe to tick
from the epoch loop and the export flusher thread concurrently.

Naming follows the export schema's unit convention: ``_total`` for
counters, ``_s``/``_us`` embedded unit suffixes for durations, ``_count``
for event counts.

:class:`CounterDict` is the bridge for ``core.runtime``'s
``DISPATCH_COUNTS`` module dict: a dict-API view over one counter family
with a fixed label key, so ``counts["observe_all"] += 1`` increments
``repro_dispatch_total{kind="observe_all"}`` while every caller
(``dict(view)``, ``counting()``'s ``_CounterView``, test equality checks)
keeps working unchanged.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricFamily", "MetricsRegistry",
    "CounterDict", "REGISTRY", "DEFAULT_LATENCY_BUCKETS_S",
]

# Latency buckets (seconds) sized for host-side dispatch/sync work: 10us to
# ~10s, roughly x4 per step.  Bounded: 10 finite bounds + overflow.
DEFAULT_LATENCY_BUCKETS_S: Tuple[float, ...] = (
    1e-5, 4e-5, 1.6e-4, 6.4e-4, 2.56e-3, 1.024e-2,
    4.096e-2, 1.6384e-1, 6.5536e-1, 2.62144,
)

_MAX_BUCKETS = 64
_MAX_CHILDREN = 4096       # per-family cardinality bound


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotone counter child.  ``set`` exists only for the legacy dict
    views (``CounterDict.__setitem__`` writes absolute values through)."""

    __slots__ = ("labels", "value", "_lock")

    def __init__(self, labels: Tuple[Tuple[str, str], ...],
                 lock: threading.RLock) -> None:
        self.labels = labels
        self.value = 0
        self._lock = lock

    def inc(self, n=1) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self.value += n

    def set(self, value) -> None:
        with self._lock:
            self.value = value


class Gauge:
    """Last-value gauge child."""

    __slots__ = ("labels", "value", "_lock")

    def __init__(self, labels: Tuple[Tuple[str, str], ...],
                 lock: threading.RLock) -> None:
        self.labels = labels
        self.value = 0.0
        self._lock = lock

    def set(self, value) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, n=1.0) -> None:
        with self._lock:
            self.value += n


class Histogram:
    """Bounded-bucket histogram child (cumulative rendering happens in the
    Prometheus sink; storage here is per-bucket counts + sum + count)."""

    __slots__ = ("labels", "bounds", "bucket_counts", "sum", "count", "_lock")

    def __init__(self, labels: Tuple[Tuple[str, str], ...],
                 bounds: Tuple[float, ...], lock: threading.RLock) -> None:
        self.labels = labels
        self.bounds = bounds
        self.bucket_counts = [0] * (len(bounds) + 1)   # +1 overflow bucket
        self.sum = 0.0
        self.count = 0
        self._lock = lock

    def observe(self, value) -> None:
        v = float(value)
        with self._lock:
            i = 0
            for i, bound in enumerate(self.bounds):        # noqa: B007
                if v <= bound:
                    break
            else:
                i = len(self.bounds)                       # overflow
            self.bucket_counts[i] += 1
            self.sum += v
            self.count += 1


_KIND_CHILD = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricFamily:
    """A named metric of one kind with a set of labeled children."""

    def __init__(self, name: str, kind: str, help: str = "", unit: str = "",
                 buckets: Optional[Sequence[float]] = None,
                 _lock: Optional[threading.RLock] = None) -> None:
        if kind not in _KIND_CHILD:
            raise ValueError(f"unknown metric kind {kind!r}")
        if kind == "histogram":
            buckets = tuple(float(b) for b in
                            (buckets or DEFAULT_LATENCY_BUCKETS_S))
            if not buckets or len(buckets) > _MAX_BUCKETS:
                raise ValueError(
                    f"histogram needs 1..{_MAX_BUCKETS} bounds, "
                    f"got {len(buckets)}")
            if list(buckets) != sorted(buckets) or len(set(buckets)) != len(buckets):
                raise ValueError("histogram bounds must be strictly increasing")
        elif buckets is not None:
            raise ValueError(f"buckets only apply to histograms, not {kind}")
        self.name = name
        self.kind = kind
        self.help = help
        self.unit = unit
        self.buckets: Optional[Tuple[float, ...]] = (
            tuple(buckets) if kind == "histogram" else None)
        self._lock = _lock or threading.RLock()
        self._children: Dict[Tuple[Tuple[str, str], ...], object] = {}

    def labels(self, **labels: str):
        """Child for one label combination, created on first use."""
        key = _label_key(labels)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    if len(self._children) >= _MAX_CHILDREN:
                        raise ValueError(
                            f"{self.name}: label cardinality bound "
                            f"({_MAX_CHILDREN}) exceeded")
                    if self.kind == "histogram":
                        child = Histogram(key, self.buckets, self._lock)
                    else:
                        child = _KIND_CHILD[self.kind](key, self._lock)
                    self._children[key] = child
        return child

    def children(self) -> List[object]:
        with self._lock:
            return list(self._children.values())


class MetricsRegistry:
    """Thread-safe collection of metric families, keyed by name."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._families: Dict[str, MetricFamily] = {}

    def _get_or_create(self, name: str, kind: str, help: str, unit: str,
                       buckets: Optional[Sequence[float]]) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind}, "
                        f"requested {kind}")
                if help and not fam.help:
                    fam.help = help
                return fam
            fam = MetricFamily(name, kind, help=help, unit=unit,
                               buckets=buckets, _lock=self._lock)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", unit: str = "") -> MetricFamily:
        return self._get_or_create(name, "counter", help, unit, None)

    def gauge(self, name: str, help: str = "", unit: str = "") -> MetricFamily:
        return self._get_or_create(name, "gauge", help, unit, None)

    def histogram(self, name: str, help: str = "", unit: str = "",
                  buckets: Optional[Sequence[float]] = None) -> MetricFamily:
        return self._get_or_create(name, "histogram", help, unit, buckets)

    def families(self) -> List[MetricFamily]:
        with self._lock:
            return list(self._families.values())

    def publish(self, sink) -> None:
        """Push every family into a Prometheus-style sink.

        Counters/gauges go through ``set_counter`` / ``set_gauge`` (falling
        back to ``set_counter`` when the sink predates gauges), histograms
        through ``set_histogram``.  Sinks missing a hook skip that family —
        publication is best-effort by design.
        """
        set_counter = getattr(sink, "set_counter", None)
        set_gauge = getattr(sink, "set_gauge", None) or set_counter
        set_histogram = getattr(sink, "set_histogram", None)
        for fam in self.families():
            for child in fam.children():
                labels = dict(child.labels)
                if fam.kind == "counter" and set_counter is not None:
                    set_counter(fam.name, child.value, help=fam.help, **labels)
                elif fam.kind == "gauge" and set_gauge is not None:
                    set_gauge(fam.name, child.value, help=fam.help, **labels)
                elif fam.kind == "histogram" and set_histogram is not None:
                    set_histogram(fam.name, fam.buckets, child.bucket_counts,
                                  child.sum, child.count, help=fam.help,
                                  **labels)


#: Process-default registry — the one the runtime's counter dicts live in.
REGISTRY = MetricsRegistry()


class CounterDict:
    """Dict-API view over one counter family with a fixed label key.

    ``view[k]`` reads the child ``{label_key: k}``, ``view[k] = v`` writes
    the absolute value through (so ``view[k] += 1`` is an increment), and
    iteration/``keys``/``items``/``get``/``in``/``dict(view)`` all behave
    like the plain dict this replaces.  New keys may be introduced by
    assignment, exactly as with a dict; reads of unknown keys raise
    ``KeyError`` (the fail-fast contract ``counting()`` relies on).
    """

    __slots__ = ("_family", "_label", "_keys")

    def __init__(self, family: MetricFamily, label: str,
                 keys: Sequence[str] = ()) -> None:
        if family.kind != "counter":
            raise ValueError(f"CounterDict needs a counter family, "
                             f"got {family.kind}")
        self._family = family
        self._label = label
        self._keys: List[str] = []
        for k in keys:
            self._ensure(k)

    def _ensure(self, key: str) -> Counter:
        child = self._family.labels(**{self._label: key})
        if key not in self._keys:
            self._keys.append(key)
        return child

    def __getitem__(self, key: str):
        if key not in self._keys:
            raise KeyError(key)
        return self._family.labels(**{self._label: key}).value

    def __setitem__(self, key: str, value) -> None:
        self._ensure(key).set(value)

    def get(self, key: str, default=None):
        if key not in self._keys:
            return default
        return self[key]

    def keys(self):
        return tuple(self._keys)

    def values(self):
        return tuple(self[k] for k in self._keys)

    def items(self):
        return tuple((k, self[k]) for k in self._keys)

    def __iter__(self) -> Iterator[str]:
        return iter(tuple(self._keys))

    def __contains__(self, key) -> bool:
        return key in self._keys

    def __len__(self) -> int:
        return len(self._keys)

    def __eq__(self, other) -> bool:
        if isinstance(other, (dict, CounterDict)):
            return dict(self.items()) == dict(other.items()) \
                if isinstance(other, CounterDict) else dict(self.items()) == other
        return NotImplemented

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    def __repr__(self) -> str:
        return f"CounterDict({dict(self.items())!r})"
