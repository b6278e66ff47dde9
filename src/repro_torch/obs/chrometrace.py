"""Chrome trace-event JSON writer — the pipelining proof as a timeline
(PyTorch port of ``repro/obs/chrometrace.py``, same behaviour).

Converts recorded :class:`~repro_torch.obs.trace.Span` objects into the
Trace Event Format consumed by ``chrome://tracing`` and Perfetto
(``{"traceEvents": [...]}`` with ``ph: "X"`` complete events, timestamps
in microseconds).  Host threads map to tracks by thread name; on top of
those, :func:`device_track_events` synthesizes a ``device`` track: for each
``record_sync`` span (one ``.cpu()`` pull draining K buffered epochs) it
draws the interval from the *first drained epoch's* ``observe_all``
dispatch to the sync's end — the window in which the device stream was
running ahead of the host.

:func:`pipelining_visible` is the structural check behind the pipelined
record pull, readable off the timeline: with ``sync_every=K>1`` there must
exist a ``record_sync`` span that *begins after* the dispatch of an epoch
newer than any epoch it drains — i.e. the host kept feeding the device
while the previous window's records were still in flight.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence

__all__ = [
    "chrome_trace_events", "device_track_events", "write_chrome_trace",
    "pipelining_visible",
]

_PID = 1


def _t_base(spans: Sequence) -> float:
    return min((s.t0_s for s in spans), default=0.0)


def chrome_trace_events(spans: Sequence, *, t_base: Optional[float] = None,
                        cat: str = "runtime") -> List[dict]:
    """Spans -> chrome ``ph:"X"`` complete events (ts/dur in microseconds,
    normalised so the earliest span starts at ts=0)."""
    base = _t_base(spans) if t_base is None else t_base
    events: List[dict] = []
    for s in spans:
        args: Dict[str, object] = {}
        if s.epoch is not None:
            args["epoch"] = s.epoch
        if s.args:
            args.update(s.args)
        events.append({
            "name": s.name, "ph": "X", "cat": cat,
            "ts": (s.t0_s - base) * 1e6, "dur": s.dur_s * 1e6,
            "pid": _PID, "tid": s.tid,
            "args": args,
        })
    return events


def _sync_window(sync_span, spans) -> Optional[dict]:
    """The (t0, t1, epochs) device window one record_sync span drains."""
    args = sync_span.args or {}
    base, n = args.get("epoch_base"), args.get("n_epochs")
    if base is None or n is None:
        return None
    starts = [s.t0_s for s in spans
              if s.name == "observe_all" and s.epoch is not None
              and base <= s.epoch < base + n]
    if not starts:
        return None
    return {"t0": min(starts), "t1": sync_span.t0_s + sync_span.dur_s,
            "epoch_base": base, "n_epochs": n}


def device_track_events(spans: Sequence, *,
                        t_base: Optional[float] = None) -> List[dict]:
    """Synthesized ``device`` track: one span per record_sync window,
    covering first-drained-epoch dispatch -> sync completion."""
    base_t = _t_base(spans) if t_base is None else t_base
    events: List[dict] = []
    for s in spans:
        if s.name != "record_sync":
            continue
        win = _sync_window(s, spans)
        if win is None:
            continue
        lo, hi = win["epoch_base"], win["epoch_base"] + win["n_epochs"]
        events.append({
            "name": f"device epochs [{lo},{hi})", "ph": "X", "cat": "device",
            "ts": (win["t0"] - base_t) * 1e6,
            "dur": (win["t1"] - win["t0"]) * 1e6,
            "pid": _PID, "tid": "device",
            "args": {"epoch_base": lo, "n_epochs": win["n_epochs"]},
        })
    return events


def pipelining_visible(spans: Iterable) -> bool:
    """True iff some record_sync span started after the host had already
    dispatched an epoch newer than every epoch that sync drains.

    ``sync_every=1`` can never satisfy this (each epoch is drained before
    the next is dispatched); ``sync_every=K>1`` must (``_step_fused``
    dispatches ``observe_all`` for epoch *e* before draining epochs
    ``[e-K, e)``), so the check is deterministic, not timing-dependent.
    """
    spans = list(spans)
    observe_starts = {s.epoch: s.t0_s for s in spans
                      if s.name == "observe_all" and s.epoch is not None}
    for s in spans:
        if s.name != "record_sync" or not s.args:
            continue
        base, n = s.args.get("epoch_base"), s.args.get("n_epochs")
        if base is None or n is None:
            continue
        for epoch, t0 in observe_starts.items():
            if epoch >= base + n and t0 <= s.t0_s:
                return True
    return False


def write_chrome_trace(path, spans: Sequence, *, device_track: bool = True,
                       metadata: Optional[dict] = None) -> dict:
    """Write ``{"traceEvents": [...]}`` JSON for chrome://tracing; returns
    the document (also handy for asserting on it in tests)."""
    base = _t_base(spans)
    events = chrome_trace_events(spans, t_base=base)
    if device_track:
        events.extend(device_track_events(spans, t_base=base))
    doc: Dict[str, object] = {
        "traceEvents": sorted(events, key=lambda e: (e["ts"], e["tid"])),
        "displayTimeUnit": "ms",
    }
    if metadata:
        doc["otherData"] = dict(metadata)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, separators=(",", ":"), sort_keys=True)
        fh.write("\n")
    return doc
