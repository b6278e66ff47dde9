"""Frozen telemetry wire schema — the contract downstream tooling parses
(PyTorch port of ``repro/export/schema.py``).

The in-process record types (:class:`~repro_torch.core.runtime.EpochRecord`,
:class:`~repro_torch.fleet.accounting.TenantRecord`, the ``run_scenario``
summary dicts) are free to evolve with the runtime; what crosses the
process boundary is not.  This module freezes the **wire form**: field
names with units encoded in them (``_s`` seconds, ``_us`` microseconds,
``_blocks`` block counts, ``_count`` event counts; ratios unitless in
[0, 1]), encoded as JSON Schema in ``telemetry.schema.json`` next to this
file — the port's own copy of the reference package's document, kept byte
for byte the same (a test compares the two), so both packages emit one
wire format.

* :func:`validate_record` checks one wire record against the schema and
  raises :class:`SchemaError` with the offending path.  The validator is
  self-contained (it interprets the subset of JSON Schema the document
  uses — ``$ref`` into ``$defs``, ``const``/``enum``/``type``,
  ``properties``/``required``/``additionalProperties``, ``minimum``/
  ``maximum``, top-level ``oneOf`` dispatched on ``record_type``).
* ``epoch_record_wire`` / ``tenant_record_wire`` / ``lane_summary_wire`` /
  ``tenant_lane_summary_wire`` / ``runtime_span_wire`` /
  ``runtime_metric_wire`` convert the in-process objects to wire records.
  Conversion is the ONLY place internal and wire names may differ
  (``resident`` -> ``resident_blocks``), which is what lets the schema stay
  frozen while the runtime refactors freely.

Schema evolution is additive only: a new ``record_type`` leaves every
existing shape byte-identical; a field added to an existing shape must be
optional and bumps that shape's ``schema_version``.
"""
from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path
from typing import Dict, Optional

from ..faults.model import collector_for_lane

__all__ = [
    "SCHEMA_PATH", "SCHEMA_VERSION", "SchemaError", "load_schema",
    "validate_record", "epoch_record_wire", "tenant_record_wire",
    "lane_summary_wire", "tenant_lane_summary_wire",
    "runtime_span_wire", "runtime_metric_wire",
]

SCHEMA_VERSION = 1
SCHEMA_PATH = Path(__file__).with_name("telemetry.schema.json")

# run_scenario/tenant_summary cross-lane aggregate keys that live in the
# summary dict next to the per-lane rows; never part of a wire record
_SUMMARY_AGGREGATES = ("proactive_vs_nb_post_shift",
                       "prefetch_vs_hinted_post_shift_coverage")


class SchemaError(ValueError):
    """A wire record does not conform to the frozen telemetry schema."""


@lru_cache(maxsize=1)
def load_schema() -> dict:
    """The checked-in JSON-Schema document (parsed once per process)."""
    return json.loads(SCHEMA_PATH.read_text())


# ------------------------------------------------------------ the validator
_TYPES = {
    "object": dict, "string": str, "boolean": bool,
    "array": list, "null": type(None),
}


def _deref(node: dict, schema: dict) -> dict:
    ref = node.get("$ref")
    if ref is None:
        return node
    if not ref.startswith("#/"):              # pragma: no cover - frozen doc
        raise SchemaError(f"unsupported $ref {ref!r}")
    out = schema
    for part in ref[2:].split("/"):
        out = out[part]
    return out


def _check(value, node: dict, schema: dict, path: str) -> None:
    node = _deref(node, schema)
    if "const" in node:
        if value != node["const"]:
            raise SchemaError(f"{path}: expected {node['const']!r}, "
                              f"got {value!r}")
        return
    if "enum" in node:
        if value not in node["enum"]:
            raise SchemaError(f"{path}: {value!r} not one of {node['enum']}")
        return
    typ = node.get("type")
    if typ == "integer":
        # bool is an int subclass; the schema means a real integer
        if isinstance(value, bool) or not isinstance(value, int):
            raise SchemaError(f"{path}: expected integer, got {value!r}")
    elif typ == "number":
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise SchemaError(f"{path}: expected number, got {value!r}")
    elif typ is not None:
        if not isinstance(value, _TYPES[typ]):
            raise SchemaError(f"{path}: expected {typ}, got {value!r}")
    if "minimum" in node and value < node["minimum"]:
        raise SchemaError(f"{path}: {value!r} < minimum {node['minimum']}")
    if "maximum" in node and value > node["maximum"]:
        raise SchemaError(f"{path}: {value!r} > maximum {node['maximum']}")
    if typ == "array":
        items = node.get("items")
        if items is not None:
            for i, element in enumerate(value):
                _check(element, items, schema, f"{path}[{i}]")
    if typ == "object":
        props = node.get("properties", {})
        addl = node.get("additionalProperties")
        for req in node.get("required", ()):
            if req not in value:
                raise SchemaError(f"{path}: missing required field {req!r}")
        if addl is False:
            extra = set(value) - set(props)
            if extra:
                raise SchemaError(f"{path}: unknown fields "
                                  f"{sorted(extra)} (the schema is frozen; "
                                  f"additive changes need a version bump)")
        elif isinstance(addl, dict):    # schema-valued: free keys, typed values
            for key in set(value) - set(props):
                _check(value[key], addl, schema, f"{path}.{key}")
        for key, sub in props.items():
            if key in value:
                _check(value[key], sub, schema, f"{path}.{key}")


def validate_record(record: dict) -> dict:
    """Check one wire record against the frozen schema; returns the record
    unchanged so emit paths can validate inline.  Raises
    :class:`SchemaError` naming the offending field path."""
    if not isinstance(record, dict):
        raise SchemaError(f"record must be a dict, got {type(record).__name__}")
    schema = load_schema()
    rtype = record.get("record_type")
    defs = schema["$defs"]
    if rtype not in defs or "record_type" not in defs[rtype].get(
            "properties", {}):
        known = sorted(d for d in defs
                       if "record_type" in defs[d].get("properties", {}))
        raise SchemaError(f"record_type: {rtype!r} not one of {known}")
    _check(record, defs[rtype], schema, f"${rtype}")
    return record


# ------------------------------------------------------- wire conversions
def _with_scenario(rec: dict, scenario: Optional[str]) -> dict:
    if scenario is not None:
        rec["scenario"] = scenario
    return rec


def epoch_record_wire(rec, scenario: Optional[str] = None) -> dict:
    """:class:`~repro_torch.core.runtime.EpochRecord` -> frozen wire record.
    ``rec`` is duck-typed (attribute access only) so this package never
    imports ``repro_torch.core``."""
    return _with_scenario({
        "record_type": "epoch",
        "schema_version": SCHEMA_VERSION,
        "epoch": int(rec.epoch),
        "lane": rec.lane,
        "collector": collector_for_lane(rec.lane),
        "time_s": float(rec.time_s),
        "access_s": float(rec.access_s),
        "host_tax_s": float(rec.host_tax_s),
        "migration_s": float(rec.migration_s),
        "hidden_s": float(rec.hidden_s),
        "accuracy": float(rec.accuracy),
        "coverage": float(rec.coverage),
        "quality": float(rec.quality),
        "resident_blocks": int(rec.resident),
        "promoted_blocks": int(rec.promoted),
        "demoted_blocks": int(rec.demoted),
        "host_events_count": float(rec.host_events),
    }, scenario)


def tenant_record_wire(rec, scenario: Optional[str] = None) -> dict:
    """:class:`~repro_torch.fleet.accounting.TenantRecord` -> wire
    record."""
    return _with_scenario({
        "record_type": "tenant",
        "schema_version": SCHEMA_VERSION,
        "epoch": int(rec.epoch),
        "lane": rec.lane,
        "tenant": rec.tenant,
        "time_s": float(rec.time_s),
        "access_s": float(rec.access_s),
        "host_tax_s": float(rec.host_tax_s),
        "migration_s": float(rec.migration_s),
        "accuracy": float(rec.accuracy),
        "coverage": float(rec.coverage),
        "resident_blocks": int(rec.resident),
        "promoted_blocks": int(rec.promoted),
        "demoted_blocks": int(rec.demoted),
        "n_fast_accesses_count": float(rec.n_fast),
        "n_slow_accesses_count": float(rec.n_slow),
        "hot_k_blocks": int(rec.hot_k),
    }, scenario)


def lane_summary_wire(lane: str, summary: Dict[str, object],
                      scenario: Optional[str] = None) -> dict:
    """One lane's ``run_scenario``/``run_online`` summary dict -> wire
    record.  The summary dict is already schema-conformant field-for-field
    (units in names), so this only stamps the envelope."""
    rec = {"record_type": "lane_summary", "schema_version": SCHEMA_VERSION,
           "lane": lane}
    rec.update(summary)
    return _with_scenario(rec, scenario)


def tenant_lane_summary_wire(tenant: str, lane: str,
                             summary: Dict[str, object],
                             scenario: Optional[str] = None) -> dict:
    """One tenant x lane row of ``fleet.accounting.tenant_summary`` ->
    wire record."""
    rec = {"record_type": "tenant_lane_summary",
           "schema_version": SCHEMA_VERSION, "tenant": tenant, "lane": lane}
    rec.update(summary)
    return _with_scenario(rec, scenario)


def runtime_span_wire(span, scenario: Optional[str] = None) -> dict:
    """:class:`repro_torch.obs.trace.Span` -> wire record.  ``span`` is
    duck-typed (``name``/``t0_s``/``dur_s``/``tid``/``depth``/``epoch``/
    ``args`` attributes) so this module never imports ``repro_torch.obs``.
    Seconds become the wire's ``_us`` fields; a ``record_sync`` span's
    drained window (``epoch_base``/``n_epochs`` args) rides along so
    timeline consumers can rebuild the device track."""
    rec = {
        "record_type": "runtime_span",
        "schema_version": SCHEMA_VERSION,
        "span": str(span.name),
        "track": str(span.tid),
        "t_start_us": float(span.t0_s) * 1e6,
        "duration_us": max(float(span.dur_s), 0.0) * 1e6,
        "depth": int(span.depth),
    }
    if span.epoch is not None:
        rec["epoch"] = int(span.epoch)
    args = span.args or {}
    if "epoch_base" in args:
        rec["epoch_base"] = int(args["epoch_base"])
    if "n_epochs" in args:
        rec["n_epochs_count"] = int(args["n_epochs"])
    return _with_scenario(rec, scenario)


def runtime_metric_wire(metric: str, kind: str, value=None, *,
                        labels: Optional[Dict[str, str]] = None,
                        bucket_le=None, bucket_counts=None,
                        sum_value=None, observations=None,
                        scenario: Optional[str] = None) -> dict:
    """One registry metric sample -> wire record.  Counters/gauges carry
    ``value``; histograms carry the full bounded-bucket state
    (``bucket_le`` upper bounds, ``bucket_counts`` with the trailing
    overflow bucket, ``sum``/``observations_count``).  Label values are
    coerced to strings — the wire's ``labels`` map is string-to-string."""
    rec: Dict[str, object] = {
        "record_type": "runtime_metric",
        "schema_version": SCHEMA_VERSION,
        "metric": str(metric),
        "kind": str(kind),
    }
    if labels:
        rec["labels"] = {str(k): str(v) for k, v in labels.items()}
    if value is not None:
        rec["value"] = float(value)
    if bucket_le is not None:
        rec["bucket_le"] = [float(b) for b in bucket_le]
    if bucket_counts is not None:
        rec["bucket_counts"] = [int(c) for c in bucket_counts]
    if sum_value is not None:
        rec["sum"] = float(sum_value)
    if observations is not None:
        rec["observations_count"] = int(observations)
    return _with_scenario(rec, scenario)
