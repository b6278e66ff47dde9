"""repro_torch.export — non-blocking telemetry export plane (PyTorch port
of ``repro.export``).

Everything the runtime already measures (per-epoch lane records, per-tenant
rows, collector quality, run summaries) leaves the process through this
package, under two hard guarantees:

1. **Frozen wire schema** (``schema.py`` + ``telemetry.schema.json``, the
   port's own copy of the reference's document, byte for byte): units
   encoded in field names, every emitted record validated.
2. **Zero cost to the observed system** (``client.py`` + ``sinks.py``):
   the epoch loop's contribution is one non-blocking enqueue per record at
   the existing ``sync_every=K`` record pull — no extra device launch, no
   extra device->host transfer, byte-identical trajectories export-on vs
   export-off, and a circuit breaker that degrades a failing sink to noop
   instead of ever blocking or raising into ``run()``.

Typical use::

    from repro_torch.export import ExportClient, JsonlSink
    client = ExportClient(JsonlSink("telemetry.jsonl"))
    out = run_scenario(scenario, export=client)
    client.close()
"""
from .client import CircuitBreaker, ExportClient, NoopClient
from .schema import (SCHEMA_PATH, SCHEMA_VERSION, SchemaError, load_schema,
                     validate_record, epoch_record_wire, tenant_record_wire,
                     lane_summary_wire, tenant_lane_summary_wire,
                     runtime_span_wire, runtime_metric_wire)
from .sinks import JsonlSink, MemorySink, PrometheusTextSink, SinkError

__all__ = [
    "CircuitBreaker", "ExportClient", "NoopClient",
    "SCHEMA_PATH", "SCHEMA_VERSION", "SchemaError", "load_schema",
    "validate_record", "epoch_record_wire", "tenant_record_wire",
    "lane_summary_wire", "tenant_lane_summary_wire",
    "runtime_span_wire", "runtime_metric_wire",
    "JsonlSink", "MemorySink", "PrometheusTextSink", "SinkError",
]
