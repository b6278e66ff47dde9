"""repro_torch.faults — telemetry fault injection and degradation-aware
tiering (PyTorch port of ``repro.faults``).

* :class:`FaultModel` — what can go wrong, injected on the device inside the
  observe path: HMU counter-width saturation, PEBS sample drops, per-collector
  reset events (drain races), NB scan stalls, and a ``stale_epochs``-deep
  delay on the estimates the policies see.  Its random draws are the
  reference's own (:mod:`repro_torch.faults.prng`), so a faulty run is
  byte-identical to the reference's; a default-constructed model is
  identical to running with none.
* :class:`Hardening` — demotion hysteresis and a quality-gated per-lane
  fallback to a healthy collector.
* :class:`Counter64` — exact int64 event counters.

Entry points: ``EpochRuntime(faults=, hardening=)``,
``run_scenario(faults=, hardening=)``, ``run_fleet(faults=, hardening=)``
with per-tenant profiles via :meth:`FaultModel.for_segments`, and
``repro_torch.examples.degraded_telemetry``.
"""
from .model import (
    COLLECTORS, Counter64, FaultModel, Hardening, LANE_COLLECTOR,
    counter_add, counter_init, counter_scaled_add, counter_zero_like,
)

__all__ = [
    "COLLECTORS", "Counter64", "FaultModel", "Hardening", "LANE_COLLECTOR",
    "counter_add", "counter_init", "counter_scaled_add", "counter_zero_like",
]
