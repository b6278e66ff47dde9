"""repro_torch.faults — exact event counters and the collector map the
fault-free telemetry path needs; fault injection itself is not ported yet."""
from .model import (
    COLLECTORS, Counter64, FaultModel, Hardening, LANE_COLLECTOR,
    counter_add, counter_init, counter_scaled_add, counter_zero_like,
)

__all__ = [
    "COLLECTORS", "Counter64", "FaultModel", "Hardening", "LANE_COLLECTOR",
    "counter_add", "counter_init", "counter_scaled_add", "counter_zero_like",
]
