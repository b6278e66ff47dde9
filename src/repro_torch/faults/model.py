"""What the fault-free telemetry path needs of ``repro/faults/model.py``.

* :class:`Counter64` — an exact scalar event counter.  The reference carries
  it as a hi/lo int32 pair (``value == hi * 2**CARRY_BITS + lo``) because
  JAX runs with ``x64`` off; PyTorch has int64 on every device, so the port
  holds the value in one int64 device scalar and exposes ``hi``/``lo`` for
  the carry-across converters.  Reads recombine to the same exact value, and
  the host's float64 reading is the same number.
* :data:`COLLECTORS` / :data:`LANE_COLLECTOR` — collector order and which
  collector feeds each policy lane.
* :class:`FaultModel` / :class:`Hardening` — names only.  Fault injection and
  hardening are not ported yet (ROADMAP Queue 1, item 10); the runtime
  raises ``NotImplementedError`` when given either.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

__all__ = [
    "CARRY_BASE", "CARRY_BITS", "COLLECTORS", "Counter64", "FaultModel",
    "Hardening", "INT32_MAX", "LANE_COLLECTOR", "counter_add",
    "counter_init", "counter_scaled_add", "counter_zero_like",
]

COLLECTORS = ("hmu", "pebs", "nb")

INT32_MAX = (1 << 31) - 1

# lo carries the low CARRY_BITS of the value, hi the rest (the reference's
# split, kept for the hi/lo views and the record layout)
CARRY_BITS = 24
CARRY_BASE = 1 << CARRY_BITS


@dataclasses.dataclass(frozen=True)
class Counter64:
    """Exact scalar event counter: ``value`` is a () int64 tensor."""
    value: torch.Tensor

    @property
    def hi(self) -> torch.Tensor:
        return self.value >> CARRY_BITS

    @property
    def lo(self) -> torch.Tensor:
        return self.value & (CARRY_BASE - 1)

    def __int__(self) -> int:
        return int(self.value)

    def __float__(self) -> float:
        return float(int(self.value))


def counter_init(device) -> Counter64:
    return Counter64(torch.zeros((), dtype=torch.int64, device=device))


def counter_zero_like(c: Counter64) -> Counter64:
    return Counter64(torch.zeros_like(c.value))


def counter_add(c: Counter64, n) -> Counter64:
    """``c + n`` for a non-negative delta (int or integer tensor)."""
    if isinstance(n, torch.Tensor):
        n = n.to(torch.int64)
    return Counter64(c.value + n)


def counter_scaled_add(c: Counter64, other: Counter64, scale: int) -> Counter64:
    """``c + other * scale`` for a small static non-negative int ``scale``
    (the reference's bound, kept so the two accept the same inputs)."""
    scale = int(scale)
    if not 0 <= scale < 64:
        raise ValueError(f"scale must be a small non-negative int "
                         f"(0 <= scale < 64), got {scale!r}")
    return Counter64(c.value + other.value * scale)


# Which collector each policy lane's decision input comes from (the prefetch
# lane runs on compiler hints, not a collector).
LANE_COLLECTOR: Dict[str, Optional[str]] = {
    "hmu_oracle": "hmu",
    "reactive_watermark": "hmu",
    "proactive_ewma": "hmu",
    "nb_two_touch": "nb",
    "hinted": "pebs",
    "prefetch": None,
}


class FaultModel:
    """Placeholder for the reference's fault model; not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "repro_torch.faults.FaultModel: fault injection is not ported "
            "yet (ROADMAP Queue 1, item 10)")


class Hardening:
    """Placeholder for the reference's hardening config; not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "repro_torch.faults.Hardening: degradation-aware hardening is "
            "not ported yet (ROADMAP Queue 1, item 10)")
