"""Fault models: what can go wrong with a telemetry collector (PyTorch port
of ``repro/faults/model.py``).

* :class:`FaultModel` — fault knobs plus the mutable fault state (the
  Threefry key, drop/reset/stall counters), injected on the device inside
  the observe path (``core.telemetry``).  A default-constructed model is
  *neutral*: every knob at its no-op value, records identical to running
  with no model at all.  Its draws are the reference's, bit for bit
  (:mod:`repro_torch.faults.prng`), so a faulty run equals the reference's
  too.
* :class:`Hardening` — the degradation-aware runtime config read by
  ``core.runtime``: demotion hysteresis, per-lane collector fallbacks, and
  the quality floor/smoothing that drive the branchless input swap.
* :class:`Counter64` — an exact scalar event counter.  The reference carries
  it as a hi/lo int32 pair (``value == hi * 2**CARRY_BITS + lo``) because
  JAX runs with ``x64`` off; PyTorch has int64 on every device, so the port
  holds the value in one int64 device scalar and exposes ``hi``/``lo`` for
  the converters.  Reads recombine to the same exact value.

Nothing here imports ``repro_torch.core``: ``core.telemetry`` injects these
models, so the package stays a leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import prng

__all__ = [
    "CARRY_BASE", "CARRY_BITS", "COLLECTORS", "Counter64", "FaultModel",
    "Hardening", "INT32_MAX", "LANE_COLLECTOR", "collector_for_lane",
    "counter_add", "counter_init", "counter_scaled_add", "counter_zero_like",
]

# Collector order used everywhere a (3,)-shaped fault/quality array appears.
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


# ==========================================================  the fault model
def _rate_leaf(p, n_blocks: Optional[int], name: str) -> torch.Tensor:
    """Probability knob as a float32 tensor: scalar, or per-block for
    per-tenant fault profiles (``FaultModel.for_segments``)."""
    arr = np.asarray(p, np.float32)
    if arr.ndim not in (0, 1):
        raise ValueError(f"{name} must be a scalar or (n_blocks,) array, "
                         f"got shape {arr.shape}")
    if arr.ndim == 1 and n_blocks is not None and arr.shape[0] != n_blocks:
        raise ValueError(f"{name} per-block array has {arr.shape[0]} entries, "
                         f"expected n_blocks={n_blocks}")
    if arr.size and (arr.min() < 0.0 or arr.max() > 1.0):
        raise ValueError(f"{name} is a probability and must lie in [0, 1], "
                         f"got range [{arr.min()}, {arr.max()}]")
    return torch.from_numpy(np.array(arr))


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Collector fault knobs + mutable fault state, injected on the device.

    Knobs (tensors, so a sweep changes values, never code paths):

    * ``hmu_counter_max`` — HMU counters saturate at this value (scalar or
      per-block int32); ``2**bits - 1`` for a ``bits``-wide counter, int32
      max is the neutral value;
    * ``pebs_drop_p`` — each would-be PEBS sample is lost with this
      probability (scalar or per-block float32);
    * ``reset_p`` — (3,) per-collector probability, once per epoch, that
      the collector's cumulative state resets to empty (drain races);
    * ``nb_stall_p`` — per-batch probability the NB scanner makes no
      progress.

    Static: ``stale_epochs`` (estimates are served from a ring this many
    epochs deep) and ``seed``.

    Mutable state, replaced by the observe path: the Threefry ``key`` ((2,)
    int64 words), ``pebs_dropped`` (exact :class:`Counter64`), per-collector
    ``resets`` and ``nb_stalls``.  :meth:`create` builds the model on the
    CPU; a runtime takes a private copy on its own device (:meth:`to`).
    """
    hmu_counter_max: torch.Tensor    # () or (n_blocks,) int32 saturation cap
    pebs_drop_p: torch.Tensor        # () or (n_blocks,) float32
    reset_p: torch.Tensor            # (3,) float32, COLLECTORS order
    nb_stall_p: torch.Tensor         # () float32
    key: torch.Tensor                # (2,) int64 Threefry key words
    pebs_dropped: Counter64          # samples lost to drops
    resets: torch.Tensor             # (3,) int32 resets applied so far
    nb_stalls: torch.Tensor          # () int32 stalled scanner ticks
    stale_epochs: int = 0
    seed: int = 0

    @classmethod
    def create(
        cls,
        hmu_counter_bits: int = 31,
        pebs_drop_p=0.0,
        reset_p=0.0,
        nb_stall_p: float = 0.0,
        stale_epochs: int = 0,
        seed: int = 0,
        n_blocks: Optional[int] = None,
        hmu_counter_max=None,
    ) -> "FaultModel":
        """Build a model from human-sized knobs; every default is the
        neutral no-op value.  ``reset_p`` is a scalar (one rate for all
        three collectors) or a 3-sequence in :data:`COLLECTORS` order;
        ``pebs_drop_p`` and ``hmu_counter_max`` may be per-block arrays
        (pass ``n_blocks`` to check their length)."""
        if hmu_counter_max is None:
            bits = int(hmu_counter_bits)
            if not 1 <= bits <= 31:
                raise ValueError(f"hmu_counter_bits must be in [1, 31], "
                                 f"got {hmu_counter_bits!r}")
            hmu_counter_max = (1 << bits) - 1
        cap = np.asarray(hmu_counter_max).astype(np.int32)
        if cap.ndim == 1 and n_blocks is not None and cap.shape[0] != n_blocks:
            raise ValueError(f"hmu_counter_max per-block array has "
                             f"{cap.shape[0]} entries, expected {n_blocks}")
        rp = np.asarray(reset_p, np.float32)
        if rp.ndim == 0:
            rp = np.full((3,), rp, np.float32)
        if rp.shape != (3,):
            raise ValueError(f"reset_p must be a scalar or one rate per "
                             f"collector {COLLECTORS}, got shape {rp.shape}")
        stale = int(stale_epochs)
        if stale < 0:
            raise ValueError(f"stale_epochs must be >= 0, got {stale_epochs!r}")
        return cls(
            hmu_counter_max=torch.from_numpy(np.array(cap)),
            pebs_drop_p=_rate_leaf(pebs_drop_p, n_blocks, "pebs_drop_p"),
            reset_p=torch.from_numpy(np.array(rp)),
            nb_stall_p=torch.tensor(float(nb_stall_p), dtype=torch.float32),
            key=prng.prng_key(int(seed)),
            pebs_dropped=counter_init("cpu"),
            resets=torch.zeros((3,), dtype=torch.int32),
            nb_stalls=torch.zeros((), dtype=torch.int32),
            stale_epochs=stale,
            seed=int(seed),
        )

    @classmethod
    def for_segments(
        cls,
        offsets: Sequence[int],
        profiles: Sequence[Optional[dict]],
        **global_kwargs,
    ) -> "FaultModel":
        """Per-segment fault profile over one shared block space (the
        fleet's per-tenant degradation).  ``offsets`` are the cumulative
        segment bounds (length T+1, as ``runtime.Tenancy``); ``profiles[t]``
        sets the per-block knobs of segment ``t`` (``pebs_drop_p``,
        ``hmu_counter_bits`` / ``hmu_counter_max``) or is None for a healthy
        segment.  Collector-wide knobs (``reset_p``, ``nb_stall_p``,
        ``stale_epochs``, ``seed``) come in through ``global_kwargs``."""
        offsets = tuple(int(o) for o in offsets)
        if len(offsets) != len(profiles) + 1:
            raise ValueError(f"need len(offsets) == len(profiles) + 1, got "
                             f"{len(offsets)} offsets for {len(profiles)} "
                             f"profiles")
        n_blocks = offsets[-1]
        drop_p = np.zeros((n_blocks,), np.float32)
        cap = np.full((n_blocks,), INT32_MAX, np.int32)
        per_block_keys = {"pebs_drop_p", "hmu_counter_bits", "hmu_counter_max"}
        for t, prof in enumerate(profiles):
            if prof is None:
                continue
            unknown = set(prof) - per_block_keys
            if unknown:
                raise ValueError(
                    f"segment profile {t} has non-per-block knobs "
                    f"{sorted(unknown)}; collector-wide knobs (reset_p, "
                    f"nb_stall_p, stale_epochs, seed) are global kwargs")
            sl = slice(offsets[t], offsets[t + 1])
            if "pebs_drop_p" in prof:
                drop_p[sl] = float(prof["pebs_drop_p"])
            if "hmu_counter_max" in prof:
                cap[sl] = int(prof["hmu_counter_max"])
            elif "hmu_counter_bits" in prof:
                cap[sl] = (1 << int(prof["hmu_counter_bits"])) - 1
        return cls.create(hmu_counter_max=cap, pebs_drop_p=drop_p,
                          n_blocks=n_blocks, **global_kwargs)

    def to(self, device) -> "FaultModel":
        """A private copy of every tensor on ``device`` (the runtime's own:
        its state is replaced epoch by epoch, never shared with the
        caller's model)."""
        device = torch.device(device)

        def copy(t: torch.Tensor) -> torch.Tensor:
            if t.device.type == "cpu" and device.type == "cuda":
                # through pinned memory: a pageable upload would stall the
                # host (pin_memory() is itself the copy)
                return t.pin_memory().to(device, non_blocking=True)
            return t.to(device=device, copy=True)

        return dataclasses.replace(
            self, hmu_counter_max=copy(self.hmu_counter_max),
            pebs_drop_p=copy(self.pebs_drop_p), reset_p=copy(self.reset_p),
            nb_stall_p=copy(self.nb_stall_p), key=copy(self.key),
            pebs_dropped=Counter64(copy(self.pebs_dropped.value)),
            resets=copy(self.resets), nb_stalls=copy(self.nb_stalls))


# ======================================================  hardening config
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


def collector_for_lane(lane: str) -> Optional[str]:
    """The collector feeding ``lane``'s decisions (``None`` for lanes that
    consume no telemetry, e.g. ``prefetch``)."""
    return LANE_COLLECTOR.get(lane)


class Hardening(NamedTuple):
    """Degradation-aware runtime config (static, part of the epoch step's
    config).

    * ``demote_hysteresis`` — a resident block must look cold for this many
      consecutive epochs before watermark demotion frees it (H=1 is the
      unhardened behaviour);
    * ``fallback`` — ``(lane, collector)`` pairs: when the lane's primary
      collector's smoothed quality drops below ``quality_floor``, the lane's
      decision input is swapped — by ``torch.where`` on the quality scalar,
      never a host branch — to the named collector's estimate;
    * ``quality_floor`` / ``quality_beta`` — the swap threshold and the
      EWMA weight of a new quality observation.

    Use :meth:`make` to build from a ``{lane: collector}`` dict.
    """
    demote_hysteresis: int = 1
    fallback: Tuple[Tuple[str, str], ...] = ()
    quality_floor: float = 0.5
    quality_beta: float = 0.5

    @classmethod
    def make(cls, fallback: Optional[Dict[str, str]] = None,
             demote_hysteresis: int = 1, quality_floor: float = 0.5,
             quality_beta: float = 0.5) -> "Hardening":
        items = (fallback.items() if isinstance(fallback, dict)
                 else (fallback or ()))
        pairs = tuple(sorted(dict(items).items()))
        h = cls(demote_hysteresis=int(demote_hysteresis), fallback=pairs,
                quality_floor=float(quality_floor),
                quality_beta=float(quality_beta))
        h.validate()
        return h

    def validate(self) -> None:
        if self.demote_hysteresis < 1:
            raise ValueError(f"demote_hysteresis must be >= 1, got "
                             f"{self.demote_hysteresis!r}")
        if not 0.0 <= self.quality_floor <= 1.0:
            raise ValueError(f"quality_floor must be in [0, 1], got "
                             f"{self.quality_floor!r}")
        if not 0.0 < self.quality_beta <= 1.0:
            raise ValueError(f"quality_beta must be in (0, 1], got "
                             f"{self.quality_beta!r}")
        for lane, col in self.fallback:
            if lane not in LANE_COLLECTOR:
                raise ValueError(f"unknown fallback lane {lane!r}; choose "
                                 f"from {sorted(LANE_COLLECTOR)}")
            if LANE_COLLECTOR[lane] is None:
                raise ValueError(f"lane {lane!r} runs on compiler hints, "
                                 f"not a collector — nothing to fall back "
                                 f"from")
            if col not in COLLECTORS:
                raise ValueError(f"unknown fallback collector {col!r}; "
                                 f"choose from {COLLECTORS}")
            if col == LANE_COLLECTOR[lane]:
                raise ValueError(f"lane {lane!r} already reads {col!r}; a "
                                 f"fallback must name a different collector")
