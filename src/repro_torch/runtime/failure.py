"""Fault-tolerance runtime: preemption handling + straggler detection (the
port's pure-Python copy of ``repro/runtime/failure.py``).

At 1000+ nodes, preemptions and slow hosts are the steady state, not the
exception.  The trainer composes:

  * ``PreemptionGuard`` — installs SIGTERM/SIGINT handlers that set a flag;
    the training loop checks it each step and performs a final synchronous
    checkpoint before exit.  Combined with the deterministic data pipeline
    (seed, step), restart loses zero batches.
  * ``StragglerDetector`` — per-step wall-time EWMA + deviation; a step (or,
    multi-host, a rank's reported step time) slower than
    ``mean + k * std`` for ``patience`` consecutive steps is flagged.
    Mitigation escalates: log -> within-host retry hint -> exclusion
    proposal handed to the ElasticPlanner.
"""
from __future__ import annotations

import signal
import time
from typing import Callable, List, Optional


class PreemptionGuard:
    def __init__(self, install: bool = True):
        self.preempted = False
        self._prev = {}
        if install:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:      # not main thread (tests)
                    pass

    def _handler(self, signum, frame):
        self.preempted = True

    def trigger(self):                  # for tests / manual drills
        self.preempted = True

    def restore(self):
        for sig, h in self._prev.items():
            signal.signal(sig, h)


class StragglerDetector:
    """EWMA step-time outlier detector with escalation callbacks."""

    def __init__(self, threshold_sigma: float = 3.0, patience: int = 3,
                 alpha: float = 0.05, warmup_steps: int = 10):
        self.threshold = threshold_sigma
        self.patience = patience
        self.alpha = alpha
        self.warmup = warmup_steps
        self.mean: Optional[float] = None
        self.var: float = 0.0
        self.n = 0
        self.consecutive = 0
        self.flagged_steps: List[int] = []

    def observe(self, step: int, step_time_s: float) -> Optional[str]:
        """Feed one step time; returns an escalation action or None."""
        self.n += 1
        if self.mean is None:
            self.mean = step_time_s
            return None
        dev = step_time_s - self.mean
        is_outlier = (
            self.n > self.warmup
            and self.var > 0
            and dev > self.threshold * (self.var ** 0.5)
        )
        # EWMA update (skip outliers so stragglers don't poison the baseline)
        if not is_outlier:
            self.mean += self.alpha * dev
            self.var = (1 - self.alpha) * (self.var + self.alpha * dev * dev)
            self.consecutive = 0
            return None
        self.consecutive += 1
        self.flagged_steps.append(step)
        if self.consecutive >= 2 * self.patience:
            return "propose_exclusion"     # hand to ElasticPlanner
        if self.consecutive >= self.patience:
            return "retry_host"            # within-host mitigation
        return "log"


class Heartbeat:
    """Host-liveness tracking (coordinator side).  Hosts report
    (host_id, time); hosts silent past ``timeout_s`` are dead."""

    def __init__(self, timeout_s: float = 60.0):
        self.timeout = timeout_s
        self.last_seen: dict = {}

    def beat(self, host_id: str, now: Optional[float] = None):
        self.last_seen[host_id] = now if now is not None else time.time()

    def dead_hosts(self, now: Optional[float] = None) -> List[str]:
        now = now if now is not None else time.time()
        return [h for h, t in self.last_seen.items() if now - t > self.timeout]
