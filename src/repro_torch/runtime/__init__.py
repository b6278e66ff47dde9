"""Fault-tolerance runtime (the port's copy of ``repro/runtime``)."""
from .failure import Heartbeat, PreemptionGuard, StragglerDetector
from .elastic import ElasticPlanner

__all__ = ["ElasticPlanner", "Heartbeat", "PreemptionGuard",
           "StragglerDetector"]
