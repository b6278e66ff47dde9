"""Elastic scaling: re-plan the mesh when the healthy host set changes (the
port's pure-Python copy of ``repro/runtime/elastic.py``).

The checkpoint format is mesh-agnostic (global logical arrays), so elastic
restart = (1) pick the new mesh from surviving hosts, (2) recompute
shardings from the same schema rules, (3) restore onto the new mesh.
This module implements step (1) plus the batch re-split, and validates
divisibility so the restart fails fast (not mid-compile).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    devices_used: int
    grad_accum_factor: int   # extra accumulation to keep global batch fixed


class ElasticPlanner:
    """Chooses (data, model) mesh shapes for the devices that remain.

    Policy: keep the model axis fixed (it encodes the TP/EP layout the
    weights need); shrink the data axis to the largest value that fits the
    surviving device count; recover the lost global batch with gradient
    accumulation so optimization hyperparameters stay valid.
    """

    def __init__(self, model_axis: int, global_batch: int,
                 pod_size: Optional[int] = None):
        self.model_axis = model_axis
        self.global_batch = global_batch
        self.pod_size = pod_size

    def plan(self, healthy_devices: int, baseline_data_axis: int) -> MeshPlan:
        if healthy_devices < self.model_axis:
            raise RuntimeError(
                f"cannot form a model axis of {self.model_axis} from "
                f"{healthy_devices} devices")
        data = healthy_devices // self.model_axis
        # data axis must divide the global batch
        while data > 1 and self.global_batch % data:
            data -= 1
        accum = max(baseline_data_axis // data, 1)
        return MeshPlan(
            shape=(data, self.model_axis),
            axes=("data", "model"),
            devices_used=data * self.model_axis,
            grad_accum_factor=accum,
        )

    def replan_on_failure(self, current: MeshPlan, failed_devices: int
                          ) -> MeshPlan:
        return self.plan(current.devices_used - failed_devices,
                         baseline_data_axis=current.shape[0] *
                         current.grad_accum_factor)
