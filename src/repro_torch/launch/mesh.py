"""Device meshes for the sharded telemetry state (PyTorch port of
``repro/launch/mesh.py``).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the
default process group, which the CALLER initialises, as ``torchrun`` would
(``torch.distributed.init_process_group`` with its rank, world size and a
store): this module never starts one.  One rank drives one device; on the
CPU the group is ``gloo``, on the card ``nccl`` with one rank per GPU.

    torchrun --nproc-per-node 2 my_run.py      # each rank, in my_run.py:
    dist.init_process_group("gloo")
    mesh = make_telemetry_mesh(device="cpu")
    run_online(..., mesh=mesh, device="cpu")

:func:`make_production_mesh` is the reference's production shape, one pod
of 16 x 16 or two of them; its caller is the dry run (``launch.dryrun``),
which builds it over a fake process group of that many ranks.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..kernels.dispatch import resolve_device

__all__ = ["current_mesh", "make_mesh", "make_production_mesh",
           "make_telemetry_mesh", "use_mesh"]

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)


def make_mesh(shape: Sequence[int], axes: Sequence[str], device="cuda"):
    """A mesh of ``shape`` named ``axes`` over ranks ``0 .. prod(shape) -
    1`` of the initialised default group, on ``device``'s type (default
    ``"cuda"``: raises without a CUDA device).  Every rank of the group
    calls it, also a rank outside the mesh."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process "
                           "group: call torch.distributed."
                           "init_process_group first (torchrun does)")
    n = math.prod(shape)
    if not 1 <= n <= dist.get_world_size():
        raise ValueError(f"a mesh of {n} ranks does not fit the "
                         f"{dist.get_world_size()}-rank process group")
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The reference's production mesh over the default group: one pod
    (16, 16) over ("data", "model"), or two (2, 16, 16) over ("pod",
    "data", "model").  "pod" is the outer data-parallel axis, "data" FSDP
    and batch, "model" tensor and expert parallel.  Raises ``ValueError``
    when the group has fewer ranks than the mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_telemetry_mesh(n_devices: Optional[int] = None,
                        axis: str = "blocks", device="cuda"):
    """1-D mesh for memory-side telemetry: per-block state (collector
    histograms, lane placements) shards over ``axis``.  ``n_devices``
    defaults to the world size of the default group."""
    if n_devices is None:
        if not dist.is_initialized():
            raise RuntimeError("make_telemetry_mesh needs an initialised "
                               "default process group")
        n_devices = dist.get_world_size()
    return make_mesh((int(n_devices),), (axis,), device=device)


@contextlib.contextmanager
def use_mesh(mesh):
    """Ambient-mesh context: :func:`current_mesh` returns ``mesh`` inside
    the block (nestable)."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    """The mesh of the innermost :func:`use_mesh` block, or ``None``."""
    return _MESH.get()
