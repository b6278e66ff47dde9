"""Worker side of ``tests/test_torch_mesh.py``: one process per rank of a
gloo group, importing only ``repro_torch``.

Every rank builds the 2-, 3- and 4-rank telemetry meshes (subgroups of one
4-rank group: ``new_group`` is collective over the whole group), then runs
each case whose mesh it belongs to and writes ``<case>.<rank>.json`` into
the output directory: the run's JSON, its record pulls and dispatches, and
the collectives of every epoch.  A rank that fails writes
``<case>.<rank>.error`` and leaves the group, so the others fail at their
next collective instead of waiting forever.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import math
import os
import traceback

import numpy as np

N_RANKS = 4
N_SMALL = 5_000                 # datagen.SMALL's pages
# the fault case: every fault on, both per-block leaves per block
PER_BLOCK_DROP = np.random.default_rng(5).uniform(
    0.0, 0.9, N_SMALL).astype(np.float32)
PER_BLOCK_CAP = np.random.default_rng(6).integers(
    2, 64, N_SMALL).astype(np.int32)
ALL_FAULTS = dict(pebs_drop_p=PER_BLOCK_DROP, hmu_counter_max=PER_BLOCK_CAP,
                  reset_p=(0.5, 0.5, 0.5), nb_stall_p=0.5, stale_epochs=1,
                  seed=7)
HARD = dict(fallback={"hmu_oracle": "pebs", "hinted": "hmu",
                      "nb_two_touch": "hmu"}, demote_hysteresis=2)
DLRM_KW = dict(n_epochs=4, batches_per_epoch=2, shift_at=2)
FAULT_KW = dict(n_epochs=6, batches_per_epoch=2, shift_at=3)
FLEET_KW = dict(k_hot=280, capacity="weighted")
FLEET_EPOCHS = 3

# name -> (world size, kind, sync_every)
CASES = {
    "dlrm_k1_w2": (2, "dlrm", 1),
    "dlrm_k3_w2": (2, "dlrm", 3),
    "dlrm_k1_w4": (4, "dlrm", 1),
    "dlrm_k3_w4": (4, "dlrm", 3),
    "neutral_k2_w4": (4, "neutral", 2),
    "fleet_w2": (2, "fleet", 1),
    "faults_k2_w3": (3, "faults", 2),
    "lanes_w2": (2, "lanes", 1),
}


def n_epochs(kind: str) -> int:
    return {"faults": FAULT_KW["n_epochs"],
            "fleet": FLEET_EPOCHS}.get(kind, DLRM_KW["n_epochs"])


def lanes_json(lanes) -> dict:
    """``EpochRuntime.lanes`` as JSON: the maps, and the EWMA's bits."""
    return {name: {"s2b": lane.slot_to_block.tolist(),
                   "b2s": lane.block_to_slot.tolist(),
                   "pred": None if lane.pred is None
                   else lane.pred.view(np.int32).tolist()}
            for name, lane in lanes.items()}


def lanes_run(mesh, epochs_hook=iter, sync_every: int = 1) -> dict:
    """The DLRM case's runtime, driven directly, and its lane views (under
    a mesh, gathered over the whole block axis)."""
    from repro_torch.core.runtime import EpochRuntime
    from repro_torch.dlrm import datagen
    from repro_torch.scenarios import DLRMScenario, build_hints

    sc = DLRMScenario(spec=dataclasses.replace(
        datagen.SMALL, lookups_per_batch=8_000), **DLRM_KW)
    rt = EpochRuntime.for_scenario(sc, hints=build_hints(sc), mesh=mesh,
                                   sync_every=sync_every, device="cpu")
    rt.run(epochs_hook(sc.epochs()))
    return {"lanes": lanes_json(rt.lanes)}


def _run(kind: str, sync_every: int, mesh, epochs_hook):
    from repro_torch.dlrm import datagen
    from repro_torch.faults import FaultModel
    from repro_torch.fleet import FleetScenario, TenantSpec, run_fleet
    from repro_torch.scenarios import (DLRMScenario, MmapBenchScenario,
                                       run_scenario)

    if kind == "lanes":
        return lanes_run(mesh, epochs_hook, sync_every)
    spec = dataclasses.replace(datagen.SMALL, lookups_per_batch=8_000)
    kw = dict(hints=True, mesh=mesh, sync_every=sync_every, device="cpu")
    if kind == "fleet":
        fleet = FleetScenario([
            TenantSpec(DLRMScenario(spec=spec, n_epochs=FLEET_EPOCHS,
                                    batches_per_epoch=2, shift_at=2),
                       weight=10.0, name="dlrm"),
            TenantSpec(MmapBenchScenario(n_epochs=FLEET_EPOCHS,
                                         batches_per_epoch=2,
                                         accesses_per_batch=8_000),
                       weight=1.0, name="scanner")], **FLEET_KW)
        out = run_fleet(fleet, epochs=epochs_hook(fleet.epochs()), **kw)
        return {"trajectory": out["trajectory"], "tenants": out["tenants"]}
    sc = DLRMScenario(spec=spec, **(FAULT_KW if kind == "faults"
                                    else DLRM_KW))
    if kind == "faults":
        kw.update(pebs_period=101, hardening=HARD,
                  faults=FaultModel.create(n_blocks=sc.n_blocks,
                                           **ALL_FAULTS))
    elif kind == "neutral":
        kw.update(faults=FaultModel.create(n_blocks=sc.n_blocks))
    # kind "dlrm" is run_online's packaging: this scenario, no override
    out = run_scenario(sc, epochs=epochs_hook(sc.epochs()), **kw)
    return {"trajectory": out["trajectory"], "summary": out["summary"]}


def run_case(name: str, mesh, rank: int, out_dir: str) -> None:
    from repro_torch.core import runtime, shard

    world, kind, k = CASES[name]
    snaps = []

    def hook(epochs):
        # a snapshot each time the runtime pulls an epoch (and at the end
        # of the stream): the steps done so far and the collectives
        def snap():
            snaps.append((runtime.DISPATCH_COUNTS["epoch_step"],
                          dict(shard.COLLECTIVES)))
        for e in epochs:
            snap()
            yield e
        snap()

    with runtime.counting() as c:
        res = _run(kind, k, mesh, hook)
        snaps.append((runtime.DISPATCH_COUNTS["epoch_step"],
                      dict(shard.COLLECTIVES)))
    per_epoch, between = [], []
    for (s0, c0), (s1, c1) in zip(snaps, snaps[1:]):
        delta = {key: c1[key] - c0[key] for key in c0}
        (per_epoch if s1 - s0 == 1 else between).append(
            (s1 - s0, delta))
    res.update(
        pulls=c.dispatch["record_sync"],
        observe_all=c.dispatch["observe_all"],
        epoch_step=c.dispatch["epoch_step"],
        expected_pulls=math.ceil(n_epochs(kind) / k),
        epoch_collectives=[d for _, d in per_epoch],
        other_collectives=between)
    with open(os.path.join(out_dir, f"{name}.{rank}.json"), "w") as f:
        json.dump(res, f, sort_keys=True)


def worker(rank: int, store_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(store_path, N_RANKS),
                            rank=rank, world_size=N_RANKS,
                            timeout=datetime.timedelta(seconds=120))
    from repro_torch.launch.mesh import make_telemetry_mesh

    meshes = {w: make_telemetry_mesh(w, device="cpu") for w in (2, 3, 4)}
    try:
        for name, (world, _, _) in CASES.items():
            if rank < world:
                run_case(name, meshes[world], rank, out_dir)
    except BaseException:
        with open(os.path.join(out_dir, f"{name}.{rank}.error"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)
    dist.destroy_process_group()
