"""Sharded telemetry state on the port: ``EpochRuntime(mesh=)`` through
``run_scenario`` / ``run_fleet`` at world sizes 2, 3 and 4 over gloo,
against ``repro``'s UNSHARDED run of the same inputs.

The reference defines a sharded run to equal the single-device run byte
for byte (``tests/test_runtime.py``, ``test_pipelined.py``,
``test_faults.py`` and ``test_fleet.py``'s sharded tests, which fail on
this jax); those four cases are mirrored here: the DLRM phase-shift run
with hints at K 1 and 3 over 2 and 4 ranks, a neutral fault model at K 2
over 4, the 2-tenant weighted fleet over 2, and one uneven split (SMALL's
5,000 pages over 3 ranks) with every fault and the hardening on.

One spawn of 4 gloo ranks (``tests/_torch_mesh_worker.py``, which imports
only ``repro_torch``) serves the module; it runs while this process
computes the reference's JSON.  Each rank also reports its record pulls,
its dispatches and the collectives of every epoch.

Tolerance: exact — the trajectories, summaries and tenant rows compare as
JSON text."""
import dataclasses
import json
import multiprocessing
import os

import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402
_torch_threads.limit()

import _torch_mesh_worker as mw  # noqa: E402
from repro.dlrm import datagen as jdata  # noqa: E402
from repro.faults import FaultModel as JFaultModel  # noqa: E402
from repro.fleet import FleetScenario as JFleet  # noqa: E402
from repro.fleet import TenantSpec as JTenant  # noqa: E402
from repro.fleet import run_fleet as jrun_fleet  # noqa: E402
from repro.scenarios import DLRMScenario as JDLRM  # noqa: E402
from repro.scenarios import MmapBenchScenario as JMmap  # noqa: E402
from repro.scenarios import run_scenario as jrun_scenario  # noqa: E402

J_SPEC = dataclasses.replace(jdata.SMALL, lookups_per_batch=8_000)


class _Ranks:
    """The spawned ranks: started once, joined on first read."""

    def __init__(self, tmp):
        self.out = str(tmp)
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=mw.worker,
                                  args=(r, str(tmp / "store"), self.out))
                      for r in range(mw.N_RANKS)]
        for p in self.procs:
            p.start()
        self.joined = False

    def results(self, case: str, world: int):
        if not self.joined:
            for p in self.procs:
                p.join(timeout=300)
            for p in self.procs:
                if p.is_alive():
                    p.terminate()
            self.joined = True
        errors = [f for f in os.listdir(self.out) if f.endswith(".error")]
        for name in errors:
            with open(os.path.join(self.out, name)) as f:
                print(name, f.read())
        assert not errors, errors
        got = []
        for r in range(world):
            with open(os.path.join(self.out, f"{case}.{r}.json")) as f:
                got.append(json.load(f))
        return got


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = _Ranks(tmp_path_factory.mktemp("mesh"))
    yield r
    for p in r.procs:
        if p.is_alive():
            p.terminate()


def _reference(kind: str) -> dict:
    """``repro``'s meshless run of the case's inputs (K does not change a
    trajectory; the neutral case's oracle is the run without a model)."""
    if kind == "fleet":
        fleet = JFleet([
            JTenant(JDLRM(spec=J_SPEC, n_epochs=mw.FLEET_EPOCHS,
                          batches_per_epoch=2, shift_at=2),
                    weight=10.0, name="dlrm"),
            JTenant(JMmap(n_epochs=mw.FLEET_EPOCHS, batches_per_epoch=2,
                          accesses_per_batch=8_000),
                    weight=1.0, name="scanner")], **mw.FLEET_KW)
        out = jrun_fleet(fleet, hints=True)
        return {"trajectory": out["trajectory"], "tenants": out["tenants"]}
    sc = JDLRM(spec=J_SPEC, **(mw.FAULT_KW if kind == "faults"
                                else mw.DLRM_KW))
    kw = {}
    if kind == "faults":
        kw = dict(pebs_period=101, hardening=mw.HARD,
                  faults=JFaultModel.create(n_blocks=sc.n_blocks,
                                            **mw.ALL_FAULTS))
    out = jrun_scenario(sc, hints=True, **kw)
    res = {"trajectory": out["trajectory"]}
    if kind != "neutral":
        res["summary"] = out["summary"]
    return res


_REFS = {}


@pytest.mark.parametrize("case", sorted(c for c, (_, kind, _) in
                                         mw.CASES.items() if kind != "lanes"))
def test_sharded_run_byte_identical_to_the_unsharded_reference(ranks, case):
    world, kind, k = mw.CASES[case]
    if kind not in _REFS:
        _REFS[kind] = _reference(kind)
    want = _REFS[kind]
    got = ranks.results(case, world)
    for key, val in want.items():
        text = json.dumps(val, sort_keys=True)
        for r, res in enumerate(got):
            assert json.dumps(res[key], sort_keys=True) == text, (case, r,
                                                                 key)
    n = mw.n_epochs(kind)
    for res in got:
        # ceil(n / K) record pulls, one observe_all + one epoch_step an
        # epoch, and the same collectives in every epoch (none between)
        assert res["pulls"] == res["expected_pulls"]
        assert res["observe_all"] == res["epoch_step"] == n
        per = res["epoch_collectives"]
        assert len(per) == n and all(p == per[0] for p in per), per
        assert per[0]["all_gather"] >= 1 and per[0]["all_reduce"] >= 1
        assert all(not any(d.values()) for _, d in res["other_collectives"])
    # the ranks agree on the collectives too
    assert all(res["epoch_collectives"] == got[0]["epoch_collectives"]
               for res in got)


# ---------------------------------------------- the mesh helpers, one rank
@pytest.fixture
def one_rank(tmp_path):
    """A 1-rank gloo default group in this process, torn down after."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_split_rule_and_the_integer_only_reduce():
    from repro_torch.core import shard
    assert [shard.split(5_000, 3, r) for r in range(3)] == [
        (0, 1_667), (1_667, 3_334), (3_334, 5_000)]
    assert [shard.split(8, 4, r) for r in range(4)] == [
        (0, 2), (2, 4), (4, 6), (6, 8)]
    with pytest.raises(ValueError, match="no block"):
        shard.split(5, 4, 3)        # ranges of 2: rank 3 would start at 6
    sh = shard.BlockShard(lo=0, hi=4, n_global=4, world=1, group=None)
    with pytest.raises(TypeError, match="integer"):
        shard.all_reduce(sh, torch.zeros(3))


def test_mesh_helpers_and_the_runtime_refusals(one_rank, monkeypatch):
    from repro_torch.core.runtime import EpochRuntime
    from repro_torch.launch.mesh import (current_mesh, make_mesh,
                                         make_telemetry_mesh, use_mesh)
    mesh = make_telemetry_mesh(device="cpu")     # the world size: 1
    assert mesh.mesh_dim_names == ("blocks",) and mesh.size() == 1
    assert current_mesh() is None
    with use_mesh(mesh):
        assert current_mesh() is mesh
    assert current_mesh() is None
    with pytest.raises(ValueError, match="does not fit"):
        make_telemetry_mesh(2, device="cpu")
    other = make_mesh((1,), ("data",), device="cpu")
    with pytest.raises(TypeError, match="no axis 'blocks'"):
        EpochRuntime(100, 10, mesh=other, device="cpu")
    EpochRuntime(100, 10, mesh=other, mesh_axis="data", device="cpu")
    with pytest.raises(ValueError, match="fused epoch step"):
        EpochRuntime(100, 10, mesh=mesh, fused=False, device="cpu")
    # no fallback: a mesh on the card without one raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_telemetry_mesh(device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EpochRuntime(100, 10, mesh=mesh)


def test_one_rank_mesh_run_equals_the_meshless_run(one_rank):
    """W 1: the collectives run (each one its own rank's copy) and the
    run is the meshless one byte for byte; without a mesh no collective
    runs at all."""
    from repro_torch.core import shard
    from repro_torch.dlrm import datagen
    from repro_torch.launch.mesh import make_telemetry_mesh
    from repro_torch.scenarios import run_online
    spec = dataclasses.replace(datagen.SMALL, lookups_per_batch=8_000)
    kw = dict(spec=spec, n_epochs=3, batches_per_epoch=2, shift_at=1,
              hints=True, device="cpu")
    before = dict(shard.COLLECTIVES)
    plain = run_online(**kw)
    assert shard.COLLECTIVES == before
    sharded = run_online(mesh=make_telemetry_mesh(1, device="cpu"),
                         sync_every=2, **kw)
    assert shard.COLLECTIVES["all_gather"] > before["all_gather"]
    assert json.dumps(sharded, sort_keys=True) == json.dumps(plain,
                                                             sort_keys=True)


def test_sharded_lane_views_gather_the_whole_block_axis(ranks):
    """``EpochRuntime.lanes`` under a 2-rank mesh (every rank reads it, an
    all-gather) equals the meshless runtime's maps and EWMA bits."""
    want = json.dumps(mw.lanes_run(None), sort_keys=True)
    got = ranks.results("lanes_w2", 2)
    assert [json.dumps({"lanes": r["lanes"]}, sort_keys=True)
            for r in got] == [want, want]
