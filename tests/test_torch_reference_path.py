"""The per-lane reference path (``EpochRuntime(fused=False)``) and the eager
``hinted`` / ``prefetch`` policies of the port against the reference's.

Every case runs the same stream through ``repro``'s ``fused=False`` and the
port's on the CPU: trajectories compare as JSON text byte for byte, final
placements and per-tenant rows with ``==``, and the reference path's
``DISPATCH_COUNTS["reference"]`` (pulls, decisions, evictions) must be
equal.  Where the reference's own tests hold its fused path against its
reference path (``tests/test_runtime.py``, ``test_pipelined.py``,
``test_scenarios.py``, ``test_fleet.py``), the port's fused path must equal
the port's reference path too.

The reference path calls its policies outside ``jit``, so every float op
rounds on its own; the port's ``policy.hinted_score_eager`` keeps that form
(a true division, then the products, then the sum), which differs in the
last bit from the fused step's contracted form on some inputs.

Tolerance: exact everywhere."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402
_torch_threads.limit()
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import policy as jpol  # noqa: E402
from repro.core import runtime as jrt  # noqa: E402
from repro.dlrm import datagen as jdata  # noqa: E402
from repro.fleet import FleetScenario as JFleet  # noqa: E402
from repro.fleet import TenantSpec as JTenant  # noqa: E402
from repro.fleet import run_fleet as jrun_fleet  # noqa: E402
from repro.hints import HintPipeline as JHints  # noqa: E402
from repro.scenarios import DLRMScenario as JDLRM  # noqa: E402
from repro.scenarios import KVCacheScenario as JKV  # noqa: E402
from repro.scenarios import MmapBenchScenario as JMmap  # noqa: E402
from repro.scenarios import MoEExpertScenario as JMoE  # noqa: E402
from repro.scenarios import run_scenario as jrun  # noqa: E402
from repro_torch.core import costmodel as tcost  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.core import runtime as trt  # noqa: E402
from repro_torch.core.runtime import ALL_POLICIES, EpochRuntime  # noqa: E402
from repro_torch.dlrm import datagen as tdata  # noqa: E402
from repro_torch.fleet import FleetScenario, TenantSpec, run_fleet  # noqa: E402
from repro_torch.hints import HintPipeline as THints  # noqa: E402
from repro_torch.scenarios import (DLRMScenario, MmapBenchScenario,  # noqa: E402
                                   run_scenario)

J_SPEC = dataclasses.replace(jdata.SMALL, lookups_per_batch=10_000)
T_SPEC = dataclasses.replace(tdata.SMALL, lookups_per_batch=10_000)


class Replay:
    """A reference scenario's epochs (made once) and geometry, replayed as
    numpy into the port: the stream seam of the model-backed scenarios."""

    def __init__(self, ref):
        self._epochs = [np.asarray(e) for e in ref.epochs()]
        for attr in ("name", "n_blocks", "k_hot", "bytes_per_access",
                     "block_bytes", "pebs_period", "shift_at", "n_epochs",
                     "batches_per_epoch", "nb_scan_rate"):
            setattr(self, attr, getattr(ref, attr))
        for attr in ("batch_len", "accesses_per_batch"):   # fleet weighting
            if hasattr(ref, attr):
                setattr(self, attr, getattr(ref, attr))
        self.system = tcost.TPU_V5E_SYSTEM     # both model scenarios
        assert dataclasses.asdict(self.system) == dataclasses.asdict(
            ref.system)

    def epochs(self):
        return iter(self._epochs)

    def hint_layout(self):
        return None


def placements(rt) -> dict:
    return {name: (np.array(lane.slot_to_block), np.array(lane.block_to_slot))
            for name, lane in rt.lanes.items()}


def assert_same_placements(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for name in a:
        np.testing.assert_array_equal(a[name][0], b[name][0], err_msg=name)
        np.testing.assert_array_equal(a[name][1], b[name][1], err_msg=name)


# ------------------------------------------- the phase-shift runtime cases
def _phase_shift(pkg: str, fused: bool, hints: bool = False, **kw):
    """``tests/test_runtime.py``'s phase-shift run in either package:
    (runtime, trajectory JSON, the run's dispatch counts)."""
    j = pkg == "repro"
    rt_cls, dg, spec = ((jrt.EpochRuntime, jdata, J_SPEC) if j else
                        (EpochRuntime, tdata, T_SPEC))
    n = spec.n_pages
    extra = {} if j else {"device": "cpu"}
    if hints:
        extra["hints"] = (JHints if j else THints).for_dlrm(spec, seed=0)
    counting = jrt.counting if j else trt.counting
    with counting() as c:
        rt = rt_cls(n, fused=fused, policies=ALL_POLICIES,
                    bytes_per_access=spec.row_bytes,
                    block_bytes=spec.page_bytes, **kw, **extra)
        traj = rt.run(dg.phase_shift_epochs(
            spec, n_epochs=6, batches_per_epoch=3, shift_at=3,
            rotate_by=n // 2, seed=0))
        counts = dict(c.dispatch.items())
    return rt, traj.to_json(), counts


_HINTS = np.random.default_rng(7)
_HINT_RANK = (_HINTS.random(J_SPEC.n_pages)
              * (_HINTS.random(J_SPEC.n_pages) < 0.1)).astype(np.float32)
PHASE_SHIFT_CASES = {
    # tests/test_runtime.py:172
    "defaults": (dict(k_hot=250, pebs_period=401,
                      nb_scan_rate=J_SPEC.n_pages // 4), False),
    # tests/test_runtime.py:193
    "hints_and_rate_limit": (dict(k_hot=200, pebs_period=211,
                                  nb_scan_rate=J_SPEC.n_pages // 3,
                                  hint_rank=_HINT_RANK, hint_weight=0.4,
                                  nb_rate_limit=37, ewma_alpha=0.3), False),
    # the same at other blend weights (the eager EWMA and hinted score)
    "alpha_0.7_weight_0.6": (dict(k_hot=200, pebs_period=211,
                                  nb_scan_rate=J_SPEC.n_pages // 3,
                                  hint_rank=_HINT_RANK, hint_weight=0.6,
                                  ewma_alpha=0.7), False),
    # tests/test_runtime.py:324
    "hint_pipeline": (dict(k_hot=250, pebs_period=401,
                           nb_scan_rate=J_SPEC.n_pages // 4), True),
}


@pytest.mark.parametrize("case", sorted(PHASE_SHIFT_CASES))
def test_phase_shift_reference_path_equals_repro(case):
    """The port's fused=False == repro's fused=False: every record of every
    lane, the final placements and the EWMA state, with equal dispatch
    counts (``reference`` among them); and the port's fused path equals
    its reference path, as the reference's tests hold for its own."""
    kw, hints = PHASE_SHIFT_CASES[case]
    j_rt, j_json, j_counts = _phase_shift("repro", False, hints, **kw)
    t_rt, t_json, t_counts = _phase_shift("torch", False, hints, **kw)
    assert t_json == j_json
    for kind in ("observe_all", "epoch_step", "reference", "hint_refresh",
                 "record_sync"):
        assert t_counts[kind] == j_counts[kind], kind
    assert t_counts["reference"] > 0 and t_counts["epoch_step"] == 0
    assert_same_placements(placements(t_rt), placements(j_rt))
    np.testing.assert_array_equal(t_rt.lanes["proactive_ewma"].pred,
                                  np.asarray(j_rt.lanes["proactive_ewma"].pred))
    f_rt, f_json, _ = _phase_shift("torch", True, hints, **kw)
    assert f_json == t_json
    assert_same_placements(placements(f_rt), placements(t_rt))


# ------------------------------------ tests/test_pipelined.py, the oracle
def _pipelined_epochs(n_epochs: int, n_blocks: int = 400, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.zipf(1.3, size=(3, 2_000)).astype(np.int64) % n_blocks
            for _ in range(n_epochs)]


@pytest.fixture(scope="module")
def pipelined_oracle():
    """The reference's synchronous oracle on test_pipelined's runtime
    (400 blocks, 40 fast, 7 epochs)."""
    epochs = [e.astype(np.int32) for e in _pipelined_epochs(7)]
    rt = jrt.EpochRuntime(400, 40, fused=False, pebs_period=97,
                          nb_scan_rate=100)
    traj = rt.run(iter(epochs))
    return epochs, traj.to_json(), placements(rt)


@pytest.mark.parametrize("sync_every", [1, 4, 7])
def test_sync_every_equals_the_reference_path_oracle(pipelined_oracle,
                                                     sync_every):
    """``tests/test_pipelined.py:76``: K in {1, 4, 7} reproduce the
    synchronous oracle; here the port's oracle equals repro's and the
    port's fused run at every K equals the port's oracle."""
    epochs, j_json, j_lanes = pipelined_oracle
    ref = EpochRuntime(400, 40, fused=False, pebs_period=97,
                       nb_scan_rate=100, device="cpu")
    t_json = ref.run(iter(epochs)).to_json()
    assert t_json == j_json
    assert_same_placements(placements(ref), j_lanes)
    rt = EpochRuntime(400, 40, sync_every=sync_every, pebs_period=97,
                      nb_scan_rate=100, device="cpu")
    assert rt.run(iter(epochs)).to_json() == t_json
    assert_same_placements(placements(rt), placements(ref))


def test_reference_path_refuses_what_the_reference_refuses():
    """``tests/test_pipelined.py:101`` and the fault guard: the reference
    path takes sync_every 1, no fault model and no mesh (refused before
    the mesh's type is looked at)."""
    with pytest.raises(ValueError, match="reference"):
        EpochRuntime(400, 40, fused=False, sync_every=2, device="cpu")
    with pytest.raises(ValueError, match="sync_every"):
        EpochRuntime(400, 40, sync_every=0, device="cpu")
    from repro_torch.faults import FaultModel
    with pytest.raises(ValueError, match="fault-free bit-identity oracle"):
        EpochRuntime(400, 40, fused=False, faults=FaultModel.create(),
                     device="cpu")
    with pytest.raises(ValueError, match="fault-free bit-identity oracle"):
        EpochRuntime(400, 40, fused=False,
                     hardening={"fallback": {"hmu_oracle": "pebs"}},
                     device="cpu")
    with pytest.raises(ValueError, match="requires the fused epoch step"):
        EpochRuntime(400, 40, fused=False, mesh=object(), device="cpu")


def test_reference_path_manual_steps_and_views():
    """``step`` returns the epoch's records, ``flush`` is a no-op,
    ``pending_migration_s`` reads the prefetch lane's last boundary, the
    lane views are the live host state, and ``block_until_ready``
    returns the runtime."""
    epochs = _pipelined_epochs(3)
    rt = EpochRuntime(400, 40, fused=False, pebs_period=97,
                      nb_scan_rate=100, device="cpu")
    for e in epochs:
        recs = rt.step(e)
        assert set(recs) == set(ALL_POLICIES)
    assert rt.flush() == {}
    assert rt.block_until_ready() is rt
    assert rt.pending_migration_s == 0.0            # no lookahead: no moves
    lane = rt.lanes["hmu_oracle"]
    assert lane is rt.lanes["hmu_oracle"]
    res = lane.resident_ids()
    np.testing.assert_array_equal(lane.block_to_slot[res],
                                  np.nonzero(lane.slot_to_block >= 0)[0])
    assert [r.epoch for r in rt.records["hinted"]] == [0, 1, 2]


def test_set_hint_ranks_keeps_host_arrays_and_counts():
    rt = EpochRuntime(400, 40, fused=False, device="cpu")
    h = np.linspace(0, 1, 400, dtype=np.float32)
    with trt.counting() as c:
        rt.set_hint_ranks(h, None)
        rt.set_hint_ranks(rt.hint_rank, None)       # same object: skipped
    assert c.dispatch["hint_refresh"] == 1
    np.testing.assert_array_equal(rt.hint_rank, h)
    assert not hasattr(rt, "_state")


def test_reference_step_span():
    """The reference path records its ``reference_step`` span (and no
    fused span) under a tracer."""
    from repro_torch.obs import trace as obs_trace
    epochs = _pipelined_epochs(2)
    rt = EpochRuntime(400, 40, fused=False, device="cpu")
    with obs_trace.tracing() as tr:
        rt.run(iter(epochs))
    names = [s.name for s in tr.spans]
    assert names.count("reference_step") == 2
    assert "epoch_step" not in names and "record_sync" not in names


# ------------------------------------------------ the eager policies
def _tied_keys(n: int = 300, seed: int = 0) -> np.ndarray:
    """Counts with heavy ties (few distinct values) and many zeros."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4, n) * (rng.random(n) < 0.6)).astype(np.int32)


def _plan(p) -> np.ndarray:
    return np.asarray(p.promote).astype(np.int64)


@pytest.mark.parametrize("k", [1, 17, 120, 300])
def test_eager_policies_equal_repro_on_tied_keys(k):
    """Every eager policy's plan equals repro's, ties lowest index first
    (``lax.top_k``), including the hinted lane's stable double argsort."""
    est = _tied_keys()
    rng = np.random.default_rng(1)
    hint = (rng.integers(0, 3, est.size) / 2).astype(np.float32)
    look = (rng.integers(0, 3, est.size) / 4).astype(np.float32)
    je, te = jnp.asarray(est), torch.from_numpy(est)
    pairs = [
        (jpol.oracle_top_k(je, k), tpol.oracle_top_k(te, k)),
        (jpol.nb_two_touch(je, k, 9), tpol.nb_two_touch(te, k, 9)),
        (jpol.reactive_watermark(je, 2, jnp.asarray(11), k),
         tpol.reactive_watermark(te, 2, 11, k)),
        (jpol.hinted(je, jnp.asarray(hint), k, 0.25),
         tpol.hinted(te, torch.from_numpy(hint), k, 0.25)),
        (jpol.prefetch(jnp.asarray(look), k),
         tpol.prefetch(torch.from_numpy(look), k)),
    ]
    for i, (jp, tp) in enumerate(pairs):
        np.testing.assert_array_equal(_plan(tp), _plan(jp), err_msg=str(i))


@pytest.mark.parametrize("alpha", [0.3, 0.5, 0.7, 0.9])
def test_eager_proactive_ewma_equals_repro(alpha):
    """The eager EWMA rounds each op on its own, at every alpha."""
    rng = np.random.default_rng(2)
    prev = (rng.random(500) * 7).astype(np.float32)
    est = rng.integers(0, 50, 500).astype(np.int32)
    jp, jplan = jpol.proactive_ewma(jnp.asarray(prev),
                                    jnp.asarray(est, jnp.float32), 60, alpha)
    tp, tplan = tpol.proactive_ewma(torch.from_numpy(prev),
                                    torch.from_numpy(est.astype(np.float32)),
                                    60, alpha)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(_plan(tplan), _plan(jplan))


def test_hinted_takes_the_eager_form_where_it_differs_from_jit():
    """On this input repro's eager ``hinted_score`` and its jit form differ
    in the last bit on some elements; the port's eager form equals the
    eager one bit for bit, its fused-step form the jit one."""
    n, w = 4_999, 0.25
    rng = np.random.default_rng(3)
    est = rng.integers(0, 40, n).astype(np.int32)
    hint = rng.random(n).astype(np.float32)
    je = jnp.asarray(est)
    t_rank = jnp.argsort(jnp.argsort(je))
    eager = np.asarray(jpol.hinted_score(je, t_rank, jnp.asarray(hint), w))
    jit = np.asarray(jax.jit(jpol.hinted_score, static_argnums=3)(
        je, t_rank, jnp.asarray(hint), w))
    differ = eager != jit
    assert differ.any()
    te = torch.from_numpy(est)
    tr = tpol.stable_rank(te)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(t_rank))
    got_eager = tpol.hinted_score_eager(te, tr, torch.from_numpy(hint),
                                        w).numpy()
    got_jit = tpol.hinted_score(te, tr, torch.from_numpy(hint), w).numpy()
    np.testing.assert_array_equal(got_eager.view(np.int32),
                                  eager.view(np.int32))
    np.testing.assert_array_equal(got_jit.view(np.int32), jit.view(np.int32))
    assert (got_eager != got_jit).sum() == differ.sum()
    np.testing.assert_array_equal(
        _plan(tpol.hinted(te, torch.from_numpy(hint), 600, w)),
        _plan(jpol.hinted(je, jnp.asarray(hint), 600, w)))


# ------------------------------------- scenarios (tests/test_scenarios.py)
@pytest.fixture(scope="module")
def model_streams():
    """The reference's KV and MoE scenario streams, made once."""
    kv = JKV(batch=2, n_epochs=4, batches_per_epoch=2,
             accesses_per_batch=1_024)
    moe = JMoE(n_epochs=4, batches_per_epoch=2, shift_at=2, batch=2)
    return {"kv_cache": kv, "moe_experts": moe}


@pytest.mark.parametrize("name", ["kv_cache", "moe_experts"])
def test_scenario_reference_path_equals_repro(model_streams, name):
    """``tests/test_scenarios.py:99`` on the port: the model-backed
    streams, hints on, through both paths of both packages."""
    j = model_streams[name]
    with jrt.counting() as jc:
        want = jrun(j, hints=True, fused=False)
    t = Replay(j)
    with trt.counting() as tc:
        got = run_scenario(t, hints=True, fused=False, device="cpu")
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert tc.dispatch["reference"] == jc.dispatch["reference"]
    fused = run_scenario(t, hints=True, device="cpu")
    assert fused["trajectory"] == got["trajectory"]
    assert fused["summary"] == got["summary"]


def test_mmap_scenario_reference_path_equals_repro():
    """``tests/test_fleet.py:109``: the mmap-bench scenario's reference
    path, both packages, and the port's fused run equal to it."""
    kw = dict(n_epochs=4, batches_per_epoch=2, accesses_per_batch=8_000)
    want = jrun(JMmap(**kw), hints=True, fused=False)
    sc = MmapBenchScenario(**kw)
    got = run_scenario(sc, hints=True, fused=False, device="cpu")
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert run_scenario(sc, hints=True, device="cpu")["trajectory"] == \
        got["trajectory"]


# ---------------------------------------- the fleet (tests/test_fleet.py)
MIX_KW = dict(n_epochs=4, batches_per_epoch=2)


def _fleets(moe, capacity):
    jf = JFleet(
        [JTenant(JDLRM(spec=dataclasses.replace(jdata.SMALL,
                                                lookups_per_batch=8_000),
                       shift_at=2, **MIX_KW), weight=10.0, name="dlrm"),
         JTenant(JMmap(accesses_per_batch=8_000, **MIX_KW), weight=1.0,
                 name="scanner"),
         JTenant(moe, weight=1.0, name="moe")],
        k_hot=300, capacity=capacity)
    tf = FleetScenario(
        [TenantSpec(DLRMScenario(spec=dataclasses.replace(
            tdata.SMALL, lookups_per_batch=8_000), shift_at=2, **MIX_KW),
            weight=10.0, name="dlrm"),
         TenantSpec(MmapBenchScenario(accesses_per_batch=8_000, **MIX_KW),
                    weight=1.0, name="scanner"),
         TenantSpec(Replay(moe), weight=1.0, name="moe")],
        k_hot=300, capacity=capacity)
    return jf, tf


@pytest.mark.parametrize("capacity", ["shared", "partition", "weighted"])
def test_fleet_reference_path_equals_repro(model_streams, capacity):
    """``tests/test_fleet.py:226`` on the port: the 3-tenant mix with hints
    (and quotas, where the capacity policy sets them) through the reference
    path of both packages — trajectory JSON, summary and tenant rows — and
    the port's fused run equal to its reference run."""
    moe = model_streams["moe_experts"]
    jf, tf = _fleets(moe, capacity)
    with jrt.counting() as jc:
        want = jrun_fleet(jf, hints=True, fused=False)
    with trt.counting() as tc:
        got = run_fleet(tf, hints=True, fused=False, device="cpu")
    assert json.dumps(got["trajectory"]) == json.dumps(want["trajectory"])
    assert got["summary"] == want["summary"]
    assert got["tenants"] == want["tenants"]
    assert tc.dispatch["reference"] == jc.dispatch["reference"]
    fused = run_fleet(tf, hints=True, device="cpu")
    assert fused["trajectory"] == got["trajectory"]
    assert fused["tenants"] == got["tenants"]


# ------------------------------------------ tests/test_export.py:504
def test_reference_path_exports_too():
    from repro_torch.export import ExportClient, MemorySink, validate_record
    rt = EpochRuntime(400, 40, fused=False,
                      policies=("hmu_oracle", "hinted"), device="cpu")
    sink = MemorySink()
    rt.export = ExportClient(sink, flush_interval_s=0.005)
    try:
        rt.run(iter(_pipelined_epochs(3)))
        rt.export.flush(timeout=30)
        recs = sink.snapshot()
    finally:
        rt.export.close()
    assert len(recs) == 3 * 2
    for rec in recs:
        validate_record(rec)
