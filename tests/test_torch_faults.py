"""Degraded telemetry on the port: ``repro_torch.faults`` (the fault model,
the hardening config) and the fault and hardening paths of telemetry, the
runtime, the scenarios and the fleet, against the reference's.

The centre is a small DLRM run by both packages under every fault alone
(counter saturation, PEBS drops at one rate and per block, collector resets,
NB stalls, staleness of one and of two epochs) and all of them together,
each with and without hardening, for two record-pull periods: the
trajectories compare as JSON text, and the collector states, the fault
counters (the Threefry key among them) and the runtime's robustness leaves
compare leaf by leaf after the run; the same whole runs hold the quality
blend at seven betas.  Around it: the pieces (model and hardening
construction and validation), a reference model carried across mid-run, the
reference's own non-sharded fault tests mirrored on the port, the example,
and the fleet with per-tenant profiles against the reference's.

Tolerance: exact everywhere — integer states and counts compare with
``==``, float32 leaves by their bits, records as JSON text (their floats
come from the same float64 host arithmetic over the same integers)."""
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core import runtime as jrt  # noqa: E402
from repro.dlrm import datagen as jdata  # noqa: E402
from repro.faults import FaultModel as JFaultModel  # noqa: E402
from repro.faults import Hardening as JHardening  # noqa: E402
from repro.fleet import run_fleet as jrun_fleet  # noqa: E402
from repro.scenarios import DLRMScenario as JDLRM  # noqa: E402
from repro.scenarios import MoEExpertScenario  # noqa: E402
from repro.scenarios import build_hints as jbuild_hints  # noqa: E402
from repro_torch.convert import (bundle_to_numpy, fault_model_from_numpy,  # noqa: E402
                                 fault_model_to_numpy, fused_state_from_numpy,
                                 hardening_from_fields)
from repro_torch.core import runtime as trt  # noqa: E402
from repro_torch.core import telemetry as tel  # noqa: E402
from repro_torch.core.runtime import ALL_POLICIES, EpochRuntime  # noqa: E402
from repro_torch.dlrm import datagen as tdata  # noqa: E402
from repro_torch.examples import degraded_telemetry  # noqa: E402
from repro_torch.faults import (COLLECTORS, FaultModel, Hardening,  # noqa: E402
                                LANE_COLLECTOR)
from repro_torch.fleet import FleetScenario, TenantSpec, run_fleet  # noqa: E402
from repro_torch.scenarios import DLRMScenario, KVCacheScenario  # noqa: E402
from repro_torch.scenarios import build_hints, run_scenario  # noqa: E402
from test_torch_fleet import MIX_KW, MoEReplay, reference_fleet, small_fleet  # noqa: E402

J_SPEC = dataclasses.replace(jdata.SMALL, lookups_per_batch=8_000)
T_SPEC = dataclasses.replace(tdata.SMALL, lookups_per_batch=8_000)
N_SMALL = T_SPEC.n_pages
SMALL_SPEC = T_SPEC
HARD = dict(fallback={"hmu_oracle": "pebs", "hinted": "hmu",
                      "nb_two_touch": "hmu"}, demote_hysteresis=2)
ALL_FAULTS = dict(pebs_drop_p=0.3, reset_p=(0.5, 0.5, 0.5), nb_stall_p=0.5,
                  hmu_counter_bits=12, stale_epochs=1, seed=7)
PER_BLOCK_DROP = np.random.default_rng(5).uniform(
    0.0, 0.9, N_SMALL).astype(np.float32)
FAULTS = {
    "saturation": dict(hmu_counter_bits=6),
    "drops": dict(pebs_drop_p=0.3, seed=7),
    "per_block_drops": dict(pebs_drop_p=PER_BLOCK_DROP, seed=3),
    "resets": dict(reset_p=(0.5, 0.4, 0.6), seed=7),
    "stalls": dict(nb_stall_p=0.5, seed=2 ** 31 - 1),
    "stale_1": dict(stale_epochs=1),
    "stale_2": dict(stale_epochs=2),
    "all": ALL_FAULTS,
}
# the robustness leaves of _FusedState, compared after every run
ROBUST = ("prev_true", "stale", "quality", "prev_nb", "nb_ewma",
          "cold_streak")


def jax_flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(getattr(p, "name", getattr(p, "key", p)))
                     for p in path): np.asarray(v) for path, v in leaves}


def bits(x: np.ndarray) -> np.ndarray:
    """Floats by their bits, integers as they are."""
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_states_equal(port: EpochRuntime, ref) -> None:
    """Collector states and fault counters (Threefry key included), and
    the runtime's robustness leaves, leaf by leaf."""
    j = jax_flat(ref._state)
    got = bundle_to_numpy(port._state.bundle)
    assert ("faults.key" in got) == (port._state.bundle.faults is not None)
    for key, val in got.items():
        np.testing.assert_array_equal(bits(val), bits(j["bundle." + key]),
                                      err_msg=key)
    for name in ROBUST:
        leaf = getattr(port._state, name)
        assert (leaf is None) == (name not in j), name
        if leaf is not None:
            np.testing.assert_array_equal(bits(leaf.numpy()), bits(j[name]),
                                          err_msg=name)
    if port._state.stale is not None:
        assert port._state.stale_ptr == int(j["stale_ptr"])


def small_pair(n_epochs=6, shift_at=3):
    return (JDLRM(spec=J_SPEC, n_epochs=n_epochs, shift_at=shift_at),
            DLRMScenario(spec=T_SPEC, n_epochs=n_epochs, shift_at=shift_at))


def run_both(fault_kw, hardening, sync_every, pebs_period=101):
    """The same DLRM run through both packages' runtimes (hints on):
    -> (port runtime, its trajectory, reference runtime, its trajectory)."""
    js, ts = small_pair()
    kw = dict(sync_every=sync_every, pebs_period=pebs_period)
    ref = jrt.EpochRuntime.for_scenario(
        js, hints=jbuild_hints(js), **kw,
        faults=(None if fault_kw is None
                else JFaultModel.create(n_blocks=js.n_blocks, **fault_kw)),
        hardening=None if hardening is None else JHardening.make(**hardening))
    port = EpochRuntime.for_scenario(
        ts, hints=build_hints(ts), device="cpu", **kw,
        faults=(None if fault_kw is None
                else FaultModel.create(n_blocks=ts.n_blocks, **fault_kw)),
        hardening=None if hardening is None else Hardening.make(**hardening))
    return port, port.run(ts.epochs()), ref, ref.run(js.epochs())


# ------------------------------------------------- the centre: whole runs
@pytest.mark.parametrize("sync_every", [1, 4])
@pytest.mark.parametrize("hardened", [False, True],
                         ids=["unhardened", "hardened"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faulty_run_byte_identical_to_reference(fault, hardened, sync_every):
    """Every fault alone and all together, with and without hardening:
    trajectory JSON byte-identical to the reference's, and the collector
    states, fault counters and robustness leaves exact after the run."""
    port, got, ref, want = run_both(FAULTS[fault], HARD if hardened else None,
                                    sync_every)
    assert got.to_json() == want.to_json()
    assert_states_equal(port, ref)


def test_faults_change_the_trajectory():
    """The cases above are not vacuous: the faulty model moves the records
    of every collector-backed lane away from the healthy run's."""
    _, healthy, _, _ = run_both(None, None, 1)
    _, faulty, _, _ = run_both(ALL_FAULTS, HARD, 1)
    for lane in ALL_POLICIES:
        if LANE_COLLECTOR[lane] is None:
            continue
        assert [r.to_dict() for r in healthy.lane(lane)] != \
            [r.to_dict() for r in faulty.lane(lane)], lane
    quality = [r.quality for r in faulty.lane("hinted")]
    assert min(quality) < 1.0


# ------------------------------------------------------------- the pieces
@pytest.mark.parametrize("kw", [
    {}, dict(hmu_counter_bits=3, pebs_drop_p=0.25, reset_p=0.1,
             nb_stall_p=0.75, stale_epochs=2, seed=2 ** 31 - 1),
    dict(reset_p=np.float32([1.0, 0.0, 0.5]), seed=-3),
    dict(pebs_drop_p=PER_BLOCK_DROP, n_blocks=N_SMALL,
         hmu_counter_max=np.arange(N_SMALL, dtype=np.int32)),
], ids=["neutral", "scalars", "reset_vector", "per_block"])
def test_fault_model_create_equals_reference(kw):
    got = fault_model_to_numpy(FaultModel.create(**kw))
    want = jax_flat(JFaultModel.create(**kw))
    assert set(got) == set(want)
    for key in got:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(bits(got[key]), bits(want[key]),
                                      err_msg=key)
    fm = FaultModel.create(**kw)
    assert (fm.stale_epochs, fm.seed) == (kw.get("stale_epochs", 0),
                                          kw.get("seed", 0))


def test_fault_model_validation():
    with pytest.raises(ValueError, match="reset_p"):
        FaultModel.create(reset_p=np.zeros((2,), np.float32))
    with pytest.raises(ValueError, match="stale_epochs"):
        FaultModel.create(stale_epochs=-1)
    with pytest.raises(ValueError, match="pebs_drop_p"):
        FaultModel.create(pebs_drop_p=1.5)
    with pytest.raises(ValueError, match="entries"):
        FaultModel.create(pebs_drop_p=np.zeros((7,), np.float32), n_blocks=9)
    with pytest.raises(ValueError, match="hmu_counter_bits"):
        FaultModel.create(hmu_counter_bits=32)
    with pytest.raises(ValueError, match="entries"):
        FaultModel.create(hmu_counter_max=np.ones((3,), np.int32), n_blocks=4)
    with pytest.raises(ValueError, match="scalar or"):
        FaultModel.create(pebs_drop_p=np.zeros((2, 2), np.float32))


def test_fault_model_for_segments_rejects_global_knobs_per_segment():
    with pytest.raises(ValueError, match="non-per-block"):
        FaultModel.for_segments((0, 5, 10), [{"reset_p": 1.0}, None])
    with pytest.raises(ValueError, match="offsets"):
        FaultModel.for_segments((0, 5), [{}, {}])


def test_fault_model_for_segments_equals_reference():
    args = ((0, 4, 10), [{"pebs_drop_p": 0.5, "hmu_counter_bits": 3}, None])
    fm = FaultModel.for_segments(*args, nb_stall_p=0.25, seed=9)
    drop, cap = fm.pebs_drop_p.numpy(), fm.hmu_counter_max.numpy()
    np.testing.assert_allclose(drop[:4], 0.5)
    np.testing.assert_allclose(drop[4:], 0.0)
    assert (cap[:4] == 7).all() and (cap[4:] == np.iinfo(np.int32).max).all()
    got = fault_model_to_numpy(fm)
    want = jax_flat(JFaultModel.for_segments(*args, nb_stall_p=0.25, seed=9))
    for key in got:
        np.testing.assert_array_equal(bits(got[key]), bits(want[key]),
                                      err_msg=key)


def test_hardening_validation():
    with pytest.raises(ValueError, match="hysteresis"):
        Hardening.make(demote_hysteresis=0)
    with pytest.raises(ValueError, match="unknown fallback lane"):
        Hardening.make(fallback={"nope": "hmu"})
    with pytest.raises(ValueError, match="compiler hints"):
        Hardening.make(fallback={"prefetch": "hmu"})
    with pytest.raises(ValueError, match="different collector"):
        Hardening.make(fallback={"hmu_oracle": "hmu"})
    with pytest.raises(ValueError, match="unknown fallback collector"):
        Hardening.make(fallback={"hmu_oracle": "tsc"})
    with pytest.raises(ValueError, match="quality_floor"):
        Hardening.make(quality_floor=1.5)
    with pytest.raises(ValueError, match="quality_beta"):
        Hardening.make(quality_beta=0.0)


@pytest.mark.parametrize("kw", [{}, HARD, dict(
    fallback=[("proactive_ewma", "nb"), ("reactive_watermark", "pebs")],
    demote_hysteresis=4, quality_floor=0.25, quality_beta=0.75)])
def test_hardening_make_equals_reference(kw):
    got, want = Hardening.make(**kw), JHardening.make(**kw)
    assert tuple(got) == tuple(want)
    assert hardening_from_fields(want._asdict()) == got


BLEND_BETAS = [0.5, 0.1, 0.3, 0.7, 0.9, 1 / 3, 1.0]
BLEND_CASES = ([pytest.param(b, "all", 1, id=str(b)) for b in BLEND_BETAS]
               + [pytest.param(0.7, f, 4, id=f"0.7-{f}-K4")
                  for f in ("drops", "resets")])


@pytest.mark.parametrize("beta,fault,sync_every", BLEND_CASES)
def test_quality_blend_equals_the_reference_steps_jit(beta, fault,
                                                      sync_every):
    """The hardened quality blend at betas other than the exact 0.5, over
    whole runs against the reference's jitted step: trajectory JSON byte
    for byte and every state leaf (``quality`` and ``nb_ewma`` among them)
    by its bits.  Inside the step XLA contracts a different product per
    element (the carried state's for HMU and NB quality, the raw value's
    for PEBS quality and ``nb_ewma``), which a jit of the blend alone
    does not reproduce, so only the whole step can check it."""
    port, got, ref, want = run_both(FAULTS[fault],
                                    dict(HARD, quality_beta=beta), sync_every)
    assert got.to_json() == want.to_json()
    assert_states_equal(port, ref)
    assert min(r.quality for r in got.lane("hinted")) < 1.0


def test_faults_require_the_fused_path():
    with pytest.raises(ValueError, match="fused"):
        EpochRuntime(100, 10, fused=False, faults=FaultModel.create(),
                     device="cpu")
    with pytest.raises(ValueError, match="fused"):
        EpochRuntime(100, 10, fused=False, hardening=Hardening.make(),
                     device="cpu")


def test_runtime_refuses_per_block_knobs_of_the_wrong_length():
    for kw in (dict(pebs_drop_p=np.zeros((99,), np.float32)),
               dict(hmu_counter_max=np.ones((99,), np.int32))):
        with pytest.raises(ValueError, match="n_blocks=100"):
            EpochRuntime(100, 10, faults=FaultModel.create(**kw),
                         device="cpu")


def test_hardening_as_a_dict_equals_the_container():
    a = EpochRuntime(400, 40, device="cpu", faults=FaultModel.create(),
                     hardening=dict(fallback={"hmu_oracle": "pebs"},
                                    demote_hysteresis=3))
    assert a.hardening == Hardening.make(fallback={"hmu_oracle": "pebs"},
                                         demote_hysteresis=3)
    assert a._state.cold_streak.shape == (len(ALL_POLICIES), 400)
    with pytest.raises(ValueError, match="hysteresis"):
        EpochRuntime(400, 40, device="cpu",
                     hardening=dict(demote_hysteresis=0))


def test_runtime_copies_the_callers_model():
    fm = FaultModel.create(pebs_drop_p=0.5, seed=4)
    rt = EpochRuntime(400, 40, device="cpu", pebs_period=7, faults=fm)
    rt.run(iter(make_epochs(2)))
    assert fm.key.tolist() == [0, 4] and int(fm.pebs_dropped) == 0
    assert int(rt._state.bundle.faults.pebs_dropped) > 0


def test_reference_state_carries_across_mid_run():
    """A reference runtime under every fault and hardening runs three
    epochs; its state (the fault model's key words and counters, the stale
    ring and the quality leaves included) carries into the port, and both
    continue on the same epochs with identical records and state."""
    fk = dict(ALL_FAULTS, stale_epochs=2)
    kw = dict(pebs_period=101, nb_scan_rate=90, sync_every=1)
    har = dict(HARD, demote_hysteresis=3)
    ref = jrt.EpochRuntime(400, 40, **kw,
                           faults=JFaultModel.create(n_blocks=400, **fk),
                           hardening=JHardening.make(**har))
    epochs = make_epochs(7, seed=4)
    for e in epochs[:3]:
        ref.step(e)
    port = EpochRuntime(400, 40, device="cpu", **kw,
                        faults=FaultModel.create(n_blocks=400, **fk),
                        hardening=Hardening.make(**har))
    port._state = fused_state_from_numpy(jax_flat(ref._state),
                                         like=port._state)
    port.epoch = ref.epoch
    port._prev_pebs_host = ref._prev_pebs_host
    port._prev_nb_host = ref._prev_nb_host
    port._prefetch_pending = ref._prefetch_pending
    assert port._state.bundle.faults.key.tolist() == \
        np.asarray(ref._state.bundle.faults.key).tolist()
    for e in epochs[3:]:
        got, want = port.step(e), ref.step(e)
        assert {n: r.to_dict() for n, r in got.items()} == \
            {n: r.to_dict() for n, r in want.items()}
    assert_states_equal(port, ref)


def test_fault_model_round_trips_through_numpy():
    fm = FaultModel.create(pebs_drop_p=PER_BLOCK_DROP, n_blocks=N_SMALL,
                           reset_p=0.2, nb_stall_p=0.1, stale_epochs=1,
                           seed=12)
    fm = dataclasses.replace(fm, key=torch.tensor([3, 2 ** 32 - 1]),
                             pebs_dropped=trt.tel.Counter64(
                                 torch.tensor(2 ** 40 + 5)))
    back = fault_model_from_numpy(fault_model_to_numpy(fm), like=fm)
    for name in ("hmu_counter_max", "pebs_drop_p", "reset_p", "nb_stall_p",
                 "key", "resets", "nb_stalls"):
        assert torch.equal(getattr(back, name), getattr(fm, name)), name
    assert int(back.pebs_dropped) == 2 ** 40 + 5


# --------------------- the reference's non-sharded fault tests, mirrored
def make_runtime(**kw):
    kw.setdefault("policies", ALL_POLICIES)
    kw.setdefault("pebs_period", 101)
    kw.setdefault("nb_scan_rate", 90)
    return EpochRuntime(400, 40, device="cpu", **kw)


def make_epochs(n_epochs, n_blocks=400, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, n_blocks, (3, 2000)).astype(np.int32)
            for _ in range(n_epochs)]


def zipf_epochs(n_epochs, n_blocks=400, seed=3):
    rng = np.random.default_rng(seed)
    z = (rng.zipf(1.5, size=(n_epochs, 4, 4000)) % n_blocks).astype(np.int32)
    return [z[i] for i in range(n_epochs)]


@pytest.mark.parametrize("sync_every", [1, 4])
def test_neutral_model_bit_identical_single_device(sync_every):
    """A neutral model reproduces the fault-free records and placements bit
    for bit, and both equal the reference's neutral run."""
    epochs = make_epochs(6)
    base = make_runtime(sync_every=sync_every)
    tb = base.run(iter(epochs))
    neut = make_runtime(sync_every=sync_every,
                        faults=FaultModel.create(n_blocks=400))
    tn = neut.run(iter(epochs))
    assert tn.to_json() == tb.to_json()
    for lane in ALL_POLICIES:
        np.testing.assert_array_equal(base.lanes[lane].slot_to_block,
                                      neut.lanes[lane].slot_to_block)
    ref = jrt.EpochRuntime(400, 40, pebs_period=101, nb_scan_rate=90,
                           sync_every=sync_every,
                           faults=JFaultModel.create(n_blocks=400))
    assert ref.run(iter(epochs)).to_json() == tn.to_json()


def test_neutral_hardening_changes_nothing_but_reports_quality():
    epochs = make_epochs(5)
    tb = make_runtime().run(iter(epochs))
    th = make_runtime(
        faults=FaultModel.create(n_blocks=400),
        hardening=Hardening.make(fallback={"hmu_oracle": "pebs"}),
    ).run(iter(epochs))
    for lane in ALL_POLICIES:
        for x, y in zip(tb.lane(lane), th.lane(lane)):
            dx, dy = x.to_dict(), y.to_dict()
            assert dx.pop("quality") == 1.0
            q = dy.pop("quality")
            assert dx == dy, (lane, x.epoch)
            if LANE_COLLECTOR[lane] is None:
                assert q == 1.0
            else:
                assert q > 0.9, (lane, q)


def two_tenant_fleet(n_epochs=3, **kw):
    return FleetScenario([
        TenantSpec(DLRMScenario(spec=SMALL_SPEC, n_epochs=n_epochs,
                                batches_per_epoch=2)),
        TenantSpec(KVCacheScenario(batch=2, n_epochs=n_epochs,
                                   batches_per_epoch=2,
                                   accesses_per_batch=1024, device="cpu")),
    ], **kw)


def test_neutral_model_bit_identical_fleet():
    fl = two_tenant_fleet()
    base = run_fleet(fl, hints=False, sync_every=2, device="cpu")
    neut = run_fleet(fl, hints=False, sync_every=2, device="cpu",
                     faults={"dlrm": {"pebs_drop_p": 0.0}})
    assert base["trajectory"] == neut["trajectory"]
    assert base["summary"] == neut["summary"]
    assert base["tenants"] == neut["tenants"]


def test_hmu_saturation_pins_counters_at_the_cap():
    fm = FaultModel.create(hmu_counter_bits=3, n_blocks=8)   # cap = 7
    bundle = tel.bundle_init(8, faults=fm)
    bundle = tel.observe_all(bundle, torch.zeros((1, 100), dtype=torch.int32))
    assert int(bundle.hmu.counts[0]) == 7                    # not wrapped
    assert int(tel.hmu_saturated(bundle.hmu,
                                 bundle.faults.hmu_counter_max)) == 1
    assert int(bundle.true_counts[0]) == 100                 # truth intact


def test_hmu_saturating_observe_without_a_model_clamps_at_int32():
    st = tel.hmu_init(4)
    st = dataclasses.replace(st, counts=torch.tensor(
        [2 ** 31 - 3, 0, 0, 0], dtype=torch.int32))
    st = tel.hmu_observe(st, torch.zeros((10,), dtype=torch.int32))
    assert int(st.counts[0]) == 2 ** 31 - 1
    assert int(tel.hmu_saturated(st)) == 1


def test_pebs_drops_starve_the_sampled_histogram():
    fm = FaultModel.create(pebs_drop_p=1.0, n_blocks=16, seed=2)
    bundle = tel.bundle_init(16, pebs_period=3, faults=fm)
    bundle = tel.observe_all(
        bundle, (torch.arange(48, dtype=torch.int32) % 16).reshape(2, 24))
    assert int(bundle.pebs.sampled.sum()) == 0
    assert float(bundle.pebs.host_events) == 0.0      # dropped != serviced
    assert float(bundle.faults.pebs_dropped) == 16.0  # 48 accesses / period 3


def test_nb_stall_freezes_scanner_and_counts_stalls():
    fm = FaultModel.create(nb_stall_p=1.0, n_blocks=10, seed=4)
    bundle = tel.bundle_init(10, nb_scan_rate=4, faults=fm)
    for _ in range(3):
        bundle = tel.observe_all(bundle, torch.zeros((2, 5),
                                                     dtype=torch.int32))
    assert int(bundle.nb.scan_ptr) == 0
    assert int(bundle.nb.faults.sum()) == 0
    assert int(bundle.faults.nb_stalls) == 6


def test_collector_reset_wipes_counts_and_ticks_the_event_counter():
    fm = FaultModel.create(reset_p=np.array([1.0, 0.0, 0.0], np.float32),
                           n_blocks=8, seed=0)
    bundle = tel.bundle_init(8, faults=fm)
    for _ in range(2):
        bundle = tel.observe_all(bundle, torch.zeros((2, 50),
                                                     dtype=torch.int32))
    assert int(bundle.hmu.counts[0]) == 100
    assert int(bundle.faults.resets[COLLECTORS.index("hmu")]) == 2
    assert int(bundle.true_counts[0]) == 200


def test_staleness_serves_estimates_d_epochs_late():
    n, d = 64, 2
    epochs = [np.full((1, 512), e, np.int32) for e in range(8)]
    rt = EpochRuntime(n, 1, policies=("hmu_oracle",), device="cpu",
                      faults=FaultModel.create(stale_epochs=d, n_blocks=n))
    traj = rt.run(iter(epochs))
    assert int(rt.lanes["hmu_oracle"].slot_to_block[0]) == 7 - d
    assert traj.lane("hmu_oracle")[-1].coverage == 0.0
    fresh = EpochRuntime(n, 1, policies=("hmu_oracle",), device="cpu",
                         faults=FaultModel.create(n_blocks=n))
    fresh.run(iter(epochs))
    assert int(fresh.lanes["hmu_oracle"].slot_to_block[0]) == 7


def test_fallback_holds_coverage_where_naive_lane_collapses():
    eps = zipf_epochs(12)

    def fm():
        return FaultModel.create(
            reset_p=np.array([1.0, 0.0, 0.0], np.float32), seed=11,
            n_blocks=400)

    naive = EpochRuntime(400, 40, policies=("hmu_oracle",), pebs_period=101,
                         faults=fm(), device="cpu")
    tn = naive.run(iter(eps))
    hard = EpochRuntime(400, 40, policies=("hmu_oracle",), pebs_period=101,
                        faults=fm(), device="cpu",
                        hardening=Hardening.make(
                            fallback={"hmu_oracle": "pebs"}))
    th = hard.run(iter(eps))
    cn = np.mean([r.coverage for r in tn.lane("hmu_oracle")[3:]])
    ch = np.mean([r.coverage for r in th.lane("hmu_oracle")[3:]])
    assert ch > cn + 0.05, (cn, ch)
    assert th.lane("hmu_oracle")[-1].quality < 0.2
    assert tn.lane("hmu_oracle")[-1].quality == 1.0


def test_hysteresis_one_matches_unhardened_demotions():
    epochs = make_epochs(6, seed=7)
    tb = make_runtime(policies=("reactive_watermark",)).run(iter(epochs))
    th = make_runtime(policies=("reactive_watermark",),
                      faults=FaultModel.create(n_blocks=400),
                      hardening=Hardening.make(demote_hysteresis=1),
                      ).run(iter(epochs))
    for x, y in zip(tb.lane("reactive_watermark"),
                    th.lane("reactive_watermark")):
        dx, dy = x.to_dict(), y.to_dict()
        dx.pop("quality"), dy.pop("quality")
        assert dx == dy


def test_hysteresis_defers_demotion_until_h_cold_epochs():
    n, k = 32, 4
    hot = np.full((1, 256), 5, np.int32)
    cold = np.full((1, 256), 9, np.int32)
    epochs = [hot, cold, cold, cold]

    def demotions(h):
        rt = EpochRuntime(n, k, policies=("reactive_watermark",),
                          device="cpu", faults=FaultModel.create(n_blocks=n),
                          hardening=Hardening.make(demote_hysteresis=h))
        rt.run(iter(e.copy() for e in epochs))
        return [r.demoted for r in rt.records["reactive_watermark"]]

    d1, d4 = demotions(1), demotions(4)
    assert sum(d1[1:]) > 0
    assert sum(d4[1:3]) == 0
    assert sum(d4) <= sum(d1)


def test_fleet_per_tenant_profile_degrades_only_that_tenant():
    fl = two_tenant_fleet(n_epochs=4, pebs_period=11)
    fm = fl.build_faults({"dlrm": {"pebs_drop_p": 1.0}}, seed=1)
    drop = fm.pebs_drop_p.numpy()
    dl = fl.tenant_index("dlrm")
    assert (drop[fl.offsets[dl]:fl.offsets[dl + 1]] == 1.0).all()
    assert (drop[fl.offsets[dl + 1]:] == 0.0).all()
    out = run_fleet(two_tenant_fleet(n_epochs=4, pebs_period=11),
                    policies=("hinted",), hints=True, faults=fm, device="cpu")
    assert set(out["tenants"]) == {"dlrm", "kv_cache"}
    assert "hinted" in out["tenants"]["dlrm"]["lanes"]
    with pytest.raises(KeyError, match="unknown tenant"):
        fl.build_faults({"nope": {}})


class _NoHostRead:
    """Makes every host read of a tensor's value raise while active (item,
    truth value, int/float/index conversion, tolist): the CPU stand-in for
    the card's ``set_sync_debug_mode("error")``."""
    NAMES = ("item", "tolist", "__bool__", "__int__", "__float__",
             "__index__")

    def __init__(self, monkeypatch):
        self.mp = monkeypatch

    def __enter__(self):
        def refuse(*_a, **_k):
            raise AssertionError("a host read of a tensor inside the loop")
        for name in self.NAMES:
            self.mp.setattr(torch.Tensor, name, refuse)
        return self

    def __exit__(self, *exc):
        self.mp.undo()


def test_fleet_faulty_run_keeps_its_dispatch_pull_and_no_sync_structure(
        monkeypatch):
    """One observe_all and one epoch step an epoch, one record pull every
    K epochs, and nothing in the loop reads a tensor's value back."""
    fl = two_tenant_fleet()
    run_fleet(fl, hints=False, device="cpu")        # the KV stream, made once
    with trt.counting() as c, _NoHostRead(monkeypatch):
        run_fleet(fl, hints=False, sync_every=3, device="cpu",
                  faults={"dlrm": {"pebs_drop_p": 0.7}},
                  hardening=Hardening.make(fallback={"hinted": "hmu"}))
    assert c.dispatch["observe_all"] == 3
    assert c.dispatch["epoch_step"] == 3
    assert c.dispatch["record_sync"] == 1


# -------------------------------------------------------------- the example
def test_degraded_example_meets_the_reference_margins():
    """The port's example inside the reference example's margins, one
    observe_all, one epoch step and one record pull an epoch."""
    res = degraded_telemetry.run(device="cpu")
    assert all(degraded_telemetry.margins_met(res).values()), \
        degraded_telemetry.margins_met(res)
    assert res["dispatch"]["record_sync"] == degraded_telemetry.N_EPOCHS


# ---------------------------------------------------------------- the fleet
@pytest.fixture(scope="module")
def moe_pair():
    ref = MoEExpertScenario(shift_at=2, batch=2, **MIX_KW)
    return ref, MoEReplay(ref)


FLEET_PROFILE = {"scanner": {"pebs_drop_p": 0.5, "hmu_counter_bits": 8},
                 "dlrm": {"pebs_drop_p": 0.2}}


@pytest.mark.parametrize("capacity", ["shared", "partition", "weighted"])
@pytest.mark.parametrize("sync_every", [1, 3])
def test_faulty_fleet_equals_reference(moe_pair, capacity, sync_every):
    """The 3-tenant DLRM + scanner + MoE mix under a per-tenant profile and
    collector-wide resets and stalls, hardened: the port's run_fleet equals
    the reference's — trajectory JSON byte for byte, summary and tenant
    rows with ``==``."""
    jmoe, tmoe = moe_pair
    kw = dict(reset_p=0.2, nb_stall_p=0.3, seed=3)
    jfl, tfl = reference_fleet(jmoe, capacity), small_fleet(tmoe, capacity)
    har = dict(fallback={"hmu_oracle": "pebs", "hinted": "hmu"},
               demote_hysteresis=2)
    ref = jrun_fleet(jfl, hints=True, sync_every=sync_every,
                     faults=jfl.build_faults(FLEET_PROFILE, **kw),
                     hardening=JHardening.make(**har))
    with trt.counting() as c:
        got = run_fleet(tfl, hints=True, sync_every=sync_every, device="cpu",
                        faults=tfl.build_faults(FLEET_PROFILE, **kw),
                        hardening=har)
    assert json.dumps(got["trajectory"]) == json.dumps(ref["trajectory"])
    assert got["summary"] == ref["summary"]
    assert got["tenants"] == ref["tenants"]
    n = tfl.n_epochs
    assert c.dispatch["observe_all"] == c.dispatch["epoch_step"] == n
    assert c.dispatch["record_sync"] == math.ceil(n / sync_every)


def test_fleet_dict_profile_equals_build_faults(moe_pair):
    """``faults=`` as a per-tenant dict is ``build_faults`` of it."""
    a = run_fleet(small_fleet(moe_pair[1]), hints=False, device="cpu",
                  faults={"scanner": {"pebs_drop_p": 0.5}})
    fl = small_fleet(moe_pair[1])
    b = run_fleet(fl, hints=False, device="cpu",
                  faults=fl.build_faults({"scanner": {"pebs_drop_p": 0.5}}))
    assert a["trajectory"] == b["trajectory"] and a["tenants"] == b["tenants"]
