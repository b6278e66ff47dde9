"""The fleet (many workloads, one fast tier): the port's ``repro_torch.fleet``
and the fused epoch step's tenancy branch against the reference.

The centre is the 3-tenant DLRM + scanner + MoE mix of
``tests/test_fleet.py``, run by both packages for every capacity policy and
two record-pull periods.  Its MoE tenant replays the reference's
``MoEExpertScenario`` epochs as numpy, with the reference's geometry (the
same stream seam the KV tests use): the port's own MoE stream follows the
reference's only within a bound, since a bf16 rounding can flip a routing
near-tie (``tests/test_torch_moe.py``).  The other
cases mirror the reference's non-sharded fleet tests on the port: id
plumbing, the interleaver, capacity policies, tenancy validation, per-tenant
conservation, quota isolation and the interference headline; and the
repairs made with the port of the tenancy branch (the segment layout
uploaded once, one segment call for the per-tenant hot sets).

Tolerance: exact.  Trajectories compare as JSON text byte for byte, and
summaries and tenant rows with ``==``: their floats come from the same
float64 host arithmetic over the same integer counts."""
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402
_torch_threads.limit()

from _hypothesis_compat import given, settings, st  # noqa: E402
from repro.dlrm import datagen as jdata  # noqa: E402
from repro.fleet import FleetScenario as JFleet  # noqa: E402
from repro.fleet import TenantSpec as JTenant  # noqa: E402
from repro.fleet import fair_quotas as jfair_quotas  # noqa: E402
from repro.fleet import run_fleet as jrun_fleet  # noqa: E402
from repro.scenarios import DLRMScenario as JDLRM  # noqa: E402
from repro.scenarios import MmapBenchScenario as JMmap  # noqa: E402
from repro.scenarios import MoEExpertScenario  # noqa: E402
from repro_torch.core import costmodel as tcost  # noqa: E402
from repro_torch.core import runtime as trt  # noqa: E402
from repro_torch.core import selectk  # noqa: E402
from repro_torch.core.runtime import ALL_POLICIES, EpochRuntime, Tenancy  # noqa: E402
from repro_torch.dlrm import datagen  # noqa: E402
from repro_torch.examples import fleet_mix  # noqa: E402
from repro_torch.fleet import (FleetScenario, TenantSpec, fair_quotas,  # noqa: E402
                               make_tenancy, run_fleet, tenant_trajectories)
from repro_torch.scenarios import (DLRMScenario, MmapBenchScenario,  # noqa: E402
                                   run_scenario)
from repro_torch.workloads import mmap_bench  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SMALL_SPEC = dataclasses.replace(datagen.SMALL, lookups_per_batch=8_000)
J_SMALL_SPEC = dataclasses.replace(jdata.SMALL, lookups_per_batch=8_000)
MIX_KW = dict(n_epochs=4, batches_per_epoch=2)


class MoEReplay:
    """The reference's ``MoEExpertScenario`` as numpy: its epochs (made once
    by the reference's model) and its geometry, replayed.  No hint layout,
    as the reference's."""

    name = "moe_experts"

    def __init__(self, ref):
        self._epochs = [np.asarray(e) for e in ref.epochs()]
        for attr in ("n_blocks", "k_hot", "bytes_per_access", "block_bytes",
                     "pebs_period", "shift_at", "batch_len", "n_epochs",
                     "batches_per_epoch", "nb_scan_rate"):
            setattr(self, attr, getattr(ref, attr))
        self.system = tcost.TPU_V5E_SYSTEM

    def epochs(self):
        return iter(self._epochs)

    def hint_layout(self):
        return None


@pytest.fixture(scope="module")
def moe_pair():
    """(the reference's MoE scenario, the port's replay of it)."""
    ref = MoEExpertScenario(shift_at=2, batch=2, **MIX_KW)
    return ref, MoEReplay(ref)


def small_dlrm(**kw):
    kw.setdefault("spec", SMALL_SPEC)
    kw.setdefault("shift_at", 2)
    return DLRMScenario(**{**MIX_KW, **kw})


def small_scanner(**kw):
    kw.setdefault("accesses_per_batch", 8_000)
    return MmapBenchScenario(**{**MIX_KW, **kw})


def small_fleet(moe, capacity="weighted", k_hot=300, **kw):
    return FleetScenario(
        [TenantSpec(small_dlrm(), weight=10.0, name="dlrm"),
         TenantSpec(small_scanner(), weight=1.0, name="scanner"),
         TenantSpec(moe, weight=1.0, name="moe")],
        k_hot=k_hot, capacity=capacity, **kw)


def reference_fleet(moe, capacity="weighted", k_hot=300):
    return JFleet(
        [JTenant(JDLRM(spec=J_SMALL_SPEC, shift_at=2, **MIX_KW),
                 weight=10.0, name="dlrm"),
         JTenant(JMmap(accesses_per_batch=8_000, **MIX_KW), weight=1.0,
                 name="scanner"),
         JTenant(moe, weight=1.0, name="moe")],
        k_hot=k_hot, capacity=capacity)


# ------------------------------------------------ the centre: vs reference
@pytest.mark.parametrize("capacity", ["shared", "partition", "weighted"])
@pytest.mark.parametrize("sync_every", [1, 3])
def test_run_fleet_equals_reference(moe_pair, capacity, sync_every):
    """The port's run_fleet == the reference's fused run_fleet on the
    3-tenant mix with hints: trajectory JSON byte-identical, summary and
    tenant rows equal; one observe_all and one epoch step an epoch, and
    ceil(n / K) record pulls with the tenant rows riding them."""
    jmoe, tmoe = moe_pair
    ref = jrun_fleet(reference_fleet(jmoe, capacity), hints=True,
                     sync_every=sync_every)
    fleet = small_fleet(tmoe, capacity)
    with trt.counting() as c:
        got = run_fleet(fleet, hints=True, sync_every=sync_every,
                        device="cpu")
    assert json.dumps(got["trajectory"]) == json.dumps(ref["trajectory"])
    assert got["summary"] == ref["summary"]
    assert got["tenants"] == ref["tenants"]
    assert (got["tenants"]["dlrm"]["cap"] is None) == (capacity == "shared")
    n = fleet.n_epochs
    assert c.dispatch["observe_all"] == c.dispatch["epoch_step"] == n
    assert c.dispatch["record_sync"] == math.ceil(n / sync_every)


def test_fleet_sync_every_parity_including_tenant_rows(moe_pair):
    """The per-tenant (L, T) rows ride the batched pull unchanged: the
    global trajectory, summary and every tenant record are identical for
    K=3 and K=1 (``tests/test_pipelined.py``'s fleet case, on the port)."""
    base = run_fleet(small_fleet(moe_pair[1]), hints=True, device="cpu")
    batched = run_fleet(small_fleet(moe_pair[1]), hints=True, sync_every=3,
                        device="cpu")
    assert batched["trajectory"] == base["trajectory"]
    assert batched["summary"] == base["summary"]
    assert batched["tenants"] == base["tenants"]


# ------------------------------------------------------------- id plumbing
@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(min_value=1, max_value=400), min_size=2,
                max_size=5),
       st.lists(st.integers(min_value=0, max_value=1 << 30), min_size=1,
                max_size=32))
def test_tenant_id_space_round_trip(sizes, raw_ids):
    """global->local->global is the identity on every valid global id, the
    recovered tenant owns the id's range, and out-of-range ids raise."""
    scenarios = [small_scanner(
        spec=mmap_bench.MmapBenchSpec(total_bytes=s * 4096,
                                      hot_bytes=max(s // 2, 1) * 4096))
        for s in sizes]
    fleet = FleetScenario([TenantSpec(sc, name=f"t{i}")
                           for i, sc in enumerate(scenarios)])
    ids = np.asarray(raw_ids) % fleet.n_blocks
    tenant, local = fleet.to_local(ids)
    for g, t, l in zip(ids, tenant, local):
        assert fleet.offsets[t] <= g < fleet.offsets[t + 1]
        assert fleet.to_global(int(t), int(l))[()] == g
    with pytest.raises(ValueError):
        fleet.to_local(np.array([fleet.n_blocks]))
    with pytest.raises(ValueError):
        fleet.to_global(0, np.array([scenarios[0].n_blocks]))


def test_interleaver_is_deterministic_and_conserves_tenant_traffic(moe_pair):
    jmoe, tmoe = moe_pair
    fleet = small_fleet(tmoe)
    eps1 = [e.copy() for e in fleet.epochs()]
    assert len(eps1) == fleet.n_epochs
    for a, b, r in zip(eps1, fleet.epochs(), reference_fleet(jmoe).epochs()):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, r)          # the reference's stream
        assert a.dtype == r.dtype
    # per-epoch per-tenant access counts survive the shuffle (up to the
    # deterministic sub-row tail drop)
    streams = [list(t.scenario.epochs()) for t in fleet.tenants]
    for e, ep in enumerate(eps1):
        assert ep.shape[0] == fleet.batches_per_epoch
        tenant, _ = fleet.to_local(ep.ravel())
        got = np.bincount(tenant, minlength=len(fleet.tenants))
        want = np.array([streams[i][e].size
                         for i in range(len(fleet.tenants))])
        dropped = want.sum() - got.sum()
        assert 0 <= dropped < fleet.batches_per_epoch
        assert (np.abs(got - want) <= dropped).all()


def test_fleet_geometry_equals_reference(moe_pair):
    jmoe, tmoe = moe_pair
    for capacity in ("shared", "partition", "weighted"):
        got, want = small_fleet(tmoe, capacity), reference_fleet(jmoe,
                                                                 capacity)
        for attr in ("n_blocks", "offsets", "k_hot", "n_epochs",
                     "batches_per_epoch", "shift_at", "bytes_per_access",
                     "block_bytes", "pebs_period", "nb_scan_rate"):
            assert getattr(got, attr) == getattr(want, attr), attr
        assert tuple(got.tenancy) == tuple(want.tenancy)
        np.testing.assert_array_equal(
            got.build_pipeline()._static_rank,
            want.build_pipeline()._static_rank)


def test_fleet_rejects_bad_configs():
    with pytest.raises(ValueError, match="two tenants"):
        FleetScenario([TenantSpec(small_scanner())])
    with pytest.raises(ValueError, match="unique"):
        FleetScenario([TenantSpec(small_scanner()),
                       TenantSpec(small_scanner())])
    with pytest.raises(ValueError, match="min_quota"):
        FleetScenario([TenantSpec(small_scanner(), name="a"),
                       TenantSpec(small_scanner(seed=1), name="b")],
                      capacity="weighted", k_hot=1)
    with pytest.raises(ValueError, match="weight"):
        TenantSpec(small_scanner(), weight=0.0)


def test_export_option_is_accepted_and_leaves_the_run_identical(moe_pair):
    """``export=`` is ported: the fleet run streams its epoch records, lane
    summaries, tenant rows and tenant-lane summaries through the client,
    tagged with the fleet's name, and returns the same output, byte for
    byte, as the run without it."""
    from repro_torch.export import ExportClient, MemorySink
    sink = MemorySink()
    client = ExportClient(sink)
    try:
        on = run_fleet(small_fleet(moe_pair[1]), hints=True, device="cpu",
                       sync_every=2, export=client)
        client.flush(timeout=30)
    finally:
        client.close()
    off = run_fleet(small_fleet(moe_pair[1]), hints=True, device="cpu",
                    sync_every=2)
    assert json.dumps(on) == json.dumps(off)
    recs = sink.snapshot()
    n_l, n_t, n_e = len(ALL_POLICIES), 3, MIX_KW["n_epochs"]
    kinds = [r["record_type"] for r in recs]
    assert [kinds.count(k) for k in ("epoch", "lane_summary", "tenant",
                                     "tenant_lane_summary")] == \
        [n_e * n_l, n_l, n_e * n_l * n_t, n_l * n_t]
    assert {r["scenario"] for r in recs} == {"fleet"}
    assert client.stats()["dropped_invalid"] == 0


@pytest.mark.parametrize("option,item", [
    ("faults", "10"), ("hardening", "10"), ("mesh", "15")])
def test_unported_options_raise_naming_their_item(moe_pair, option, item):
    """Items 10 and 15 are ported: ``faults=``, ``hardening=`` and
    ``mesh=`` of the wrong type are refused naming what they take, and
    ``build_faults`` refuses an unknown tenant."""
    fleet = small_fleet(moe_pair[1])
    value = object()
    if item == "10":
        name = "FaultModel" if option == "faults" else "Hardening"
        with pytest.raises(TypeError, match=name):
            run_fleet(fleet, device="cpu", **{option: value})
        if option == "faults":
            with pytest.raises(KeyError, match="unknown tenant"):
                fleet.build_faults({"nope": {"pebs_drop_p": 0.5}})
        return
    with pytest.raises(TypeError, match="DeviceMesh"):
        run_fleet(fleet, device="cpu", **{option: value})


# ---------------------------------------------------------------- capacity
def test_fair_quotas_exact_sum_proportional_and_floored():
    q = fair_quotas([3.0, 1.0, 4.0], 800)
    assert q.sum() == 800
    np.testing.assert_allclose(q / 800, np.array([3, 1, 4]) / 8, atol=1 / 800)
    # min-quota floor: a tiny tenant still gets a slot
    q = fair_quotas([1000.0, 1.0, 1.0], 10)
    assert q.sum() == 10 and (q >= 1).all()
    with pytest.raises(ValueError):
        fair_quotas([1.0, -1.0], 10)
    with pytest.raises(ValueError):
        fair_quotas([1.0, 1.0, 1.0], 2)              # cannot floor 3 tenants
    for w, k in (([3.0, 1.0, 4.0], 800), ([1000.0, 1.0, 1.0], 10),
                 ([486_587.0, 22.0, 60_000.0], 600_000), ([0.0, 2.0], 5)):
        np.testing.assert_array_equal(fair_quotas(w, k), jfair_quotas(w, k))


def test_make_tenancy_policies():
    offs, hot = (0, 100, 300), (10, 50)
    assert make_tenancy(offs, hot, 60, "shared").caps is None
    part = make_tenancy(offs, hot, 60, "partition")
    assert part.caps == (10, 50)                     # demand-proportional
    wgt = make_tenancy(offs, hot, 60, "weighted", weights=[1.0, 1.0])
    assert wgt.caps == (30, 30)
    with pytest.raises(ValueError, match="weights"):
        make_tenancy(offs, hot, 60, "weighted")
    with pytest.raises(ValueError, match="capacity"):
        make_tenancy(offs, hot, 60, "fair-ish")


def test_tenancy_validation():
    def build(tenancy):
        return EpochRuntime(100, 10, policies=("hmu_oracle",),
                            tenancy=tenancy, device="cpu")

    with pytest.raises(ValueError, match="offsets"):
        build(Tenancy(offsets=(0, 50, 90), hot_k=(5, 5)))
    with pytest.raises(ValueError, match="hot_k"):
        build(Tenancy(offsets=(0, 50, 100), hot_k=(5, 60)))
    with pytest.raises(ValueError, match="caps"):
        build(Tenancy(offsets=(0, 50, 100), hot_k=(5, 5),
                      caps=(8, 8)))    # sum > k_hot
    ten = Tenancy(offsets=(0, 30, 100), hot_k=(5, 5), caps=(4, 6))
    assert build(ten).tenancy is ten
    np.testing.assert_array_equal(ten.block_tenants(),
                                  np.repeat([0, 1], [30, 70]))
    # the segment cap is the card's: with no cap given, any count is valid
    many = Tenancy(offsets=tuple(range(0, 101)), hot_k=(1,) * 100)
    many.validate(100, 10)
    with pytest.raises(ValueError, match="100 tenants.*75 segments"):
        many.validate(100, 10, max_segments=75)


def test_cpu_runtime_keeps_no_segment_cap():
    """The plain versions sort per segment and have no cap, as the
    reference's plain path: a 100-tenant tenancy runs on the CPU."""
    n = 400
    ten = Tenancy(offsets=tuple(range(0, n + 1, 4)), hot_k=(1,) * (n // 4),
                  caps=(1,) * (n // 4))
    rt = EpochRuntime(n, 100, policies=("hmu_oracle",), tenancy=ten,
                      device="cpu")
    rng = np.random.default_rng(0)
    rt.step(rng.integers(0, n, (2, 1_000)).astype(np.int32))
    assert rt.tenant_records[0]["resident"].shape == (1, n // 4)


def test_run_scenario_generic_path_inherits_tenancy(moe_pair):
    """The fleet is an AccessScenario: run_scenario installs its Tenancy
    through EpochRuntime.for_scenario (quotas active, composed pipeline
    attached)."""
    fleet = small_fleet(moe_pair[1])
    rt = EpochRuntime.for_scenario(fleet, policies=("hmu_oracle",),
                                   device="cpu")
    assert rt.tenancy is fleet.tenancy
    assert rt.tenancy.caps is not None
    out = run_scenario(fleet, policies=("hmu_oracle",), hints=True,
                       device="cpu")
    assert out["trajectory"]["scenario"] == "fleet"


# ---------------------------------------------------------------- accounting
def test_per_tenant_accounting_conserves_the_global_record(moe_pair):
    """Tenant numerators sum to the global record: n_fast / n_slow /
    resident / promoted / demoted exactly, host tax to float tolerance via
    the access-share split."""
    fleet = small_fleet(moe_pair[1])
    eps = [e.copy() for e in fleet.epochs()]
    rt = EpochRuntime.for_scenario(fleet, policies=ALL_POLICIES,
                                   hints=fleet.build_pipeline(), device="cpu")
    rt.run(iter(eps))
    trajs = tenant_trajectories(rt, fleet)
    assert len(rt.tenant_records) == fleet.n_epochs
    for e in range(fleet.n_epochs):
        for lane in rt.records:
            g = rt.records[lane][e]
            rows = [trajs[t.name][lane][e] for t in fleet.tenants]
            n_fast = sum(r.n_fast for r in rows)
            n_slow = sum(r.n_slow for r in rows)
            assert n_fast + n_slow == eps[e].size
            np.testing.assert_allclose(
                rt.system.access_time_s(n_fast, n_slow,
                                        fleet.bytes_per_access),
                g.access_s, rtol=1e-12)
            assert sum(r.resident for r in rows) == g.resident
            assert sum(r.promoted for r in rows) == g.promoted
            assert sum(r.demoted for r in rows) == g.demoted
            np.testing.assert_allclose(
                sum(r.host_tax_s for r in rows), g.host_tax_s, rtol=1e-9)
            for r in rows:
                assert 0.0 <= r.coverage <= 1.0
                assert 0.0 <= r.accuracy <= 1.0
                assert r.time_s >= r.access_s >= 0.0


def test_tenant_rows_survive_in_place_buffer_reuse(moe_pair):
    """On the CPU the record pull reads the live buffer; the tenant rows are
    copies, so later epochs (which overwrite the buffer's rows in place)
    leave earlier rows as they were."""
    fleet = small_fleet(moe_pair[1])
    rt = EpochRuntime.for_scenario(fleet, policies=("hmu_oracle",),
                                   device="cpu")
    eps = list(fleet.epochs())
    rt.step(eps[0])
    first = {k: v.copy() for k, v in rt.tenant_records[0].items()}
    for ep in eps[1:]:
        rt.step(ep)
    for k, v in first.items():
        np.testing.assert_array_equal(rt.tenant_records[0][k], v)


def test_quota_caps_bound_admissions_and_converge_residency(moe_pair):
    """With sum(caps) <= k_hot every tenant's per-epoch admissions respect
    its cap, residency stays within the quota split up to the slack of
    tenants whose cap exceeds their block space, and the protected tenant
    holds its full quota under contention."""
    fleet = small_fleet(moe_pair[1], capacity="weighted", k_hot=300)
    caps = np.asarray(fleet.tenancy.caps)
    sizes = np.asarray(fleet.tenancy.sizes)
    rt = EpochRuntime.for_scenario(fleet, policies=("hmu_oracle",),
                                   device="cpu")
    rt.run(fleet.epochs())
    for raw in rt.tenant_records:
        assert (raw["promoted"][0] <= caps).all()
    slack = int(np.maximum(caps - sizes, 0).sum())
    final = rt.tenant_records[-1]["resident"][0]
    assert final.sum() <= fleet.k_hot
    assert (final <= caps + slack).all()
    assert final[0] == caps[0]


def test_shared_pool_interference_vs_weighted_fair_isolation():
    """The headline at a small size: a loud scanner under a shared pool
    craters the DLRM tenant's oracle-lane coverage; weighted-fair quotas
    sized to the DLRM solo hot set hold it within a few points of solo."""
    spec = dataclasses.replace(datagen.SMALL, lookups_per_batch=30_000)

    def dlrm():
        return DLRMScenario(spec=spec, n_epochs=5, batches_per_epoch=2,
                            shift_at=0)

    def tenants():
        return [
            TenantSpec(dlrm(), weight=250.0, name="dlrm"),
            TenantSpec(small_scanner(
                n_epochs=5,
                spec=mmap_bench.MmapBenchSpec(total_bytes=640 * 4096,
                                              hot_bytes=512 * 4096),
                accesses_per_batch=60_000), weight=30.0, name="scanner"),
        ]

    solo = run_scenario(dlrm(), policies=("hmu_oracle",), device="cpu")
    solo_cov = solo["summary"]["hmu_oracle"]["final_coverage"]
    runs = {cap: run_fleet(FleetScenario(tenants(), k_hot=300, capacity=cap),
                           policies=("hmu_oracle",), hints=False,
                           device="cpu")
            for cap in ("shared", "weighted")}
    cov = {cap: r["tenants"]["dlrm"]["lanes"]["hmu_oracle"]["final_coverage"]
           for cap, r in runs.items()}
    assert runs["weighted"]["tenants"]["dlrm"]["cap"] >= 250
    assert solo_cov > 0.8
    assert cov["shared"] < solo_cov - 0.3           # noisy neighbour craters
    assert cov["weighted"] > solo_cov - 0.05        # quotas isolate


def test_fleet_mix_example_meets_the_reference_margins():
    """The port's three-tenant example on the CPU meets both of the
    reference example's margins, and its solo runs make one observe_all
    and one epoch step an epoch."""
    res = fleet_mix.run(device="cpu")
    assert all(fleet_mix.margins_met(res).values()), res["solo_cov"]
    for solo in res["runs"]["weighted"]["solo"].values():
        assert solo["dispatches_per_epoch"] == 2.0


# ------------------------------------------------- repairs on the way
def _count_selectk_uploads(monkeypatch):
    """Record the shape of every host->device copy selectk makes."""
    calls = []
    real = selectk.upload

    def counting_upload(x, device):
        calls.append(np.asarray(x).shape)
        return real(x, device)

    monkeypatch.setattr(selectk, "upload", counting_upload)
    return calls


def test_segment_mask_given_its_layout_uploads_nothing(monkeypatch):
    """segment_layout uploads the (n,) segment ids, the segment edges and
    the widths; a segment_top_k_mask call given that layout copies nothing
    host->device and equals the call that uploads its own.  with_caps
    uploads only the S widths, and a layout of other caps is refused."""
    calls = _count_selectk_uploads(monkeypatch)
    rng = np.random.default_rng(1)
    key = torch.from_numpy(rng.integers(0, 9, (3, 1_001)).astype(np.int32))
    bounds, caps = (0, 17, 600, 1_001), (5, 31, 2)
    layout = selectk.segment_layout(bounds, caps, key.device)
    assert sorted(calls) == [(3,), (3,), (3,), (1_001,)]
    calls.clear()
    got = selectk.segment_top_k_mask(key, bounds, caps, layout=layout)
    assert calls == []
    assert torch.equal(got, selectk.segment_top_k_mask(key, bounds, caps))
    calls.clear()
    other = layout.with_caps((5, 30, 2))
    assert calls == [(3,)] and other.seg is layout.seg
    assert torch.equal(
        selectk.segment_top_k_mask(key, bounds, (5, 30, 2), layout=other),
        selectk.segment_top_k_mask(key, bounds, (5, 30, 2)))
    with pytest.raises(ValueError, match="other bounds or caps"):
        selectk.segment_top_k_mask(key, bounds, (5, 30, 2), layout=layout)


@pytest.mark.parametrize("capacity, n_uploads", [("shared", 4),
                                                 ("weighted", 5)])
def test_fleet_run_uploads_its_segment_layout_once(monkeypatch, moe_pair,
                                                   capacity, n_uploads):
    """The runtime uploads the tenant layout at construction (the hot-set
    widths and, under quotas, the caps, sharing one (n,) segment-id
    array); its epochs' segment selects upload nothing more."""
    fleet = small_fleet(moe_pair[1], capacity=capacity)
    calls = _count_selectk_uploads(monkeypatch)
    run_fleet(fleet, hints=True, device="cpu")
    assert len(calls) == n_uploads
    assert calls.count((fleet.n_blocks,)) == 1


@settings(max_examples=30, deadline=None)
@given(st.lists(st.integers(min_value=1, max_value=60), min_size=2,
                max_size=6),
       st.integers(min_value=0, max_value=2 ** 31 - 1),
       st.integers(min_value=1, max_value=7))
def test_one_segment_call_equals_per_tenant_top_k(sizes, seed, levels):
    """The epoch step takes every tenant's hot set (its top hot_k[t] of its
    id range) from ONE segment_top_k_mask call; bit for bit it is the
    reference's one top_k_mask per tenant slice, ties (few distinct
    counts) included."""
    rng = np.random.default_rng(seed)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    hot_k = [int(rng.integers(1, s + 1)) for s in sizes]
    d_true = torch.from_numpy(
        rng.integers(0, levels, int(offsets[-1])).astype(np.int32))
    got = selectk.segment_top_k_mask(d_true, offsets, hot_k)
    want = torch.cat([selectk.top_k_mask(d_true[a:b], h)
                      for a, b, h in zip(offsets, offsets[1:], hot_k)])
    assert torch.equal(got, want)


def test_import_of_the_fleet_loads_no_jax():
    code = ("import sys; import repro_torch.fleet, "
            "repro_torch.examples.fleet_mix; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'repro.')) or m == 'repro']; "
            "assert not bad, bad; print('OK')")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={"PYTHONPATH": str(REPO / "src"),
                            "PATH": "/usr/bin:/bin"})
    assert r.stdout.strip() == "OK", r.stderr[-2000:]
