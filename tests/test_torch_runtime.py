"""The main path end to end: the port's ``run_scenario(DLRMScenario(SMALL))``
vs the reference's, the record-pull count, the host-side modules (datagen,
hints, cost model), and a reference runtime's state carried across into the
port mid-run.

Tolerance: exact.  Trajectories are compared as JSON text, byte for byte:
the records' floats come from the same float64 host arithmetic over the same
integer counts, so any difference is a port fault, not rounding."""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core import costmodel as jcost  # noqa: E402
from repro.core import runtime as jrt  # noqa: E402
from repro.dlrm import datagen as jdata  # noqa: E402
from repro.hints import HintPipeline as JHints  # noqa: E402
from repro.scenarios import DLRMScenario as JDLRM  # noqa: E402
from repro.scenarios import run_scenario as jrun  # noqa: E402
from repro_torch.convert import bundle_to_numpy, fused_state_from_numpy  # noqa: E402
from repro_torch.core import costmodel as tcost  # noqa: E402
from repro_torch.core import runtime as trt  # noqa: E402
from repro_torch.dlrm import datagen as tdata  # noqa: E402
from repro_torch.hints import HintPipeline as THints  # noqa: E402
from repro_torch.scenarios import DLRMScenario as TDLRM  # noqa: E402
from repro_torch.scenarios import run_scenario as trun  # noqa: E402


def jax_flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(getattr(p, "name", getattr(p, "key", p)))
                     for p in path): np.asarray(v) for path, v in leaves}


@pytest.mark.parametrize("hints", [False, True])
@pytest.mark.parametrize("sync_every", [1, 4, 7])
def test_small_dlrm_run_scenario_byte_identical(hints, sync_every):
    """The main-path gate: SMALL x hints x sync_every (7 = tail-only flush,
    4 = one full buffer + a partial tail over 8 epochs)."""
    with jrt.counting() as jc:
        ref = jrun(JDLRM(spec=jdata.SMALL), hints=hints,
                   sync_every=sync_every)
    with trt.counting() as tc:
        got = trun(TDLRM(spec=tdata.SMALL), hints=hints,
                   sync_every=sync_every, device="cpu")
    assert json.dumps(got, sort_keys=True) == json.dumps(ref, sort_keys=True)
    n_epochs = TDLRM().n_epochs
    assert tc.dispatch["record_sync"] == math.ceil(n_epochs / sync_every)
    for kind in ("observe_all", "epoch_step", "hint_refresh", "record_sync"):
        assert tc.dispatch[kind] == jc.dispatch[kind], kind


def test_counting_is_nestable():
    with trt.counting() as outer:
        trun(TDLRM(spec=tdata.SMALL, n_epochs=2, shift_at=1), device="cpu")
        with trt.counting() as inner:
            trun(TDLRM(spec=tdata.SMALL, n_epochs=3, shift_at=1),
                 device="cpu", sync_every=2)
            assert inner.dispatch["record_sync"] == 2
        assert outer.dispatch["epoch_step"] == 5
        assert outer.dispatch["record_sync"] == 4
    with pytest.raises(KeyError):
        outer.dispatch["typo"]


def test_host_modules_match_reference():
    spec = dict(n_params=2_560_000, lookups_per_batch=2_000)
    js, ts = jdata.DLRMTraceSpec(**spec), tdata.DLRMTraceSpec(**spec)
    j_ep = list(jdata.phase_shift_epochs(js, 4, 2, shift_at=2, seed=3))
    t_ep = list(tdata.phase_shift_epochs(ts, 4, 2, shift_at=2, seed=3))
    for a, b in zip(j_ep, t_ep):
        np.testing.assert_array_equal(a, b)
    jh, th = JHints.for_dlrm(js, seed=3), THints.for_dlrm(ts, seed=3)
    for e in range(4):
        for a, b in zip(jh.epoch_ranks(j_ep[e], j_ep[e + 1:e + 2]),
                        th.epoch_ranks(t_ep[e], t_ep[e + 1:e + 2])):
            np.testing.assert_array_equal(a, b)
    assert th.detector.shifts_detected == jh.detector.shifts_detected
    for sysname in ("CXL_SYSTEM", "TPU_V5E_SYSTEM"):
        a, b = getattr(jcost, sysname), getattr(tcost, sysname)
        assert a.access_time_s(1e5, 3e4, 256.0) == b.access_time_s(
            1e5, 3e4, 256.0)
        assert a.overlapped_epoch_time_s(1e5, 3e4, 256.0, 700, 4096.0) == \
            b.overlapped_epoch_time_s(1e5, 3e4, 256.0, 700, 4096.0)


def test_reference_state_carries_across_mid_run():
    """Run the reference for three epochs, carry its state into the port,
    and continue both on the same epochs: identical records and state."""
    n, k = 400, 40
    rng = np.random.default_rng(0)
    hint = np.where(rng.random(n) < 0.2, rng.random(n), 0).astype(np.float32)
    epochs = [rng.integers(0, n, (3, 2_000)).astype(np.int32)
              for _ in range(6)]
    # alpha 0.3 and weight 0.4: both float32 blends round differently
    # fused vs eager, so the carried pred and the hinted selections check
    # the port against the reference's fused arithmetic
    kw = dict(pebs_period=101, nb_scan_rate=90, hint_rank=hint,
              ewma_alpha=0.3, hint_weight=0.4)
    ref = jrt.EpochRuntime(n, k, **kw)
    for e in epochs[:3]:
        ref.step(e)
    port = trt.EpochRuntime(n, k, device="cpu", **kw)
    port._state = fused_state_from_numpy(jax_flat(ref._state),
                                         like=port._state)
    port.epoch = ref.epoch
    port._prev_pebs_host = ref._prev_pebs_host
    port._prev_nb_host = ref._prev_nb_host
    port._prefetch_pending = ref._prefetch_pending
    for e in epochs[3:]:
        got, want = port.step(e), ref.step(e)
        assert {name: r.to_dict() for name, r in got.items()} == \
            {name: r.to_dict() for name, r in want.items()}
    j = jax_flat(ref._state)
    t = bundle_to_numpy(port._state.bundle)
    for key, val in t.items():
        np.testing.assert_array_equal(val, j["bundle." + key], err_msg=key)
    for key in ("placement.slot_to_block", "placement.block_to_slot",
                "prev_hmu", "prev_pebs"):
        obj = port._state
        for part in key.split("."):
            obj = getattr(obj, part)
        np.testing.assert_array_equal(obj.numpy(), j[key], err_msg=key)
    np.testing.assert_array_equal(port._state.pred.numpy().view(np.int32),
                                  j["pred"].view(np.int32))
    lanes = port.lanes
    assert set(lanes) == set(trt.ALL_POLICIES)
    assert all((lane.slot_to_block >= 0).sum() <= k
               for lane in lanes.values())
