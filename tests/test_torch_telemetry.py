"""telemetry: the port's collectors vs ``repro.core.telemetry`` — the whole
bundle after ``observe_all`` on a DLRM phase-shift stream, plus the edges of
``tests/test_telemetry_edges.py`` (NB wrap, zero-batch epochs, zero-cost
drain, the 40 M-event exact counter carry).

Tolerance: exact.  Every leaf is an integer (or bool) count; the reference's
hi/lo event counters are compared as the same hi/lo words."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402
_torch_threads.limit()
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import telemetry as jtel  # noqa: E402
from repro.dlrm import datagen as jdata  # noqa: E402
from repro_torch.convert import bundle_from_numpy, bundle_to_numpy  # noqa: E402
from repro_torch.core import telemetry as ttel  # noqa: E402
from repro_torch.dlrm import datagen as tdata  # noqa: E402


def jax_flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(getattr(p, "name", getattr(p, "key", p)))
                     for p in path): np.asarray(v) for path, v in leaves}


def assert_bundles_equal(tb, jb):
    t, j = bundle_to_numpy(tb), jax_flat(jb)
    assert sorted(t) == sorted(j)
    for key in j:
        np.testing.assert_array_equal(t[key], j[key], err_msg=key)


@pytest.mark.parametrize("log_capacity", [1 << 33, 9_000])
def test_observe_all_bundle_bit_identical_on_dlrm_stream(log_capacity):
    spec = dict(n_params=1_280_000, lookups_per_batch=3_001)
    jspec, tspec = jdata.DLRMTraceSpec(**spec), tdata.DLRMTraceSpec(**spec)
    n = tspec.n_pages
    kw = dict(pebs_period=401, nb_scan_rate=n // 3,
              hmu_log_capacity=log_capacity)
    jb = jtel.bundle_init(n, **kw)
    tb = ttel.bundle_init(n, **kw)
    j_epochs = jdata.phase_shift_epochs(jspec, 4, 3, shift_at=2, seed=1)
    t_epochs = tdata.phase_shift_epochs(tspec, 4, 3, shift_at=2, seed=1)
    for je, te in zip(j_epochs, t_epochs):
        np.testing.assert_array_equal(je, te)        # same stream
        jb = jtel.observe_all(jb, jnp.asarray(je))
        tb = ttel.observe_all(tb, torch.from_numpy(te))
        assert_bundles_equal(tb, jb)
        jb = type(jb)(hmu=jtel.hmu_drain_cost(jb.hmu), pebs=jb.pebs,
                      nb=jb.nb, true_counts=jb.true_counts)
        tb = type(tb)(hmu=ttel.hmu_drain_cost(tb.hmu), pebs=tb.pebs,
                      nb=tb.nb, true_counts=tb.true_counts)
        assert_bundles_equal(tb, jb)


def test_bundle_carries_across_and_back():
    n = 300
    rng = np.random.default_rng(2)
    batches = rng.integers(-3, n + 3, size=(2, 1_000)).astype(np.int32)
    jb = jtel.observe_all(jtel.bundle_init(n, pebs_period=7, nb_scan_rate=40),
                          jnp.asarray(batches))
    like = ttel.bundle_init(n, pebs_period=7, nb_scan_rate=40)
    tb = bundle_from_numpy(jax_flat(jb), like=like)
    assert_bundles_equal(tb, jb)
    jb = jtel.observe_all(jb, jnp.asarray(batches[::-1].copy()))
    tb = ttel.observe_all(tb, torch.from_numpy(batches[::-1].copy()))
    assert_bundles_equal(tb, jb)


@pytest.mark.parametrize("shape", [(0, 50), (3, 0)])
def test_zero_batch_and_empty_batch_epochs(shape):
    n = 12
    jb = jtel.bundle_init(n, pebs_period=5, nb_scan_rate=5)
    tb = ttel.bundle_init(n, pebs_period=5, nb_scan_rate=5)
    for batches in (np.zeros(shape, np.int32),
                    np.arange(12, dtype=np.int32).reshape(2, 6),
                    np.zeros(shape, np.int32)):
        jb = jtel.observe_all(jb, jnp.asarray(batches))
        tb = ttel.observe_all(tb, torch.from_numpy(batches))
        assert_bundles_equal(tb, jb)


@pytest.mark.parametrize("n,rate", [(10, 7), (8, 8), (6, 15)])
def test_nb_scanner_wrap(n, rate):
    js = jtel.nb_init(n, scan_rate=rate)
    ts = ttel.nb_init(n, scan_rate=rate)
    for ids in ([], [], [9 % n, 9 % n, 2], [0, 1, n - 1], []):
        arr = np.asarray(ids, np.int32)
        js = jtel.nb_observe(js, jnp.asarray(arr))
        ts = ttel.nb_observe(ts, torch.from_numpy(arr))
        np.testing.assert_array_equal(ts.mapped.numpy(), np.asarray(js.mapped))
        np.testing.assert_array_equal(ts.faults.numpy(), np.asarray(js.faults))
        assert int(ts.scan_ptr) == int(js.scan_ptr)
        assert float(ts.host_events) == float(js.host_events)


def test_pebs_cursor_continues_across_chopped_batches():
    period = 7
    stream = np.random.default_rng(0).integers(0, 50, 305).astype(np.int32)
    js, ts = jtel.pebs_init(50, period=period), ttel.pebs_init(50, period=period)
    for part in np.split(stream, [13, 100, 150, 296]):
        js = jtel.pebs_observe(js, jnp.asarray(part))
        ts = ttel.pebs_observe(ts, torch.from_numpy(part))
    np.testing.assert_array_equal(ts.sampled.numpy(), np.asarray(js.sampled))
    assert int(ts.cursor) == int(js.cursor) == 305 % period
    assert ts.cursor.dtype == torch.int32
    assert float(ts.host_events) == float(js.host_events)


def test_hmu_log_overflow_and_zero_cost_drain():
    js, ts = jtel.hmu_init(4, log_capacity=10), ttel.hmu_init(4, log_capacity=10)
    for _ in range(3):
        js = jtel.hmu_observe(js, jnp.zeros((6,), jnp.int32))
        ts = ttel.hmu_observe(ts, torch.zeros(6, dtype=torch.int32))
    for cost in (0.0, 2.0):
        jd, td = jtel.hmu_drain_cost(js, cost), ttel.hmu_drain_cost(ts, cost)
        for f in ("log_used", "log_dropped", "host_events"):
            assert float(getattr(td, f)) == float(getattr(jd, f)), f
    assert float(ttel.hmu_drain_cost(ts, 0.0).host_events) == 0.0
    np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))
    with pytest.raises(ValueError, match="per_record_cost"):
        ttel.hmu_drain_cost(ts, per_record_cost=1.5)


def test_counter64_carry_past_2p24_forty_million_events():
    """5 x 4 M accesses cross 2**24 in the log; a cost-2 drain charges 40 M
    host events — exact in both, where a float32 scalar stops at 16.7 M."""
    js = jtel.hmu_init(8, log_capacity=1 << 33)
    ts = ttel.hmu_init(8, log_capacity=1 << 33)
    step = 4_000_000
    zeros_j, zeros_t = jnp.zeros((step,), jnp.int32), torch.zeros(
        step, dtype=torch.int32)
    for _ in range(5):
        js = jtel.hmu_observe(js, zeros_j)
        ts = ttel.hmu_observe(ts, zeros_t)
    assert float(ts.log_used) == float(js.log_used) == 5.0 * step
    assert int(ts.log_used.hi) == int(js.log_used.hi)
    assert int(ts.log_used.lo) == int(js.log_used.lo)
    js, ts = jtel.hmu_drain_cost(js, 2.0), ttel.hmu_drain_cost(ts, 2.0)
    assert float(ts.host_events) == float(js.host_events) == 10.0 * step
    assert float(ts.log_used) == 0.0


def test_hmu_counts_saturate_at_int32_max():
    ts = ttel.hmu_init(3)
    near = torch.tensor([2 ** 31 - 2, 5, 0], dtype=torch.int32)
    ts = type(ts)(counts=near, log_used=ts.log_used,
                  log_dropped=ts.log_dropped, log_capacity=ts.log_capacity,
                  host_events=ts.host_events)
    js = jtel.hmu_init(3)
    js = type(js)(counts=jnp.asarray(near.numpy()), log_used=js.log_used,
                  log_dropped=js.log_dropped, log_capacity=js.log_capacity,
                  host_events=js.host_events)
    ids = np.array([0, 0, 0, 1], np.int32)
    ts = ttel.hmu_observe(ts, torch.from_numpy(ids))
    js = jtel.hmu_observe(js, jnp.asarray(ids))
    np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))
    assert int(ts.counts[0]) == 2 ** 31 - 1
