"""The offline profile -> promote -> replay path: the port's eager policies,
``plan_promotion``, ``TieringManager``, ``tracesim.run_table1`` /
``run_fig3``, ``TieredEmbedding`` and the DLRM tiering example, each vs the
reference on the same inputs.

Tolerance: exact everywhere but one place.  Counts, ids, placements and
storage are integers or copies; the policies' float32 scores and the cost
model's float64 arithmetic run the same operations in the same order, so
every float field must be identical too.  The one tolerance is the example's
pooled embedding-bag output (1e-5, float32 sums in another order)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402
_torch_threads.limit()
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import TieredStore as JStore  # noqa: E402
from repro.core import TieringManager as JManager  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core import telemetry as jtel  # noqa: E402
from repro.core.costmodel import CXL_SYSTEM as J_CXL  # noqa: E402
from repro.core.placement import Placement as JPlacement  # noqa: E402
from repro.core.placement import plan_promotion as j_plan_promotion  # noqa: E402
from repro.core.tiered_embedding import TieredEmbedding as JEmbedding  # noqa: E402
from repro.dlrm import datagen as jdata  # noqa: E402
from repro.dlrm import tracesim as jsim  # noqa: E402
from repro.kernels.embedding_bag import embedding_bag as jax_bag  # noqa: E402
from repro.workloads import mmap_bench as jmmap  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import CXL_SYSTEM, TieredStore, TieringManager  # noqa: E402
from repro_torch.core import policy  # noqa: E402
from repro_torch.core import telemetry as ttel  # noqa: E402
from repro_torch.core.placement import Placement, plan_promotion  # noqa: E402
from repro_torch.core.tiered_embedding import TieredEmbedding  # noqa: E402
from repro_torch.dlrm import datagen, tracesim  # noqa: E402
from repro_torch.examples import dlrm_tiering  # noqa: E402
from repro_torch.workloads import mmap_bench  # noqa: E402


def jax_flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(getattr(p, "name", getattr(p, "key", p)))
                     for p in path): np.asarray(v) for path, v in leaves}


def assert_same(a, b, where="result"):
    """Exact structural equality of nested dicts/lists/arrays/scalars."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=where)
    else:
        assert a == b and type(a) is type(b), (where, a, b)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ============================================================ eager policies
@pytest.mark.parametrize("k", [1, 7, 50, 300])
def test_oracle_nb_reactive_match_reference(k):
    rng = np.random.default_rng(k)
    est = rng.integers(0, 6, 257).astype(np.int32)          # heavy ties
    faults = rng.integers(0, 4, 257).astype(np.int32)
    for min_count in (1, 3):
        j = jpolicy.oracle_top_k(jnp.asarray(est), k, min_count=min_count)
        t = policy.oracle_top_k(torch.from_numpy(est), k, min_count=min_count)
        assert t.promote.dtype == torch.int32
        np.testing.assert_array_equal(_np(t.promote), _np(j.promote))
    for rate in (None, 5):
        j = jpolicy.nb_two_touch(jnp.asarray(faults), k, rate)
        t = policy.nb_two_touch(torch.from_numpy(faults), k, rate)
        np.testing.assert_array_equal(_np(t.promote), _np(j.promote))
    for free in (0, 3, k):
        j = jpolicy.reactive_watermark(jnp.asarray(est), 2, jnp.asarray(free),
                                       max_moves=k)
        t = policy.reactive_watermark(torch.from_numpy(est), 2, free,
                                      max_moves=k)
        np.testing.assert_array_equal(_np(t.promote), _np(j.promote))


@pytest.mark.parametrize("alpha", [0.3, 0.5, 0.9])
def test_proactive_ewma_matches_reference_eager_rounding(alpha):
    rng = np.random.default_rng(int(alpha * 10))
    prev = (rng.random(400) * 7 * (rng.random(400) < 0.5)).astype(np.float32)
    est = rng.integers(0, 9, 400).astype(np.float32)
    for k in (10, 400):
        jp, jplan = jpolicy.proactive_ewma(jnp.asarray(prev), jnp.asarray(est),
                                           k, alpha=alpha)
        tp, tplan = policy.proactive_ewma(torch.from_numpy(prev),
                                          torch.from_numpy(est), k,
                                          alpha=alpha)
        np.testing.assert_array_equal(tp.numpy().view(np.int32),
                                      np.asarray(jp).view(np.int32))
        np.testing.assert_array_equal(_np(tplan.promote), _np(jplan.promote))


def test_eager_ewma_differs_from_the_fused_form_at_alpha_0_3():
    """The eager policy rounds every op (1.64); the fused step's helper
    contracts into an FMA (1.6400001), as the reference does under jit."""
    x, prev = torch.tensor([5.0]), torch.tensor([0.2])
    eager, _ = policy.proactive_ewma(prev, x, 1, alpha=0.3)
    fused = policy.ewma(0.3, x, prev)
    jp, _ = jpolicy.proactive_ewma(jnp.asarray([0.2], jnp.float32),
                                   jnp.asarray([5.0], jnp.float32), 1,
                                   alpha=0.3)
    assert eager.numpy().view(np.int32)[0] == np.asarray(jp).view(np.int32)[0]
    assert float(eager[0]) == float(np.float32(1.64))
    assert float(fused[0]) == float(np.float32(1.6400001))
    assert float(eager[0]) != float(fused[0])


def _placements(seed, n_blocks=64, n_slots=10, resident=7):
    rng = np.random.default_rng(seed)
    s2b = np.full(n_slots, -1, np.int32)
    slots = rng.choice(n_slots, resident, replace=False)
    s2b[slots] = rng.choice(n_blocks, resident, replace=False)
    b2s = np.full(n_blocks, -1, np.int32)
    b2s[s2b[s2b >= 0]] = np.nonzero(s2b >= 0)[0]
    return (JPlacement(slot_to_block=jnp.asarray(s2b),
                       block_to_slot=jnp.asarray(b2s)),
            Placement(slot_to_block=torch.from_numpy(s2b),
                      block_to_slot=torch.from_numpy(b2s)), s2b, rng)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_promotion_matches_reference(seed):
    jp, tp, s2b, rng = _placements(seed)
    est = rng.integers(0, 5, 64)
    for want in (np.array([-1, 3], np.int32),                  # fits
                 rng.choice(64, 9, replace=False).astype(np.int32),
                 np.concatenate([s2b[s2b >= 0][:2],           # wanted residents
                                 rng.choice(64, 8).astype(np.int32), [-1]])):
        jw, jv = j_plan_promotion(jp, want, est)
        tw, tv = plan_promotion(tp, torch.from_numpy(want), est)
        np.testing.assert_array_equal(tw, jw)
        assert (jv is None) == (tv is None)
        if jv is not None:
            np.testing.assert_array_equal(_np(tv), _np(jv))


# ============================================================= the manager
def _quickstart_stream():
    rng = np.random.default_rng(0)
    for _ in range(32):
        hot = rng.integers(0, 400, 18_000)
        cold = rng.integers(400, 4096, 2_000)
        yield np.concatenate([hot, cold])


def test_quickstart_stream_through_manager_matches_reference():
    kw = dict(n_blocks=4096, k_hot=400, pebs_period=997, nb_scan_rate=1024)
    jm, tm = JManager(**kw), TieringManager(**kw, device="cpu")
    for batch in _quickstart_stream():
        jm.observe(batch)
        tm.observe(batch)
    np.testing.assert_array_equal(tm.true_counts, jm.true_counts)
    jr = jm.evaluate(J_CXL, bytes_per_access=256.0)
    tr = tm.evaluate(CXL_SYSTEM, bytes_per_access=256.0)
    assert_same({k: dataclasses.asdict(v) for k, v in tr.items()},
                {k: dataclasses.asdict(v) for k, v in jr.items()})
    # and the data plane of the quickstart: reads survive the promotion
    data = np.arange(4096 * 4 * 8, dtype=np.float32).reshape(-1, 8)
    store = TieredStore.create(torch.from_numpy(data), block_rows=4,
                               n_slots=400)
    store = store.promote(torch.from_numpy(tr["hmu"].promoted[:400]))
    assert int(store.fast_occupancy()) == int(
        JStore.create(jnp.asarray(data), block_rows=4, n_slots=400).promote(
            jnp.asarray(jr["hmu"].promoted[:400])).fast_occupancy())
    rows = np.random.default_rng(1).integers(0, 4096 * 4, 64)
    np.testing.assert_array_equal(store.gather(torch.from_numpy(rows)).numpy(),
                                  data[rows])


def test_observe_epoch_equals_per_batch_observe_and_reference():
    batches = np.stack(list(_quickstart_stream())[:6]).astype(np.int32)
    kw = dict(n_blocks=4096, k_hot=400, pebs_period=997, nb_scan_rate=1024)
    jm, t1, t2 = (JManager(**kw), TieringManager(**kw, device="cpu"),
                  TieringManager(**kw, device="cpu"))
    jm.observe_epoch(batches)
    t1.observe_epoch(batches)
    for b in batches:
        t2.observe(b)
    for tm in (t1, t2):
        assert_same(convert.bundle_to_numpy(tm.bundle), jax_flat(jm.bundle))
    with pytest.raises(ValueError, match="n_batches"):
        t1.observe_epoch(batches[0])


def _rows(rows):
    return {k: dataclasses.asdict(v) for k, v in rows.items()}


def test_run_table1_small_every_field_identical():
    kw = dict(k_hot=500, batches_per_iteration=5, eval_batches=8,
              dram_only_target_us=633.24)
    j = jsim.run_table1(jdata.SMALL, **kw)
    t = tracesim.run_table1(datagen.SMALL, device="cpu", **kw)
    assert_same(_rows(t), _rows(j))


def test_run_fig3_small_every_field_identical():
    kw = dict(total_accesses=2_000_000, pebs_period=401, n_batches=16)
    j = jsim.run_fig3(jmmap.SMALL, **kw)
    t = tracesim.run_fig3(mmap_bench.SMALL, device="cpu", **kw)
    assert_same(t, j)


# ====================================================== TieredEmbedding
def _embeddings(table, **kw):
    return (JEmbedding.create(jnp.asarray(table), **kw),
            TieredEmbedding.create(torch.from_numpy(table), **kw))


def assert_emb_same(t, j):
    np.testing.assert_array_equal(t.store.storage.numpy(),
                                  np.asarray(j.store.storage))
    np.testing.assert_array_equal(t.store.slot_to_block.numpy(),
                                  np.asarray(j.store.slot_to_block))
    np.testing.assert_array_equal(t.store.block_to_slot.numpy(),
                                  np.asarray(j.store.block_to_slot))
    np.testing.assert_array_equal(t.counts, j.counts)


def test_tiered_embedding_hit_rate_improves_with_rebalance():
    """``tests/test_lm_tiering.py``'s first flow, in both."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(4096, 32)).astype(np.float32)
    j, t = _embeddings(table, block_rows=8, fast_fraction=0.1)
    for _ in range(10):
        toks = np.where(rng.random(2048) < 0.9, rng.integers(0, 200, 2048),
                        rng.integers(200, 4096, 2048))
        j.observe_tokens(toks)
        t.observe_tokens(toks)
    assert_same(t.modeled_lookup_time_s(), j.modeled_lookup_time_s())
    moved = t.rebalance()
    assert moved == j.rebalance() and moved > 0
    assert_same(t.modeled_lookup_time_s(), j.modeled_lookup_time_s())
    assert t.modeled_lookup_time_s()["fast_hit_rate"] > 0.85
    assert_emb_same(t, j)
    rows = rng.integers(0, 4096, 64)
    np.testing.assert_array_equal(
        t.store.gather(torch.from_numpy(rows)).numpy(), table[rows])


def test_tiered_embedding_proactive_policy():
    """``tests/test_lm_tiering.py``'s second flow, in both."""
    rng = np.random.default_rng(1)
    j, t = _embeddings(np.zeros((1024, 16), np.float32), block_rows=8,
                       fast_fraction=0.25, policy="proactive")
    for _ in range(2):
        toks = rng.integers(0, 256, 4096)
        j.observe_tokens(toks)
        t.observe_tokens(toks)
        assert t.rebalance() == j.rebalance()
        np.testing.assert_array_equal(t._pred.view(np.int32),
                                      j._pred.view(np.int32))
        assert_emb_same(t, j)


@pytest.mark.parametrize("pol,alpha", [("oracle", 0.5), ("proactive", 0.3),
                                       ("reactive", 0.5)])
def test_tiered_embedding_epoch_histories_identical(pol, alpha):
    rng = np.random.default_rng(3)
    table = rng.normal(size=(2048, 8)).astype(np.float32)
    j, t = _embeddings(table, block_rows=8, fast_fraction=0.1, policy=pol,
                       ewma_alpha=alpha)
    for e in range(6):
        hot = 400 * (e // 3)                      # the hot set moves once
        toks = np.where(rng.random(3000) < 0.85,
                        rng.integers(hot, hot + 300, 3000),
                        rng.integers(0, 2048, 3000))
        assert_same(t.epoch(toks), j.epoch(toks))
        assert_emb_same(t, j)
    assert_same(t.history, j.history)


# ============================================================ the example
def _jax_example(spec, table, bag, profile_batches, eval_batches, seed,
                 fast_fraction=0.09):
    """``examples/dlrm_tiering.py``'s offline flow, with JAX calls."""
    br = spec.rows_per_page
    n_blocks, batch = spec.n_pages, spec.lookups_per_batch // bag
    store = JStore.create(jnp.asarray(table), block_rows=br,
                          n_slots=int(n_blocks * fast_fraction))
    sampler = jdata.ZipfPageSampler(spec, seed=seed + 1)
    rng = np.random.default_rng(seed)

    def batch_indices():
        pages = sampler.sample(batch * bag).astype(np.int64)
        rows = pages * br + rng.integers(0, br, batch * bag)
        return jnp.asarray(rows.reshape(batch, bag), jnp.int32)

    counts = jnp.zeros((n_blocks,), jnp.int32)
    for _ in range(profile_batches):
        pooled, counts = jax_bag(store.storage[store.fast_rows:],
                                 batch_indices(), counts, block_rows=br)
    plan = jpolicy.oracle_top_k(counts, k=store.n_slots)
    store = store.promote(plan.promote)
    eval_counts = np.zeros(n_blocks, np.int64)
    for _ in range(eval_batches):
        rows = batch_indices().reshape(-1)
        np.testing.assert_array_equal(np.asarray(store.gather(rows)),
                                      table[np.asarray(rows)])
        np.add.at(eval_counts, np.asarray(rows) // br, 1)
    fast_mask = np.asarray(store.block_to_slot) >= 0
    n_fast = float(eval_counts[fast_mask].sum())
    n_slow = float(eval_counts.sum() - n_fast)
    bpa = spec.emb_dim * 4
    return dict(profile_counts=np.asarray(counts), pooled=np.asarray(pooled),
                promoted=np.asarray(plan.promote),
                fast_occupancy=int(store.fast_occupancy()),
                eval_counts=eval_counts, n_fast=n_fast, n_slow=n_slow,
                tiered_s=J_CXL.access_time_s(n_fast, n_slow, bpa),
                dram_only_s=J_CXL.access_time_s(n_fast + n_slow, 0, bpa),
                cxl_only_s=J_CXL.access_time_s(0, n_fast + n_slow, bpa))


@pytest.mark.parametrize("seed", [0, 5])
def test_example_small_matches_the_reference_flow(seed):
    spec = dlrm_tiering.SMALL
    assert (spec.n_pages, spec.rows_per_page, spec.emb_dim) == (256, 4, 16)
    table = (np.random.default_rng(100 + seed).normal(size=(spec.n_rows, 16))
             * 0.05).astype(np.float32)
    kw = dict(bag=4, profile_batches=20, eval_batches=5, seed=seed)
    t = dlrm_tiering.run(spec, table=table, device="cpu", **kw)
    j = _jax_example(spec, table, **kw)
    assert t["batch"] == 8 and t["gathered_equal"]
    np.testing.assert_allclose(t["pooled"].numpy(), j.pop("pooled"),
                               rtol=1e-5, atol=1e-5)
    for key, val in j.items():
        assert_same(t[key], val, key)
    assert t["profile_accesses"] == 20 * 32
    assert 0.0 < t["hit_rate"] < 1.0


def test_example_runs_from_a_generated_table():
    t = dlrm_tiering.run(dlrm_tiering.SMALL, bag=4, profile_batches=2,
                         eval_batches=1, device="cpu")
    assert t["gathered_equal"] and t["fast_occupancy"] > 0


# ===================================================== carry-across (convert)
def test_store_and_bundle_carry_across_and_continue():
    rng = np.random.default_rng(9)
    data = rng.normal(size=(128, 8)).astype(np.float32)
    js = JStore.create(jnp.asarray(data), block_rows=4, n_slots=6)
    js = js.promote(jnp.asarray([3, 9, 9, 30, -1], jnp.int32))
    like = TieredStore.create(torch.zeros(128, 8), block_rows=4, n_slots=6)
    ts = convert.store_from_numpy(jax_flat(js), like=like)
    assert_same(convert.store_to_numpy(ts), jax_flat(js))
    kw = dict(n_blocks=32, k_hot=6, pebs_period=7, nb_scan_rate=8)
    jm = JManager(**kw)
    for _ in range(3):
        jm.observe(rng.integers(0, 32, 500))
    tm = TieringManager(**kw, device="cpu")
    tm.bundle = convert.bundle_from_numpy(jax_flat(jm.bundle), like=tm.bundle)
    # continue both: more traffic, decide, migrate the stores
    batch = rng.integers(0, 32, 700)
    jm.observe(batch)
    tm.observe(batch)
    assert_same(convert.bundle_to_numpy(tm.bundle), jax_flat(jm.bundle))
    jplan = jm.decide()["hmu"].promote
    tplan = tm.decide()["hmu"].promote
    np.testing.assert_array_equal(_np(tplan), _np(jplan))
    js = js.migrate(jplan, jnp.asarray([9], jnp.int32))
    ts = ts.migrate(tplan, torch.tensor([9], dtype=torch.int32))
    assert_same(convert.store_to_numpy(ts), jax_flat(js))
    assert float(jtel.hmu_estimate(jm.hmu).sum()) == float(
        ttel.hmu_estimate(tm.hmu).sum())
