"""The port's training substrate against the reference's: the data
pipeline (batches bit-identical to ``repro``'s), checkpoints (the same
on-disk layout: either package restores the other's to equal arrays), the
fault-tolerance runtime, gradient compression, the optimizers and the LR
schedule; and the cases of ``tests/test_substrate.py`` on the port's side.

Tolerances: the optimizers' new params and state within 1e-6 of each
leaf's largest magnitude of the reference's on the same grads — the same
float32 elementwise arithmetic (``b ** t`` and ``t ** -decay`` may round
one ulp apart, and where ``b1 * m + (1 - b1) * g`` or ``p - lr * delta``
cancels toward 0 what is left is ulps of the operands, not of the
result); ``cosine_schedule`` within 5e-7 relative (torch's and XLA's
float32 cos may differ in the last bit, which the schedule's arithmetic
carries up to a few ulps); int8 compression exact (round-half-even on
both sides, the same scale); top-k's kept set equal to ``lax.top_k``'s on
magnitudes without ties.  Everything else is exact."""
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402
_torch_threads.limit()
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.optim import cosine_schedule as j_cosine  # noqa: E402
from repro.optim import get_optimizer as j_get_optimizer  # noqa: E402
from repro.optim.optimizers import clip_by_global_norm as j_clip  # noqa: E402
from repro.train import compression as j_comp  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.optim import OptState, cosine_schedule, get_optimizer  # noqa: E402
from repro_torch.optim.optimizers import clip_by_global_norm  # noqa: E402
from repro_torch.pytree import flatten, leaves, unflatten  # noqa: E402
from repro_torch.runtime import (ElasticPlanner, Heartbeat,  # noqa: E402
                                 PreemptionGuard, StragglerDetector)
from repro_torch.train import compression as comp  # noqa: E402

OPT_TOL_OF_MAX = 1e-6
SCHEDULE_RTOL = 5e-7


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------- data
@pytest.mark.parametrize("kw", [
    dict(vocab_size=1000, seq_len=16, global_batch=8, seed=7),
    dict(vocab_size=151_936, seq_len=64, global_batch=4),
    dict(vocab_size=1000, seq_len=8, global_batch=8, n_ranks=4, rank=3),
    dict(vocab_size=10_000, seq_len=33, global_batch=2, zipf_alpha=1.3,
         seed=2)])
def test_pipeline_batches_bit_identical_to_the_reference(kw):
    mine, ref = TokenPipeline(DataConfig(**kw)), JTokenPipeline(JDataConfig(**kw))
    for step in (0, 1, 57):
        a, b = mine.batch(step), ref.batch(step)
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    assert mine.state(5) == ref.state(5)


def test_pipeline_deterministic_and_resumable():
    cfg = DataConfig(vocab_size=1000, seq_len=16, global_batch=8, seed=7)
    p1 = TokenPipeline(cfg)
    b5 = p1.batch(5)
    p2, step = TokenPipeline.resume(cfg, p1.state(5))
    np.testing.assert_array_equal(p2.batch(step)["tokens"], b5["tokens"])
    assert not np.array_equal(p1.batch(6)["tokens"], b5["tokens"])


def test_pipeline_rank_sharding_labels_and_skew():
    batches = [TokenPipeline(DataConfig(
        vocab_size=1000, seq_len=8, global_batch=8, n_ranks=4,
        rank=r)).batch(0) for r in range(4)]
    assert all(b["tokens"].shape == (2, 8) for b in batches)
    assert not np.array_equal(batches[0]["tokens"], batches[1]["tokens"])
    b = TokenPipeline(DataConfig(vocab_size=100, seq_len=12,
                                 global_batch=2)).batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    toks = TokenPipeline(DataConfig(vocab_size=10_000, seq_len=512,
                                    global_batch=64)).batch(0)["tokens"]
    top = np.sort(np.bincount(toks.reshape(-1), minlength=10_000))[::-1]
    assert top[:100].sum() / top.sum() > 0.3
    with pytest.raises(ValueError):
        TokenPipeline(DataConfig(vocab_size=10, seq_len=4, global_batch=3,
                                 n_ranks=2))


# ---------------------------------------------------------------- checkpoint
def _tree():
    """Dicts (keys out of order), a list, a tuple and an OptState: the
    containers the reference's tree encoding knows."""
    rng = np.random.default_rng(0)
    return {"z": t(rng.normal(size=(2, 3)).astype(np.float32)),
            "a": [t(np.arange(4, dtype=np.int32)),
                  (t(np.zeros((2, 2), np.float32)),)],
            "opt": OptState(t(np.asarray(3, np.int32)),
                            {"m": {"w": t(np.ones(5, np.float32))}})}


def _jax_tree():
    from repro.optim.optimizers import OptState as JOptState
    tr = _tree()
    return {"z": jnp.asarray(tr["z"].numpy()),
            "a": [jnp.asarray(tr["a"][0].numpy()),
                  (jnp.asarray(tr["a"][1][0].numpy()),)],
            "opt": JOptState(jnp.asarray(3, jnp.int32),
                             {"m": {"w": jnp.ones(5, jnp.float32)}})}


def test_flatten_order_is_the_references():
    mine, skeleton = flatten(_tree())
    ref = jax.tree.leaves(_jax_tree())
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = unflatten(skeleton, mine)
    assert isinstance(back["opt"], OptState) and isinstance(back["a"][1],
                                                            tuple)


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_checkpoints_restore_across_packages(tmp_path, writer):
    """A checkpoint written by either package restores in the other to
    equal arrays (dtypes too), the manifests' trees equal."""
    if writer == "repro":
        JCheckpointManager(tmp_path).save(4, _jax_tree(), extra={"k": 1},
                                          block=True)
        got, extra = CheckpointManager(tmp_path).restore(device="cpu")
        want = _tree()
    else:
        CheckpointManager(tmp_path).save(4, _tree(), extra={"k": 1},
                                         block=True)
        got, extra = JCheckpointManager(tmp_path).restore()
        want = _jax_tree()
    assert extra == {"k": 1}
    # namedtuples come back as dicts of their fields, in both packages
    assert sorted(got["opt"]) == ["inner", "step"]
    want = {**want, "opt": dict(want["opt"]._asdict())}
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, got)),
                    jax.tree.leaves(jax.tree.map(np.asarray, want))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_manifest_tree_equals_the_references(tmp_path):
    CheckpointManager(tmp_path / "t").save(1, _tree(), block=True)
    JCheckpointManager(tmp_path / "j").save(1, _jax_tree(), block=True)
    a, b = (json.loads((tmp_path / d / "step_00000001" / "manifest.json")
                       .read_text()) for d in ("t", "j"))
    assert a["tree"] == b["tree"] and a["n_arrays"] == b["n_arrays"]


def test_checkpoint_roundtrip_retention_and_atomicity(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last=2)
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": [torch.ones(4, dtype=torch.int32), torch.zeros(2, 2)]}
    for s in (1, 2, 3):
        mgr.save(s, tree, extra={"data_state": {"step": s}}, block=True)
    assert mgr.latest_step() == 3
    restored, extra = mgr.restore()
    np.testing.assert_array_equal(restored["a"], tree["a"].numpy())
    on_cpu, _ = mgr.restore(device="cpu")
    assert torch.equal(on_cpu["b"][0], tree["b"][0])
    assert extra["data_state"]["step"] == 3
    with pytest.raises(Exception):
        mgr.restore(step=1)
    (tmp_path / "step_00000004.tmp").mkdir()
    assert mgr.latest_step() == 3


def test_checkpoint_snapshot_is_taken_before_save_returns(tmp_path):
    """The host copy is taken synchronously: writing into the tensor after
    ``save`` returns (the async writer still running) changes nothing."""
    mgr = CheckpointManager(tmp_path)
    x = torch.ones(512, 512)
    mgr.save(10, {"x": x})
    x.zero_()
    mgr.wait()
    r, _ = mgr.restore(10)
    assert float(r["x"].sum()) == 512 * 512


def test_checkpoint_write_error_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"x": torch.ones(2)}, block=True)
    (tmp_path / "step_00000002.tmp").write_text("a file where a dir goes")
    mgr.save(2, {"x": torch.ones(2)})
    with pytest.raises(OSError):
        mgr.wait()


def test_checkpoint_restore_into_train_state(tmp_path):
    opt = get_optimizer("adamw")
    params = {"w": torch.ones(4, 4)}
    st_ = opt.init(params)
    CheckpointManager(tmp_path).save(5, {"params": params, "opt": st_},
                                     block=True)
    restored, _ = CheckpointManager(tmp_path).restore(5, device="cpu")
    assert torch.equal(restored["params"]["w"], params["w"])
    assert int(restored["opt"]["step"]) == 0
    assert restored["opt"]["step"].dtype == torch.int32
    assert torch.equal(restored["opt"]["inner"]["m"]["w"], torch.zeros(4, 4))


# -------------------------------------------------------------------- runtime
def test_preemption_guard_flag_and_handlers():
    import signal
    g = PreemptionGuard(install=False)
    assert not g.preempted
    g.trigger()
    assert g.preempted
    before = signal.getsignal(signal.SIGTERM)
    g = PreemptionGuard()
    if threading.current_thread() is threading.main_thread():
        signal.raise_signal(signal.SIGTERM)
        assert g.preempted
    g.restore()
    assert signal.getsignal(signal.SIGTERM) == before


def test_straggler_detector_flags_slow_steps_and_ignores_a_blip():
    det = StragglerDetector(threshold_sigma=3.0, patience=2, warmup_steps=5)
    rng = np.random.default_rng(0)
    actions = [det.observe(i, 0.10 + rng.normal(0, 0.004))
               for i in range(50)]
    assert all(a is None for a in actions[10:])
    acts = [det.observe(100 + j, 0.5) for j in range(6)]
    assert "retry_host" in acts and "propose_exclusion" in acts
    det = StragglerDetector(patience=3, warmup_steps=5)
    for i in range(30):
        det.observe(i, 0.1)
    assert det.observe(31, 0.9) in ("log", None)
    assert det.observe(32, 0.1) is None


def test_heartbeat_detects_dead_hosts():
    hb = Heartbeat(timeout_s=10)
    hb.beat("host0", now=100.0)
    hb.beat("host1", now=105.0)
    assert hb.dead_hosts(now=112.0) == ["host0"]


def test_elastic_planner_matches_the_reference():
    from repro.runtime import ElasticPlanner as JPlanner
    for model_axis, batch, healthy, failed in ((16, 256, 256, 32),
                                               (4, 96, 40, 6), (8, 64, 8, 0)):
        mine, ref = ElasticPlanner(model_axis, batch), JPlanner(model_axis,
                                                                batch)
        a, b = mine.plan(healthy, healthy // model_axis), ref.plan(
            healthy, healthy // model_axis)
        assert a.__dict__ == b.__dict__
        assert mine.replan_on_failure(a, failed).__dict__ == \
            ref.replan_on_failure(b, failed).__dict__
    with pytest.raises(RuntimeError):
        ElasticPlanner(model_axis=16, global_batch=256).plan(
            8, baseline_data_axis=16)


# ---------------------------------------------------------------- compression
def test_int8_compression_equals_the_references():
    rng = np.random.default_rng(3)
    g = {"w": rng.normal(size=(300,)).astype(np.float32) * 1e-3,
         "b": {"c": rng.normal(size=(7, 5)).astype(np.float32)}}
    e = jax.tree.map(lambda x: (rng.normal(size=x.shape) * 1e-4)
                     .astype(np.float32), g)
    jg, je, jw = j_comp.int8_compress_grads(
        jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, e))
    tg, te, tw = comp.int8_compress_grads(jax.tree.map(t, g),
                                          jax.tree.map(t, e))
    assert tw == jw
    for a, b in zip(leaves(tg) + leaves(te),
                    jax.tree.leaves(jg) + jax.tree.leaves(je)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # half-way values round to even on both sides
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], np.float32)
    q, _ = comp.quantize_int8(t(x))
    jq, _ = j_comp.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def test_topk_compression_keeps_the_references_set():
    rng = np.random.default_rng(4)
    g = {"w": rng.permutation(2000).astype(np.float32) - 1000.0}
    e = {"w": np.zeros(2000, np.float32)}
    jg, je, jw = j_comp.topk_compress_grads(
        jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, e), 0.02)
    tg, te, tw = comp.topk_compress_grads(jax.tree.map(t, g),
                                          jax.tree.map(t, e), 0.02)
    assert tw == jw
    np.testing.assert_array_equal(tg["w"].numpy(), np.asarray(jg["w"]))
    np.testing.assert_array_equal(te["w"].numpy(), np.asarray(je["w"]))


def test_int8_error_feedback_reduces_bias():
    rng = np.random.default_rng(0)
    g_true = {"w": t(rng.normal(size=(256,)).astype(np.float32) * 1e-3)}
    ef = comp.init_error_feedback(g_true)
    acc = np.zeros(256)
    for _ in range(50):
        g, ef, wire = comp.int8_compress_grads(g_true, ef)
        acc += g["w"].numpy().astype(np.float64)
    np.testing.assert_allclose(acc / 50, g_true["w"].numpy(), rtol=0.02,
                               atol=1e-6)
    assert wire == 256


def test_topk_error_feedback_conserves_gradient_mass():
    rng = np.random.default_rng(1)
    g_true = {"w": t(rng.normal(size=(1000,)).astype(np.float32))}
    ef = comp.init_error_feedback(g_true)
    acc = np.zeros(1000)
    for _ in range(50):
        g, ef, _ = comp.topk_compress_grads(g_true, ef, k_fraction=0.02)
        acc += g["w"].numpy().astype(np.float64)
    total = acc + ef["w"].numpy().astype(np.float64)
    np.testing.assert_allclose(total, 50 * g_true["w"].numpy().astype(
        np.float64), rtol=1e-4, atol=1e-4)
    assert np.count_nonzero(g["w"].numpy()) <= 0.03 * 1000


@settings(max_examples=15, deadline=None)
@given(st.integers(min_value=1, max_value=6))
def test_property_int8_quantization_bounded_error(seed):
    rng = np.random.default_rng(seed)
    x = t((rng.normal(size=(128,)) * 10.0 ** int(rng.integers(-4, 3)))
          .astype(np.float32))
    q, s = comp.quantize_int8(x)
    err = (comp.dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-9


# ----------------------------------------------------------------- optimizers
def _param_tree(rng):
    return {"w": rng.normal(size=(16, 12)).astype(np.float32),
            "stack": {"e": rng.normal(size=(3, 10, 9)).astype(np.float32),
                      "b": rng.normal(size=(12,)).astype(np.float32),
                      "thin": rng.normal(size=(4, 7)).astype(np.float32)}}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizers_match_the_reference(name):
    """Three updates on the same grads (clipped by the global norm first,
    as the step does) and learning rates; Adafactor's factored (w, e) and
    unfactored (b, thin) leaves."""
    rng = np.random.default_rng(5)
    params = _param_tree(rng)
    jopt, topt = j_get_optimizer(name), get_optimizer(name)
    j_update = jax.jit(jopt.update)
    jp, tp = jax.tree.map(jnp.asarray, params), jax.tree.map(t, params)
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    for k in range(3):
        grads = jax.tree.map(lambda x: (rng.normal(size=x.shape) * 10 ** -k)
                             .astype(np.float32), params)
        jg, jn = j_clip(jax.tree.map(jnp.asarray, grads), 1.0)
        tg, tn = clip_by_global_norm(jax.tree.map(t, grads), 1.0)
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
        lr = np.float32(1e-2 / (k + 1))
        jp, js = j_update(jg, js, jp, jnp.asarray(lr))
        tp, ts = topt.update(tg, ts, tp, torch.tensor(lr))
        for a, b in zip(leaves(tp) + leaves(ts.inner),
                        jax.tree.leaves(jp) + jax.tree.leaves(js.inner)):
            b = np.asarray(b)
            assert np.abs(a.numpy() - b).max() <= OPT_TOL_OF_MAX * np.abs(
                b).max()
    assert int(ts.step) == int(js.step) == 3
    assert ts.step.dtype == torch.int32


def test_optimizer_update_leaves_its_inputs_alone():
    rng = np.random.default_rng(6)
    params = jax.tree.map(t, _param_tree(rng))
    before = jax.tree.map(torch.clone, params)
    opt = get_optimizer("adamw")
    state = opt.init(params)
    grads = jax.tree.map(torch.ones_like, params)
    new, state2 = opt.update(grads, state, params, torch.tensor(0.1))
    for a, b in zip(leaves(params), leaves(before)):
        assert torch.equal(a, b)
    assert int(state.step) == 0 and int(state2.step) == 1
    with pytest.raises(KeyError):
        get_optimizer("sgd")


def test_cosine_schedule_matches_the_reference_over_100_steps():
    for args in ((3e-4, 10, 100), (1e-3, 1, 12), (2e-4, 0, 50, 0.2)):
        mine, ref = cosine_schedule(*args), jax.jit(j_cosine(*args))
        for step in range(101):
            a, b = mine(step), ref(jnp.int32(step))
            assert a.dtype == torch.float32
            np.testing.assert_allclose(float(a), float(b), rtol=SCHEDULE_RTOL)
        steps = torch.arange(101, dtype=torch.int32)
        np.testing.assert_allclose(
            mine(steps).numpy(), np.asarray(ref(jnp.arange(101))),
            rtol=SCHEDULE_RTOL)
