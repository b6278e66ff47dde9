"""The MoE family on the port (``repro_torch.models.moe``, the ``moe``
branches of ``models.model`` and ``serve.engine``, the expert-tiering
scenario and example) against the reference, on the reference's
``jax.random`` weights carried across (``convert.params_from_numpy``).

Tolerances.  ``moe_block``'s router counts and dropped tokens, geometry
and trajectories are exact: ``run_scenario`` fed the reference's expert
stream must give the reference's trajectory JSON byte for byte.  Float
outputs as in ``test_torch_models.py``: float32 activations 2e-5 (the same
f32 math in another summation order), bfloat16 6e-2 on hidden states and
block outputs and 1e-2 on logits (the two frameworks round the same bf16
products at other places); the balance loss 1e-5 in float32 and 1e-4 in
bfloat16 (the float32 router on bf16 activations that differ by a
rounding).

A routing decision is a top-k over float32 probabilities, so where a
layer's bfloat16 input differs by a rounding (every layer after the first
attention) a near-tie may fall the other way, and that token then takes
another expert.  So through ``forward``, ``prefill`` and ``decode_step``
the (L, E) counts are exact with float32 activations; with bfloat16 they
lie within an L1 distance of 2 % of the routings (measured on the smoke
configs over six token draws: 2 of 152, one routing moved, in 5 of 12
draws), and the hidden states and logits meet their tolerance on at least
97 % of the elements (measured: 98.8 %; the moved token's row and what
attends to it differ by up to 0.17).  The port's own expert stream (its
forward on the same weights and tokens) is held to the reference's within
an L1 distance of 2 % of a batch row per batch (measured at most 1 %: 10
of 1,024 accesses moved, 5 routings)."""
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
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.scenarios import MoEExpertScenario as JMoE  # noqa: E402
from repro.scenarios import run_scenario as jrun  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import (cache_to_numpy, params_from_numpy,  # noqa: E402
                                 params_to_numpy)
from repro_torch.core import runtime as trt  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.scenarios import MoEExpertScenario  # noqa: E402
from repro_torch.scenarios import run_scenario as trun  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
ARCHS = ("mixtral-8x22b", "kimi-k2-1t-a32b")
ACTS = {"float32": (jnp.float32, torch.float32),
        "bfloat16": (jnp.bfloat16, torch.bfloat16)}
HIDDEN_TOL = {"float32": 2e-5, "bfloat16": 6e-2}
LOGIT_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-4}
STREAM_L1_SHARE = 0.02
BF16_ROUTING_L1_SHARE = 0.02
BF16_ELEMENTS_WITHIN = 0.97
MOE_SMALL = dict(n_epochs=4, batches_per_epoch=2, shift_at=2, batch=2)


def close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def close_routed(got: torch.Tensor, want, act: str, tol: float) -> None:
    """``close`` in float32; with bfloat16 activations, within ``tol`` on
    at least 97 % of the elements (a moved routing changes its token)."""
    if act == "float32":
        close(got, want, tol)
        return
    diff = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    within = diff <= tol + tol * np.abs(np.asarray(want, np.float32))
    assert within.mean() >= BF16_ELEMENTS_WITHIN, within.mean()
    assert np.isfinite(got.float().numpy()).all()


def assert_counts(got: torch.Tensor, want, act: str) -> None:
    """(L, E) router counts: exact in float32; in bfloat16 the same totals
    per layer and an L1 distance of at most 2 % of the routings."""
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == np.int32 and got.shape == want.shape
    if act == "float32":
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_array_equal(got.sum(-1), want.sum(-1))
    assert np.abs(got - want).sum() <= BF16_ROUTING_L1_SHARE * want.sum()


@pytest.fixture(scope="module")
def carried():
    """Per (arch, act): both configs and the reference's weights on both
    sides."""
    out = {}
    for arch in ARCHS:
        for act, (jdt, tdt) in ACTS.items():
            jc = dataclasses.replace(j_smoke(arch), activ_dtype=jdt)
            tc = dataclasses.replace(get_smoke_config(arch), activ_dtype=tdt)
            jp = jm.init_params(jc, jax.random.key(0))
            out[arch, act] = (jc, tc, jp, params_from_numpy(
                jax.tree.map(np.asarray, jp), device="cpu"))
    return out


def block_inputs(jc, act: str, seed: int = 1, shape=(2, 24)):
    """A layer-0 MoE parameter set on both sides and one activation."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape + (jc.d_model,)).astype(np.float32)
    jx = jnp.asarray(x, ACTS[act][0])
    tx = torch.from_numpy(np.array(jx, np.float32)).to(ACTS[act][1])
    return jx, tx


def j_block_params(jp, layer: int = 0):
    bp = jax.tree.map(lambda t: t[layer], jp["blocks"])
    return jmoe.MoEParams(bp["router"], bp["e_gate"], bp["e_up"],
                          bp["e_down"], bp.get("s_gate"), bp.get("s_up"),
                          bp.get("s_down"))


# ---------------------------------------------------------------- moe_block
@pytest.mark.parametrize("act", sorted(ACTS))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.3])
def test_moe_block_matches_reference(carried, arch, act, capacity_factor):
    """Counts exact, output and balance loss within tolerance; at capacity
    factor 0.3 the experts overflow and tokens are dropped (their output
    is 0 on both sides, the same tokens)."""
    jc, tc, jp, tp = carried[arch, act]
    jx, tx = block_inputs(jc, act)
    jo, ja = jmoe.moe_block(jx, j_block_params(jp), top_k=jc.moe.top_k,
                            capacity_factor=capacity_factor)
    to, ta = tmoe.moe_block(tx, tm.moe_params(tm.layer_params(tp, 0)),
                            top_k=tc.moe.top_k,
                            capacity_factor=capacity_factor)
    assert to.dtype == ACTS[act][1] and to.shape == tuple(jo.shape)
    np.testing.assert_array_equal(ta["counts"].numpy(),
                                  np.asarray(ja["counts"]))
    assert ta["counts"].dtype == torch.int32
    assert int(ta["counts"].sum()) == 2 * 24 * tc.moe.top_k
    close(to, jo, HIDDEN_TOL[act])
    close(ta["aux_loss"], ja["aux_loss"], LOSS_TOL[act])
    if capacity_factor < 1:
        t, e = 2 * 24, tc.moe.n_experts
        capacity = max(int(t * tc.moe.top_k * capacity_factor / e), 4)
        assert int(ta["counts"].max()) > capacity       # tokens were dropped


def test_moe_block_ties_break_lowest_expert_first(carried):
    """A zero router gives every expert the same probability: every token
    goes to experts 0..k-1, as ``lax.top_k`` picks, with equal weights."""
    jc, tc, jp, tp = carried["mixtral-8x22b", "float32"]
    jx, tx = block_inputs(jc, "float32")
    jpar = j_block_params(jp)._replace(
        router=jnp.zeros_like(j_block_params(jp).router))
    tpar = tm.moe_params(tm.layer_params(tp, 0))._replace(
        router=torch.zeros_like(tm.layer_params(tp, 0)["router"]))
    jo, ja = jmoe.moe_block(jx, jpar, top_k=jc.moe.top_k)
    to, ta = tmoe.moe_block(tx, tpar, top_k=tc.moe.top_k)
    want = np.zeros(tc.moe.n_experts, np.int32)
    want[:tc.moe.top_k] = 2 * 24
    np.testing.assert_array_equal(ta["counts"].numpy(), want)
    np.testing.assert_array_equal(np.asarray(ja["counts"]), want)
    close(to, jo, HIDDEN_TOL["float32"])


@pytest.mark.parametrize("groups", [(2, 1), (1, 4), (2, 2)])
def test_moe_block_expert_parallel_path_needs_a_mesh(carried, groups):
    """The reference takes its shard-map path only with groups of more
    than one member AND experts sharded, over its ambient mesh; the port
    takes the mesh as an argument and refuses the path without one
    (tests/test_torch_moe_ep.py drives it over gloo meshes)."""
    _, tc, _, tp = carried["mixtral-8x22b", "float32"]
    x = torch.zeros((1, 4, tc.d_model))
    par = tm.moe_params(tm.layer_params(tp, 0))
    with pytest.raises(ValueError, match="needs the mesh"):
        tmoe.moe_block(x, par, top_k=2, groups=groups, expert_sharded=True)


@pytest.mark.parametrize("groups,expert_sharded",
                         [((2, 1), False), ((1, 4), False), ((1, 1), True)])
def test_moe_block_other_groupings_take_the_single_program_path(
        carried, groups, expert_sharded):
    """Groups without sharded experts, or sharded experts in one group:
    the reference runs its single-program path, and so does the port."""
    jc, tc, jp, tp = carried["mixtral-8x22b", "float32"]
    jx, tx = block_inputs(jc, "float32")
    jo, ja = jmoe.moe_block(jx, j_block_params(jp), top_k=jc.moe.top_k,
                            groups=groups, expert_sharded=expert_sharded)
    to, ta = tmoe.moe_block(tx, tm.moe_params(tm.layer_params(tp, 0)),
                            top_k=tc.moe.top_k, groups=groups,
                            expert_sharded=expert_sharded)
    np.testing.assert_array_equal(ta["counts"].numpy(),
                                  np.asarray(ja["counts"]))
    close(to, jo, HIDDEN_TOL["float32"])
    close(ta["aux_loss"], ja["aux_loss"], LOSS_TOL["float32"])


# ------------------------------------------------------ forward and serving
@pytest.mark.parametrize("act", sorted(ACTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(carried, arch, act):
    """The (L, E) expert counts exact; hidden, logits and the mean balance
    loss within tolerance."""
    jc, tc, jp, tp = carried[arch, act]
    toks = np.random.default_rng(3).integers(0, jc.vocab_size, (2, 19))
    jh, jaux = jm.forward(jp, jc, tokens=jnp.asarray(toks))
    th, taux = tm.forward(tp, tc, tokens=torch.from_numpy(toks))
    assert set(taux) == {"expert_counts", "moe_aux_loss"}
    assert taux["expert_counts"].shape == (tc.n_layers, tc.moe.n_experts)
    assert_counts(taux["expert_counts"], jaux["expert_counts"], act)
    close_routed(th, jh, act, HIDDEN_TOL[act])
    close(taux["moe_aux_loss"], jaux["moe_aux_loss"], LOSS_TOL[act])
    close_routed(tm.logits_fn(tp, tc, th[:, -3:]),
                 jm.logits_fn(jp, jc, jh[:, -3:]), act, LOGIT_TOL[act])


@pytest.mark.parametrize("act", sorted(ACTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(carried, arch, act):
    """Prefill logits and cache, then three decode steps (capacity factor
    4.0): logits, page masses and the step's (L, E) expert counts."""
    jc, tc, jp, tp = carried[arch, act]
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, jc.vocab_size, (2, 11)).astype(np.int32)
    jl, jcache = jeng.prefill(jp, jc, tokens=jnp.asarray(prompt), max_len=16)
    tl, tcache = teng.prefill(tp, tc, tokens=torch.from_numpy(prompt),
                              max_len=16)
    close_routed(tl, jl, act, LOGIT_TOL[act])
    close_routed(torch.from_numpy(cache_to_numpy(tcache)["k"]), jcache["k"],
                 act, HIDDEN_TOL[act])
    for step in range(3):
        tok = rng.integers(0, jc.vocab_size, (2,)).astype(np.int32)
        jl, jcache, jaux = jeng.decode_step(jp, jc, jcache, jnp.asarray(tok),
                                            page_size=4)
        tl, tcache, taux = teng.decode_step(tp, tc, tcache,
                                            torch.from_numpy(tok),
                                            page_size=4)
        assert_counts(taux["expert_counts"], jaux["expert_counts"], act)
        assert (taux["expert_counts"].sum(-1) == 2 * tc.moe.top_k).all()
        close_routed(tl, jl, act, LOGIT_TOL[act])
        close_routed(taux["kv_page_mass"], jaux["kv_page_mass"], act,
                     1e-5 if act == "float32" else 5e-4)


def test_params_carry_every_moe_leaf(carried):
    """``params_from_numpy`` / ``params_to_numpy`` carry the router, the
    expert banks and the shared expert (kimi-k2) unchanged."""
    for arch in ARCHS:
        _, tc, jp, tp = carried[arch, "float32"]
        keys = {"router", "e_gate", "e_up", "e_down"}
        if tc.moe.n_shared:
            keys |= {"s_gate", "s_up", "s_down"}
        assert keys <= set(tp["blocks"])
        back = params_to_numpy(tp)
        for key in keys:
            np.testing.assert_array_equal(
                back["blocks"][key],
                np.asarray(jp["blocks"][key], np.float32))
        own = tm.init_params(tc, 0, device="cpu")
        assert {k: tuple(v.shape) for k, v in own["blocks"].items()} == \
            {k: tuple(v.shape) for k, v in tp["blocks"].items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_moe(arch, capsys):
    rep = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "12", "--gen", "4"])
    assert rep["tokens"].shape == (2, 4)
    assert "[kv-tiering]" in capsys.readouterr().out


# -------------------------------------------------------- expert telemetry
def test_expert_access_batch_matches_reference():
    rng = np.random.default_rng(0)
    for shape in ((8,), (3, 8), (2, 384)):
        c = rng.integers(0, 9, shape).astype(np.int32)
        want = jmoe.expert_access_batch(c)
        np.testing.assert_array_equal(tmoe.expert_access_batch(c), want)
        assert tmoe.expert_access_batch(c).dtype == np.int32
        assert tmoe.expert_access_batch(c).size == int(c.sum())
    with pytest.raises(ValueError):
        tmoe.expert_access_batch(np.zeros((2, 2, 2), np.int32))


@pytest.fixture(scope="module")
def moe_pair():
    """The reference's small MoE scenario (its stream made once) and the
    port's twin on the CPU with the reference's weights carried across."""
    j = JMoE(**MOE_SMALL)
    j_epochs = list(j.epochs())
    jp = jm.init_params(j.cfg, jax.random.key(j.seed))
    t = MoEExpertScenario(device="cpu", params=params_from_numpy(
        jax.tree.map(np.asarray, jp), device="cpu"), **MOE_SMALL)
    return j, j_epochs, t


def test_moe_scenario_geometry_matches_reference():
    for kw in ({}, MOE_SMALL, dict(arch="mixtral-8x22b", k_hot=3)):
        j, t = JMoE(**kw), MoEExpertScenario(device="cpu", **kw)
        for key in ("name", "n_blocks", "k_hot", "shift_at", "n_epochs",
                    "batches_per_epoch", "bytes_per_access", "block_bytes",
                    "pebs_period", "nb_scan_rate", "batch_len"):
            assert getattr(t, key) == getattr(j, key), key
        assert dataclasses.asdict(t.system) == dataclasses.asdict(j.system)
        assert t.hint_layout() is None and j.hint_layout() is None
    with pytest.raises(ValueError, match="MoE family"):
        MoEExpertScenario(arch="qwen2-0.5b", device="cpu")


@pytest.mark.parametrize("hints", [False, True])
@pytest.mark.parametrize("sync_every", [1, 3])
def test_moe_run_scenario_on_reference_stream_byte_identical(moe_pair, hints,
                                                             sync_every):
    """The workload-blind runtime places the reference's expert stream as
    the reference does (K=3 over 4 epochs: a full buffer and a tail)."""
    j, j_epochs, t = moe_pair
    want = jrun(j, hints=hints, sync_every=sync_every)
    with trt.counting() as c:
        got = trun(t, hints=hints, sync_every=sync_every, epochs=j_epochs,
                   device="cpu")
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert c.dispatch["record_sync"] == math.ceil(t.n_epochs / sync_every)


def test_moe_scenario_own_stream_follows_the_reference(moe_pair):
    """The port's own forward passes (carried weights, the bf16 kimi-k2
    smoke model, the reference's tokens): every batch row has the
    reference's length and layer-summed totals, and its per-expert counts
    lie within an L1 distance of 2 % of the row of the reference's."""
    j, j_epochs, t = moe_pair
    t_epochs = list(t.epochs())
    assert len(t_epochs) == len(j_epochs) == t.n_epochs
    assert t.counts.shape == (t.n_epochs * t.batches_per_epoch,
                              t.cfg.n_layers, t.n_blocks)
    moved = []
    for je, te in zip(j_epochs, t_epochs):
        assert te.shape == je.shape == (t.batches_per_epoch, t.batch_len)
        assert te.dtype == np.int32
        for jr, tr in zip(je, te):
            l1 = int(np.abs(np.bincount(jr, minlength=t.n_blocks)
                            - np.bincount(tr, minlength=t.n_blocks)).sum())
            assert l1 <= STREAM_L1_SHARE * t.batch_len, l1
            moved.append(l1)
    assert sum(moved) < STREAM_L1_SHARE * t.batch_len * len(moved)


def test_expert_tiering_example_runs_on_the_cpu(capsys):
    from repro_torch.examples import expert_tiering_moe
    expert_tiering_moe.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "HMU (router) telemetry -> promote 2 experts" in out
    assert "post-shift mean fetch (modeled)" in out
    res = expert_tiering_moe.run("cpu")
    op = res["opportunity"]
    assert int(op["per_expert"].sum()) == 16 * 4 * 64 * 2 * 2
    assert 0.0 < op["fast_share"] <= 1.0
    assert op["modeled_tiered_s"] < op["modeled_all_host_s"]
    lanes = res["online"]["trajectory"]["lanes"]
    assert set(lanes) == set(expert_tiering_moe.LANES)
    assert all(len(v) == 6 for v in lanes.values())


def test_moe_module_imports_no_jax():
    code = ("import sys; import repro_torch.models.moe, "
            "repro_torch.scenarios.moe_experts, "
            "repro_torch.examples.expert_tiering_moe; "
            "print('jax' in sys.modules, 'repro' in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO,
                       env={"PYTHONPATH": str(REPO / "src"),
                            "PATH": "/usr/bin:/bin"}, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["False", "False"]
