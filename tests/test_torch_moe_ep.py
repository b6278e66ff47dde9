"""The expert-parallel MoE on the port (``models.moe``'s path for
``groups`` across a ("data", "model") mesh with experts sharded over
"model", the reference's ``_moe_shard_map``) over gloo meshes (1, 2),
(2, 2) and (1, 4), against the reference's function.

The reference's own test of that path
(``tests/test_distribution.py::test_shard_map_moe_matches_reference``)
fails on this jax.  Its all-to-alls only move whole (expert, slot) rows and
the expert products act on each row alone, so the reference's
``_dispatch_local``, ``_expert_ffn``, ``_combine_local`` and ``_shared_ffn``
run here once per group (batch slice i of gd, sequence slice j of gm) at
the local capacity of ``repro/models/moe.py:190-193`` compute exactly the
function ``_moe_shard_map`` computes, drops included: the oracle.  The
model-level cases (``forward``, ``engine.prefill``, two sharded train
steps with AdamW and with Adafactor) hold the port over the mesh to the
port on one device with each MoE layer computed per group
(``_torch_moe_ep_worker.per_group_moe``), and at capacity factor 8 (no
drops, where the grouping changes nothing) to the single-program path and
to the reference's single-device ``make_train_step``.

One spawn of 4 gloo ranks (``tests/_torch_moe_ep_worker.py``, importing
only ``repro_torch``) serves the module; while they run the model cases,
this process computes the oracle and hands it to them in an ``.npz`` with
``moe_block``'s inputs, and then its single-device comparators.

Tolerances, float32: ``moe_block``'s counts and dropped (token, expert)
pairs exact, its output within 2e-5 of the oracle's largest magnitude;
hidden states, logits and caches within 2e-5 (atol and rtol, as
tests/test_torch_moe.py); the balance loss within 1e-5; the train steps
within PERF.md §2's train-step bounds (loss 1e-5 relative, gradient norm
1e-4 relative, params and optimizer state within 2·lr a step taken and
within 1e-6 on at least 99.9 % of the elements), counts and placements
exact."""
import dataclasses
import json
import multiprocessing
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402
_torch_threads.limit()
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_moe_ep_worker as ew  # noqa: E402
from _perturbed_weights import perturbed_tree  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.optim import cosine_schedule as j_cosine  # noqa: E402
from repro.optim import get_optimizer as j_get_optimizer  # noqa: E402
from repro.train import steps as j_steps  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402

BLOCK_TOL_OF_MAX = 2e-5
HIDDEN_TOL, LOSS_TOL = 2e-5, 1e-5
LOSS_RTOL, GNORM_RTOL = 1e-5, 1e-4
PARAM_TOL, PARAM_WITHIN = 1e-6, 0.999
REFERENCE_COMPILER_OPTIONS = {"xla_backend_optimization_level": 0}
TOP_K, E, D = 2, 8, 64
MOE_FIELDS = ("router", "w_gate", "w_up", "w_down", "shared_w_gate",
              "shared_w_up", "shared_w_down")


def oracle(inputs: dict, groups, cf: float) -> dict:
    """The reference's expert-parallel function on one device: its four
    internals once per group at the local capacity; counts, the balance
    loss and the single-program output from its ``moe_block``."""
    x = jnp.asarray(inputs["x"])
    p = jmoe.MoEParams(*(jnp.asarray(inputs[k]) for k in MOE_FIELDS))
    b, s, d = x.shape
    logits = jnp.einsum("bsd,de->bse", x, p.router)
    topw, tope = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), TOP_K)
    topw = topw / jnp.clip(topw.sum(-1, keepdims=True), 1e-9)
    gd, gm = groups
    bl, sl = b // gd, s // gm
    tl = bl * sl
    capacity = max(int(tl * TOP_K * cf / E), 2)
    capacity = -(-capacity // gm) * gm              # moe.py:190-193
    out = np.zeros((b, s, d), np.float32)
    dropped = np.zeros((b, s, TOP_K), bool)
    for i in range(gd):
        for j in range(gm):
            at = (slice(i * bl, (i + 1) * bl), slice(j * sl, (j + 1) * sl))
            tw = topw[at].reshape(tl, TOP_K)
            x_buf, pos, flat_e = jmoe._dispatch_local(
                x[at].reshape(tl, d), tope[at].reshape(tl, TOP_K), tw, E,
                capacity, x.dtype)
            y_buf = jmoe._expert_ffn(x_buf, p.w_gate, p.w_up, p.w_down,
                                     x.dtype)
            out[at] = np.asarray(jmoe._combine_local(
                y_buf, pos, flat_e, tw, capacity, d, x.dtype)).reshape(
                    bl, sl, d)
            dropped[at] = np.asarray(pos >= capacity).reshape(bl, sl, TOP_K)
    out = out + np.asarray(jmoe._shared_ffn(x, p, x.dtype))
    single, aux = jmoe.moe_block(x, p, top_k=TOP_K, capacity_factor=cf)
    return {"out": out, "dropped": dropped, "capacity": capacity,
            "counts": np.asarray(aux["counts"]),
            "aux_loss": float(aux["aux_loss"]), "single": np.asarray(single)}


class _Ranks:
    """The spawned ranks (started once, joined on first read) and the
    oracle."""

    def __init__(self, tmp):
        self.out = str(tmp)
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=ew.worker,
                                  args=(r, str(tmp / "store"), self.out))
                      for r in range(ew.N_RANKS)]
        for p in self.procs:
            p.start()
        self.joined = False
        # the ranks run the model cases meanwhile, and then wait for this
        # file (written whole, then renamed into place)
        inputs = ew.block_inputs()
        self.oracle = {(m, cf): oracle(inputs, shape, cf)
                       for m, shape in ew.MESHES.items()
                       for cf in ew.FACTORS}
        part = os.path.join(self.out, "block.part.npz")
        np.savez(part, **inputs, **{f"oracle/{m}/{cf}/{k}": v
                                    for (m, cf), o in self.oracle.items()
                                    for k, v in o.items()})
        os.replace(part, os.path.join(self.out, "block.npz"))

    def join(self):
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

    def results(self, case: str, world: int = ew.N_RANKS) -> list:
        """Per rank: its JSON, with its arrays (if any) merged in."""
        self.join()
        got = []
        for r in range(world):
            with open(os.path.join(self.out, f"{case}.{r}.json")) as f:
                res = json.load(f)
            path = os.path.join(self.out, f"{case}.{r}.npz")
            if os.path.exists(path):
                with np.load(path) as z:
                    res.update(dict(z))
            got.append(res)
        return got

    def arrays(self, case: str) -> dict:
        self.join()
        with np.load(os.path.join(self.out, f"{case}.npz")) as z:
            return dict(z)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = _Ranks(tmp_path_factory.mktemp("moe_ep"))
    yield r
    for p in r.procs:
        if p.is_alive():
            p.terminate()


def within_of_max(got, want, tol: float) -> None:
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def coords(rank: int, shape):
    """(batch slice, sequence slice) of ``rank`` on a (gd, gm) mesh over
    ranks 0 .. gd gm - 1 (row major)."""
    gd, gm = shape
    i, j = divmod(rank, gm)
    bl, sl = ew.B // gd, ew.S // gm
    return slice(i * bl, (i + 1) * bl), slice(j * sl, (j + 1) * sl)


# ---------------------------------------------------------------- moe_block
@pytest.mark.parametrize("cf", ew.FACTORS)
@pytest.mark.parametrize("mesh", list(ew.MESHES))
def test_ep_moe_block_matches_the_per_group_oracle(ranks, mesh, cf):
    """Every rank: counts and its group's dropped pairs exact, its batch
    slice's output within 2e-5 of the oracle's largest magnitude; the
    slices' balance losses average to the reference's; two all-to-alls of
    E·C·D float32 each (and drops at capacity factor 1.25)."""
    shape = ew.MESHES[mesh]
    want = ranks.oracle[mesh, cf]
    if cf < 2:
        assert want["dropped"].any()
    got = ranks.results(f"block-{mesh}-{cf}", world=shape[0] * shape[1])
    for r, res in enumerate(got):
        bsl, ssl = coords(r, shape)
        np.testing.assert_array_equal(res["counts"], want["counts"])
        np.testing.assert_array_equal(res["dropped"],
                                      want["dropped"][bsl, ssl])
        within_of_max(res["out"], want["out"][bsl], BLOCK_TOL_OF_MAX)
        c = res["collectives"]
        assert c["all_to_all"] == 2
        assert c["all_to_all_bytes"] == 2 * E * want["capacity"] * D * 4
    losses = [float(res["aux_loss"]) for res in got]
    assert np.mean(losses[::shape[1]]) == pytest.approx(
        want["aux_loss"], rel=LOSS_TOL, abs=LOSS_TOL)


@pytest.mark.parametrize("mesh", list(ew.MESHES))
def test_ep_moe_block_without_drops_is_the_single_program_path(ranks, mesh):
    """At capacity factor 8 no token drops, and the expert-parallel output
    is the reference's single-program ``moe_block``'s."""
    shape = ew.MESHES[mesh]
    want = ranks.oracle[mesh, 8.0]
    assert not want["dropped"].any()
    for r, res in enumerate(ranks.results(f"block-{mesh}-8.0",
                                          world=shape[0] * shape[1])):
        assert not res["dropped"].any()
        within_of_max(res["out"], want["single"][coords(r, shape)[0]],
                      BLOCK_TOL_OF_MAX)


class _Stand:
    """A mesh stand-in: ``moe_block`` checks its groups against the sizes
    before any collective."""

    def __init__(self, **sizes):
        self.shape = sizes


@pytest.mark.parametrize("case", ["groups", "no model axis", "sequence",
                                  "experts", "block"])
def test_ep_moe_block_refuses_what_does_not_split(case):
    cfg = ew.config(1.25)
    p = tm.moe_params(tm.layer_params(ew.params(cfg), 0))
    x = torch.zeros((2, 8, cfg.d_model))
    groups, mesh, match = (1, 2), _Stand(data=1, model=2), None
    if case == "groups":
        groups, mesh, match = (2, 2), _Stand(data=2, model=2), "groups"
    elif case == "no model axis":
        mesh, match = _Stand(data=2), "groups"
    elif case == "sequence":
        x, match = torch.zeros((2, 7, cfg.d_model)), "sequence"
    elif case == "experts":
        groups, mesh, match = (1, 3), _Stand(data=1, model=3), "experts"
        x = torch.zeros((2, 9, cfg.d_model))
    else:
        match = "block"             # all 8 experts where 4 are this rank's
    with pytest.raises(ValueError, match=match):
        tmoe.moe_block(x, p, top_k=2, groups=groups, mesh=mesh,
                       expert_sharded=True)


# ----------------------------------------------------- forward and prefill
def single_device(cf: float, groups=None):
    """The port's forward and prefill on one device (the whole batch),
    each MoE layer per group when ``groups`` is given."""
    cfg = ew.config(cf)
    p = ew.params(cfg)
    toks = ew.batch(cfg, 5)["tokens"]
    real = tm.moe_block
    if groups is not None:
        tm.moe_block = ew.per_group_moe(groups)
    try:
        hidden, aux = tm.forward(p, cfg, tokens=toks)
        logits, cache = teng.prefill(p, cfg, tokens=toks)
    finally:
        tm.moe_block = real
    return hidden, aux, logits, cache


def close(got, want) -> None:
    np.testing.assert_allclose(np.asarray(got), want.detach().numpy(),
                               rtol=HIDDEN_TOL, atol=HIDDEN_TOL)


@pytest.mark.parametrize("cf", ew.FACTORS)
def test_ep_forward_and_prefill_match_one_device(ranks, cf):
    """At (2, 2): each rank's hidden states, last-token logits and cache
    rows are its batch slice's of the one-device run with each MoE layer
    per group, the (L, E) counts the whole batch's; the data slices'
    balance losses average to it.  At capacity factor 8 the same against
    the single-program path."""
    runs = [single_device(cf, (2, 2))]
    if cf > 2:
        runs.append(single_device(cf))
    got = ranks.results(f"model-{cf}")
    for hidden, aux, logits, cache in runs:
        for r, res in enumerate(got):
            bsl = coords(r, (2, 2))[0]
            close(res["hidden"], hidden[bsl])
            close(res["logits"], logits[bsl])
            close(res["k"], cache["k"][:, bsl])
            close(res["v"], cache["v"][:, bsl])
            np.testing.assert_array_equal(res["expert_counts"],
                                          aux["expert_counts"].numpy())
        assert np.mean([float(got[r]["moe_aux_loss"]) for r in (0, 2)]) \
            == pytest.approx(float(aux["moe_aux_loss"]), rel=LOSS_TOL,
                             abs=LOSS_TOL)


# ------------------------------------------------------- sharded train step
def reference_steps(opt_name: str, cf: float):
    """The reference's single-device ``make_train_step`` (jitted) on the
    same inputs, in ``one_device_steps``' form."""
    jc = j_smoke(ew.ARCH)
    jc = dataclasses.replace(jc, param_dtype=jnp.float32,
                             activ_dtype=jnp.float32, loss_chunk=ew.CHUNK,
                             attn_block_k=ew.CHUNK, moe=dataclasses.replace(
                                 jc.moe, capacity_factor=cf))
    opt = j_get_optimizer(opt_name)
    step = j_steps.make_train_step(jc, opt, j_cosine(*ew.LR))
    params = jax.tree.map(jnp.asarray, perturbed_tree(jm.iter_schema(jc)))
    state = opt.init(params)
    batches = [{k: jnp.asarray(v.numpy())
                for k, v in ew.batch(jc, seed).items()}
               for seed in ew.STEP_SEEDS]
    step = jax.jit(step).lower(params, state, batches[0]).compile(
        REFERENCE_COMPILER_OPTIONS)
    out, metrics = {}, []
    for i, bt in enumerate(batches, 1):
        params, state, m = step(params, state, bt)
        out.update({f"p{i}/{k}": v
                    for k, v in ew.named_leaves(params).items()})
        out.update({f"s{i}/{k}": v for k, v in ew.named_leaves(state).items()})
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    return out, metrics


def rel(a, b) -> float:
    return float(abs(float(a) - float(b)) / abs(float(b)))


def assert_steps_match(got: dict, gms: list, want: dict, want_m: list,
                       lr_rel: float = 0.0) -> None:
    lr_sum = 0.0
    for i, wm in enumerate(want_m):
        gm = gms[i]
        assert rel(gm["loss"], wm["loss"]) <= LOSS_RTOL
        assert rel(gm["grad_norm"], wm["grad_norm"]) <= GNORM_RTOL
        assert gm["lr"] == pytest.approx(float(wm["lr"]), rel=lr_rel, abs=0)
        assert sorted(gm) == sorted(wm)
        assert gm["expert_counts"] == np.asarray(wm["expert_counts"]).tolist()
        lr_sum += float(wm["lr"])
        keys = [k for k in want if k[:2] in (f"p{i + 1}", f"s{i + 1}")]
        assert sorted(k for k in got if k[:2] in (f"p{i + 1}", f"s{i + 1}")) \
            == sorted(keys)
        diff = np.concatenate([np.abs(got[k] - want[k]).ravel()
                               for k in keys])
        assert diff.max() <= 2 * lr_sum, diff.max()
        assert (diff <= PARAM_TOL).mean() >= PARAM_WITHIN


@pytest.mark.parametrize("cf", ew.FACTORS)
@pytest.mark.parametrize("opt_name", ew.OPTIMIZERS)
def test_ep_sharded_train_step_matches_one_device(ranks, opt_name, cf):
    """Two steps at (2, 2) with expert parallelism against the port's
    single-device step with each MoE layer per group (at capacity factor
    1.25, where experts overflow), and at capacity factor 8 against the
    port's and the reference's single-program steps.  Every rank: the
    same metrics, every leaf on its placements, the same collectives each
    step; no expert leaf gathered whole by either optimizer: each of the
    three expert leaves is gathered over "data" alone, one layer's block
    at each forward of the layer (the forward and remat's recompute), its
    gradient reduce-scattered over "data" once a layer, no other
    all-gather returns as many bytes, and Adafactor updates the rank's
    blocks."""
    case = f"train-{opt_name}-{cf}"
    per_rank = ranks.results(case)
    got = ranks.arrays(case)
    want, want_m, drops = ew.one_device_steps(opt_name, cf, (2, 2))
    if cf < 2:
        assert sum(drops) > 0
    else:
        assert sum(drops) == 0
    assert_steps_match(got, per_rank[0]["metrics"], want, want_m)
    if cf > 2:
        want, want_m, _ = ew.one_device_steps(opt_name, cf)
        assert_steps_match(got, per_rank[0]["metrics"], want, want_m)
        want, want_m = reference_steps(opt_name, cf)
        assert_steps_match(got, per_rank[0]["metrics"], want, want_m,
                           lr_rel=1e-7)
    n_layers = 2
    for res in per_rank:
        assert res["metrics"] == per_rank[0]["metrics"]
        assert all(all(ok) for ok in res["placements_ok"])
        per = res["collectives"]
        assert per[0] == per[1] == per_rank[0]["collectives"][0], per
        # forward, remat's recompute and backward: 2 + 2 + 2 a layer
        assert per[0]["all_to_all"] == 6 * n_layers
        # one layer's expert leaf as the rank's block over "model" (E / 2
        # experts), whole over "data", in float32
        block = E // 2 * D * ew.config(cf).moe.d_expert * 4
        for log in res["log"]:
            big = [(n, axis) for kind, n, _, axis in log
                   if kind == "all_gather" and n >= block]
            assert big == [(block, "data")] * (3 * 2 * n_layers), big
            scattered = [n for kind, n, _, axis in log
                         if kind == "reduce_scatter" and axis == "data"
                         and n == block // 2]
            assert len(scattered) == 3 * n_layers, scattered
