"""The sharded train step (``repro_torch.train.sharded``) at a (2, 2)
("data", "model") gloo mesh against the port's single-device
``train.steps.make_train_step`` and against the reference's single-device
``make_train_step`` (jitted) on the same inputs, for one smoke config of
each family; checkpoints across meshes; the major-first split; and
``constrain_batch`` on a DTensor.

The reference defines its sharded step to equal the single-device one
(``tests/test_distribution.py::test_sharded_train_step_matches_single_device``,
which fails on this jax), so the single-device step of either package is
the oracle.  Inputs: every parameter leaf drawn (``_perturbed_weights``),
float32, B 4, S 48 (three loss chunks and attention blocks of 16), the two
MoE at capacity factor 8 (no token drops) and again at their configs' own
1.25 (the ``-drops`` cases: experts overflow, and the tokens dropped must
be the whole batch's, not each rank's slice's), kimi-k2 on Adafactor, the
rest on AdamW, two steps.

One spawn of 4 gloo ranks (``tests/_torch_sharded_train_worker.py``, which
imports only ``repro_torch``) serves the module; this process takes the
single-device steps of both packages meanwhile.

Tolerances (PERF.md §2's train-step bounds, float32): the loss within 1e-5
relative, the gradient norm within 1e-4 relative, every gradient leaf
within 1e-4 of that leaf's largest magnitude, the params and optimizer
state within 2·lr a step taken everywhere (AdamW moves a weight by about
lr·sign(g), and where g is at the float32 noise floor the two sides may
step opposite ways) and within 1e-6 on at least 99.9 % of elements; router
counts, placements and restored checkpoints exact."""
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

import _torch_sharded_train_worker as sw  # noqa: E402
from _perturbed_weights import perturbed_tree  # noqa: E402
from repro.configs import get_optimizer_name  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.optim import cosine_schedule as j_cosine  # noqa: E402
from repro.optim import get_optimizer as j_get_optimizer  # noqa: E402
from repro.train import steps as j_steps  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.optim import OptState  # noqa: E402
from repro_torch.train.steps import loss_and_grads, make_train_step  # noqa: E402

LOSS_RTOL, GNORM_RTOL, GRAD_TOL_OF_MAX = 1e-5, 1e-4, 1e-4
PARAM_TOL, PARAM_WITHIN = 1e-6, 0.999
# a reference step compiles without LLVM's optimisation passes: the same
# HLO and float32 results in less time (as tests/test_torch_train.py)
REFERENCE_COMPILER_OPTIONS = {"xla_backend_optimization_level": 0}


class _Ranks:
    """The spawned ranks: started once, joined on first read."""

    def __init__(self, tmp):
        self.out = str(tmp)
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=sw.worker,
                                  args=(r, str(tmp / "store"), self.out))
                      for r in range(sw.N_RANKS)]
        for p in self.procs:
            p.start()
        self.joined = False

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

    def results(self, case: str, world: int = sw.N_RANKS) -> list:
        self.join()
        got = []
        for r in range(world):
            with open(os.path.join(self.out, f"{case}.{r}.json")) as f:
                got.append(json.load(f))
        return got

    def arrays(self, case: str) -> dict:
        self.join()
        with np.load(os.path.join(self.out, f"{case}.npz")) as z:
            return dict(z)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = _Ranks(tmp_path_factory.mktemp("sharded_train"))
    yield r
    for p in r.procs:
        if p.is_alive():
            p.terminate()


def rel(a, b) -> float:
    return float(abs(float(a) - float(b)) / abs(float(b)))


def assert_state_close(got: dict, want: dict, bound: float) -> None:
    assert sorted(got) == sorted(want)
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert diff.max() <= bound, diff.max()
    assert (diff <= PARAM_TOL).mean() >= PARAM_WITHIN, (diff <= PARAM_TOL).mean()


def single_device(case: str):
    """The port's single-device steps on the workers' inputs -> (the
    gathered-state names -> arrays after each step, and the first step's
    gradient; the metrics of each step)."""
    cfg, params, opt, sched = sw.inputs(case)
    step = make_train_step(cfg, opt, sched)
    state = opt.init(params)
    grads = loss_and_grads(params, cfg, sw.batch(cfg, sw.STEP_SEEDS[0]))[2]
    out, metrics = {}, []
    for i, seed in enumerate(sw.STEP_SEEDS, 1):
        params, state, m = step(params, state, sw.batch(cfg, seed))
        out.update({f"p{i}/{k}": v
                    for k, v in sw.named_leaves(params).items()})
        out.update({f"s{i}/{k}": v for k, v in sw.named_leaves(state).items()})
        metrics.append(m)
    out.update({f"g/{k}": v for k, v in sw.named_leaves(grads).items()})
    return out, metrics


def reference(case: str):
    """The reference's single-device ``make_train_step`` under
    ``jax.jit`` on the workers' inputs, in :func:`single_device`'s form
    (the first step's gradient is the one the step's ``jax.grad`` hands
    its ``grad_transform``)."""
    arch, capacity_factor = sw.CASES[case]
    jc = dataclasses.replace(j_smoke(arch), param_dtype=jnp.float32,
                             activ_dtype=jnp.float32, loss_chunk=sw.CHUNK,
                             attn_block_k=sw.CHUNK)
    if capacity_factor is not None:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(
            jc.moe, capacity_factor=capacity_factor))
    opt = j_get_optimizer(get_optimizer_name(arch))
    seen = {}

    def hand_out(g):
        seen["grads"] = g
        return g

    step = j_steps.make_train_step(jc, opt, j_cosine(*sw.LR),
                                   grad_transform=hand_out)

    def run(params, state, batch):
        return step(params, state, batch) + (seen["grads"],)

    params = jax.tree.map(jnp.asarray, perturbed_tree(jm.iter_schema(jc)))
    state = opt.init(params)
    batches = [jax.tree.map(jnp.asarray, sw.batch_np(jc, seed))
               for seed in sw.STEP_SEEDS]
    run = jax.jit(run).lower(params, state, batches[0]).compile(
        REFERENCE_COMPILER_OPTIONS)
    out, metrics = {}, []
    for i, bt in enumerate(batches, 1):
        params, state, m, grads = run(params, state, bt)
        if i == 1:
            out.update({f"g/{k}": v
                        for k, v in sw.named_leaves(grads).items()})
        out.update({f"p{i}/{k}": v
                    for k, v in sw.named_leaves(params).items()})
        out.update({f"s{i}/{k}": v for k, v in sw.named_leaves(state).items()})
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    return out, metrics


def assert_matches(got: dict, gms: list, want: dict, want_m: list,
                   lr_rel: float = 0.0) -> None:
    """The sharded run (gathered arrays ``got``, rank 0's metrics ``gms``)
    against a single-device run at the module's bounds; the learning rate
    exact against the port's schedule, within ``lr_rel`` of the
    reference's (float32 in another order, as tests/test_torch_train.py
    holds it)."""
    lr_sum = 0.0
    for i, wm in enumerate(want_m):
        gm = gms[i]
        assert rel(gm["loss"], wm["loss"]) <= LOSS_RTOL
        assert rel(gm["grad_norm"], wm["grad_norm"]) <= GNORM_RTOL
        assert gm["lr"] == pytest.approx(float(wm["lr"]), rel=lr_rel, abs=0)
        assert sorted(gm) == sorted(wm)
        if "expert_counts" in wm:
            assert gm["expert_counts"] == np.asarray(
                wm["expert_counts"]).tolist()
        lr_sum += float(wm["lr"])
        for part in ("p", "s"):
            keys = [k for k in want if k.startswith(f"{part}{i + 1}/")]
            assert_state_close({k: got[k] for k in keys},
                               {k: want[k] for k in keys}, 2 * lr_sum)
    grads = [k for k in want if k.startswith("g/")]
    assert sorted(grads) == sorted(k for k in got if k.startswith("g/"))
    for k in grads:
        err = np.abs(got[k] - want[k]).max()
        assert err <= GRAD_TOL_OF_MAX * np.abs(want[k]).max(), (k, err)


def assert_experts_overflow(case: str, metrics: list) -> None:
    """A ``-drops`` case tests something only where an expert of some
    layer receives more routed tokens than its capacity."""
    cfg = sw.config(case)
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    capacity = max(int(sw.B * sw.S * k * cfg.moe.capacity_factor / e), 4)
    most = max(int(np.max(np.asarray(m["expert_counts"]))) for m in metrics)
    assert most > capacity, (most, capacity)


@pytest.mark.parametrize("case", list(sw.CASES))
def test_sharded_step_matches_the_single_device_step(ranks, case):
    want, want_m = single_device(case)
    if case.endswith("-drops"):
        assert_experts_overflow(case, want_m)
    per_rank = ranks.results(case)
    assert_matches(ranks.arrays(case), per_rank[0]["metrics"], want,
                   [{k: v.numpy() for k, v in m.items()} for m in want_m])
    for res in per_rank:
        # every rank: the same metrics, every leaf on its named placements,
        # the same collectives in both steps (and on every rank)
        assert res["metrics"] == per_rank[0]["metrics"]
        assert all(all(ok) for ok in res["placements_ok"])
        per = res["collectives"]
        assert per[0] == per[1] == per_rank[0]["collectives"][0], per
        assert per[0]["all_gather"] >= 1 and per[0]["all_reduce"] >= 1


@pytest.mark.parametrize("case", list(sw.CASES))
def test_sharded_step_matches_the_reference_step(ranks, case):
    """The same sharded run against the reference's jitted single-device
    step, so a fault both of the port's steps share shows too."""
    want, want_m = reference(case)
    if case.endswith("-drops"):
        assert_experts_overflow(case, want_m)
    assert_matches(ranks.arrays(case), ranks.results(case)[0]["metrics"],
                   want, want_m, lr_rel=1e-7)


def test_checkpoint_restores_across_meshes_bit_for_bit(ranks):
    """Saved from the (2, 2) mesh; restored at (4,) ("data",) each rank
    holds its block of the saved array and the gathered state is it; and
    restored with no mesh it is the saved array."""
    for res in ranks.results("restore"):
        for key in ("placements_ok", "blocks_equal", "gathered_equal",
                    "meshless_equal", "step_placements_ok"):
            assert res[key] and all(res[key]), key


def test_step_after_the_restore_matches_the_single_device_step(ranks):
    """One more sharded step at (4,) from the restored state against the
    single-device step from the same checkpoint (read here, without a
    mesh); and from the same state a batch too small to split, which every
    rank takes whole."""
    cfg, _, opt, sched = sw.inputs(next(iter(sw.CASES)))
    per_rank = ranks.results("restore")
    tree, _ = CheckpointManager(os.path.join(ranks.out, "ckpt")).restore(
        device="cpu")
    params, state, m = make_train_step(cfg, opt, sched)(
        tree["params"], OptState(**tree["opt"]),
        sw.batch(cfg, sw.RESTORE_SEED))
    got = ranks.arrays("restore")
    gm = per_rank[0]["metrics"]
    assert rel(gm["loss"], m["loss"]) <= LOSS_RTOL
    assert rel(gm["grad_norm"], m["grad_norm"]) <= GNORM_RTOL
    assert gm["lr"] == float(m["lr"])
    want = {**{f"p/{k}": v for k, v in sw.named_leaves(params).items()},
            **{f"s/{k}": v for k, v in sw.named_leaves(state).items()}}
    assert_state_close(got, want, 2 * float(m["lr"]))
    assert all(res["metrics"] == gm for res in per_rank)
    # the same state and a batch of 2, which does not split over 4 ranks
    _, _, m2 = make_train_step(cfg, opt, sched)(
        tree["params"], OptState(**tree["opt"]),
        {k: v[:2] for k, v in sw.batch(cfg, sw.RESTORE_SEED).items()})
    for res in per_rank:
        assert rel(res["unsplit_metrics"]["loss"], m2["loss"]) <= LOSS_RTOL
        assert rel(res["unsplit_metrics"]["grad_norm"],
                   m2["grad_norm"]) <= GNORM_RTOL


def test_a_major_first_entry_lands_by_its_order_not_the_meshes(ranks):
    """("pod", "data") over a 2 x 2 mesh listed either way: rank (pod p,
    data q) holds block p * 2 + q (``Shard`` twice on the mesh in that
    order, a ``_StridedShard`` on "data" when the mesh lists it first),
    and DTensor's own gather agrees."""
    got = ranks.results("major_first")
    for name in ("pod_data", "data_pod"):
        for res in got:
            r = res[name]
            assert r["holds_major_first_block"], (name, r)
            assert r["dtensor_full_tensor_equal"] and r["gather_equal"], r
            assert r["slices_in_block_order"], r
        assert sorted(res[name]["block"] for res in got) == [0, 1, 2, 3]
    assert got[0]["pod_data"]["placements"] == ["Shard(dim=0)"] * 2
    assert "_StridedShard" in got[0]["data_pod"]["placements"][0]


def test_constrain_batch_on_a_dtensor_at_w2(ranks):
    for res in ranks.results("constrain", world=2):
        assert all(v for k, v in res.items() if k != "placements"), res

