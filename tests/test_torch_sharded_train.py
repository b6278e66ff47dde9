"""The sharded train step (``repro_torch.train.sharded``), FSDP over
"data" and tensor parallel over "model", at (2, 2), (1, 4) and (4, 1)
("data", "model") gloo meshes against the port's single-device
``train.steps.make_train_step`` and against the reference's single-device
``make_train_step`` (jitted) on the same inputs, for one smoke config of
each family at (2, 2), at (1, 4) a dense one (each rank slicing the KV
head its query head reads), a tied one, one whose heads the rules cut,
Mixtral and the two recurrent ones (rwkv6's 2 heads leave two ranks
none), and at (4, 1) a dense one and kimi-k2 on Adafactor, each on its
arch's sharding overrides (Mixtral's puts its experts' ``expert_mlp`` on
"model": each rank runs every expert on its block of ``d_expert``); the
collectives over "model" and over "data" (each leaf gathered at use, its
gradient reduce-scattered); Adafactor on blocks against its whole update;
the tensor-parallel modules (the MoE expert FFN, RWKV-6's time and channel
mixes and Mamba2's mix among them) against their unsharded calls at (1,
2); the step
at one "model" rank against the step without a mesh, bit for bit, and
against the reference (on the platform where they were taken, against the
digests of the step before tensor parallelism too); checkpoints across
meshes; the major-first split; and
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
step opposite ways) and within 1e-6 on at least 99.9 % of elements;
Adafactor's update on blocks against its whole update: the factored
statistics within 1e-6 relative element by element, the params within
1e-6 of each leaf's largest magnitude; router
counts, placements, collective counts, the step at one "model" rank
against the step without a mesh, and restored checkpoints exact; a tensor-parallel module's output and gradients within
1e-5 of their largest magnitude."""
import dataclasses
import functools
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
from repro_torch.launch.sharding import tp_config  # noqa: E402
from repro_torch.models.model import tp_layout  # noqa: E402
from repro_torch.optim import OptState  # noqa: E402
from repro_torch.train.steps import loss_and_grads, make_train_step  # noqa: E402

LOSS_RTOL, GNORM_RTOL, GRAD_TOL_OF_MAX = 1e-5, 1e-4, 1e-4
PARAM_TOL, PARAM_WITHIN = 1e-6, 0.999
ADAFACTOR_RTOL = 1e-6
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


@functools.cache
def reference(case: str):
    """The reference's single-device ``make_train_step`` under
    ``jax.jit`` on the workers' inputs, in :func:`single_device`'s form
    (the first step's gradient is the one the step's ``jax.grad`` hands
    its ``grad_transform``)."""
    arch, capacity_factor, _, changes = sw.CASES[case]
    jc = dataclasses.replace(j_smoke(arch), param_dtype=jnp.float32,
                             activ_dtype=jnp.float32, loss_chunk=sw.CHUNK,
                             attn_block_k=sw.CHUNK, **changes)
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
        # FSDP's gathers over "data" (at one "data" rank every leaf the
        # rules split is local to "model" in a dense config)
        assert per[0]["all_reduce"] >= 1
        if sw.mesh_size(case, "data") > 1:
            assert per[0]["all_gather"] >= 1


@pytest.mark.parametrize("case", list(sw.CASES))
def test_sharded_step_matches_the_reference_step(ranks, case):
    """The same sharded run against the reference's jitted single-device
    step, so a fault both of the port's steps share shows too."""
    want, want_m = reference(case)
    if case.endswith("-drops"):
        assert_experts_overflow(case, want_m)
    assert_matches(ranks.arrays(case), ranks.results(case)[0]["metrics"],
                   want, want_m, lr_rel=1e-7)


# the step's all-reduces over "model" in a config whose tokens are
# embedded, dense, MoE with its expert FFN tensor parallel, or recurrent:
# a dense layer 5 (the attention's and the MLP's from_model in the
# forward, the attention's again in the recompute under remat: the
# checkpoint stops recomputing once the tensors it saved are back, before
# the MLP's; the two to_model in the backward), a MoE layer 6 (the
# attention's and the experts' from_model in the forward, the attention's
# again in the recompute, which stops before the experts'; the
# attention's to_model and the experts' two, of the dispatched rows and
# of the routing weights, in the backward), an RWKV-6 layer 4 (the time
# mix's from_model in the forward and in the recompute, the two mixes'
# to_model in the backward; the channel mix joins in a reduce-scatter and
# an all-gather), a Mamba2 layer 7 (its sum of squares and its output in
# the forward and in its group's recompute, the sum of squares alone in
# its own recompute, which stops before the output's; the input's and
# the sum of squares' to_model in the backward), zamba2's shared block 5
# an invocation (a dense layer's), 1 of the embedding, 1 of the loss's
# to_model, 4 a loss chunk (its row max and its packed sums, again in the
# chunk's recompute) and one a partial leaf's gradient where "model" does
# not cut the leaf (the clip's squares take one more after these)
def model_all_reduces(cfg, n_partial: int) -> int:
    per_layer = {"moe": 6, "rwkv6": 4, "zamba2": 7}.get(cfg.family, 5)
    shared = 5 * cfg.n_shared_attn if cfg.family == "zamba2" else 0
    return per_layer * cfg.n_layers + shared + 1 + 1 \
        + 4 * (sw.S // sw.CHUNK) + n_partial


EXPERT_LEAVES = {"blocks/e_gate", "blocks/e_up", "blocks/e_down"}


def uses(cfg, path: str) -> int:
    """How many times a step's forward reads leaf ``path`` (``a/b``): a
    stacked leaf once a layer, zamba2's shared block once an invocation,
    the embedding once for tokens and once more as a tied head."""
    if path.startswith("blocks/"):
        return cfg.n_layers
    if path.startswith("shared_attn/"):
        return cfg.n_shared_attn
    if path == "embed":
        return int(cfg.frontend == "tokens") + int(cfg.tie_embeddings)
    return 1


def forward_runs(cfg, path: str) -> int:
    """How many times a step runs each forward of the block that reads
    leaf ``path``, gathering it each time: a checkpointed block twice (the
    forward and the recompute), zamba2's Mamba2 layers three times (each
    is checkpointed inside its checkpointed group: the group's recompute
    runs the layer's forward again, and the layer's backward recomputes
    it once more); the embedding and the loss's head, read outside the
    checkpoints, once."""
    if path.startswith("blocks/"):
        return 3 if cfg.family == "zamba2" else 2
    if path.startswith("shared_attn/"):
        return 2
    return 1


@pytest.mark.parametrize("case", list(sw.CASES))
def test_collectives_over_model(ranks, case):
    """No leaf that the rules split over "model" on its heads, KV heads,
    mlp or vocab dim is all-gathered over "model" in a dense or MoE
    attention, the embedding or the loss: each rank uses its block.  The
    all-gathers over "model" recorded in the step's gradient (its forward,
    backward and reduction) are exactly the other leaves the rules cut
    over "model" (MoE's expert leaves, RWKV-6's ``wo`` and, where its
    heads do not divide "model", its ``wr`` / ``wk`` / ``wv`` / ``wg``,
    Mamba2's ``in_proj`` and conv, zamba2's LoRA factors), each gathered
    at each use in each forward of its block, and, where the rules cut
    through a head, 3 of q's or o's columns a layer (the forward, the
    recompute and the backward of o's split); the partial ones among them
    are reduce-scattered over "model" once a use.  RWKV-6's channel mix
    adds 2 all-gathers (the forward's join, the backward of its
    reduce-scatter) and 2 reduce-scatters (the forward and the recompute)
    a layer.  The all-reduces over "model" are exactly
    :func:`model_all_reduces`' (5 a dense layer).  Each rank keeps as its
    block every leaf the rules cut over "model" where the block is the
    rank's heads' or columns' slice: RWKV-6's channel mix always, its time
    mix's ``wr`` / ``wk`` / ``wv`` / ``wg`` where its heads divide
    "model", Mamba2's ``out_proj`` where its heads do.  Where the
    overrides put ``expert_mlp`` on "model" (Mixtral) the expert leaves
    are local too, each rank's block of every expert's ``d_expert`` (cut
    over "data" as well), never gathered over "model", and a MoE layer
    takes 6 all-reduces over "model" (:func:`model_all_reduces`)."""
    cfg = sw.config(case)
    per_rank = ranks.results(case)
    leaves = per_rank[0]["leaves"]
    if sw.mesh_size(case, "model") == 1:
        # FSDP alone: nothing is local to "model", nothing crosses it
        assert not leaves["local"] and not leaves["partial"]
        assert not any(v for res in per_rank
                       for v in res["grads_over_model"].values())
        return
    assert "embed" in leaves["local"]
    if cfg.family in ("attn", "moe"):
        assert {"blocks/wq", "blocks/wo"} <= set(leaves["local"])
        assert set(leaves["gathered"]) <= {f"blocks/{k}" for k in (
            "e_gate", "e_up", "e_down", "s_gate", "s_up", "s_down")}, leaves
    if cfg.family == "attn":
        assert not leaves["gathered"]
        assert {"blocks/w_gate", "blocks/w_up", "blocks/w_down"} \
            <= set(leaves["local"])
    m = sw.mesh_size(case, "model")
    mix, ffn = tp_layout(tp_config(cfg, FakeMesh(case), sw.overrides(case)),
                         m)[5:]
    if cfg.family == "rwkv6":
        heads = cfg.d_model // 64
        assert mix == ("local" if heads % m == 0 else "sliced") and ffn
        assert {"blocks/f_wk", "blocks/f_wv", "blocks/f_wr"} \
            <= set(leaves["local"])
        time = {f"blocks/{w}" for w in ("wr", "wk", "wv", "wg")}
        assert (time <= set(leaves["local"])) == (heads % m == 0)
        assert (time <= set(leaves["gathered"]) & set(leaves["partial"])) \
            == (heads % m != 0)
        assert "blocks/wo" in set(leaves["gathered"]) & set(leaves["partial"])
    if cfg.family == "zamba2":
        assert mix == ("local" if cfg.mamba_heads % m == 0 else "sliced")
        assert ("blocks/out_proj" in leaves["local"]) == (mix == "local")
        assert {"blocks/in_proj", "blocks/conv_w", "blocks/conv_b"} \
            <= set(leaves["gathered"]) & set(leaves["partial"])
    experts_tp = sw.overrides(case).get("expert_mlp") == "model"
    if experts_tp:
        assert EXPERT_LEAVES <= set(leaves["local"]) and \
            not leaves["gathered"], leaves
        cut_by = sw.mesh_size(case, "data") * sw.mesh_size(case, "model")
        for res in per_rank:
            for k in EXPERT_LEAVES:
                b = res["blocks"][k]
                assert b["bytes"] * cut_by == b["whole"], (k, b)
    cut = cfg.family in ("attn", "moe", "zamba2") \
        and cfg.n_heads % sw.mesh_size(case, "model") != 0
    if cfg.family in ("attn", "moe"):
        sliced = not cut \
            and cfg.n_kv_heads % sw.mesh_size(case, "model") != 0
        kv = {"blocks/wk", "blocks/wv"}
        assert (kv <= set(leaves["partial"])) == sliced
        assert (kv <= set(leaves["local"])) == (not cut and not sliced)
    gathers = sum(uses(cfg, k) * forward_runs(cfg, k)
                  for k in leaves["gathered"])
    summed = sum(uses(cfg, k) for k in leaves["gathered"]
                 if k in leaves["partial"])
    joins = 2 * cfg.n_layers if ffn else 0
    for res in per_rank:
        assert res["leaves"] == leaves
        over = res["grads_over_model"]
        assert over["all_gather"] == gathers + joins \
            + (3 * cfg.n_layers if cut else 0), (over, leaves)
        assert over["reduce_scatter"] == summed + joins, (over, leaves)
        if (cfg.family != "moe" or experts_tp) \
                and cfg.frontend == "tokens":
            assert over["all_reduce"] == model_all_reduces(
                cfg, len(set(leaves["partial"])
                         - set(leaves["gathered"]))), over


class FakeMesh:
    """A case's mesh as the rules read it (``shape`` alone)."""

    def __init__(self, case: str):
        self.shape = {"data": sw.mesh_size(case, "data"),
                      "model": sw.mesh_size(case, "model")}


def layer_bytes(cfg, blocks: dict) -> tuple:
    """(one layer's leaves, the largest leaf outside the layers), whole,
    in bytes."""
    layer = sum(b["whole"] // cfg.n_layers for k, b in blocks.items()
                if k.startswith("blocks/"))
    return layer, max(b["whole"] for k, b in blocks.items()
                      if not k.startswith("blocks/"))


@pytest.mark.parametrize("case", [c for c in sw.CASES
                                  if sw.mesh_size(c, "data") > 1])
def test_collectives_over_data(ranks, case):
    """FSDP over "data", exactly, in the step's gradient on every rank:
    each leaf "data" cuts is all-gathered over "data" at each use in each
    forward of its block (the recompute gathers again), and its gradient
    comes back in one reduce-scatter over "data" a use; the all-reduces
    over "data" are the packed loss terms and one a leaf "data" does not
    cut, at that leaf's bytes (none of a leaf "data" cuts); MoE's routed
    counts add one all-gather of each batch slice's a forward of each
    layer; no all-gather returns more than one layer's leaves or the
    largest leaf outside the layers.  The step's own collectives: the same
    in both steps, and at (4, 1) none over "model"."""
    cfg = sw.config(case)
    for res in ranks.results(case):
        blocks = res["blocks"]
        cut = [k for k, b in blocks.items() if b["data_cut"]]
        whole = [k for k, b in blocks.items() if not b["data_cut"]]
        assert cut and "embed" in cut
        log = res["grads_over_data"]
        kinds = {k: [n for kind, n in log if kind == k]
                 for k in ("all_gather", "reduce_scatter", "all_reduce",
                           "all_to_all")}
        routed = 2 * cfg.n_layers if cfg.family == "moe" else 0
        assert len(kinds["all_gather"]) == routed + sum(
            uses(cfg, k) * forward_runs(cfg, k) for k in cut), case
        assert len(kinds["reduce_scatter"]) == sum(uses(cfg, k)
                                                   for k in cut), case
        packed = 8 * (3 if cfg.family == "moe" else 2)
        assert sorted(kinds["all_reduce"]) == sorted(
            [packed] + [blocks[k]["bytes"] for k in whole]), case
        assert not kinds["all_to_all"]
        assert max(kinds["all_gather"]) <= max(layer_bytes(cfg, blocks))
        if sw.mesh_size(case, "model") == 1:
            per = res["collectives"][0]
            assert per == res["collectives"][1]
            assert not any(res["grads_over_model"].values())


def test_adafactor_on_blocks_matches_the_whole_update(ranks):
    """Adafactor's update of kimi-k2's smoke leaves on each rank's blocks
    at (2, 2) and (4, 1) (its means over a cut dim summed over the axes
    that cut it) against its update of the whole leaves from the same
    gradient and state, on every rank: the factored statistics within
    1e-6 relative element by element, the new params within 1e-6 of each
    leaf's largest magnitude (an element near 0 is a difference of two
    numbers some 1e2 larger)."""
    for res in ranks.results("adafactor"):
        for name in ("mesh22", "mesh41"):
            got = res[name]
            assert got["cut"] > 0 and got["steps"] == [4, 4], (name, got)
            assert got["state_relative"] <= ADAFACTOR_RTOL, (name, got)
            assert got["params_of_max"] <= ADAFACTOR_RTOL, (name, got)


@pytest.mark.parametrize("unit", sw.UNITS + tuple(sw.MOE_UNITS))
def test_tensor_parallel_module_matches_the_unsharded_call(ranks, unit):
    """At (1, 2): the module on each rank's blocks (the heads, the mlp
    columns, the vocabulary, every expert's d_expert) against the
    unsharded call on the same draw; output and every gradient within
    1e-5 of their largest magnitude (the MoE's router gradient, whole on
    each rank, among them)."""
    want_layout = {"attention-kv-local": ("whole", "local"),
                   "attention-kv-sliced": ("whole", "sliced"),
                   "attention-kv-repeated": ("whole", "sliced"),
                   "attention-heads-cut": ("cut", None)}
    for res in ranks.results("units", world=2):
        got = res[unit]
        if unit in want_layout:
            assert (got["heads"], got["kv"]) == want_layout[unit]
        assert got["local"], got
        assert max(got["errors"].values()) <= 1e-5, got["errors"]


@pytest.mark.parametrize("unit", list(sw.RECURRENT_UNITS))
def test_recurrent_mix_on_the_ranks_heads_matches_the_unsharded_call(
        ranks, unit):
    """At (1, 2): RWKV-6's time mix, its channel mix and Mamba2's mix on
    each rank's heads (or blocks) against the unsharded call on the same
    draw; output, the rank's heads' final state and every gradient within
    1e-5 of their largest magnitude.  At whole heads a rank (2 of
    RWKV-6's, 4 of Mamba2's) the rank's block of ``wr`` / ``wk`` / ``wv``
    / ``wg`` (of ``out_proj``) is its heads' and used as it is; at 3 heads
    (2 / 1) they are whole and sliced; every other leaf the mix reads is
    whole on the rank, its gradient summed over "model"."""
    got = [res[unit] for res in ranks.results("units", world=2)]
    arch, changes = sw.RECURRENT_UNITS[unit]
    for r, res in enumerate(got):
        assert max(res["errors"].values()) <= 1e-5, res["errors"]
        assert not res["whole"], res
        if unit.startswith("rwkv6-channel"):
            assert res["ffn"] and res["local"] == ["f_wk", "f_wr", "f_wv"]
            assert res["partial"] == ["f_mu_k", "f_mu_r"]
            continue
        cut = unit.endswith("-cut")
        assert res["mix"] == ("sliced" if cut else "local")
        assert res["heads"] == ([[0, 2], [2, 1]][r] if cut
                                else [r * res["heads"][1], res["heads"][1]])
        own = (["out_proj"] if arch == "zamba2-2.7b"
               else ["wg", "wk", "wr", "wv"])
        assert res["local"] == ([] if cut else own), res
        assert res["state_shape"][1] == res["heads"][1]


@pytest.mark.parametrize("unit", list(sw.MOE_UNITS))
def test_moe_expert_tp_routes_alike_on_every_rank(ranks, unit):
    """At (1, 2), ``moe_block`` on each rank's block of ``d_expert``: each
    rank holds half of every expert's columns of ``w_gate`` / ``w_up`` and
    rows of ``w_down``, and its router counts and dropped pairs are the
    unsharded call's exactly, the same on both ranks (the ``-drops`` unit
    drops pairs)."""
    cfg = sw.config("mixtral-8x22b")
    e, d, fe = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert
    got = [res[unit] for res in ranks.results("units", world=2)]
    for res in got:
        assert res["counts_equal"] and res["dropped_equal"], res
        assert res["block_shapes"] == {
            "router": [d, e], "w_gate": [e, d, fe // 2],
            "w_up": [e, d, fe // 2], "w_down": [e, fe // 2, d]}
        assert res["counts"] == got[0]["counts"]
        assert res["dropped"] == got[0]["dropped"]
    assert (got[0]["n_dropped"] > 0) == unit.endswith("-drops")


# the digests of two steps of each case, taken with the step as it was
# before tensor parallelism (parent of the change that added it; for
# rwkv6 and zamba2, of the change that split their mixes' heads over
# "model"), one thread, without a mesh and at a (1, 1) mesh alike, on the
# platform named (float32 bytes depend on the torch build and the CPU's
# kernels)
DIGEST_PLATFORM = "torch 2.13.0+cpu x86_64 AVX512"
DIGESTS = {
    "qwen2-0.5b":
        "e2674a2d056b63a3d570ea63e9e4d982273b2bb8b50e817700fc44489bc8f213",
    "kimi-k2-1t-a32b":
        "37bd715d02ac3463d3ed8dc392614c4c95bb461fe319adc445e9e6c4d34480de",
    "rwkv6-3b":
        "7d0f6da09d74661525fe1c8a708b773bf824fdc7464f59e4e1322916ff3df3ca",
    "zamba2-2.7b":
        "ae0843672eeb16fa600a588f40970a01877d4b2d50ac28e610f051f614942c80"}


@pytest.mark.parametrize("case", sw.DIGEST_CASES)
def test_one_model_rank_is_the_step_as_it_was(ranks, case):
    """Without a mesh and at a (1, 1) mesh the step is the same bit for
    bit: the params, optimizer state and metrics of two steps hash alike
    (AdamW on the tied qwen2 config and on rwkv6 and zamba2, Adafactor on
    kimi-k2).  The (1, 1)
    run is held to the reference's single-device step at the module's
    bounds, and on the platform where the digests of the step before
    tensor parallelism were taken, to those digests."""
    res = ranks.results("digest", world=1)[0]
    got = res[case]
    assert got["meshless"] == got["mesh11"]
    want, want_m = reference(case)
    assert_matches(ranks.arrays(f"digest-{case}"), got["mesh11"]["metrics"],
                   want, want_m, lr_rel=1e-7)
    if res["platform"] == DIGEST_PLATFORM:
        assert got["mesh11"]["digest"] == DIGESTS[case]


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

