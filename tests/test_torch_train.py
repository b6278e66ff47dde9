"""The port's train step (``repro_torch.train.steps``) against the
reference's ``make_train_step`` on every ``ARCH_IDS`` smoke config: the
same perturbed weights (``_perturbed_weights``: every leaf drawn, the
init's zero leaves too) carried across, the same numpy batch, at S 48 with
``loss_chunk`` and ``attn_block_k`` 16 (three loss chunks, three blocks of
the attention's backward, Mixtral's window of 32 inside the sequence).

The reference's step is compiled once per config and activation dtype,
with a ``grad_transform`` that
also hands out the gradient it is given (the step's own ``jax.grad``,
before clipping), so one compile serves the step, its gradient leaves and
every batch seed.

Tolerances, float32 activations: the loss within 1e-5 relative and the
gradient norm within 1e-4 relative (the same float32 sums in another
order); for the attn and moe families every gradient leaf within 1e-4 of
that leaf's largest magnitude.  The updated params within 2·lr everywhere
and within 1e-6 on at least 99.9 % of elements: AdamW's first step moves a
weight by about lr·sign(g), so where g is at the float32 noise floor the
two sides may step opposite ways.  MoE's router counts exact.  bfloat16
activations, on one config of each family (BF16_ARCHS): the port's step
no farther from the port's float32 step than twice the reference's
bfloat16 step is from the reference's float32 step (the rule of
``tests/_torch_recurrent.py``), in loss, gradient norm and updated params
(largest and mean difference), each distance the mean over BF16_SEEDS
batches: one batch's loss distance is a single sum of roundings that
partly cancel, a draw (over 8 batches the two sides' loss distances still
lie up to 2.2x apart either way, over 16 at most 1.5x)."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS, get_optimizer_name  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.optim import cosine_schedule as j_cosine  # noqa: E402
from repro.optim import get_optimizer as j_get_optimizer  # noqa: E402
from repro.train import steps as j_steps  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.optim import cosine_schedule, get_optimizer  # noqa: E402
from repro_torch.train import steps  # noqa: E402

from _perturbed_weights import perturbed_tree  # noqa: E402

ACTS = {"float32": (jnp.float32, torch.float32),
        "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, S, CHUNK = 2, 48, 16
LOSS_RTOL, GNORM_RTOL, GRAD_TOL_OF_MAX = 1e-5, 1e-4, 1e-4
PARAM_TOL, PARAM_WITHIN = 1e-6, 0.999
LR = (1e-3, 10, 100)          # peak, warmup, total: lr(1) = 1e-4
# bfloat16: one config of each family, qwen2 the full-width target
BF16_ARCHS = ("qwen2-0.5b", "mixtral-8x22b", "rwkv6-3b", "zamba2-2.7b")
BF16_SEEDS = tuple(range(1, 17))   # batch seeds of the bfloat16 distances
TRANSFORMS = ("grad_accum", "int8", "topk")
# a reference step that runs once compiles without LLVM's optimisation
# passes: the same HLO and float32 results, compiled in about 60 % of the
# time (the BF16_ARCHS steps, which run at every seed, stay optimised)
RUN_ONCE_COMPILER_OPTIONS = {"xla_backend_optimization_level": 0}


def configs(arch: str, act: str):
    jdt, tdt = ACTS[act]
    cut = dict(frontend="tokens", loss_chunk=CHUNK, attn_block_k=CHUNK)
    return (dataclasses.replace(j_smoke(arch), activ_dtype=jdt, **cut),
            dataclasses.replace(get_smoke_config(arch), activ_dtype=tdt,
                                **cut))


def batch_np(vocab: int, seed: int = 1, b: int = B) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, S)).astype(np.int32)}


def j_step(jc, arch, **kw):
    """The reference's ``make_train_step`` under ``jax.jit``: (params,
    batch) -> (updated params, metrics, the gradient before
    ``grad_transform``)."""
    opt = j_get_optimizer(get_optimizer_name(arch))
    seen = {}
    transform = kw.pop("grad_transform", lambda g: g)

    def hand_out(g):
        seen["grads"] = g
        return transform(g)

    step = j_steps.make_train_step(jc, opt, j_cosine(*LR),
                                   grad_transform=hand_out, **kw)

    def run(params, batch):
        p2, _, m = step(params, opt.init(params), batch)
        return p2, m, seen["grads"]

    return jax.jit(run)


def transform_kwargs(transform: str):
    """(the reference's, the port's) ``make_train_step`` keywords of one
    TRANSFORMS case: ``grad_accum=2``, or a compressor as
    ``grad_transform`` (error feedback from zero)."""
    from repro.train import compression as j_comp
    from repro_torch.train import compression as t_comp
    if transform == "grad_accum":
        return dict(grad_accum=2), dict(grad_accum=2)
    name = f"{transform}_compress_grads"
    jf, tf = getattr(j_comp, name), getattr(t_comp, name)
    return (dict(grad_transform=lambda g: jf(
                g, j_comp.init_error_feedback(g))[0]),
            dict(grad_transform=lambda g: tf(
                g, t_comp.init_error_feedback(g))[0]))


def transform_case(transform: str):
    """A TRANSFORMS case's float32 qwen2 config, weights and batch of 4."""
    jc, tc = configs("qwen2-0.5b", "float32")
    return (jc, tc, perturbed_tree(jm.iter_schema(jc), 3),
            batch_np(jc.vocab_size, seed=4, b=4))


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


_STEPS: dict = {}


def reference_step(key):
    """The compiled reference step of ``key``, once per process:
    ("float32", arch), ("bfloat16", arch) or ("transform", name)."""
    if key not in _STEPS:
        kind, name = key
        if kind == "transform":
            jc, _, tree, batch = transform_case(name)
            arch, kw = "qwen2-0.5b", transform_kwargs(name)[0]
        else:
            jc, arch, kw = configs(name, kind)[0], name, {}
            tree = perturbed_tree(jm.iter_schema(jc), 0)
            batch = batch_np(jc.vocab_size)
        _STEPS[key] = j_step(jc, arch, **kw).lower(
            to_jax(tree), to_jax(batch)).compile(
                None if name in BF16_ARCHS else RUN_ONCE_COMPILER_OPTIONS)
    return _STEPS[key]


def j_run(step, tree, batch):
    p2, m, g = step(to_jax(tree), to_jax(batch))
    return (jax.tree.map(lambda x: np.asarray(x, np.float32), p2),
            {k: np.asarray(v) for k, v in m.items()},
            jax.tree.map(lambda x: np.asarray(x, np.float32), g))


def t_run(tc, arch, tree, batch, **kw):
    opt = get_optimizer(get_optimizer_name(arch))
    params = params_from_numpy(tree, device="cpu")
    step = steps.make_train_step(tc, opt, cosine_schedule(*LR), **kw)
    p2, o2, m = step(params, opt.init(params),
                     {k: torch.from_numpy(v) for k, v in batch.items()})
    assert int(o2.step) == 1 and o2.step.dtype == torch.int32
    return params_to_numpy(p2), {k: v.numpy() for k, v in m.items()}


_RUNS: dict = {}


def seed_run(arch: str, act: str, seed: int = 1):
    """(weights, batch, the reference's (params, metrics, grads), the
    port's (params, metrics)) of one arch, activation dtype and batch seed,
    computed once per process; the weights are the same at every seed."""
    if (arch, act, seed) not in _RUNS:
        jc, tc = configs(arch, act)
        tree = perturbed_tree(jm.iter_schema(jc), 0)
        batch = batch_np(jc.vocab_size, seed)
        _RUNS[arch, act, seed] = (
            tree, batch, j_run(reference_step((act, arch)), tree, batch),
            t_run(tc, arch, tree, batch))
    return _RUNS[arch, act, seed]


def flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_params_close(got: dict, want: dict, lr: float) -> None:
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert diff.max() <= 2 * lr, diff.max()
    assert (diff <= PARAM_TOL).mean() >= PARAM_WITHIN, (diff <= PARAM_TOL).mean()


def rel(a, b) -> float:
    return float(abs(float(a) - float(b)) / abs(float(b)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_matches_the_reference(arch):
    _, _, (jp, jmet, _), (tp, tmet) = seed_run(arch, "float32")
    assert rel(tmet["loss"], jmet["loss"]) <= LOSS_RTOL
    assert rel(tmet["grad_norm"], jmet["grad_norm"]) <= GNORM_RTOL
    assert float(tmet["lr"]) == pytest.approx(float(jmet["lr"]), rel=1e-7)
    assert_params_close(tp, jp, float(jmet["lr"]))
    if "expert_counts" in jmet:
        np.testing.assert_array_equal(tmet["expert_counts"],
                                      jmet["expert_counts"])
    assert sorted(tmet) == sorted(jmet)


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if j_smoke(a).family in ("attn", "moe")])
def test_gradient_leaves_match_jax_grad(arch):
    _, tc = configs(arch, "float32")
    tree, batch, (_, _, want), _ = seed_run(arch, "float32")
    _, _, got = steps.loss_and_grads(
        params_from_numpy(tree, device="cpu"), tc,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    got, want = flat(params_to_numpy(got)), flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        err = np.abs(got[k] - want[k]).max()
        assert err <= GRAD_TOL_OF_MAX * np.abs(want[k]).max(), (k, err)


QUANTITIES = ("loss", "grad_norm", "params_max", "params_mean")


@functools.lru_cache(maxsize=None)
def _bf16_distance(arch: str, side: str) -> dict:
    """``side``'s ("reference" or "port") bfloat16 step against its own
    float32 step on the same batch: |loss difference|, |grad norm
    difference| and the largest and the mean |difference| of the updated
    params, each the mean over BF16_SEEDS."""
    pick = {"reference": 2, "port": 3}[side]
    dist = []
    for seed in BF16_SEEDS:
        p16, m16 = seed_run(arch, "bfloat16", seed)[pick][:2]
        p32, m32 = seed_run(arch, "float32", seed)[pick][:2]
        truth, got = flat(p32), flat(p16)
        diff = np.concatenate([np.abs(got[k] - truth[k]).ravel()
                               for k in truth])
        dist.append([abs(float(m16["loss"]) - float(m32["loss"])),
                     abs(float(m16["grad_norm"]) - float(m32["grad_norm"])),
                     float(diff.max()), float(diff.mean())])
    return dict(zip(QUANTITIES, np.mean(dist, axis=0)))


@pytest.mark.parametrize("quantity", QUANTITIES)
@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_step_no_farther_than_the_references(arch, quantity):
    """The port's bfloat16 step no farther from its float32 step than
    twice the reference's bfloat16 step is from the reference's float32
    step, in one quantity (loss, gradient norm, updated params' largest or
    mean difference), each distance a mean over BF16_SEEDS batches."""
    port = _bf16_distance(arch, "port")[quantity]
    ref = _bf16_distance(arch, "reference")[quantity]
    assert port <= 2 * ref, (port, ref)


@pytest.mark.parametrize("transform", ["grad_accum", "int8", "topk"])
def test_accumulation_and_compression_match_the_reference(transform):
    """``grad_accum=2`` (two microbatches of 2) and both compressors as
    ``grad_transform`` (error feedback from zero), on qwen2's smoke config:
    the tolerances of the float32 step."""
    _, tc, tree, batch = transform_case(transform)
    jp, jmet, _ = j_run(reference_step(("transform", transform)), tree, batch)
    tp, tmet = t_run(tc, "qwen2-0.5b", tree, batch,
                     **transform_kwargs(transform)[1])
    assert rel(tmet["loss"], jmet["loss"]) <= LOSS_RTOL
    assert rel(tmet["grad_norm"], jmet["grad_norm"]) <= GNORM_RTOL
    assert_params_close(tp, jp, float(jmet["lr"]))
