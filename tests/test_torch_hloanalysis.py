"""The port's copy of the HLO analyzer (``repro_torch.launch.hloanalysis``)
and of ``dryrun.collective_bytes`` against the reference's, dict for dict,
on the same HLO text: ``tests/test_hloanalysis.py``'s four compiled
programs, a hand-written sharded program with every collective kind in
and out of a while loop, and the compiled HLO of two smoke train steps.

Tolerance: exact (the same parse of the same text)."""
import dataclasses
import os

import numpy as np
import pytest

pytest.importorskip("torch")
import _torch_threads  # noqa: E402
_torch_threads.limit()
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402

# the reference's dryrun module sets XLA_FLAGS to 512 host devices when
# imported; this process keeps its own devices
_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as j_dryrun  # noqa: E402
if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS
from repro.launch import hloanalysis as J  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.optim import cosine_schedule as j_cosine  # noqa: E402
from repro.optim import get_optimizer as j_get_optimizer  # noqa: E402
from repro.train import steps as j_steps  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hloanalysis as H  # noqa: E402

# a reference step compiles without LLVM's optimisation passes: the same
# HLO in less time (as tests/test_torch_train.py)
REFERENCE_COMPILER_OPTIONS = {"xla_backend_optimization_level": 0}
TRAIN_ARCHS = ("qwen2-0.5b", "mixtral-8x22b")

# a per-device program of a sharded step: every collective kind, in the
# entry and in a 12-trip while loop, with both replica_groups forms and
# one without (the default group size)
SHARDED_HLO = """HloModule sharded_step

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(f32[] %a, f32[] %b)
}

%cond (p: (s32[], f32[8,128])) -> pred[] {
  %p = (s32[], f32[8,128]) parameter(0)
  %i = s32[] get-tuple-element((s32[], f32[8,128]) %p), index=0
  %n = s32[] constant(12)
  ROOT %lt = pred[] compare(s32[] %i, s32[] %n), direction=LT
}

%body (p: (s32[], f32[8,128])) -> (s32[], f32[8,128]) {
  %p = (s32[], f32[8,128]) parameter(0)
  %i = s32[] get-tuple-element((s32[], f32[8,128]) %p), index=0
  %x = f32[8,128]{1,0} get-tuple-element((s32[], f32[8,128]) %p), index=1
  %ag = f32[128,128]{1,0} all-gather(f32[8,128]{1,0} %x), channel_id=1, replica_groups=[16,16]<=[256], dimensions={0}
  %w = f32[128,128]{1,0} constant({...})
  %d = f32[128,128]{1,0} dot(f32[128,128]{1,0} %ag, f32[128,128]{1,0} %w), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %rs = f32[8,128]{1,0} reduce-scatter(f32[128,128]{1,0} %d), channel_id=2, replica_groups=[16,16]<=[256], dimensions={0}, to_apply=%add
  %ar = f32[8,128]{1,0} all-reduce(f32[8,128]{1,0} %rs), channel_id=3, replica_groups={{0,1,2,3},{4,5,6,7}}, to_apply=%add
  %one = s32[] constant(1)
  %j = s32[] add(s32[] %i, s32[] %one)
  ROOT %t = (s32[], f32[8,128]) tuple(s32[] %j, f32[8,128]{1,0} %ar)
}

ENTRY %main (x: f32[8,128], y: bf16[64,256]) -> (f32[8,128], bf16[64,256]) {
  %x = f32[8,128]{1,0} parameter(0)
  %y = bf16[64,256]{1,0} parameter(1)
  %zero = s32[] constant(0)
  %init = (s32[], f32[8,128]) tuple(s32[] %zero, f32[8,128]{1,0} %x)
  %loop = (s32[], f32[8,128]) while((s32[], f32[8,128]) %init), condition=%cond, body=%body
  %out = f32[8,128]{1,0} get-tuple-element((s32[], f32[8,128]) %loop), index=1
  %a2a = bf16[64,256]{1,0} all-to-all(bf16[64,256]{1,0} %y), channel_id=4, replica_groups={{0,1}}, dimensions={0}
  %cps = (bf16[64,256]{1,0}, bf16[64,256]{1,0}) collective-permute-start(bf16[64,256]{1,0} %a2a), channel_id=5, source_target_pairs={{0,1},{1,0}}
  %cpd = bf16[64,256]{1,0} collective-permute-done((bf16[64,256]{1,0}, bf16[64,256]{1,0}) %cps)
  %ar2 = (f32[8,128]{1,0}, bf16[64,256]{1,0}) all-reduce(f32[8,128]{1,0} %out, bf16[64,256]{1,0} %cpd), channel_id=6, to_apply=%add
  %r0 = f32[8,128]{1,0} get-tuple-element((f32[8,128]{1,0}, bf16[64,256]{1,0}) %ar2), index=0
  %r1 = bf16[64,256]{1,0} get-tuple-element((f32[8,128]{1,0}, bf16[64,256]{1,0}) %ar2), index=1
  ROOT %res = (f32[8,128], bf16[64,256]) tuple(f32[8,128]{1,0} %r0, bf16[64,256]{1,0} %r1)
}
"""


def compiled_text(fn, *args) -> str:
    return jax.jit(fn).lower(*args).compile().as_text()


def scan_program() -> str:
    n, trips = 128, 12
    w = jnp.ones((n, n), jnp.float32)

    def f(x):
        def body(c, _):
            return c @ w, None
        y, _ = jax.lax.scan(body, x, None, length=trips)
        return y
    return compiled_text(f, jnp.ones((n, n), jnp.float32))


def dot_program() -> str:
    a = jnp.ones((256, 256), jnp.float32)
    return compiled_text(lambda a, b: a @ b, a, a)


def dus_program() -> str:
    big = jnp.zeros((4096, 1024), jnp.float32)
    upd = jnp.ones((1, 1024), jnp.float32)

    def f(buf, u):
        def body(c, i):
            return jax.lax.dynamic_update_slice(c, u, (i, 0)), None
        out, _ = jax.lax.scan(body, buf, jnp.arange(64))
        return out
    return compiled_text(f, big, upd)


def gather_program() -> str:
    table = jnp.zeros((100_000, 64), jnp.float32)
    idx = jnp.arange(16, dtype=jnp.int32)
    return compiled_text(lambda t, i: jnp.take(t, i, axis=0).sum(), table,
                         idx)


def train_step_program(arch: str) -> str:
    jc = j_smoke(arch)
    params = jm.init_params(jc, jax.random.PRNGKey(0))
    opt = j_get_optimizer("adamw")
    step = j_steps.make_train_step(jc, opt, j_cosine(3e-4, 100, 10000))
    toks = jnp.asarray(np.random.default_rng(0).integers(
        0, jc.vocab_size, (2, 64)).astype(np.int32))
    return jax.jit(step).lower(params, opt.init(params), {
        "tokens": toks, "labels": toks}).compile(
            REFERENCE_COMPILER_OPTIONS).as_text()


BUILDERS = {"scan": scan_program, "dot": dot_program, "dus": dus_program,
            "gather": gather_program, "sharded": lambda: SHARDED_HLO}
BUILDERS.update({f"train {a}": (lambda a=a: train_step_program(a))
                 for a in TRAIN_ARCHS})


@pytest.fixture(scope="module")
def texts():
    return {}


def text(texts: dict, name: str) -> str:
    if name not in texts:
        texts[name] = BUILDERS[name]()
    return texts[name]


@pytest.mark.parametrize("name", list(BUILDERS))
def test_analyze_matches_the_reference(texts, name):
    t = text(texts, name)
    got, want = H.analyze(t), J.analyze(t)
    assert got == want
    if name.startswith("train") or name in ("scan", "dot"):
        assert got["flops"] > 0


@pytest.mark.parametrize("n", [2, 8, 16])
def test_analyze_default_group_matches_the_reference(texts, n):
    """The all-reduce without replica_groups takes the default size."""
    t = text(texts, "sharded")
    assert H.analyze(t, n_devices_per_group=n) \
        == J.analyze(t, n_devices_per_group=n)


@pytest.mark.parametrize("name", list(BUILDERS))
def test_collective_bytes_matches_the_reference(texts, name):
    t = text(texts, name)
    assert dryrun.collective_bytes(t) == j_dryrun.collective_bytes(t)


@pytest.mark.parametrize("name", list(BUILDERS))
def test_parse_hlo_matches_the_reference(texts, name):
    t = text(texts, name)
    got, want = H.parse_hlo(t), J.parse_hlo(t)
    assert sorted(got) == sorted(want)
    for k in want:
        assert dataclasses.asdict(got[k]) == dataclasses.asdict(want[k])


def test_sharded_program_counts_every_kind(texts):
    """The loop's collectives count 12 times, each kind's wire bytes are
    ``wire_bytes`` of its output at its group's size."""
    res = H.analyze(text(texts, "sharded"), n_devices_per_group=8)
    assert res["collective_count"] == {
        "all-gather": 12, "reduce-scatter": 12, "all-reduce": 13,
        "all-to-all": 1, "collective-permute": 1}
    f32_8x128, f32_128x128, bf16_64x256 = 8 * 128 * 4, 128 * 128 * 4, \
        64 * 256 * 2
    assert res["collective_wire_bytes"] == {
        "all-gather": 12 * H.wire_bytes("all-gather", f32_128x128, 16),
        "reduce-scatter": 12 * H.wire_bytes("reduce-scatter", f32_8x128, 16),
        "all-reduce": 12 * H.wire_bytes("all-reduce", f32_8x128, 4)
        + H.wire_bytes("all-reduce", f32_8x128 + bf16_64x256, 8),
        "all-to-all": H.wire_bytes("all-to-all", bf16_64x256, 2),
        "collective-permute": H.wire_bytes("collective-permute",
                                           2 * bf16_64x256, 8)}
    assert res["flops"] == 12 * 2 * 128 ** 3


@pytest.mark.parametrize("kind,factor", [
    ("all-gather", 15 / 16), ("reduce-scatter", 15 / 16),
    ("all-reduce", 2 * 15 / 16), ("all-to-all", 15 / 16),
    ("collective-permute", 1.0)])
def test_wire_bytes_is_the_ring_cost(kind, factor):
    assert H.wire_bytes(kind, 1600, 16) == 1600 * factor
    assert H.wire_bytes(kind, 1600, 1) == (1600.0 if kind ==
                                           "collective-permute" else 0.0)


@pytest.mark.parametrize("type_str", [
    "bf16[256,4096]{1,0}", "(f32[8,8], s32[4])", "pred[]", "token[]",
    "(bf16[2,3]{1,0}, (f32[4], u8[16]))", "f8e4m3fn[1024]", "c64[2,2]"])
def test_tuple_bytes_matches_the_reference(type_str):
    assert H._tuple_bytes(type_str) == J._tuple_bytes(type_str)
