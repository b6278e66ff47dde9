"""The port's model stack (``repro_torch.models``, ``repro_torch.configs``)
vs the reference on the same inputs: numpy draws for activations, the
reference's ``jax.random`` weights carried across with
``convert.params_from_numpy``.

Tolerance: float32 activations 2e-5 (relative and absolute) — the same f32
math in another summation order (measured: at most 1e-6 on the smoke
configs).  bfloat16 activations 6e-2 on hidden states and 1e-2 on logits —
the two frameworks round the same bf16 products at other places (an XLA
dot rounds once, torch's CPU matmul may round partial sums), one bf16 ulp
at |x| ~ 4 is 1.6e-2; measured at most 3.1e-2 (hidden) and 2.0e-3
(logits)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402

F32_TOL = 2e-5
BF16_HIDDEN_TOL, BF16_LOGIT_TOL = 6e-2, 1e-2
ACTS = {"float32": (jnp.float32, torch.float32),
        "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def configs(arch: str, act: str):
    """The smoke config on both sides, with the activation dtype ``act``
    (the embeddings frontend swapped for tokens, as the launcher does)."""
    jdt, tdt = ACTS[act]
    jc = dataclasses.replace(j_smoke(arch), activ_dtype=jdt, frontend="tokens")
    tc = dataclasses.replace(get_smoke_config(arch), activ_dtype=tdt,
                             frontend="tokens")
    return jc, tc


def carried_params(jc, seed=0):
    jp = jm.init_params(jc, jax.random.key(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def both(x: np.ndarray, act: str):
    """One numpy array as the same values in both frameworks' dtype."""
    jdt, tdt = ACTS[act]
    j = jnp.asarray(x, jdt)
    return j, torch.from_numpy(np.array(j, np.float32)).to(tdt)


def close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ------------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_configs_and_schema_match_the_reference(arch):
    """Every config (all families), full and smoke: the same fields and the
    same parameter schema, leaf for leaf."""
    assert ARCH_IDS == J_ARCH_IDS
    for jget, tget in ((j_get_config, get_config), (j_smoke, get_smoke_config)):
        jc, tc = jget(arch), tget(arch)
        for f in dataclasses.fields(jc):
            a, b = getattr(jc, f.name), getattr(tc, f.name)
            if f.name in ("param_dtype", "activ_dtype"):
                assert jnp.dtype(a).name == str(b).split(".")[-1], f.name
            elif f.name == "moe":
                assert (a is None) == (b is None)
                if a is not None:
                    assert dataclasses.asdict(a) == dataclasses.asdict(b)
            else:
                assert a == b, f.name
        j_leaves = [(p, s.shape, s.init) for p, s in jm.iter_schema(jc)]
        t_leaves = [(p, s.shape, s.init) for p, s in tm.iter_schema(tc)]
        assert t_leaves == j_leaves
        assert tc.param_count() == jc.param_count()


def test_init_params_is_seeded_on_the_cpu_and_follows_the_schema():
    cfg = get_smoke_config("qwen2-0.5b")
    a = tm.init_params(cfg, 3, device="cpu")
    b = tm.init_params(cfg, 3, device="cpu")
    c = tm.init_params(cfg, 4, device="cpu")
    flat_a, flat_b = params_to_numpy(a), params_to_numpy(b)
    assert np.array_equal(flat_a["embed"], flat_b["embed"])
    assert not np.array_equal(flat_a["embed"], params_to_numpy(c)["embed"])
    for path, spec in tm.iter_schema(cfg):
        node = a
        for part in path.split("."):
            node = node[part]
        assert tuple(node.shape) == spec.shape and node.dtype == torch.float32
    assert torch.all(a["blocks"]["bq"] == 0) and torch.all(a["final_norm"] == 1)
    # the reference's scale: N(0,1) * min(0.02, fan_in ** -0.5)
    assert abs(float(a["blocks"]["wq"].std()) - 0.02) < 2e-3


def test_params_round_trip_keeps_dtype():
    jc = dataclasses.replace(j_smoke("internlm2-1.8b"), param_dtype=jnp.bfloat16)
    jp = jm.init_params(jc, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert tp["blocks"]["wq"].dtype == torch.bfloat16
    assert tp["blocks"]["wq"].shape == jp["blocks"]["wq"].shape
    back = params_to_numpy(tp)
    np.testing.assert_array_equal(back["blocks"]["w_up"],
                                  np.asarray(jp["blocks"]["w_up"], np.float32))


# -------------------------------------------------------------------- layers
@pytest.mark.parametrize("act", sorted(ACTS))
def test_rms_norm_and_swiglu(act):
    rng = np.random.default_rng(0)
    jx, tx = both(rng.normal(size=(2, 5, 64)), act)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    tol = F32_TOL if act == "float32" else BF16_HIDDEN_TOL
    close(tl.rms_norm(tx, torch.from_numpy(scale)),
          jl.rms_norm(jx, jnp.asarray(scale)), tol)
    ws = [rng.normal(size=s).astype(np.float32) * 0.1
          for s in ((64, 96), (64, 96), (96, 64))]
    close(tl.swiglu(tx, *map(torch.from_numpy, ws)),
          jl.swiglu(jx, *map(jnp.asarray, ws)), tol)


@pytest.mark.parametrize("act", sorted(ACTS))
def test_rope_and_mrope(act):
    rng = np.random.default_rng(1)
    jx, tx = both(rng.normal(size=(2, 4, 7, 16)), act)
    pos = rng.integers(0, 4096, (2, 7))
    tol = F32_TOL if act == "float32" else BF16_HIDDEN_TOL
    close(tl.apply_rope(tx, torch.from_numpy(pos)[:, None], 1e6),
          jl.apply_rope(jx, jnp.asarray(pos)[:, None], 1e6), tol)
    pos3 = rng.integers(0, 64, (3, 2, 7))
    sections = tl.mrope_sections(16)
    assert sections == (2, 3, 3)
    close(tl.apply_mrope(tx, torch.from_numpy(pos3), sections, 1e6),
          jl.apply_mrope(jx, jnp.asarray(pos3), sections, 1e6), tol)


@pytest.mark.parametrize("act", sorted(ACTS))
@pytest.mark.parametrize("rope_mode,window", [("rope", None), ("mrope", None),
                                              ("rope", 4), ("none", None)])
def test_attention_block(act, rope_mode, window):
    rng = np.random.default_rng(2)
    d, h, kvh, hd, b, s = 64, 4, 2, 16, 2, 11
    jx, tx = both(rng.normal(size=(b, s, d)), act)
    ws = {n: rng.normal(size=shape).astype(np.float32) * 0.1 for n, shape in
          (("wq", (d, h * hd)), ("wk", (d, kvh * hd)), ("wv", (d, kvh * hd)),
           ("wo", (h * hd, d)), ("bq", (h * hd,)), ("bk", (kvh * hd,)),
           ("bv", (kvh * hd,)))}
    pos = np.broadcast_to(np.arange(s), (b, s))
    if rope_mode == "mrope":
        pos = np.broadcast_to(pos, (3, b, s))
    kw = dict(n_heads=h, n_kv_heads=kvh, head_dim=hd, rope_mode=rope_mode,
              rope_theta=1e6, window=window, return_kv=True)
    jout, (jk, jv) = jl.attention_block(
        jx, jl.AttnParams(**{n: jnp.asarray(w) for n, w in ws.items()}),
        positions=jnp.asarray(pos), **kw)
    tout, (tk, tv) = tl.attention_block(
        tx, tl.AttnParams(**{n: torch.from_numpy(w) for n, w in ws.items()}),
        positions=torch.from_numpy(np.ascontiguousarray(pos)), **kw)
    tol = F32_TOL if act == "float32" else BF16_HIDDEN_TOL
    close(tout, jout, tol)
    close(tk, jk, tol)
    close(tv, jv, tol)


# ------------------------------------------------------------------- forward
@pytest.mark.parametrize("act", sorted(ACTS))
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "internlm2-1.8b"])
def test_forward_and_logits(arch, act):
    jc, tc = configs(arch, act)
    jp, tp = carried_params(jc)
    toks = np.random.default_rng(3).integers(0, jc.vocab_size, (2, 19))
    jh, _ = jm.forward(jp, jc, tokens=jnp.asarray(toks))
    th, aux = tm.forward(tp, tc, tokens=torch.from_numpy(toks))
    assert aux == {} and th.dtype == ACTS[act][1]
    f32 = act == "float32"
    close(th, jh, F32_TOL if f32 else BF16_HIDDEN_TOL)
    close(tm.logits_fn(tp, tc, th[:, -3:]),
          jm.logits_fn(jp, jc, jh[:, -3:]), F32_TOL if f32 else BF16_LOGIT_TOL)


@pytest.mark.parametrize("act", sorted(ACTS))
def test_decode_attention_and_kv_update(act):
    """The decode-side helpers the serving engine runs in plain PyTorch:
    one token against a cache with a window and the page-mass grid, and
    the functional cache update."""
    from repro.models import attention as ja
    from repro_torch.models import attention as ta
    rng = np.random.default_rng(4)
    b, h, kvh, s, d = 2, 4, 2, 13, 16
    jq, tq = both(rng.normal(size=(b, h, d)), act)
    jk, tk = both(rng.normal(size=(b, kvh, s, d)), act)
    jv, tv = both(rng.normal(size=(b, kvh, s, d)), act)
    pos = np.array([5, 12])
    jo, jmass = ja.decode_step(jq, jk, jv, jnp.asarray(pos), window=4,
                               page_size=4)
    to, tmass = ta.decode_step(tq, tk, tv, torch.from_numpy(pos), window=4,
                               page_size=4)
    close(to, jo, F32_TOL if act == "float32" else BF16_LOGIT_TOL)
    close(tmass, jmass, 1e-5 if act == "float32" else 5e-4)
    jkn, tkn = both(rng.normal(size=(b, kvh, d)), act)
    jkc, jvc = ja.update_kv_cache(jk, jv, jkn, jkn, jnp.asarray(pos))
    tkc, tvc = ta.update_kv_cache(tk, tv, tkn, tkn, torch.from_numpy(pos))
    close(tkc, jkc, 0.0)
    close(tvc, jvc, 0.0)
    assert not torch.equal(tkc, tk)              # a new cache, as in JAX
