"""The Mamba2 / Zamba2 family on the port (``repro_torch.models.mamba2``, the
``zamba2`` branches of ``models.model``, ``serve.engine`` and the launcher)
against the reference on perturbed weights carried across
(``_perturbed_weights.perturbed_tree``: the reference's init zeroes the conv
bias, ``dt_bias`` and every LoRA delta of the shared block), at S 19 (one
chunk) and 150 (three chunks of 64, the last padded: the carried state).
The smoke config has 4 Mamba2 layers and the shared block after every 2
(invocations 0 and 1); its attention runs ``flash_attention``'s plain
version here, the reference's ``flash_train``.

Tolerances.  float32 2e-5, relative and absolute: the same float32 math,
the three-operand contractions (the carried state's read and update) and
the matmuls summed in another order.  bfloat16 activations:
``_torch_recurrent.close``'s rule at 6e-2 for hidden states, block
outputs, the conv state and K/V, 1e-2 for logits and the float32 SSM state
(inputs that differ by a bfloat16 rounding)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402
_torch_threads.limit()
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_recurrent import (ACTS, BF16_HIDDEN_TOL, BF16_LOGIT_TOL,  # noqa: E402
                              bf16_error_within_the_references, both,
                              carried, close, layer, perturbed_tree)
from repro.models import mamba2 as jmb  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro_torch.convert import (cache_from_numpy, cache_to_numpy,  # noqa: E402
                                 params_from_numpy, params_to_numpy)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import mamba2 as tmb  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402

ARCH = "zamba2-2.7b"
F32_TOL = 2e-5
HIDDEN_TOL = {"float32": F32_TOL, "bfloat16": BF16_HIDDEN_TOL}
LOGIT_TOL = {"float32": F32_TOL, "bfloat16": BF16_LOGIT_TOL}
STATE_TOL = {"float32": F32_TOL, "bfloat16": 1e-2}
LENGTHS = (19, 150)
N_DECODE = 3


def j_params(bp):
    return jmb.Mamba2Params(*(bp[f] for f in jmb.Mamba2Params._fields))


def mix_kw(cfg) -> dict:
    return dict(d_inner=cfg.d_inner, n_heads=cfg.mamba_heads,
                d_state=cfg.ssm_state)


def positions(b: int, s: int):
    pos = np.broadcast_to(np.arange(s), (b, s))
    return jnp.asarray(pos), torch.from_numpy(np.ascontiguousarray(pos))


def _run_both(act: str, s: int) -> dict:
    """forward, prefill (max_len s + 4) and N_DECODE decode steps on both
    sides, each decode chain from its own prefill."""
    jc, tc, jp, tp = carried(ARCH, act)
    toks = np.random.default_rng(s).integers(0, jc.vocab_size,
                                             (2, s + N_DECODE))
    out = dict(jc=jc, tc=tc, jp=jp, tp=tp, toks=toks)
    jt, tt = jnp.asarray(toks[:, :s]), torch.from_numpy(toks[:, :s])
    jh, _ = jm.forward(jp, jc, tokens=jt)
    th, out["t_aux"] = tm.forward(tp, tc, tokens=tt)
    out["hidden"] = (th, jh)
    out["logits"] = (tm.logits_fn(tp, tc, th[:, -3:]),
                     jm.logits_fn(jp, jc, jh[:, -3:]))
    jl_, jcache = jeng.prefill(jp, jc, tokens=jt, max_len=s + 4)
    tl_, tcache = teng.prefill(tp, tc, tokens=tt, max_len=s + 4)
    out["prefill"] = (tl_, {k: v.clone() for k, v in tcache.items()},
                      jl_, jcache)
    jstep = jax.jit(lambda p, c, t: jeng.decode_step(p, jc, c, t))
    steps = []
    for k in range(N_DECODE):
        nxt = toks[:, s + k]
        jlog, jcache, _ = jstep(jp, jcache, jnp.asarray(nxt, jnp.int32))
        tlog, tcache, taux = teng.decode_step(tp, tc, tcache,
                                              torch.from_numpy(nxt))
        steps.append((tlog, {k_: v.clone() for k_, v in tcache.items()},
                      taux, jlog, jcache))
    out["decode"] = steps
    return out


@pytest.fixture(scope="module")
def runs():
    memo = {}

    def get(act: str, s: int) -> dict:
        if (act, s) not in memo:
            memo[act, s] = _run_both(act, s)
        return memo[act, s]
    return get


def close_cache(tcache: dict, jcache, act: str) -> None:
    assert set(tcache) == set(jcache) == {"ssm", "conv", "k", "v", "pos"}
    for key in tcache:
        assert tuple(tcache[key].shape) == jcache[key].shape, key
    close(tcache["ssm"], jcache["ssm"], STATE_TOL[act], act)
    for key in ("conv", "k", "v"):
        assert tcache[key].dtype == ACTS[act][1], key
        close(tcache[key], jcache[key], HIDDEN_TOL[act], act)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


# ------------------------------------------------------------------- mixes
@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("act", sorted(ACTS))
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_mix_matches_reference(runs, act, s, with_state):
    """The chunked SSD scan and its final state on layer 1's weights, from
    zeros or a carried state."""
    r = runs(act, s)
    jc, tp, jp = r["jc"], r["tp"], r["jp"]
    rng = np.random.default_rng(7)
    jx, tx = both(rng.normal(size=(2, s, jc.d_model)), act)
    jstate = tstate = None
    if with_state:
        st = rng.normal(0, 0.1, (2, jc.mamba_heads,
                                 jc.d_inner // jc.mamba_heads,
                                 jc.ssm_state)).astype(np.float32)
        jstate, tstate = jnp.asarray(st), torch.from_numpy(st)
    jout, jst = jmb.mamba2_mix(jx, j_params(layer(jp, 1)), jstate,
                               **mix_kw(jc))
    tout, tst = tmb.mamba2_mix(tx, tm.mamba2_params(layer(tp, 1)), tstate,
                               **mix_kw(jc))
    assert tout.dtype == ACTS[act][1] and tst.dtype == torch.float32
    close(tout, jout, HIDDEN_TOL[act], act)
    close(tst, jst, STATE_TOL[act], act)


@pytest.mark.parametrize("act", sorted(ACTS))
def test_mamba2_step_matches_reference(runs, act):
    """One decode step of the mix on layer 0's weights: output, the
    shifted conv window and the SSM state."""
    r = runs(act, LENGTHS[0])
    jc, tp, jp = r["jc"], r["tp"], r["jp"]
    rng = np.random.default_rng(8)
    jx, tx = both(rng.normal(size=(3, jc.d_model)), act)
    jcv, tcv = both(rng.normal(size=(3, 3, jc.d_inner + 2 * jc.ssm_state)),
                    act)
    st = rng.normal(0, 0.1, (3, jc.mamba_heads, jc.d_inner // jc.mamba_heads,
                             jc.ssm_state)).astype(np.float32)
    jout, jcv2, jst = jmb.mamba2_mix_step(jx, jcv, jnp.asarray(st),
                                          j_params(layer(jp, 0)),
                                          **mix_kw(jc))
    tout, tcv2, tst = tmb.mamba2_mix_step(tx, tcv, torch.from_numpy(st),
                                          tm.mamba2_params(layer(tp, 0)),
                                          **mix_kw(jc))
    close(tout, jout, HIDDEN_TOL[act], act)
    # the window moves up a row exactly; its new row is in_proj's output
    close(tcv2[:, :2], jcv2[:, :2], 0.0)
    close(tcv2[:, 2], jcv2[:, 2], HIDDEN_TOL[act], act)
    close(tst, jst, STATE_TOL[act], act)


@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("act", sorted(ACTS))
def test_zamba2_mamba_block_matches_reference(runs, act, s):
    r = runs(act, s)
    jc, tc, tp, jp = r["jc"], r["tc"], r["tp"], r["jp"]
    jx, tx = both(np.random.default_rng(9).normal(size=(2, s, jc.d_model)),
                  act)
    jout, jst = jm.zamba2_mamba_block(jx, layer(jp, 0), jc)
    tout, tst = tm.zamba2_mamba_block(tx, layer(tp, 0), tc)
    close(tout, jout, HIDDEN_TOL[act], act)
    close(tst, jst, STATE_TOL[act], act)


@pytest.mark.parametrize("inv", [0, 1])
@pytest.mark.parametrize("act", sorted(ACTS))
def test_shared_attention_matches_reference(runs, act, inv):
    """The shared block at each invocation (its own LoRA deltas), S 150."""
    r = runs(act, 150)
    jc, tc, tp, jp = r["jc"], r["tc"], r["tp"], r["jp"]
    jx, tx = both(np.random.default_rng(10 + inv).normal(
        size=(2, 150, jc.d_model)), act)
    jpos, tpos = positions(2, 150)
    want = jm.zamba2_shared_attention(jx, jp["shared_attn"], jc, inv, jpos)
    got, (k, v) = tm.zamba2_shared_attention(tx, tp["shared_attn"], tc, inv,
                                             tpos, return_kv=True)
    close(got, want, HIDDEN_TOL[act], act)
    _, (jk, jv) = jeng._zamba_shared_attn_kv(jx, jp["shared_attn"], jc, inv,
                                              jpos)
    close(k, jk, HIDDEN_TOL[act], act)
    close(v, jv, HIDDEN_TOL[act], act)


@pytest.mark.parametrize("act", sorted(ACTS))
def test_shared_attention_decode_matches_reference(runs, act):
    """One token through the shared block at invocation 1 against caches
    of length 12 at ragged positions: the output and the cache rows the
    port writes in place."""
    r = runs(act, LENGTHS[0])
    jc, tc, tp, jp = r["jc"], r["tc"], r["tp"], r["jp"]
    rng = np.random.default_rng(11)
    jx, tx = both(rng.normal(size=(2, jc.d_model)), act)
    shape = (2, jc.n_kv_heads, 12, jc.head_dim)
    jkc, tkc = both(rng.normal(size=shape), act)
    jvc, tvc = both(rng.normal(size=shape), act)
    pos = np.array([4, 11], np.int32)
    want, jk, jv = jeng._zamba_shared_attn_decode(
        jx, jp["shared_attn"], jc, 1, jkc, jvc, jnp.asarray(pos))
    got = teng._zamba_shared_attn_decode(tx, tp["shared_attn"], tc, 1, tkc,
                                         tvc, torch.from_numpy(pos))
    close(got, want, HIDDEN_TOL[act], act)
    close(tkc, jk, HIDDEN_TOL[act], act)
    close(tvc, jv, HIDDEN_TOL[act], act)


# ----------------------------------------------------- forward and serving
@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("act", sorted(ACTS))
def test_forward_matches_reference(runs, act, s):
    r = runs(act, s)
    assert r["t_aux"] == {}
    th, jh = r["hidden"]
    assert th.dtype == ACTS[act][1] and th.shape == jh.shape
    close(th, jh, HIDDEN_TOL[act], act)
    close(*r["logits"], LOGIT_TOL[act], act)


@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("act", sorted(ACTS))
def test_prefill_matches_reference(runs, act, s):
    """Logits and every cache leaf: the SSM states, the conv tails (the
    last three pre-conv rows), K/V after RoPE in the first s rows and
    zeros after them."""
    tlog, tcache, jlog, jcache = runs(act, s)["prefill"]
    close(tlog, jlog, LOGIT_TOL[act], act)
    close_cache(tcache, jcache, act)
    assert not tcache["k"][:, :, :, s:].any()


@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("act", sorted(ACTS))
def test_decode_steps_match_reference(runs, act, s):
    """Three decode steps from each side's own prefill: logits, every cache
    leaf, an empty aux."""
    for tlog, tcache, taux, jlog, jcache in runs(act, s)["decode"]:
        assert taux == {}
        close(tlog, jlog, LOGIT_TOL[act], act)
        close_cache(tcache, jcache, act)



@pytest.mark.parametrize("s", LENGTHS)
def test_bfloat16_error_within_the_references(runs, s):
    bf16_error_within_the_references(runs("bfloat16", s), runs("float32", s))

@pytest.mark.parametrize("s", [2, 149])
@pytest.mark.parametrize("act", sorted(ACTS))
def test_prefill_then_decode_equals_forward(runs, act, s):
    """The port's prefill of s tokens and one decode step give forward's
    logits at position s + 1: at 149 three chunks, the last padded; at 2 a
    prompt shorter than the conv window (its conv state zero-padded)."""
    r = runs(act, 150)
    tc, tp, toks = r["tc"], r["tp"], torch.from_numpy(r["toks"])
    _, cache = teng.prefill(tp, tc, tokens=toks[:, :s], max_len=s + 1)
    got, _, _ = teng.decode_step(tp, tc, cache, toks[:, s])
    if s == 149:
        want = r["logits"][0][:, -1]
    else:
        h, _ = tm.forward(tp, tc, tokens=toks[:, :s + 1])
        want = tm.logits_fn(tp, tc, h[:, -1:])[:, 0]
    close(got, want.float(), LOGIT_TOL[act], act)


def test_prefill_launches_attention_once_per_invocation(runs, monkeypatch):
    """flash_train runs once per shared-block invocation in a prefill and
    never in a decode step."""
    from repro_torch.models import attention
    r = runs("float32", LENGTHS[0])
    calls = []
    real = attention.flash_train
    monkeypatch.setattr(attention, "flash_train",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    toks = torch.from_numpy(r["toks"])
    _, cache = teng.prefill(r["tp"], r["tc"], tokens=toks[:, :19], max_len=21)
    assert len(calls) == r["tc"].n_shared_attn == 2
    teng.decode_step(r["tp"], r["tc"], cache, toks[:, 19])
    assert len(calls) == 2


def test_init_cache_layout_matches_reference():
    jc, tc, _, _ = carried(ARCH, "bfloat16")
    want = jeng.init_cache(jc, 3, 17)
    got = teng.init_cache(tc, 3, 17, device="cpu")
    assert set(got) == set(want)
    for key, leaf in want.items():
        assert tuple(got[key].shape) == leaf.shape, key
        assert str(got[key].dtype).split(".")[-1] == jnp.dtype(leaf.dtype).name
        assert not got[key].any()


def test_new_leaves_round_trip_through_the_converters(runs):
    """Every zamba2 parameter leaf (the stacked Mamba2 leaves and the
    shared block's) and cache leaf crosses the generic tree maps and back
    unchanged (bfloat16 through float32)."""
    jc = runs("bfloat16", 19)["jc"]
    tree = perturbed_tree(jm.iter_schema(jc), 3)
    back = params_to_numpy(params_from_numpy(tree, device="cpu"))
    for group in ("blocks", "shared_attn"):
        for key, val in tree[group].items():
            np.testing.assert_array_equal(back[group][key], val)
    _, _, _, jcache = runs("bfloat16", 19)["prefill"]
    flat = jax.tree.map(np.asarray, jcache)
    tcache = cache_from_numpy(flat, device="cpu")
    assert tcache["conv"].dtype == torch.bfloat16
    assert tcache["ssm"].dtype == torch.float32
    for key, val in cache_to_numpy(tcache).items():
        np.testing.assert_array_equal(val, np.asarray(flat[key], val.dtype))


def test_launcher_serves_zamba2_on_the_cpu(capsys):
    rep = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "70", "--gen", "4"])
    out = capsys.readouterr().out
    assert "prefill: 2x70 in" in out and "decode: 3 steps in" in out
    assert "[kv-tiering]" not in out
    assert rep["tokens"].shape == (2, 4) and rep["page_mass"] is None
