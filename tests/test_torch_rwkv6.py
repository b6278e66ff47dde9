"""The RWKV-6 family on the port (``repro_torch.models.rwkv6``, the
``rwkv6`` branches of ``models.model``, ``serve.engine`` and the launcher)
against the reference on perturbed weights carried across
(``_perturbed_weights.perturbed_tree``: the reference's init zeroes the
token shift, the decay LoRA and the bonus), at S 19 (one chunk) and 150
(three chunks of 64, the last padded: the carried state).

Tolerances.  float32 2e-5, relative and absolute: the same float32 math,
the three-operand contractions (the pairwise-decay scores, the bonus) and
the matmuls summed in another order.  bfloat16 activations:
``_torch_recurrent.close``'s rule at 6e-2 for hidden states, block outputs
and the shift states, 1e-2 for logits and the float32 wkv state (it
accumulates k v^T from bf16-rounded projections of inputs that differ by
a rounding).

One leaf is held to the reference's functions, not to its ``prefill``: the
channel mix's token-shift state ``sh_ffn``.  The reference's prefill stores
ln2 of the block's output there, where its own ``decode_step`` reads the
channel mix's input (ln2 of x after the time mix), so its prefill + decode
leaves the forward pass once ``f_mu_k`` / ``f_mu_r`` are not zero
(``test_reference_prefill_shift_fault``).  The port stores the channel
mix's input; ``test_prefill_then_decode_equals_forward`` holds it to
that."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_recurrent import (ACTS, BF16_HIDDEN_TOL, BF16_LOGIT_TOL,  # noqa: E402
                              bf16_error_within_the_references, both,
                              carried, close, layer, perturbed_tree)
from repro.models import layers as jl  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import rwkv6 as jr  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro_torch.convert import (cache_from_numpy, cache_to_numpy,  # noqa: E402
                                 params_from_numpy, params_to_numpy)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import rwkv6 as tr  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402

ARCH = "rwkv6-3b"
F32_TOL = 2e-5
HIDDEN_TOL = {"float32": F32_TOL, "bfloat16": BF16_HIDDEN_TOL}
LOGIT_TOL = {"float32": F32_TOL, "bfloat16": BF16_LOGIT_TOL}
STATE_TOL = {"float32": F32_TOL, "bfloat16": 1e-2}
LENGTHS = (19, 150)
N_DECODE = 3


def j_params(bp):
    return (jr.RWKV6Params(*(bp[f] for f in jr.RWKV6Params._fields)),
            jr.RWKV6FFNParams(*(bp["f_" + f]
                                for f in jr.RWKV6FFNParams._fields)))


def j_shift_states(jp, jc, toks):
    """The reference's functions composed as its decode_step reads them:
    per layer, ln1 of the block input and ln2 of x after the time mix, at
    the last position -> (sh_mix, sh_ffn), each (L, B, D)."""
    x = jnp.take(jp["embed"], toks, axis=0).astype(jc.activ_dtype)
    shm, shf = [], []
    for i in range(jc.n_layers):
        bp = layer(jp, i)
        p, fp = j_params(bp)
        xn = jl.rms_norm(x, bp["ln1"], jc.norm_eps)
        h, _ = jr.rwkv6_mix(xn, p, n_heads=jc.d_model // 64)
        x = x + h
        xn2 = jl.rms_norm(x, bp["ln2"], jc.norm_eps)
        x = x + jr.rwkv6_channel_mix(xn2, fp)
        shm.append(xn[:, -1])
        shf.append(xn2[:, -1])
    return jnp.stack(shm), jnp.stack(shf)


def _run_both(act: str, s: int) -> dict:
    """forward, prefill (max_len s + 4) and N_DECODE decode steps on both
    sides; the reference's decode chain starts from its prefill's cache
    with sh_ffn the channel mix's input (module docstring)."""
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
    out["shift_want"] = j_shift_states(jp, jc, jt)
    jcache = dict(jcache, sh_ffn=out["shift_want"][1])
    jstep = jax.jit(lambda p, c, t: jeng.decode_step(p, jc, c, t))
    steps = []
    for k in range(N_DECODE):
        nxt = toks[:, s + k]
        jlog, jcache, jaux = jstep(jp, jcache, jnp.asarray(nxt, jnp.int32))
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


# ------------------------------------------------------------------- mixes
@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("act", sorted(ACTS))
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_mix_matches_reference(runs, act, s, with_state):
    """The chunked time mix and its final state on layer 1's weights, from
    zeros or a carried state."""
    r = runs(act, s)
    jc, tp, jp = r["jc"], r["tp"], r["jp"]
    rng = np.random.default_rng(7)
    jx, tx = both(rng.normal(size=(2, s, jc.d_model)), act)
    h = jc.d_model // 64
    jstate = tstate = None
    if with_state:
        st = rng.normal(0, 0.1, (2, h, 64, 64)).astype(np.float32)
        jstate, tstate = jnp.asarray(st), torch.from_numpy(st)
    jout, jst = jr.rwkv6_mix(jx, j_params(layer(jp, 1))[0], jstate,
                             n_heads=h)
    tout, tst = tr.rwkv6_mix(tx, tm.rwkv6_params(layer(tp, 1)), tstate,
                             n_heads=h)
    assert tout.dtype == ACTS[act][1] and tst.dtype == torch.float32
    close(tout, jout, HIDDEN_TOL[act], act)
    close(tst, jst, STATE_TOL[act], act)


@pytest.mark.parametrize("act", sorted(ACTS))
def test_rwkv6_steps_match_reference(runs, act):
    """The single-token time mix and channel mix on layer 0's weights."""
    r = runs(act, LENGTHS[0])
    jc, tp, jp = r["jc"], r["tp"], r["jp"]
    rng = np.random.default_rng(8)
    d, h = jc.d_model, jc.d_model // 64
    jx, tx = both(rng.normal(size=(3, d)), act)
    jxp, txp = both(rng.normal(size=(3, d)), act)
    st = rng.normal(0, 0.1, (3, h, 64, 64)).astype(np.float32)
    jp_, jfp = j_params(layer(jp, 0))
    jout, jst = jr.rwkv6_mix_step(jx, jxp, jnp.asarray(st), jp_, n_heads=h)
    tout, tst = tr.rwkv6_mix_step(tx, txp, torch.from_numpy(st),
                                  tm.rwkv6_params(layer(tp, 0)), n_heads=h)
    close(tout, jout, HIDDEN_TOL[act], act)
    close(tst, jst, STATE_TOL[act], act)
    close(tr.rwkv6_channel_mix_step(tx, txp, tm.rwkv6_ffn_params(layer(tp, 0))),
          jr.rwkv6_channel_mix_step(jx, jxp, jfp), HIDDEN_TOL[act], act)


@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("act", sorted(ACTS))
def test_rwkv6_block_matches_reference(runs, act, s):
    r = runs(act, s)
    jc, tc, tp, jp = r["jc"], r["tc"], r["tp"], r["jp"]
    jx, tx = both(np.random.default_rng(9).normal(size=(2, s, jc.d_model)),
                  act)
    jout, jst = jm.rwkv6_block(jx, layer(jp, 0), jc)
    tout, tst = tm.rwkv6_block(tx, layer(tp, 0), tc)
    close(tout, jout, HIDDEN_TOL[act], act)
    close(tst, jst, STATE_TOL[act], act)
    close(tr.rwkv6_channel_mix(tx, tm.rwkv6_ffn_params(layer(tp, 0))),
          jr.rwkv6_channel_mix(jx, j_params(layer(jp, 0))[1]),
          HIDDEN_TOL[act], act)


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
    """Logits and every cache leaf: wkv and sh_mix against the reference's
    prefill, sh_ffn against the reference's functions (module
    docstring)."""
    r = runs(act, s)
    tlog, tcache, jlog, jcache = r["prefill"]
    assert set(tcache) == set(jcache) == {"wkv", "sh_mix", "sh_ffn", "pos"}
    for key in tcache:
        assert tuple(tcache[key].shape) == jcache[key].shape, key
    assert tcache["wkv"].dtype == torch.float32
    assert tcache["sh_mix"].dtype == ACTS[act][1]
    close(tlog, jlog, LOGIT_TOL[act], act)
    close(tcache["wkv"], jcache["wkv"], STATE_TOL[act], act)
    close(tcache["sh_mix"], jcache["sh_mix"], HIDDEN_TOL[act], act)
    close(tcache["sh_mix"], r["shift_want"][0], HIDDEN_TOL[act], act)
    close(tcache["sh_ffn"], r["shift_want"][1], HIDDEN_TOL[act], act)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("act", sorted(ACTS))
def test_decode_steps_match_reference(runs, act, s):
    """Three decode steps: logits, every cache leaf, an empty aux."""
    for tlog, tcache, taux, jlog, jcache in runs(act, s)["decode"]:
        assert taux == {}
        close(tlog, jlog, LOGIT_TOL[act], act)
        close(tcache["wkv"], jcache["wkv"], STATE_TOL[act], act)
        for key in ("sh_mix", "sh_ffn"):
            close(tcache[key], jcache[key], HIDDEN_TOL[act], act)
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))



@pytest.mark.parametrize("s", LENGTHS)
def test_bfloat16_error_within_the_references(runs, s):
    bf16_error_within_the_references(runs("bfloat16", s), runs("float32", s))

@pytest.mark.parametrize("act", sorted(ACTS))
def test_prefill_then_decode_equals_forward(runs, act):
    """The port's prefill of 149 tokens and one decode step give forward's
    logits at position 150 (three chunks, the last padded)."""
    r = runs(act, 150)
    tc, tp, toks = r["tc"], r["tp"], torch.from_numpy(r["toks"])
    _, cache = teng.prefill(tp, tc, tokens=toks[:, :149], max_len=150)
    got, _, _ = teng.decode_step(tp, tc, cache, toks[:, 149])
    close(got, r["logits"][0][:, -1].float(), LOGIT_TOL[act], act)


def test_reference_prefill_shift_fault(runs):
    """The reference's own prefill + decode leaves its forward pass on
    perturbed weights (its sh_ffn is ln2 of the block output), and its
    decode_step from the channel mix's input rejoins it: the fault the
    port's prefill does not carry (ROADMAP Queue 3)."""
    r = runs("float32", 150)
    jc, jp, toks = r["jc"], r["jp"], jnp.asarray(r["toks"])
    want = r["logits"][1][:, -1]
    _, cache = jeng.prefill(jp, jc, tokens=toks[:, :149], max_len=150)
    bad, _, _ = jeng.decode_step(jp, jc, cache, toks[:, 149])
    fixed = dict(cache, sh_ffn=j_shift_states(jp, jc, toks[:, :149])[1])
    good, _, _ = jeng.decode_step(jp, jc, fixed, toks[:, 149])
    assert float(jnp.abs(bad - want).max()) > 1e-3
    np.testing.assert_allclose(np.asarray(good), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)


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
    """Every rwkv6 parameter leaf and cache leaf crosses the generic tree
    maps and back unchanged (bfloat16 through float32)."""
    jc = runs("bfloat16", 19)["jc"]
    tree = perturbed_tree(jm.iter_schema(jc), 3)
    back = params_to_numpy(params_from_numpy(tree, device="cpu"))
    for key, val in tree["blocks"].items():
        np.testing.assert_array_equal(back["blocks"][key], val)
    _, _, _, jcache = runs("bfloat16", 19)["prefill"]
    flat = jax.tree.map(np.asarray, jcache)
    tcache = cache_from_numpy(flat, device="cpu")
    assert tcache["sh_mix"].dtype == torch.bfloat16
    assert tcache["wkv"].dtype == torch.float32
    for key, val in cache_to_numpy(tcache).items():
        np.testing.assert_array_equal(val, np.asarray(flat[key], val.dtype))


def test_launcher_serves_rwkv6_on_the_cpu(capsys):
    rep = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "70", "--gen", "4"])
    out = capsys.readouterr().out
    assert "prefill: 2x70 in" in out and "decode: 3 steps in" in out
    assert "[kv-tiering]" not in out
    assert rep["tokens"].shape == (2, 4) and rep["page_mass"] is None
