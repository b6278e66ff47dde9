"""flash_attention's gradient: ``attention_bwd_ref`` (the plain blocked
backward) and ``FlashAttentionFn`` (the kernel's forward on the card, the
plain version's here, with that backward) against ``jax.grad`` of the
reference's pure-JAX ``flash_train`` (both schedules) and against autograd
of the plain ``attention_ref``.

Tolerance: float32 gradients within 2e-5 of each tensor's largest
magnitude — the same float32 products and softmax, summed in another
order (the reference's scan or unrolled blocks, the port's blocks of query
rows).  bfloat16: the port's gradient against the reference's float32
gradient rounded once: an element may land one bfloat16 step (2**-7 of its
value) apart, plus 1e-3 of the largest for float32 noise near 0, and at
most 1 % of them may differ at all (the forward check's rule,
``chip_smoke.py``'s FLASH_TOL); and no farther from the float32 gradient
than twice the reference's own bfloat16 gradient."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as j_attn  # noqa: E402
from repro_torch.kernels.flash_attention import (FlashAttentionFn,  # noqa: E402
                                                 attention_bwd_ref,
                                                 attention_ref,
                                                 flash_attention)
from repro_torch.models import attention as t_attn  # noqa: E402

F32_TOL_OF_MAX = 2e-5
BF16_RTOL, BF16_ATOL_OF_MAX, BF16_DIFFERING = 2 ** -7, 1e-3, 0.01
ACTS = {"float32": (jnp.float32, torch.float32),
        "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, b, h, kvh, s, d, dtype):
    """q, k, v (B, H|KVH, S, d) and dO in both frameworks: numpy draws
    (q scaled by 3: a peaked softmax), rounded once to ``dtype``."""
    jdt, tdt = ACTS[dtype]
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, h, s, d)) * 3, rng.normal(size=(b, kvh, s, d)),
            rng.normal(size=(b, kvh, s, d)), rng.normal(size=(b, h, s, d))]
    j = [jnp.asarray(a, jdt) for a in arrs]
    return j, [torch.from_numpy(np.array(x, np.float32)).to(tdt) for x in j]


def _assert_grad_close(got: torch.Tensor, want, dtype: str) -> None:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    diff, top = np.abs(got - want), np.abs(want).max()
    if dtype == "float32":
        assert diff.max() <= F32_TOL_OF_MAX * top, diff.max() / top
        return
    assert (diff <= BF16_RTOL * np.abs(want) + BF16_ATOL_OF_MAX * top).all()
    assert (diff > 0).mean() <= BF16_DIFFERING, (diff > 0).mean()


CASES = {
    # label: (B, H, KVH, S, d, window, block_k)
    "causal MHA": (2, 4, 4, 64, 16, None, 16),
    "GQA 7:1": (1, 14, 2, 48, 16, None, 16),
    "windowed": (2, 4, 2, 64, 16, 9, 16),
    "ragged S": (2, 4, 2, 37, 16, None, 16),
    "ragged S, one block": (1, 6, 3, 19, 32, 4, 512),
}


def _schedules(case):
    """The reference's triangular schedule splits S into S // block_k
    blocks of equal size and fails when they do not cover S (ROADMAP Queue
    3), so a ragged S runs on the masked schedule alone."""
    b, h, kvh, s, d, window, block_k = CASES[case]
    return ["masked"] + (["triangular"] if s < 2 * block_k
                         or s % block_k == 0 else [])


def _kwargs(schedule, case) -> dict:
    b, h, kvh, s, d, window, block_k = CASES[case]
    return dict(causal=True, window=window, block_k=block_k,
                causal_schedule=schedule)


@functools.lru_cache(maxsize=None)
def _jitted_vjp(schedule, case):
    """``jax.vjp`` of the reference's flash_train, one jitted function
    per case and schedule (compiled once per dtype)."""
    kw = _kwargs(schedule, case)

    @jax.jit
    def grads(q, k, v, do):
        return jax.vjp(lambda q, k, v: j_attn.flash_train(q, k, v, **kw),
                       q, k, v)[1](do)
    return grads


def _jax_vjp(j_inputs, schedule, case):
    return _jitted_vjp(schedule, case)(*j_inputs), _kwargs(schedule, case)


@pytest.mark.parametrize("case,schedule", [
    (c, sch) for c in sorted(CASES) for sch in _schedules(c)])
def test_flash_train_gradient_matches_jax_grad(case, schedule):
    """The port's flash_train under grad (through FlashAttentionFn) against
    ``jax.vjp`` of the reference's flash_train, float32."""
    b, h, kvh, s, d, window, block_k = CASES[case]
    j_in, (q, k, v, do) = _inputs(s + h, b, h, kvh, s, d, "float32")
    want, kw = _jax_vjp(j_in, schedule, case)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out = t_attn.flash_train(*leaves, **kw)
    # the output is a reshape of FlashAttentionFn's
    assert type(out.grad_fn.next_functions[0][0]).__name__ \
        == "FlashAttentionFnBackward"
    got = torch.autograd.grad(out, leaves, do)
    for g, w in zip(got, want):
        _assert_grad_close(g, w, "float32")


@pytest.mark.parametrize("schedule", ["masked", "triangular"])
@pytest.mark.parametrize("case", ["GQA 7:1", "windowed"])
def test_bf16_gradient_no_farther_than_the_references(case, schedule):
    """bfloat16 q, k, v, dO.  The port sums every gradient in float32 and
    rounds it once; the reference rounds a block's contribution to bfloat16
    before its ``astype``'s VJP sums the blocks (dk, dv over the triangular
    schedule's query blocks, dq over the masked schedule's KV blocks), so
    the two are held to float32 instead: each port gradient no farther
    from the reference's float32 gradient (same inputs) than twice the
    reference's own bfloat16 gradient (the rule of
    ``tests/_torch_recurrent.py``), and within the float32-sum rule of
    ``_assert_grad_close`` of the float32 gradient rounded once."""
    b, h, kvh, s, d, window, block_k = CASES[case]
    j16, (q, k, v, do) = _inputs(7, b, h, kvh, s, d, "bfloat16")
    ref16, kw = _jax_vjp(j16, schedule, case)
    truth, _ = _jax_vjp([x.astype(jnp.float32) for x in j16], schedule,
                        case)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(t_attn.flash_train(*leaves, **kw), leaves, do)
    for g, r, t in zip(got, ref16, truth):
        assert g.dtype == torch.bfloat16
        t = np.asarray(t, np.float32)
        port_err = np.abs(g.float().numpy() - t).max()
        ref_err = np.abs(np.asarray(r, np.float32) - t).max()
        assert port_err <= 2 * ref_err, (port_err, ref_err)
        _assert_grad_close(g, jnp.asarray(t).astype(jnp.bfloat16),
                           "bfloat16")


@pytest.mark.parametrize("causal,sq,sk,window", [
    (True, 40, 40, None), (True, 40, 40, 7), (True, 50, 30, None),
    (False, 30, 50, None), (False, 40, 40, 5), (True, 33, 33, 0)])
@pytest.mark.parametrize("block_q", [8, 512])
def test_bwd_ref_matches_autograd_of_the_plain_version(causal, sq, sk,
                                                       window, block_q):
    """attention_bwd_ref against autograd of attention_ref (float32) on
    causal and non-causal masks, Sq != Sk, windows (0: each row sees itself
    only) and blocks that split the rows or take them all."""
    rng = np.random.default_rng(sq * sk + block_q)
    bh, kvh, d = 6, 2, 16
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                   for shape in ((bh, sq, d), (kvh, sk, d), (kvh, sk, d),
                                 (bh, sq, d)))
    q = q * 3
    kw = dict(q_per_kv=bh // kvh, causal=causal, window=window)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*leaves, **kw), leaves, do)
    got = attention_bwd_ref(q, k, v, do, block_q=block_q, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        top = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= F32_TOL_OF_MAX * top
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = FlashAttentionFn.apply(*leaves, bh // kvh, causal, window, None,
                                 block_q)
    assert torch.equal(out, attention_ref(q, k, v, **kw))
    for g, w in zip(torch.autograd.grad(out, leaves, do), got):
        assert torch.equal(g, w)


def test_rows_without_keys_get_zero_gradient():
    """A query block whose rows see no key (Sq > Sk, causal, a window that
    ends before the keys do) gives dq 0 there, as autograd of the plain
    version does."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(2, 40, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, 8, 16)).astype(np.float32))
            for _ in range(2))
    do = torch.ones_like(q)
    dq, dk, dv = attention_bwd_ref(q, k, v, do, q_per_kv=1, window=3,
                                   block_q=8)
    assert torch.all(dq[:, 16:] == 0)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*leaves, q_per_kv=1, window=3),
                               leaves, do)
    for g, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(g, w, rtol=0, atol=2e-5 * float(
            w.abs().max()))


def test_flash_train_without_grad_keeps_the_serving_call():
    """Without grad mode, or with no input that requires grad, flash_train
    (FlashAttentionFn's forward alone) builds no graph and gives the
    serving call's output, flash_attention's."""
    _, (q, k, v, _) = _inputs(1, 1, 4, 2, 16, 16, "float32")
    serving = flash_attention(q.reshape(4, 16, 16), k.reshape(2, 16, 16),
                              v.reshape(2, 16, 16), q_per_kv=2)
    out = t_attn.flash_train(q, k, v)
    assert out.grad_fn is None
    assert torch.equal(out, serving.reshape(out.shape))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    with torch.no_grad():
        out = t_attn.flash_train(*leaves)
    assert out.grad_fn is None
    assert torch.equal(out, serving.reshape(out.shape))
