"""flash_attention's backward kernels (``csrc/flash_attention_bwd.cuh``,
``csrc/flash_attention_bwd_wgmma.cuh``) on the CPU: a plain-torch twin of
their schedule, held against the plain backward ``attention_bwd_ref`` and
against ``jax.vjp`` of the reference's ``flash_train`` at every head dim;
what the forward saves for them (``attention_lse_ref`` against the JAX
reference's scores; why D needs the float32 output); ``FlashAttentionFn``'s
saved tensors and its backward dispatch on CPU and ``meta`` tensors; the
backward's charge.

The twin computes what the kernels compute, tile by tile, in float32 torch
ops, from what the forward saves: each row's lse (``attention_lse_ref``,
log2 units) and the float32 output o (on the bf16 route emulated as that
forward computes it, P split hi + lo before P.V).  D0 = rowsum(dO o) in
float32; (a) for each block of query rows, one sweep over the KV tiles the
mask lets through: P = exp2(c S - lse), dS = P (dP - D0), dq += dS.K a
tile at a time; on the bf16 route also the residual res = sum_j dS and
P_hi.K, dq -= res P_hi.K at the end and D = D0 + res (the split P of the
forward leaves D0 off by about 2^-17, which a peaked softmax turns into a
bf16 miss); (b) for each block of keys and each group of query heads
(two on the bf16 wgmma kernels, one elsewhere), dv += P^T.dO and dk +=
dS^T.Q with that D, a query step at a time, head after head, the groups'
parts summed in group order.  On the bf16 route P and dS are split x_hi + x_lo
(``.to(torch.bfloat16)``) before those products, as the kernels split
them; the f32 route's products are float32 (its 3xTF32 split is emulated in
tests/test_torch_flash_tf32x3.py).  The mma's own truncating adds are not
emulated: no product accumulates across tiles in the kernels (each tile's
part is added to the running sums by rounded float32 adds), which this twin
does too.

Tolerances (tests/test_torch_attention_grad.py's): float32 within 2e-5 of
each gradient's largest magnitude; bfloat16 within one bfloat16 step (2**-7
of the value) plus 1e-3 of the largest, with at most 1 % of the elements
differing at all, against the float32 gradient rounded once.  The lse:
within 1e-5 of max(1, its largest magnitude) (float32 sums in another
order), +inf exactly on the rows without a valid key."""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402
_torch_threads.limit()
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ref as j_ref  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro_torch.kernels.flash_attention import (FlashAttentionFn,  # noqa: E402
                                                 attention_bwd_ref,
                                                 attention_lse_ref,
                                                 attention_ref,
                                                 flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402

F32_TOL_OF_MAX = 2e-5
BF16_RTOL, BF16_ATOL_OF_MAX, BF16_DIFFERING = 2 ** -7, 1e-3, 0.01
LSE_TOL = 1e-5


def tiles(route: str, d: int) -> dict:
    """The kernels' tiles: query rows of a dq block and keys of its KV
    tiles; keys of a dk / dv block, query rows of its steps and the query
    heads it takes (one after the other into one running sum).  bf16 on
    wgmma (``flash_attention_bwd_wgmma.cuh``'s DqSmem / DkvSmem) at every d
    but 256, on mma.sync there (``flash_attention_bwd.cuh``'s Bf16Dq /
    Bf16Dkv); float32 F32Dq / F32Dkv."""
    if route == "tensor_core" and d <= 128:
        return dict(rows=128, bk=128 if d <= 64 else 32, keys=128,
                    bq=64 if d <= 64 else 32, group=2)
    if route == "tensor_core":
        return dict(rows=64, bk=16, keys=64, bq=16, group=1)
    return dict(rows=64, bk=32 if d <= 128 else 8,
                keys=64 if d <= 128 else 32,
                bq=32 if d <= 64 else 16 if d <= 128 else 8, group=1)


def _mask(rows, cols, sq, sk, causal, window):
    i, j = rows[:, None], cols[None, :]
    ok = (i < sq) & (j < sk)
    if causal:
        ok &= j <= i
    if window is not None:
        ok &= j >= i - window
    return ok


def _split_mm(a, b, split: bool):
    """a @ b with a split hi + lo to bfloat16 first (the bf16 route's P and
    dS), lo's product first into the same sum."""
    if not split:
        return a @ b
    hi = a.to(torch.bfloat16).float()
    lo = (a - hi).to(torch.bfloat16).float()
    return lo @ b + hi @ b


def _rows(x, r0, n_rows, n):
    """Rows [r0, r0 + n_rows) of x (n rows), zero past n."""
    out = torch.zeros((n_rows,) + x.shape[1:], dtype=x.dtype)
    m = max(0, min(n - r0, n_rows))
    out[:m] = x[r0:r0 + m]
    return out


def twin(q, k, v, do, *, q_per_kv, causal=True, window=None, sm_scale=None,
         split=None, d_from="float32", correct=None):
    """(dq, dk, dv) by the kernels' schedule (module docstring) in the
    inputs' dtype.  ``split``: split P and dS hi + lo before their
    products (default: the bf16 route's rule, bf16 inputs); False rounds
    nothing, "once" rounds them to bfloat16 once.  ``d_from``: D0 from the
    float32 output (the kernels') or, "bfloat16", from the output rounded
    to bf16.  ``correct``: D's residual correction (default: the bf16
    route's rule)."""
    bh, sq, d = q.shape
    bkh, sk, _ = k.shape
    t = tiles(fa_kernel.route(q.dtype, d), d)
    rows, bk, keys, bq, group = (t["rows"], t["bk"], t["keys"], t["bq"],
                                 t["group"])
    bf16 = q.dtype == torch.bfloat16
    if split is None:
        split = bf16
    if correct is None:
        correct = bf16
    rnd = (lambda x: x.to(torch.bfloat16).float()) if split == "once" \
        else (lambda x: x)
    split = split is True
    kw = dict(q_per_kv=q_per_kv, causal=causal, window=window,
              sm_scale=sm_scale)
    c = (d ** -0.5 if sm_scale is None else sm_scale) * math.log2(math.e)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    # what the forward saves, and D0
    lse = attention_lse_ref(q, k, **kw)
    if bf16:
        kk, vv = (torch.repeat_interleave(x, q_per_kv, dim=0)
                  for x in (kf, vf))
        ok = _mask(torch.arange(sq), torch.arange(sk), sq, sk, causal, window)
        p_all = torch.where(ok, torch.exp2(qf @ kk.transpose(1, 2) * c
                                           - lse[..., None]), 0.0)
        o = _split_mm(p_all, vv, True)
        del kk, vv, p_all
    else:
        o = attention_ref(qf, kf, vf, **kw)
    if d_from == "bfloat16":
        o = o.to(torch.bfloat16).float()
    dd = (dof * o).sum(-1)
    dq = torch.zeros(bh, sq, d)
    for h in range(bh):
        kv = h // q_per_kv
        for q0 in range(0, sq, rows):
            qrows = torch.arange(q0, q0 + rows)
            qb, dob = _rows(qf[h], q0, rows, sq), _rows(dof[h], q0, rows, sq)
            lq, dq_d = _rows(lse[h], q0, rows, sq), _rows(dd[h], q0, rows, sq)
            q_last = min(q0 + rows, sq) - 1
            k_end = min(sk, q_last + 1) if causal else sk
            k_begin = 0 if window is None else max(0, q0 - window)
            t_end = -(-k_end // bk) if k_end > k_begin else k_begin // bk
            acc, b_acc, res = (torch.zeros(rows, d), torch.zeros(rows, d),
                               torch.zeros(rows))
            for kt in range(k_begin // bk, t_end):
                k0 = kt * bk
                kb, vb = _rows(kf[kv], k0, bk, sk), _rows(vf[kv], k0, bk, sk)
                ok = _mask(qrows, torch.arange(k0, k0 + bk), sq, sk, causal,
                           window)
                p = torch.where(ok, torch.exp2((qb @ kb.T) * c - lq[:, None]),
                                0.0)
                ds = p * (dob @ vb.T - dq_d[:, None])
                res = res + ds.sum(1)
                b_acc = b_acc + p.to(torch.bfloat16).float() @ kb
                acc = acc + _split_mm(rnd(ds), kb, split)
            if correct:
                acc = acc - res[:, None] * b_acc
                n = max(0, min(sq - q0, rows))
                dd[h, q0:q0 + n] += res[:n]
            n = max(0, min(sq - q0, rows))
            dq[h, q0:q0 + n] = acc[:n]
    dk = torch.zeros(bkh, sk, d)
    dv = torch.zeros(bkh, sk, d)
    for kv in range(bkh):
        for k0 in range(0, sk, keys):
            cols = torch.arange(k0, k0 + keys)
            kb, vb = _rows(kf[kv], k0, keys, sk), _rows(vf[kv], k0, keys, sk)
            i_begin = min(k0, sq) if causal else 0
            i_end = sq if window is None else min(sq, k0 + keys + window)
            qts = range(i_begin // bq,
                        -(-i_end // bq) if i_end > i_begin else i_begin // bq)
            parts = []
            for g0 in range(0, q_per_kv, group):    # a block a head group
                pk, pv = torch.zeros(keys, d), torch.zeros(keys, d)
                heads = range(kv * q_per_kv + g0,
                              kv * q_per_kv + min(g0 + group, q_per_kv))
                for h, qt in ((h, qt) for h in heads for qt in qts):
                    qs = qt * bq
                    qb = _rows(qf[h], qs, bq, sq)
                    dob = _rows(dof[h], qs, bq, sq)
                    lq, dq_d = _rows(lse[h], qs, bq, sq), _rows(dd[h], qs, bq,
                                                                sq)
                    ok = _mask(torch.arange(qs, qs + bq), cols, sq, sk, causal,
                               window).T
                    pt = torch.where(ok, torch.exp2((kb @ qb.T) * c - lq), 0.0)
                    dst = rnd(pt * (vb @ dob.T - dq_d))
                    pt = rnd(pt)
                    pv = pv + _split_mm(pt, dob, split)
                    pk = pk + _split_mm(dst, qb, split)
                parts.append((pk, pv))
            sum_k, sum_v = parts[0]
            for pk, pv in parts[1:]:
                sum_k, sum_v = sum_k + pk, sum_v + pv
            nk = min(sk - k0, keys)
            dk[kv, k0:k0 + nk], dv[kv, k0:k0 + nk] = sum_k[:nk], sum_v[:nk]
    scale = d ** -0.5 if sm_scale is None else sm_scale
    return ((dq * scale).to(q.dtype), (dk * scale).to(k.dtype),
            dv.to(v.dtype))


def _verdict(got, want, dtype) -> tuple:
    """(within the tolerance, max |err| / its bound, share differing)."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    diff, top = np.abs(got - want), float(np.abs(want).max())
    if dtype == "float32":
        share = float(diff.max()) / max(F32_TOL_OF_MAX * top, 1e-30)
        return share <= 1.0, share, float((diff > 0).mean())
    bound = BF16_RTOL * np.abs(want) + BF16_ATOL_OF_MAX * top
    worst = float((diff / np.maximum(bound, 1e-30)).max())
    differing = float((diff > 0).mean())
    return worst <= 1.0 and differing <= BF16_DIFFERING, worst, differing


def _inputs(seed, b, h, kvh, sq, sk, d, dtype):
    """q (B·H, Sq, d) scaled by 3 (a peaked softmax), k, v (B·KVH, Sk, d)
    and dO, numpy draws rounded once to ``dtype``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b * h, sq, d)) * 3,
            rng.normal(size=(b * kvh, sk, d)),
            rng.normal(size=(b * kvh, sk, d)),
            rng.normal(size=(b * h, sq, d))]
    tdt = getattr(torch, dtype)
    return [torch.from_numpy(a.astype(np.float32)).to(tdt) for a in arrs]


CASES = {
    # label: (B, H, KVH, Sq, Sk, causal, window)
    "causal GQA, ragged S": (1, 4, 2, 70, 70, True, None),
    "window inside a tile": (1, 4, 2, 100, 100, True, 13),
    "non-causal Sq > Sk": (1, 4, 2, 90, 50, False, None),
    "non-causal Sq < Sk, window": (1, 2, 1, 50, 90, False, 20),
    "rows without keys": (1, 2, 2, 120, 40, True, 10),
}
# the cases the reference's flash_train takes (self-attention, causal)
JAX_CASES = ("causal GQA, ragged S", "window inside a tile")


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", fa_kernel.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_twin_matches_the_plain_backward(dtype, d, case):
    """The twin against attention_bwd_ref on the same inputs (both round
    one float32 result once), and dq exactly 0 on the rows that see no
    key."""
    b, h, kvh, sq, sk, causal, window = CASES[case]
    q, k, v, do = _inputs(sq * d + h, b, h, kvh, sq, sk, d, dtype)
    kw = dict(q_per_kv=h // kvh, causal=causal, window=window)
    got = twin(q, k, v, do, **kw)
    want = attention_bwd_ref(q, k, v, do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        ok, worst, differing = _verdict(g, w.float().numpy(), dtype)
        assert ok, (worst, differing)
    keyless = [r for r in range(sq) if (min(r, sk - 1) if causal else sk - 1)
               < (0 if window is None else max(0, r - window))]
    assert (case == "rows without keys") == bool(keyless)
    assert not got[0][:, keyless].any()


@functools.lru_cache(maxsize=None)
def _jax_grads(case: str, d: int):
    """jax.vjp of the reference's flash_train (f32, the masked schedule),
    jitted once per (case, d)."""
    b, h, kvh, s, _, causal, window = CASES[case]

    @jax.jit
    def grads(q, k, v, do):
        return jax.vjp(lambda q, k, v: j_attn.flash_train(
            q, k, v, causal=causal, window=window, block_k=32,
            causal_schedule="masked"), q, k, v)[1](do)
    return grads


@pytest.mark.parametrize("case", JAX_CASES)
@pytest.mark.parametrize("d", fa_kernel.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_twin_matches_jax_vjp_of_flash_train(dtype, d, case):
    """The twin against jax.vjp of the reference's flash_train in float32
    on the same (dtype-rounded) inputs, that gradient rounded once to the
    dtype."""
    b, h, kvh, s, _, causal, window = CASES[case]
    q, k, v, do = _inputs(s * d + h + 1, b, h, kvh, s, s, d, dtype)
    got = twin(q, k, v, do, q_per_kv=h // kvh, causal=causal, window=window)
    shapes = [(b, h, s, d), (b, kvh, s, d), (b, kvh, s, d), (b, h, s, d)]
    j_in = [jnp.asarray(t.float().numpy().reshape(sh))
            for t, sh in zip((q, k, v, do), shapes)]
    want = _jax_grads(case, d)(*j_in)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32).reshape(g.shape)
        if dtype == "bfloat16":
            w = np.asarray(jnp.asarray(w).astype(jnp.bfloat16), np.float32)
        ok, worst, differing = _verdict(g, w, dtype)
        assert ok, (worst, differing)


def test_rounding_p_and_ds_once_misses_the_bf16_check():
    """Why the bf16 route splits P and dS: rounded once to bfloat16 before
    their products (FA2's rule), the gradient misses the bf16 check's 1 %
    on a peaked softmax; split hi + lo it meets it."""
    q, k, v, do = _inputs(5, 1, 4, 2, 128, 128, 64, "bfloat16")
    kw = dict(q_per_kv=2)
    want = attention_bwd_ref(q, k, v, do, **kw)
    once = twin(q, k, v, do, split="once", **kw)
    split = twin(q, k, v, do, **kw)
    assert any(not _verdict(g, w.float().numpy(), "bfloat16")[0]
               for g, w in zip(once, want))
    assert all(_verdict(g, w.float().numpy(), "bfloat16")[0]
               for g, w in zip(split, want))


def _jax_lse(q, k, *, q_per_kv, causal, window):
    """The log-sum-exp of the scores of the reference's attention
    (``repro.kernels.flash_attention.ref.attention_ref``: f32 scores of the
    repeated KV heads, scaled, masked) over the valid keys, in log2 units,
    computed in jnp on the same numpy inputs."""
    d = q.shape[-1]
    kk = jnp.repeat(jnp.asarray(k), q_per_kv, axis=0)
    s = jnp.einsum("hqd,hkd->hqk", jnp.asarray(q), kk) * d ** -0.5
    qpos = jnp.arange(q.shape[1])[:, None]
    kpos = jnp.arange(k.shape[1])[None, :]
    mask = jnp.ones((q.shape[1], k.shape[1]), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos >= qpos - window
    lse = jax.nn.logsumexp(jnp.where(mask[None], s, -jnp.inf), axis=-1)
    return np.asarray(jnp.where(mask.any(-1)[None], lse * math.log2(math.e),
                                jnp.inf))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_lse_ref_matches_the_reference_scores(dtype, case):
    """attention_lse_ref against the log-sum-exp of the JAX reference's
    scores on the same inputs: within LSE_TOL of max(1, its largest
    magnitude), +inf on the same rows (those without a valid key)."""
    b, h, kvh, sq, sk, causal, window = CASES[case]
    q, k, _, _ = _inputs(sq + sk + h, b, h, kvh, sq, sk, 64, dtype)
    kw = dict(q_per_kv=h // kvh, causal=causal, window=window)
    got = attention_lse_ref(q, k, **kw).numpy()
    want = _jax_lse(q.float().numpy(), k.float().numpy(), **kw)
    assert got.dtype == np.float32 and got.shape == (b * h, sq)
    assert np.array_equal(np.isinf(got), np.isinf(want))
    assert (case == "rows without keys") == bool(np.isinf(want).any())
    fin = np.isfinite(want)
    assert np.abs(got[fin] - want[fin]).max() \
        <= LSE_TOL * max(1.0, np.abs(want[fin]).max())
    # j_ref's own output: the softmax these scores normalise, once more
    out = np.asarray(j_ref.attention_ref(
        jnp.asarray(q.float().numpy()), jnp.asarray(k.float().numpy()),
        jnp.asarray(k.float().numpy()), **kw))
    assert np.allclose(attention_ref(q.float(), k.float(), k.float(), **kw)
                       .numpy(), out, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", fa_kernel.HEAD_DIMS)
def test_d_from_the_bf16_output_misses_the_bf16_check(d):
    """Why the bf16 forward writes its output in float32 for the backward:
    D = rowsum(dO o) from the bf16 output misses the bf16 check's 1 % by
    far on a peaked softmax (a fifth or more of dq or dk differing), and
    from the float32 output (with the residual correction) it meets it."""
    b, h, kvh, sq, sk, causal, window = CASES["causal GQA, ragged S"]
    q, k, v, do = _inputs(7 * d, b, h, kvh, sq, sk, d, "bfloat16")
    kw = dict(q_per_kv=h // kvh, causal=causal, window=window)
    want = attention_bwd_ref(q, k, v, do, **kw)
    from_bf16 = twin(q, k, v, do, d_from="bfloat16", correct=False, **kw)
    from_f32 = twin(q, k, v, do, **kw)
    verdicts = [_verdict(g, w.float().numpy(), "bfloat16")
                for g, w in zip(from_bf16[:2], want[:2])]
    assert not all(ok for ok, _, _ in verdicts)
    assert max(differing for _, _, differing in verdicts) > 0.2
    assert all(_verdict(g, w.float().numpy(), "bfloat16")[0]
               for g, w in zip(from_f32, want))


def _misses(d: int, **extra) -> int:
    """The CASES (at head dim d, bf16) in which the twin with ``extra``
    misses the bf16 check on dq, dk or dv."""
    n = 0
    for case in sorted(CASES):
        b, h, kvh, sq, sk, causal, window = CASES[case]
        q, k, v, do = _inputs(sq * d + h, b, h, kvh, sq, sk, d, "bfloat16")
        kw = dict(q_per_kv=h // kvh, causal=causal, window=window)
        want = attention_bwd_ref(q, k, v, do, **kw)
        got = twin(q, k, v, do, **kw, **extra)
        n += not all(_verdict(g, w.float().numpy(), "bfloat16")[0]
                     for g, w in zip(got, want))
    return n


@pytest.mark.parametrize("d", [64, 128])
def test_the_residual_correction_of_d_meets_the_bf16_check(d):
    """Why the bf16 dq kernels correct D: from the bf16 forward's float32
    output (P split in two bf16 before P.V, 16 bits) D0 alone misses the
    bf16 check in some of CASES; with the correction every case meets it,
    at qwen2-0.5b's and Mixtral's head dims."""
    assert _misses(d, correct=False) > 0
    assert _misses(d) == 0


@pytest.mark.parametrize("d", [16, 128])
def test_the_corrected_d_from_the_bf16_output_still_misses(d):
    """The correction does not make the float32 output unneeded: D0 from
    the bf16 output, corrected, still misses the bf16 check in some of
    CASES (at d 16 and 128; at d 64 it meets it)."""
    assert _misses(d, d_from="bfloat16") > 0


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_fn_saves_the_lse_and_the_f32_output(dtype):
    """FlashAttentionFn's forward on CPU tensors saves q, k, v, the output
    in float32 (the output itself in float32; in bf16 a float32 tensor that
    rounds to the output) and attention_lse_ref's lse;
    ``flash_attention(return_lse=True)`` returns them and on meta tensors
    their shapes and dtypes."""
    b, h, kvh, sq, sk, causal, window = CASES["rows without keys"]
    q, k, v, _ = _inputs(11, b, h, kvh, sq, sk, 32, dtype)
    kw = dict(q_per_kv=h // kvh, causal=causal, window=window)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = FlashAttentionFn.apply(*leaves, kw["q_per_kv"], causal, window,
                                 None, 16)
    sq_, sk_, sv, o32, lse = out.grad_fn.saved_tensors
    assert all(torch.equal(a, b_) for a, b_ in zip((sq_, sk_, sv), (q, k, v)))
    assert o32.dtype == torch.float32 and o32.shape == q.shape
    assert torch.equal(o32.to(q.dtype), out.detach())
    assert torch.equal(o32, attention_ref(q.float(), k.float(), v.float(),
                                          **kw))
    if dtype == "float32":
        assert o32.data_ptr() == out.data_ptr()
    assert torch.equal(lse, attention_lse_ref(q, k, **kw))
    assert lse.dtype == torch.float32 and lse.shape == (b * h, sq)
    assert bool(lse.isinf().any()) and not bool(lse.isnan().any())
    got = flash_attention(q, k, v, return_lse=True, **kw)
    assert all(torch.equal(x, y) for x, y in zip(got, (out.detach(), lse,
                                                       o32)))
    meta = flash_attention(*(t.to("meta") for t in (q, k, v)),
                           return_lse=True, **kw)
    assert [(t.device.type, t.shape, t.dtype) for t in meta] == [
        ("meta", x.shape, x.dtype) for x in got]


# --------------------------------------------------------------- dispatch
def test_backward_runs_the_plain_version_on_the_cpu():
    """On CPU tensors FlashAttentionFn's backward is attention_bwd_ref
    (bit for bit) and launches nothing; the CUDA wrapper refuses CPU
    tensors."""
    q, k, v, do = _inputs(3, 1, 6, 2, 40, 40, 16, "float32")
    launches = (fa_kernel.BWD_LAUNCHES, dict(fa_kernel.BWD_ROUTE_LAUNCHES))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = FlashAttentionFn.apply(*leaves, 3, True, 7, None, 16)
    got = torch.autograd.grad(out, leaves, do)
    want = attention_bwd_ref(q, k, v, do, q_per_kv=3, window=7, block_q=16)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    o, lse = torch.zeros_like(q), torch.zeros(q.shape[:2])
    assert all(torch.equal(g, w) for g, w in zip(
        flash_attention_bwd(q, k, v, o, do, lse, q_per_kv=3, window=7,
                            block_q=16),
        want))
    assert (fa_kernel.BWD_LAUNCHES,
            dict(fa_kernel.BWD_ROUTE_LAUNCHES)) == launches
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention_bwd_cuda(q, k, v, o, do, lse, q_per_kv=3)


def test_backward_meta_route_charge_at_the_training_shape():
    """qwen2-0.5b's training attention (B 4, H 14, KVH 2, S 2,048, d 64,
    bf16, causal): on meta tensors the backward makes the wrapper's checks,
    returns meta dq, dk, dv of the inputs' shapes and records the call in
    BWD_META_CALLS, with no launch; its charge is 10 · d · B·H · the causal
    pairs (five products) and q, k, v, dO, the saved float32 output and
    lse read and dq, dk, dv written once."""
    q = torch.empty(56, 2048, 64, dtype=torch.bfloat16, device="meta")
    k = torch.empty(8, 2048, 64, dtype=torch.bfloat16, device="meta")
    launches = (fa_kernel.BWD_LAUNCHES, fa_kernel.LAUNCHES)
    fa_kernel.BWD_META_CALLS.clear()
    leaves = [t.clone().requires_grad_() for t in (q, k, k)]
    out = FlashAttentionFn.apply(*leaves, 7, True, None, None, 512)
    grads = torch.autograd.grad(out, leaves, torch.empty_like(out))
    assert [(g.device.type, g.shape, g.dtype) for g in grads] == [
        ("meta", t.shape, t.dtype) for t in (q, k, k)]
    key = (56, 2048, 2048, 64, 7, True, None, torch.bfloat16, True)
    assert fa_kernel.BWD_META_CALLS == {key: 1}
    pairs = 2048 * 2049 // 2
    assert fa_kernel.bwd_charge(key) == (
        10 * 64 * 56 * pairs,
        (3 * 56 + 4 * 8) * 2048 * 64 * 2 + 4 * 56 * 2048 * (64 + 1))
    assert fa_kernel.bwd_charge(key) == (75_198_627_840, 82_247_680)
    assert (fa_kernel.BWD_LAUNCHES, fa_kernel.LAUNCHES) == launches
    o = torch.empty(q.shape, dtype=torch.float32, device="meta")
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="do must be"):
        flash_attention_bwd(q, k, k, o, q[:, :100], lse, q_per_kv=7)
    with pytest.raises(ValueError, match="KV rows"):
        flash_attention_bwd(q, k, k, o, q, lse, q_per_kv=6)
    with pytest.raises(ValueError, match="lse must be"):
        flash_attention_bwd(q, k, k, o, q, lse[:, :100], q_per_kv=7)
    with pytest.raises(ValueError, match="o must be"):
        flash_attention_bwd(q, k, k, q, q, lse, q_per_kv=7)
    fa_kernel.BWD_META_CALLS.clear()
