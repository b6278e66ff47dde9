"""flash_attention's backward kernels (``csrc/flash_attention_bwd.cuh``) on
the CPU: a plain-torch twin of their schedule, held against the plain
backward ``attention_bwd_ref`` and against ``jax.vjp`` of the reference's
``flash_train`` at every head dim; ``FlashAttentionFn``'s backward dispatch
on CPU and ``meta`` tensors; the backward's charge.

The twin computes what the kernels compute, tile by tile, in float32 torch
ops: (a) for each block of 64 query rows, the online sweep over the KV
tiles the mask lets through (the running max m in log2 units, the sum l
and D = sum p dP rescaled with it), then the second sweep (P = exp2(x - m)
/ l, dS = P (dP - D), dq += dS.K a tile at a time); (b) for each block of
keys and each query head apart, dv += P^T.dO and dk += dS^T.Q a query step
at a time, the heads' parts summed in head order.  On the bf16 route P and
dS are split x_hi + x_lo (``.to(torch.bfloat16)``) before those products,
as the kernels split them; the f32 route's products are float32 (its
3xTF32 split is emulated in tests/test_torch_flash_tf32x3.py).  The mma's
own truncating adds are not emulated: no product accumulates across tiles
in the kernels (each tile's part is added to the running sums by rounded
float32 adds), which this twin does too.

Tolerances (tests/test_torch_attention_grad.py's): float32 within 2e-5 of
each gradient's largest magnitude; bfloat16 within one bfloat16 step (2**-7
of the value) plus 1e-3 of the largest, with at most 1 % of the elements
differing at all, against the float32 gradient rounded once."""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402
_torch_threads.limit()
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as j_attn  # noqa: E402
from repro_torch.kernels.flash_attention import (FlashAttentionFn,  # noqa: E402
                                                 attention_bwd_ref,
                                                 flash_attention_bwd)
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402

F32_TOL_OF_MAX = 2e-5
BF16_RTOL, BF16_ATOL_OF_MAX, BF16_DIFFERING = 2 ** -7, 1e-3, 0.01
NEG_INF = -1e30
ROWS = 64            # query rows of a dq block, keys of a dk / dv block


def tiles(route: str, d: int) -> dict:
    """The kernels' tiles (flash_attention_bwd.cuh's Bf16Dq / Bf16Dkv /
    F32Dq / F32Dkv): keys a KV tile of the dq kernel, query rows a step and
    keys a block of the dk / dv kernel."""
    if route == "tensor_core":
        return dict(bk=64 if d <= 64 else 32, bq=64 if d <= 128 else 16,
                    keys=ROWS)
    return dict(bk=32 if d <= 128 else 8,
                bq=32 if d <= 64 else 16 if d <= 128 else 8,
                keys=ROWS if d <= 128 else 32)


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


def twin(q, k, v, do, *, q_per_kv, causal=True, window=None, sm_scale=None,
         split=None):
    """(dq, dk, dv) by the kernels' schedule (module docstring) in the
    inputs' dtype.  ``split``: split P and dS hi + lo before their
    products (default: the bf16 route's rule, bf16 inputs); False rounds
    nothing, "once" rounds them to bfloat16 once."""
    bh, sq, d = q.shape
    bkh, sk, _ = k.shape
    route = fa_kernel.route(q.dtype, d)
    t = tiles(route, d)
    bk, bq, keys = t["bk"], t["bq"], t["keys"]
    if split is None:
        split = route == "tensor_core"
    rnd = (lambda x: x.to(torch.bfloat16).float()) if split == "once" \
        else (lambda x: x)
    split = split is True
    c = (d ** -0.5 if sm_scale is None else sm_scale) * math.log2(math.e)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    n_qt = -(-sq // ROWS)
    stats = torch.zeros(3, bh, n_qt * ROWS)
    dq = torch.zeros(bh, sq, d)
    for h in range(bh):
        kv = h // q_per_kv
        for qt in range(n_qt):
            q0 = qt * ROWS
            rows = torch.arange(q0, q0 + ROWS)
            qb = torch.zeros(ROWS, d)
            dob = torch.zeros(ROWS, d)
            n = max(0, min(sq - q0, ROWS))
            qb[:n], dob[:n] = qf[h, q0:q0 + n], dof[h, q0:q0 + n]
            q_last = min(q0 + ROWS, sq) - 1
            k_end = min(sk, q_last + 1) if causal else sk
            k_begin = 0 if window is None else max(0, q0 - window)
            t_end = -(-k_end // bk) if k_end > k_begin else k_begin // bk
            kts = range(k_begin // bk, t_end)
            m = torch.full((ROWS,), NEG_INF)
            l = torch.zeros(ROWS)
            dd = torch.zeros(ROWS)

            def tile(kt):
                k0 = kt * bk
                kb = torch.zeros(bk, d)
                vb = torch.zeros(bk, d)
                nk = max(0, min(sk - k0, bk))
                kb[:nk], vb[:nk] = kf[kv, k0:k0 + nk], vf[kv, k0:k0 + nk]
                ok = _mask(rows, torch.arange(k0, k0 + bk), sq, sk, causal,
                           window)
                x = torch.where(ok, (qb @ kb.T) * c, NEG_INF)
                return x, dob @ vb.T, kb
            for kt in kts:                      # sweep 1
                x, dp, _ = tile(kt)
                m_new = torch.maximum(m, x.max(1).values)
                alpha = torch.exp2(m - m_new)
                p = torch.where(x > NEG_INF, torch.exp2(x - m_new[:, None]),
                                0.0)
                l = l * alpha + p.sum(1)
                dd = dd * alpha + (p * dp).sum(1)
                m = m_new
            inv_l = torch.where(l > 0, 1 / l, torch.zeros(()))
            dd = dd * inv_l
            stats[:, h, q0:q0 + ROWS] = torch.stack([m, inv_l, dd])
            acc = torch.zeros(ROWS, d)
            for kt in kts:                      # sweep 2
                x, dp, kb = tile(kt)
                p = torch.where(x > NEG_INF,
                                torch.exp2(x - m[:, None]) * inv_l[:, None],
                                0.0)
                ds = rnd(p * (dp - dd[:, None]))
                acc = acc + _split_mm(ds, kb, split)
            dq[h, q0:q0 + n] = acc[:n]
    dk = torch.zeros(bkh, sk, d)
    dv = torch.zeros(bkh, sk, d)
    for kv in range(bkh):
        for k0 in range(0, sk, keys):
            cols = torch.arange(k0, k0 + keys)
            kb = torch.zeros(keys, d)
            vb = torch.zeros(keys, d)
            nk = min(sk - k0, keys)
            kb[:nk], vb[:nk] = kf[kv, k0:k0 + nk], vf[kv, k0:k0 + nk]
            i_begin = min(k0, sq) if causal else 0
            i_end = sq if window is None else min(sq, k0 + keys + window)
            qts = range(i_begin // bq,
                        -(-i_end // bq) if i_end > i_begin else i_begin // bq)
            parts = []
            for g in range(q_per_kv):           # a block a query head
                h = kv * q_per_kv + g
                pk, pv = torch.zeros(keys, d), torch.zeros(keys, d)
                for qt in qts:
                    qs = qt * bq
                    qrows = torch.arange(qs, qs + bq)
                    qb = torch.zeros(bq, d)
                    dob = torch.zeros(bq, d)
                    n = max(0, min(sq - qs, bq))
                    qb[:n], dob[:n] = qf[h, qs:qs + n], dof[h, qs:qs + n]
                    m, inv_l, dd = stats[:, h, qs:qs + bq]
                    ok = _mask(qrows, cols, sq, sk, causal, window).T
                    pt = torch.where(
                        ok, torch.exp2((kb @ qb.T) * c - m) * inv_l, 0.0)
                    dst = rnd(pt * (vb @ dob.T - dd))
                    pt = rnd(pt)
                    pv = pv + _split_mm(pt, dob, split)
                    pk = pk + _split_mm(dst, qb, split)
                parts.append((pk, pv))
            sum_k, sum_v = parts[0]
            for pk, pv in parts[1:]:
                sum_k, sum_v = sum_k + pk, sum_v + pv
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
    assert all(torch.equal(g, w) for g, w in zip(
        flash_attention_bwd(q, k, v, do, q_per_kv=3, window=7, block_q=16),
        want))
    assert (fa_kernel.BWD_LAUNCHES,
            dict(fa_kernel.BWD_ROUTE_LAUNCHES)) == launches
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention_bwd_cuda(q, k, v, do, q_per_kv=3)


def test_backward_meta_route_charge_at_the_training_shape():
    """qwen2-0.5b's training attention (B 4, H 14, KVH 2, S 2,048, d 64,
    bf16, causal): on meta tensors the backward makes the wrapper's checks,
    returns meta dq, dk, dv of the inputs' shapes and records the call in
    BWD_META_CALLS, with no launch; its charge is 10 · d · B·H · the causal
    pairs (five products) and q, k, v, dO read and dq, dk, dv written
    once."""
    q = torch.empty(56, 2048, 64, dtype=torch.bfloat16, device="meta")
    k = torch.empty(8, 2048, 64, dtype=torch.bfloat16, device="meta")
    launches = (fa_kernel.BWD_LAUNCHES, fa_kernel.LAUNCHES)
    fa_kernel.BWD_META_CALLS.clear()
    leaves = [t.clone().requires_grad_() for t in (q, k, k)]
    out = FlashAttentionFn.apply(*leaves, 7, True, None, None, 512)
    grads = torch.autograd.grad(out, leaves, torch.empty_like(out))
    assert [(g.device.type, g.shape, g.dtype) for g in grads] == [
        ("meta", t.shape, t.dtype) for t in (q, k, k)]
    key = (56, 2048, 2048, 64, 7, True, None, torch.bfloat16)
    assert fa_kernel.BWD_META_CALLS == {key: 1}
    pairs = 2048 * 2049 // 2
    assert fa_kernel.bwd_charge(key) == (
        10 * 64 * 56 * pairs, (3 * 56 + 4 * 8) * 2048 * 64 * 2)
    assert fa_kernel.bwd_charge(key) == (75_198_627_840, 52_428_800)
    assert (fa_kernel.BWD_LAUNCHES, fa_kernel.LAUNCHES) == launches
    with pytest.raises(ValueError, match="do must be"):
        flash_attention_bwd(q, k, k, q[:, :100], q_per_kv=7)
    with pytest.raises(ValueError, match="KV rows"):
        flash_attention_bwd(q, k, k, q, q_per_kv=6)
    fa_kernel.BWD_META_CALLS.clear()
