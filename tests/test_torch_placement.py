"""policy + placement: the port's helpers vs ``repro.core.policy`` and
``repro.core.placement`` on lane-stacked states driven through several
promote/evict rounds.

Tolerance: exact for the integer maps and counts; the float32 blends
(``hinted_score``, the EWMA) are held bit for bit to the reference's fused
(jit) arithmetic."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import placement as jpl  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro_torch.core import placement as tpl  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402


def _eq(t, j):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


def _want(rng, lanes, k, n):
    want = np.full((lanes, k), -1, np.int32)
    for i in range(lanes):
        m = rng.integers(0, k + 1)
        want[i, :m] = rng.choice(n, m, replace=False)
    return want


@pytest.mark.parametrize("lanes,n,k", [(3, 60, 8), (6, 257, 31)])
def test_apply_plan_and_demote_idle_rounds(lanes, n, k):
    rng = np.random.default_rng(n)
    jp = jpl.Placement.create(n, k, lanes=lanes)
    tp = tpl.Placement.create(n, k, lanes=lanes)
    for _ in range(6):
        est = rng.integers(0, 4, size=(lanes, n)).astype(np.float32)
        enable = rng.random((lanes, 1)) < 0.5
        jp, jd = jpl.demote_idle(jp, jnp.asarray(est), jnp.asarray(enable))
        tp, td = tpl.demote_idle(tp, torch.from_numpy(est),
                                 torch.from_numpy(enable))
        _eq(td, jd)
        want = _want(rng, lanes, k, n)
        jp, jprom, jdem = jpl.apply_plan(jp, jnp.asarray(want),
                                         jnp.asarray(est))
        tp, tprom, tdem = tpl.apply_plan(tp, torch.from_numpy(want),
                                         torch.from_numpy(est))
        _eq(tprom, jprom)
        _eq(tdem, jdem)
        _eq(tp.slot_to_block, jp.slot_to_block)
        _eq(tp.block_to_slot, jp.block_to_slot)
        _eq(tp.resident(), jp.resident())


def test_plan_eviction_and_coldest_victims():
    rng = np.random.default_rng(1)
    n, k = 50, 12
    s2b = np.full(k, -1, np.int32)
    s2b[:9] = rng.choice(n, 9, replace=False)
    est = rng.integers(0, 3, n).astype(np.float32)
    want = np.array([s2b[0], s2b[3], -1, 7], np.int32)
    for need in (0, 1, 4, 12):
        _eq(tpol.plan_eviction(torch.from_numpy(est), torch.from_numpy(want),
                               torch.from_numpy(s2b), need),
            jpol.plan_eviction(jnp.asarray(est), jnp.asarray(want),
                               jnp.asarray(s2b), need))
    _eq(tpol.coldest_victims(torch.from_numpy(est), torch.from_numpy(s2b), 5),
        jpol.coldest_victims(jnp.asarray(est), jnp.asarray(s2b), 5))


def test_cold_streak():
    rng = np.random.default_rng(2)
    streak = rng.integers(0, 3, (2, 30)).astype(np.int32)
    est = rng.integers(0, 2, (2, 30)).astype(np.int32)
    fast = rng.random((2, 30)) < 0.5
    _eq(tpol.cold_streak(torch.from_numpy(streak), torch.from_numpy(est),
                         torch.from_numpy(fast)),
        jpol.cold_streak(jnp.asarray(streak), jnp.asarray(est),
                         jnp.asarray(fast)))


@pytest.mark.parametrize("n,weight", [(4_999, 0.25), (1, 0.25), (777, 0.4),
                                      (300_001, 0.1)])
def test_hinted_score_bits_match_the_fused_reference(n, weight):
    """Inside the reference's jit'd epoch step XLA folds ``/ (n - 1)`` into
    a constant and contracts the first product into an FMA; the port
    reproduces that, bit for bit (eager JAX rounds differently)."""
    rng = np.random.default_rng(n)
    est = np.where(rng.random(n) < 0.3, rng.integers(1, 9, n), 0).astype(
        np.int32)
    t_rank = rng.permutation(n).astype(np.int32)
    hint = np.where(rng.random(n) < 0.2, rng.random(n), 0).astype(np.float32)
    got = tpol.hinted_score(torch.from_numpy(est), torch.from_numpy(t_rank),
                            torch.from_numpy(hint), weight)
    want = jax.jit(jpol.hinted_score, static_argnums=3)(
        jnp.asarray(est), jnp.asarray(t_rank), jnp.asarray(hint), weight)
    assert got.dtype == torch.float32
    _eq(got.numpy().view(np.int32), np.asarray(want).view(np.int32))


@pytest.mark.parametrize("alpha", [0.5, 0.3, 0.77])
def test_ewma_bits_match_the_fused_reference(alpha):
    rng = np.random.default_rng(int(alpha * 100))
    x = rng.integers(0, 60, 200_000).astype(np.float32)
    prev = (rng.random(200_000) * 40).astype(np.float32)
    want = jax.jit(lambda a, b: alpha * a + (1.0 - alpha) * b)(
        jnp.asarray(x), jnp.asarray(prev))
    got = tpol.ewma(alpha, torch.from_numpy(x), torch.from_numpy(prev))
    _eq(got.numpy().view(np.int32), np.asarray(want).view(np.int32))


def test_fma_f32_rounds_once():
    """Cases where two roundings differ from one: a tie in float32 that
    only the float64 error breaks, and a product that is not exact in
    float32."""
    a = torch.tensor([1.0 + 2.0 ** -12, 3.0, 1.0 + 2.0 ** -23],
                     dtype=torch.float32)
    b = torch.tensor([1.0 + 2.0 ** -12, 1.0 / 3.0, 1.0 - 2.0 ** -23],
                     dtype=torch.float32)
    c = torch.tensor([2.0 ** -60, -1.0, -1.0], dtype=torch.float32)
    got = tpol.fma_f32(a, b, c)
    exact = [float(np.float32(np.longdouble(x) * np.longdouble(y)
                              + np.longdouble(z)))
             for x, y, z in zip(a.numpy(), b.numpy(), c.numpy())]
    assert got.tolist() == exact
