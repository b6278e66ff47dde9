"""selectk: every ported function vs ``repro.core.selectk`` on the same
numpy inputs, including the int32.min quota sentinel and tie-heavy keys.

Tolerance: exact — selections, ranks, thresholds and prefix sums are
integers; the port's indices are int64 where the reference's are int32, so
values are compared, not dtypes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402
_torch_threads.limit()
import jax.numpy as jnp  # noqa: E402

from repro.core import selectk as jsel  # noqa: E402
from repro.kernels.dispatch import PallasBackend  # noqa: E402
from repro_torch.core import selectk as tsel  # noqa: E402

INT32_MIN = np.iinfo(np.int32).min
JAX_BACKEND = PallasBackend(interpret=True, select_tile_n=256)


def _rows(rng, b, n):
    key = rng.integers(0, 6, size=(b, n)).astype(np.int32)    # tie-heavy
    key[0, ::3] = INT32_MIN                                    # sentinel
    if b > 1:
        key[1] = rng.integers(-2 ** 31, 2 ** 31 - 1, n,
                              dtype=np.int64).astype(np.int32)
    return key


def _eq(t, j):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


@pytest.mark.parametrize("n,k", [(131, 0), (131, 13), (131, 131),
                                 (997, 97), (512, 511)])
def test_select_top_k_and_masks(n, k):
    key = _rows(np.random.default_rng(n + k), 3, n)
    tv, ti, tm = tsel.select_top_k(torch.from_numpy(key), k,
                                   return_mask=True)
    jv, ji, jm = jsel.select_top_k(jnp.asarray(key), k, return_mask=True)
    _eq(tv, jv)
    _eq(ti, ji)
    _eq(tm, jm)
    # the reference's Pallas path (interpret mode) selects the same set
    _, ji2 = jsel.select_top_k(jnp.asarray(key), k, backend=JAX_BACKEND)
    _eq(ti, ji2)
    _eq(tsel.top_k_mask(torch.from_numpy(key), k),
        jsel.top_k_mask(jnp.asarray(key), k))


def test_bottom_k_mask_with_per_row_counts():
    rng = np.random.default_rng(3)
    key = _rows(rng, 4, 200)
    counts = np.array([0, 5, 200, 77], np.int32)
    _eq(tsel.bottom_k_mask(torch.from_numpy(key), torch.from_numpy(counts)),
        jsel.bottom_k_mask(jnp.asarray(key), jnp.asarray(counts)))
    # static count and clipping past n
    _eq(tsel.bottom_k_mask(torch.from_numpy(key), 250),
        jsel.bottom_k_mask(jnp.asarray(key), 250))


def test_kth_largest_prefix_sum_and_compact():
    rng = np.random.default_rng(4)
    key = _rows(rng, 2, 301)
    u_t = tsel._to_u(torch.from_numpy(key))
    u_j = jsel._to_u(jnp.asarray(key))
    _eq(u_t, np.asarray(u_j).astype(np.int64))
    for k in (0, 1, 150, 301):
        _eq(tsel._kth_largest(u_t, k),
            np.asarray(jsel._kth_largest(u_j, k)).astype(np.int64))
    mask = rng.random((2, 301)) < 0.3
    ps_t = tsel.prefix_sum(torch.from_numpy(mask))
    assert ps_t.dtype == torch.int32
    _eq(ps_t, jsel.prefix_sum(jnp.asarray(mask)))
    _eq(tsel.compact(ps_t, 120), jsel.compact(jsel.prefix_sum(
        jnp.asarray(mask)), 120))


def test_segment_top_k_mask_both_paths():
    rng = np.random.default_rng(5)
    key = _rows(rng, 3, 400)
    bounds, caps = (0, 97, 250, 400), (0, 153, 40)
    want = jsel.segment_top_k_mask(jnp.asarray(key), bounds, caps)
    _eq(tsel.segment_top_k_mask(torch.from_numpy(key), bounds, caps), want)
    _eq(want, jsel.segment_top_k_mask(jnp.asarray(key), bounds, caps,
                                      backend=JAX_BACKEND))


@pytest.mark.parametrize("n,n_pos", [(1, 1), (97, 0), (500, 37), (500, 500)])
def test_stable_rank_sparse(n, n_pos):
    rng = np.random.default_rng(n + n_pos)
    x = np.zeros(n, np.int32)
    x[rng.choice(n, n_pos, replace=False)] = rng.integers(1, 4, n_pos)
    bound = max(n_pos, 1)
    got = tsel.stable_rank_sparse(torch.from_numpy(x), bound)
    assert got.dtype == torch.int32
    _eq(got, jsel.stable_rank_sparse(jnp.asarray(x), bound))
    _eq(got, np.argsort(np.argsort(x, kind="stable"), kind="stable"))


def test_sortable_key_bits_and_contract():
    x = np.array([0.0, 1.5, 3.25e-8, 7e5, -1.0, -1.0], np.float32)
    _eq(tsel.sortable_key(torch.from_numpy(x)),
        jsel.sortable_key(jnp.asarray(x)))
    with pytest.raises(ValueError, match="shared"):
        tsel.sortable_key(torch.tensor([-1.0, -2.0, 3.0]))
