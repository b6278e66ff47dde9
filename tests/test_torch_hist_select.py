"""hist_select: the port's plain version (what a CPU tensor runs) vs the
reference's Pallas kernel in interpret mode.

The port takes the int32 selection keys and returns int64 thresholds in the
order-preserving unsigned image ``u = key + 2**31``; the reference takes
that image as uint32.  Tolerance: exact — a threshold is an integer."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.hist_select import kth_key_u  # noqa: E402
from repro_torch.kernels.hist_select import kth_key  # noqa: E402


def _keys(rng, b, n, ties=True):
    key = rng.integers(-2 ** 31, 2 ** 31 - 1, size=(b, n),
                       dtype=np.int64).astype(np.int32)
    if ties and n >= 8:
        key[:, : n // 4] = key[:, :1]             # long duplicate run
        key[:, n // 4: n // 3] = -2 ** 31         # the int32.min sentinel
    return key


def _u(key):
    return jnp.asarray(key.view(np.uint32) ^ np.uint32(0x80000000))


def _jax(key, seg, ks):
    out = kth_key_u(_u(key), jnp.asarray(seg), tuple(ks), tile_n=128,
                    use_pallas=True, interpret=True)
    return np.asarray(out).astype(np.int64)


@pytest.mark.parametrize("n", [50, 131, 997])      # 131, 997: prime
def test_one_segment_matches_reference_kernel(n):
    rng = np.random.default_rng(n)
    key = _keys(rng, 3, n)
    seg = np.zeros(n, np.int32)
    for k in sorted({0, 1, 7, n // 2, n}):
        got = kth_key(torch.from_numpy(key), None, (k,)).numpy()
        np.testing.assert_array_equal(got, _jax(key, seg, (k,)),
                                      err_msg=f"k={k}")
        got_seg = kth_key(torch.from_numpy(key), torch.from_numpy(seg),
                          (k,)).numpy()
        np.testing.assert_array_equal(got_seg, got)


def test_segments_with_zero_and_full_caps_and_padding():
    rng = np.random.default_rng(7)
    n = 613
    key = _keys(rng, 2, n)
    bounds = (0, 101, 400, 600)
    seg = np.full(n, -1, np.int32)                 # tail: padding (-1)
    for s, (a, b) in enumerate(zip(bounds, bounds[1:])):
        seg[a:b] = s
    ks = (0, 299, 17)                              # 0, full segment, middle
    got = kth_key(torch.from_numpy(key), torch.from_numpy(seg), ks).numpy()
    np.testing.assert_array_equal(got, _jax(key, seg, ks))
    assert (got[:, 0] == 0xFFFFFFFF).all()


def test_all_equal_keys():
    key = np.full((2, 300), 5, np.int32)
    for k in (1, 150, 300):
        got = kth_key(torch.from_numpy(key), None, (k,)).numpy()
        np.testing.assert_array_equal(
            got, _jax(key, np.zeros(300, np.int32), (k,)))
        assert (got == 5 + 2 ** 31).all()
