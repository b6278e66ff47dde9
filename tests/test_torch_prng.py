"""The port's Threefry draws (``repro_torch.faults.prng``) against
``jax.random``: keys, splits, 32-bit words, uniforms and Bernoulli draws.

The fault model draws through these, so a degraded trajectory can equal the
reference's byte for byte only if every word here equals JAX's.  The port
computes partitionable Threefry-2x32, which is JAX's generator while
``jax_threefry_partitionable`` is on (its default since jax 0.5); a test
pins that flag, so a change of JAX's default fails here loudly rather than
as a trajectory mismatch elsewhere.

Tolerance: exact.  Words compare as integers and floats by their bits."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402
_torch_threads.limit()
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.faults import prng  # noqa: E402

SEEDS = [0, 7, 2 ** 31 - 1]
SHAPES = [(), (3,), (40_000,), (2, 5)]


def words(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def test_jax_threefry_is_partitionable():
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS + [-1, 2 ** 32 + 5])
def test_prng_key_equals_jax(seed):
    np.testing.assert_array_equal(prng.prng_key(seed).numpy(),
                                  words(jax.random.PRNGKey(seed)))


def test_prng_key_rejects_what_no_c_long_holds():
    with pytest.raises(OverflowError):
        prng.prng_key(2 ** 63)


def test_threefry2x32_known_answers():
    """The Random123 known-answer vectors of Threefry-2x32 with 20 rounds
    (zeros, all ones, and the digits of pi), independent of JAX."""
    cases = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
             ((0xFFFFFFFF,) * 2, (0xFFFFFFFF,) * 2, (0x1CB996FC, 0xBB002BE7)),
             ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
              (0xC4923A9C, 0x483DF7A0))]
    for (k1, k2), (x0, x1), want in cases:
        got = prng.threefry2x32(*(torch.tensor(v, dtype=torch.int64)
                                  for v in (k1, k2, x0, x1)))
        assert tuple(int(w) for w in got) == want


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 1000])
def test_split_equals_jax(seed, num):
    got = prng.split(prng.prng_key(seed), num)
    assert got.shape == (num, 2)
    np.testing.assert_array_equal(
        got.numpy(), words(jax.random.split(jax.random.PRNGKey(seed), num)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_random_bits_equal_jax(seed, shape):
    want = jax.random.bits(jax.random.PRNGKey(seed), shape, jnp.uint32)
    got = prng.random_bits(prng.prng_key(seed), shape)
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), words(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform_equals_jax(seed, shape):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape))
    got = prng.uniform(prng.prng_key(seed), shape).numpy()
    assert got.dtype == want.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (got >= 0.0).all() and (got < 1.0).all()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bernoulli_equals_jax(seed, shape):
    key = jax.random.PRNGKey(seed)
    for p in (0.0, 0.3, 0.999, 1.0):
        want = np.asarray(jax.random.bernoulli(key, p, shape))
        got = prng.bernoulli(prng.prng_key(seed), p, shape).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_bernoulli_on_a_scalar_rate_tensor_equals_jax(seed):
    """The NB stall draw: ``bernoulli(key, p)`` with a () float32 rate and
    no shape takes the rate's shape."""
    for p in (0.05, 0.5, 0.95):
        want = bool(jax.random.bernoulli(jax.random.PRNGKey(seed),
                                         jnp.float32(p)))
        got = prng.bernoulli(prng.prng_key(seed),
                             torch.tensor(p, dtype=torch.float32))
        assert got.shape == () and bool(got) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_the_fault_models_draw_sequence_equals_jax(seed):
    """The reference's draws in the order its observe path makes them:
    an epoch's reset draw, then per batch a three-way split, a per-event
    keep mask against per-block rates, and a stall bit."""
    rng = np.random.default_rng(seed % 1000)
    drop_p = rng.random(50).astype(np.float32)
    ids = rng.integers(0, 50, 4_000).astype(np.int32)
    reset_p = np.float32([0.3, 0.6, 0.9])
    jkey, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed)

    jkey, kr = jax.random.split(jkey)
    tk = prng.split(tkey)
    tkey = tk[0]
    np.testing.assert_array_equal(
        prng.uniform(tk[1], (3,)).numpy() < reset_p,
        np.asarray(jax.random.uniform(kr, (3,)) < reset_p))
    for _ in range(3):
        jkey, k_drop, k_stall = jax.random.split(jkey, 3)
        tk = prng.split(tkey, 3)
        tkey = tk[0]
        want = np.asarray(jax.random.uniform(k_drop, ids.shape)
                          >= jnp.asarray(drop_p)[ids])
        got = (prng.uniform(tk[1], ids.shape)
               >= torch.from_numpy(drop_p)[torch.from_numpy(ids).long()])
        np.testing.assert_array_equal(got.numpy(), want)
        assert bool(prng.bernoulli(tk[2], torch.tensor(0.4))) == bool(
            jax.random.bernoulli(k_stall, jnp.float32(0.4)))
    np.testing.assert_array_equal(tkey.numpy(), words(jkey))
