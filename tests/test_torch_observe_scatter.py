"""observe_scatter: the port's plain version (what a CPU tensor runs) vs the
reference's Pallas kernel in interpret mode and its jnp oracle.

Tolerance: exact.  Both compute integer histograms of the same id stream;
any difference is a semantic bug (id wrap/drop, sampler phase, keep mask),
never rounding."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.observe_scatter import (observe_scatter as jax_scatter,  # noqa: E402
                                           observe_scatter_ref as jax_ref)
from repro_torch.kernels.observe_scatter import (observe_scatter,  # noqa: E402
                                                 observe_scatter_ref)


@pytest.mark.parametrize("m,n_blocks,period,cursor", [
    (512, 100, 37, 0),
    (1000, 997, 7, 11),        # ragged M, cursor mid-phase
    (37, 50, 1, 3),            # period 1: every position sampled
    (300, 64, 10007, 10006),   # period > M, cursor wraps mid-batch
    (700, 64, 10007, 5),       # period > M, no sample in the batch
])
def test_plain_version_matches_reference_kernel_and_ref(m, n_blocks, period,
                                                        cursor):
    rng = np.random.default_rng(m + n_blocks)
    # ids straddle the valid range on both sides: negatives wrap once,
    # >= n_blocks drops, and -n_blocks - 1 stays out of range after the wrap
    ids = rng.integers(-n_blocks - 2, n_blocks + 3, size=m).astype(np.int32)
    keep = rng.random(m) < 0.6
    for km in (None, keep):
        j_kernel = jax_scatter(
            jnp.asarray(ids), jnp.asarray(cursor, jnp.int32),
            n_blocks=n_blocks, period=period,
            keep=None if km is None else jnp.asarray(km), tile_m=256,
            use_pallas=True, interpret=True)
        j_ref = jax_ref(jnp.asarray(ids), jnp.asarray(cursor, jnp.int32),
                        n_blocks=n_blocks, period=period,
                        keep=None if km is None else jnp.asarray(km))
        got = observe_scatter(
            torch.from_numpy(ids), torch.tensor(cursor, dtype=torch.int32),
            n_blocks=n_blocks, period=period,
            keep=None if km is None else torch.from_numpy(km))
        for g, jk, jr in zip(got, j_kernel, j_ref):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(jk))
            np.testing.assert_array_equal(g.numpy(), np.asarray(jr))


def test_empty_batch_gives_zero_histograms():
    hist, pebs = observe_scatter_ref(torch.zeros(0, dtype=torch.int32),
                                     torch.tensor(4, dtype=torch.int32),
                                     n_blocks=9, period=5)
    assert hist.shape == pebs.shape == (9,)
    assert int(hist.sum()) == int(pebs.sum()) == 0


def test_large_paper_like_block_count_without_max_blocks():
    """The reference falls back to XLA past 2**20 blocks (a VMEM limit);
    the port has no such bound — its plain version and kernel take any
    n_blocks, and still agree with the reference's oracle."""
    n_blocks, m = (1 << 20) + 17, 4_096
    rng = np.random.default_rng(5)
    ids = rng.integers(-5, n_blocks + 5, size=m).astype(np.int32)
    got = observe_scatter(torch.from_numpy(ids),
                          torch.tensor(9, dtype=torch.int32),
                          n_blocks=n_blocks, period=101)
    ref = jax_ref(jnp.asarray(ids), jnp.asarray(9, jnp.int32),
                  n_blocks=n_blocks, period=101)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
