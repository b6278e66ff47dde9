"""embedding_bag: the port's plain version (what a CPU tensor runs) vs the
reference's Pallas kernel in interpret mode and its jnp oracle, on
``tests/test_kernels.py``'s parameter grids.

Tolerance: pooled outputs within 1e-5 (float32) and 2e-2 (bfloat16),
relative and absolute, as ``tests/test_kernels.py`` holds the reference's
kernel to its oracle: both sum L products in float32, in orders that may
differ in the last bits, and bfloat16 rounds the sum once more.  The
counters are integers and exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.embedding_bag import (embedding_bag as jax_bag,  # noqa: E402
                                         embedding_bag_ref as jax_ref)
from repro_torch.kernels.embedding_bag import embedding_bag  # noqa: E402
from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def both(storage, idx, counts, w, block_rows, dtype="float32"):
    jd, td, tol = DTYPES[dtype]
    j_args = (jnp.asarray(storage, jd), jnp.asarray(idx, jnp.int32),
              jnp.asarray(counts, jnp.int32))
    jw = None if w is None else jnp.asarray(w, jnp.float32)
    j_out, j_counts = jax_bag(*j_args, jw, block_rows=block_rows,
                              use_pallas=True, interpret=True)
    r_out, _ = jax_ref(j_args[0], j_args[1],
                       jnp.ones(idx.shape, jnp.float32) if w is None else jw,
                       j_args[2], block_rows=block_rows)
    t_out, t_counts = embedding_bag(
        torch.from_numpy(storage).to(td), torch.from_numpy(idx),
        torch.from_numpy(counts),
        None if w is None else torch.from_numpy(w), block_rows=block_rows)
    assert t_out.dtype == td and t_counts.dtype == torch.int32
    for ref in (j_out, r_out):
        np.testing.assert_allclose(t_out.to(torch.float32).numpy(),
                                   np.asarray(ref, np.float32),
                                   rtol=tol, atol=tol)
    np.testing.assert_array_equal(t_counts.numpy(), np.asarray(j_counts))
    return t_out, t_counts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,n,d,block_rows", [
    (4, 8, 256, 128, 8),
    (8, 16, 512, 256, 16),
    (2, 4, 128, 512, 4),
])
def test_plain_version_matches_reference_kernel(b, l, n, d, block_rows, dtype):
    rng = np.random.default_rng(1)
    storage = rng.normal(size=(n, d)).astype(np.float32)
    idx = rng.integers(0, n, (b, l)).astype(np.int32)
    w = rng.uniform(0.5, 1.5, (b, l)).astype(np.float32)
    both(storage, idx, np.zeros(n // block_rows, np.int32), w, block_rows,
         dtype)


def test_ragged_bag_grid_with_carry_in():
    """B=3, L=5: no round shapes anywhere; counters start non-zero."""
    rng = np.random.default_rng(8)
    storage = rng.normal(size=(128, 128)).astype(np.float32)
    idx = rng.integers(0, 128, (3, 5)).astype(np.int32)
    w = rng.uniform(0.5, 1.5, (3, 5)).astype(np.float32)
    _, c = both(storage, idx, np.full(16, 2, np.int32), w, 8)
    assert int(c.sum()) == 16 * 2 + 15


def test_unweighted_defaults_to_sum():
    storage = np.eye(16, 128, dtype=np.float32)
    idx = np.asarray([[0, 1, 2, 3]], np.int32)
    out, _ = both(storage, idx, np.zeros(4, np.int32), None, 4)
    expect = np.zeros((1, 128), np.float32)
    expect[0, :4] = 1.0
    np.testing.assert_array_equal(out.numpy(), expect)


def test_cuda_wrapper_refuses_cpu_tensors():
    idx = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        embedding_bag_cuda(torch.zeros(8, 4), idx, torch.ones(1, 2),
                           torch.zeros(2, dtype=torch.int32), block_rows=4)
