"""gather_count: the port's plain version (what a CPU tensor runs) vs the
reference's Pallas kernel in interpret mode, on ``tests/test_kernels.py``'s
parameter grids.

Tolerance: exact.  The rows are copies (bfloat16 values are compared as
float32, which holds them exactly) and the counters are integers.  The
port has no tile padding; the ragged cases hold it to the reference
wrapper's padded-and-corrected result."""
import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.gather_count import gather_count as jax_gather_count  # noqa: E402
from repro_torch.kernels.gather_count import (gather_count,  # noqa: E402
                                              gather_count_ref)
from repro_torch.kernels.gather_count.kernel import (copy_unit,  # noqa: E402
                                                     gather_count_cuda)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def both(storage, idx, counts, block_rows, dtype="float32", tile_m=128):
    jd, td = DTYPES[dtype]
    j_out, j_counts = jax_gather_count(
        jnp.asarray(storage, jd), jnp.asarray(idx, jnp.int32),
        jnp.asarray(counts, jnp.int32), block_rows=block_rows,
        use_pallas=True, interpret=True, tile_m=tile_m)
    t_out, t_counts = gather_count(
        torch.from_numpy(storage).to(td), torch.from_numpy(idx),
        torch.from_numpy(counts), block_rows=block_rows)
    assert t_out.dtype == td and t_counts.dtype == torch.int32
    np.testing.assert_array_equal(t_out.to(torch.float32).numpy(),
                                  np.asarray(j_out, np.float32))
    np.testing.assert_array_equal(t_counts.numpy(), np.asarray(j_counts))
    return t_out, t_counts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,m,block_rows", [
    (256, 128, 128, 8),
    (512, 256, 384, 16),
    (128, 512, 100, 4),     # M not a tile multiple
])
def test_plain_version_matches_reference_kernel(n, d, m, block_rows, dtype):
    rng = np.random.default_rng(0)
    storage = rng.normal(size=(n, d)).astype(np.float32)
    idx = rng.integers(0, n, m).astype(np.int32)
    counts = np.zeros(n // block_rows, np.int32)
    both(storage, idx, counts, block_rows, dtype)


@pytest.mark.parametrize("m", [1, 127, 129])
def test_ragged_m_with_carry_in(m):
    """Any M, and a non-zero carry-in: the reference pads to its tile and
    subtracts the phantom counts; the port has neither, same result."""
    rng = np.random.default_rng(7)
    storage = rng.normal(size=(64, 128)).astype(np.float32)
    idx = rng.integers(0, 64, m).astype(np.int32)
    out, _ = both(storage, idx, np.full(8, 5, np.int32), 8)
    assert out.shape == (m, 128)


def test_empty_batch_returns_the_carry_in():
    counts = torch.full((8,), 3, dtype=torch.int32)
    out, new = gather_count_ref(torch.zeros(64, 16),
                                torch.zeros(0, dtype=torch.int32), counts,
                                block_rows=8)
    assert out.shape == (0, 16)
    assert torch.equal(new, counts) and new is not counts


def test_accumulates_over_calls():
    storage = np.zeros((64, 128), np.float32)
    counts = np.zeros(8, np.int32)
    idx = np.asarray([0, 8, 8, 63], np.int32)
    for _ in range(3):
        _, c = both(storage, idx, counts, 8)
        counts = c.numpy()
    np.testing.assert_array_equal(counts, [3, 6, 0, 0, 0, 0, 0, 3])


@settings(max_examples=10, deadline=None)
@given(st.lists(st.integers(min_value=0, max_value=255), min_size=1,
                max_size=64))
def test_property_counts_equal_exact_histogram(idx_list):
    idx = np.asarray(idx_list, np.int32)
    _, c = both(np.zeros((256, 128), np.float32), idx, np.zeros(32, np.int32),
                8, dtype="bfloat16")
    np.testing.assert_array_equal(c.numpy(),
                                  np.bincount(idx // 8, minlength=32))


def test_copy_unit_picks_the_widest_aligned_width():
    assert copy_unit(1024, 0, 4096) == 16        # D=256 f32
    assert copy_unit(512, 0, 4096) == 16         # D=256 bf16
    assert copy_unit(40, 0, 4096) == 4           # D=10 f32: 16 ∤ 40
    assert copy_unit(1024, 0, 4100) == 4         # misaligned output
    assert copy_unit(6, 0, 4096) == 2            # D=3 bf16
    with pytest.raises(ValueError):
        copy_unit(3, 0, 0)


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        gather_count_cuda(torch.zeros(8, 4), torch.zeros(2, dtype=torch.int32),
                          torch.zeros(2, dtype=torch.int32), block_rows=4)
