"""flash_attention's plain version (what the port runs on the CPU, and what
the CUDA kernel is held against on the card) vs the reference: the Pallas
kernel in interpret mode on ``tests/test_kernels.py``'s shapes, the
reference oracle at GQA 7:1 with ragged lengths, and ``flash_train`` (both
of the reference's schedules) through the port's ``flash_train``.

Tolerance: the JAX tests' own — 2e-5 (float32) and 3e-2 (bfloat16),
relative and absolute.  Both sides compute f32 scores and an f32 softmax;
the Pallas kernel sums its online softmax block by block, the plain version
in one pass, so they differ in the last bits of f32, and bf16 outputs by
at most one rounding."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402
_torch_threads.limit()
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as j_ref  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro_torch.kernels.dispatch import KernelBackend  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref, flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _qkv(seed, bh, kvh, sq, sk, d, dtype):
    """The same inputs for both sides: numpy draws, rounded once to dtype."""
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=shape) * 0.3 for shape in
            ((bh, sq, d), (kvh, sk, d), (kvh, sk, d))]
    j = [jnp.asarray(a, jdt) for a in arrs]
    t = [torch.from_numpy(np.array(x, np.float32)).to(tdt) for x in j]
    return j, t


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bh,kvh,s,d", [
    (4, 4, 256, 128),      # MHA
    (8, 2, 256, 128),      # GQA 4:1
    (2, 1, 512, 256),      # MQA
])
def test_plain_matches_pallas_causal(bh, kvh, s, d, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(2, bh, kvh, s, s, d, dtype)
    want = flash_attention_pallas(jq, jk, jv, q_per_kv=bh // kvh,
                                  causal=True, interpret=True)
    got = flash_attention(q, k, v, q_per_kv=bh // kvh, causal=True)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("causal,window,s", [(True, 128, 512),
                                             (False, None, 256)],
                         ids=["sliding_window", "noncausal"])
def test_plain_matches_pallas_window_and_noncausal(causal, window, s):
    (jq, jk, jv), (q, k, v) = _qkv(3, 2, 2, s, s, 128, "float32")
    want = flash_attention_pallas(jq, jk, jv, q_per_kv=1, causal=causal,
                                  window=window, interpret=True)
    got = flash_attention(q, k, v, q_per_kv=1, causal=causal, window=window)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("sq,sk,causal,window", [
    (1, 1, True, None), (19, 19, True, None), (100, 100, True, 7),
    (19, 33, False, None), (33, 19, True, None), (40, 10, True, 3),
])
def test_plain_matches_oracle_gqa_7_to_1_ragged(sq, sk, causal, window,
                                                dtype):
    """qwen2-0.5b's 14 query heads over 2 KV heads, lengths no tile divides;
    (40, 10, window 3) leaves rows 14.. with no valid key, which give 0."""
    (jq, jk, jv), (q, k, v) = _qkv(sq * 100 + sk, 14, 2, sq, sk, 64, dtype)
    want = j_ref(jq, jk, jv, q_per_kv=7, causal=causal, window=window)
    got = flash_attention(q, k, v, q_per_kv=7, causal=causal, window=window)
    _close(got, want, DTYPES[dtype][2])
    if (sq, sk, window) == (40, 10, 3):
        assert torch.all(got[:, 14:] == 0)


@pytest.mark.parametrize("schedule,block_k,s", [
    ("masked", 8, 32), ("masked", 512, 19), ("triangular", 8, 32),
    ("triangular", 512, 64)])
@pytest.mark.parametrize("window", [None, 5])
def test_flash_train_matches_reference(schedule, block_k, s, window):
    """The port's flash_train takes the reference's schedule and block_k
    and computes the same function whatever they are."""
    (jq, jk, jv), (q, k, v) = _qkv(s + block_k, 2 * 14, 2 * 2, s, s, 16,
                                   "float32")
    b = 2
    jq, jk, jv = (x.reshape(b, -1, s, 16) for x in (jq, jk, jv))
    q, k, v = (x.reshape(b, -1, s, 16) for x in (q, k, v))
    want = j_attn.flash_train(jq, jk, jv, causal=True, window=window,
                              block_k=block_k, causal_schedule=schedule)
    got = t_attn.flash_train(q, k, v, causal=True, window=window,
                             block_k=block_k, causal_schedule=schedule)
    assert got.shape == (b, 14, s, 16)
    _close(got, want, 2e-5)


def test_dispatch_runs_the_plain_version_on_the_cpu():
    _, (q, k, v) = _qkv(5, 4, 2, 9, 9, 32, "float32")
    before = fa_kernel.LAUNCHES
    a = flash_attention(q, k, v, q_per_kv=2)
    b = flash_attention(q, k, v, q_per_kv=2, backend=KernelBackend(plain=True))
    c = attention_ref(q, k, v, q_per_kv=2)
    assert torch.equal(a, c) and torch.equal(b, c)
    assert fa_kernel.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention_cuda(q, k, v, q_per_kv=2)
