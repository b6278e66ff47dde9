"""Kernel-vs-plain checks that need the card (marked ``cuda``; they skip on
a machine without a CUDA device).  This file imports no JAX, so it also runs
where only PyTorch is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: exact — both kernels compute integers, and int32 atomics give
the same counts in any order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.dispatch import KernelBackend  # noqa: E402
from repro_torch.kernels.hist_select import kernel as hs_kernel  # noqa: E402
from repro_torch.kernels.hist_select import kth_key  # noqa: E402
from repro_torch.kernels.observe_scatter import kernel as os_kernel  # noqa: E402
from repro_torch.kernels.observe_scatter import observe_scatter  # noqa: E402
from repro_torch.scenarios import DLRMScenario, run_scenario  # noqa: E402

PLAIN = KernelBackend(plain=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_blocks,m", [(97, 1_000), (5_000, 30_001),
                                        (100_003, 50_000)])
def test_observe_scatter_kernel_matches_plain(cuda, n_blocks, m):
    rng = np.random.default_rng(m)
    ids = torch.from_numpy(rng.integers(-n_blocks - 2, n_blocks + 3, m)
                           .astype(np.int32)).to(cuda)
    keep = torch.from_numpy(rng.random(m) < 0.5).to(cuda)
    cursor = torch.tensor(17, dtype=torch.int32, device=cuda)
    before = os_kernel.LAUNCHES
    for km in (None, keep):
        got = observe_scatter(ids, cursor, n_blocks=n_blocks, period=13,
                              keep=km)
        ref = observe_scatter(ids, cursor, n_blocks=n_blocks, period=13,
                              keep=km, backend=PLAIN)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    assert os_kernel.LAUNCHES == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 131, 70_001])
def test_hist_select_kernel_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    keys = rng.integers(-3, 4, (4, n)).astype(np.int32)
    keys[1] = rng.integers(-2 ** 31, 2 ** 31 - 1, n, dtype=np.int64)
    keys_t = torch.from_numpy(keys).to(cuda)
    seg = torch.from_numpy(np.minimum(np.arange(n) * 3 // max(n, 1), 2)
                           .astype(np.int32)).to(cuda)
    lens = torch.bincount(seg.cpu().to(torch.int64), minlength=3).tolist()
    before = hs_kernel.LAUNCHES
    for sg, ks in ((None, (0,)), (None, (1,)), (None, (n,)),
                   (seg, (0, lens[1], lens[2] // 2))):
        assert torch.equal(kth_key(keys_t, sg, ks),
                           kth_key(keys_t, sg, ks, backend=PLAIN))
    assert hs_kernel.LAUNCHES == before + 4


@pytest.mark.cuda
def test_small_run_identical_on_gpu_and_cpu(cuda):
    scen = dict(n_epochs=3, batches_per_epoch=2, shift_at=1)
    a = run_scenario(DLRMScenario(**scen), hints=True, sync_every=2)
    b = run_scenario(DLRMScenario(**scen), hints=True, sync_every=2,
                     device="cpu")
    assert a == b
