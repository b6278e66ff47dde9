"""The mmap-bench scenario (the paper's §III.A region as an online
workload): the port's ``MmapBenchScenario`` against the reference's — its
stream, its identity hint layout and its six-lane online run.

Tolerance: exact.  The stream is the same numpy draw, the hint ranks the
same float32 arithmetic, and the trajectories are compared as JSON text,
byte for byte (their floats come from the same float64 host arithmetic
over the same integer counts)."""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.scenarios import MmapBenchScenario as JMmap  # noqa: E402
from repro.scenarios import build_hints as jbuild_hints  # noqa: E402
from repro.scenarios import run_scenario as jrun  # noqa: E402
from repro_torch.core import runtime as trt  # noqa: E402
from repro_torch.scenarios import MmapBenchScenario as TMmap  # noqa: E402
from repro_torch.scenarios import build_hints as tbuild_hints  # noqa: E402
from repro_torch.scenarios import run_scenario as trun  # noqa: E402

SMALL_KW = dict(n_epochs=4, batches_per_epoch=2, accesses_per_batch=8_000)


def test_mmap_scenario_protocol_and_stream():
    sc, ref = TMmap(**SMALL_KW), JMmap(**SMALL_KW)
    assert sc.n_blocks == sc.spec.n_pages == ref.n_blocks
    assert sc.k_hot == sc.spec.k_hot == ref.k_hot
    for attr in ("bytes_per_access", "block_bytes", "nb_scan_rate",
                 "pebs_period", "shift_at"):
        assert getattr(sc, attr) == getattr(ref, attr), attr
    eps1, eps2 = list(sc.epochs()), list(sc.epochs())
    assert len(eps1) == sc.n_epochs
    for a, b, r in zip(eps1, eps2, ref.epochs()):
        np.testing.assert_array_equal(a, b)          # deterministic per call
        np.testing.assert_array_equal(a, r)          # the reference's stream
        assert a.dtype == r.dtype
    for ep in eps1:
        assert ep.shape == (sc.batches_per_epoch, sc.accesses_per_batch)
        assert 0 <= ep.min() and ep.max() < sc.n_blocks
    # the 90/10 region split: hot pages dominate the stream
    hist = np.bincount(np.concatenate([e.ravel() for e in eps1]),
                       minlength=sc.n_blocks)
    hot_share = hist[: sc.spec.k_hot].sum() / hist.sum()
    assert 0.85 < hot_share < 0.95


def test_mmap_scenario_static_hints_mark_the_declared_arena():
    sc = TMmap(**SMALL_KW)
    assert sc.hint_layout().rank_to_page is not None
    rank = tbuild_hints(sc, clip_rank=sc.spec.k_hot)._static_rank
    assert (rank[: sc.spec.k_hot] == 1.0).all()      # flat within-arena prior
    assert (rank[sc.spec.k_hot:] == 0.0).all()
    want = jbuild_hints(JMmap(**SMALL_KW))._static_rank
    np.testing.assert_array_equal(tbuild_hints(sc)._static_rank, want)


@pytest.mark.parametrize("hints", [False, True])
@pytest.mark.parametrize("sync_every", [1, 3])
def test_mmap_scenario_online_run_byte_identical(hints, sync_every):
    """§III.A on the six-lane loop: byte-identical to the reference, one
    observe_all and one epoch step an epoch, ceil(n / K) record pulls, and
    the oracle lane converges onto the hot region."""
    ref = jrun(JMmap(**SMALL_KW), hints=hints, sync_every=sync_every)
    with trt.counting() as c:
        got = trun(TMmap(**SMALL_KW), hints=hints, sync_every=sync_every,
                   device="cpu")
    assert json.dumps(got, sort_keys=True) == json.dumps(ref, sort_keys=True)
    n = SMALL_KW["n_epochs"]
    assert c.dispatch["observe_all"] == c.dispatch["epoch_step"] == n
    assert c.dispatch["record_sync"] == math.ceil(n / sync_every)
    assert got["summary"]["hmu_oracle"]["final_coverage"] > 0.9
