"""Kernel-vs-plain checks that need the card (marked ``cuda``; they skip on
a machine without a CUDA device).  This file imports no JAX, so it also runs
where only PyTorch is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: exact for observe_scatter, hist_select and gather_count — they
compute integers or copy rows, and int32 atomics give the same counts in
any order.  embedding_bag's pooled rows: 1e-5 (float32) and 2e-2
(bfloat16), relative and absolute — the kernel and the plain version sum
the same float32 products in different orders; its counts are exact; and
its tiled route equals its per-bag route bit for bit (the same sums in
the same order).
flash_attention: an online softmax against a one-pass softmax, both in
float32.  float32 outputs: 2e-5, relative and absolute, the JAX kernel
tests' own.  bfloat16 outputs: both round once from float32, so they may
land one bfloat16 step apart (2**-7 of the value), plus 1e-3 of the largest
output for float32 noise near 0; and at most 1 % of them may differ at all,
since such straddles are rare and a rounding fault moves about half.  The
inputs make the softmax peaked (q scaled by 3, k and v by 1), so a wrong
max, scale, mask or KV tile moves the output by the size of v."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402
_torch_threads.limit()

from repro_torch.examples import dlrm_tiering  # noqa: E402
from repro_torch.kernels.dispatch import KernelBackend  # noqa: E402
from repro_torch.kernels.embedding_bag import embedding_bag  # noqa: E402
from repro_torch.kernels.embedding_bag import kernel as eb_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.gather_count import gather_count  # noqa: E402
from repro_torch.kernels.gather_count import kernel as gc_kernel  # noqa: E402
from repro_torch.kernels.hist_select import kernel as hs_kernel  # noqa: E402
from repro_torch.kernels.hist_select import kth_key  # noqa: E402
from repro_torch.kernels.observe_scatter import kernel as os_kernel  # noqa: E402
from repro_torch.kernels.observe_scatter import observe_scatter  # noqa: E402
from repro_torch.models.attention import flash_train  # noqa: E402
from repro_torch.scenarios import DLRMScenario, KVCacheScenario, run_scenario  # noqa: E402

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


def _observe_ids(kind, rng, n_blocks, m):
    if kind == "zipf_head":         # a quarter of the ids on one page
        ids = np.where(rng.random(m) < 0.25, 5,
                       (rng.zipf(1.31, m) - 1) % (n_blocks + 6) - 3)
    elif kind == "all_distinct":    # overflows every table
        ids = rng.permutation(n_blocks)[:m]
    elif kind == "hot_among_distinct":  # blocks stop claiming slots
        ids = np.where(rng.random(m) < 0.05, 7,
                       rng.permutation(n_blocks)[:m])
    else:
        ids = rng.integers(-n_blocks - 2, n_blocks + 3, m)
    return ids.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n_blocks,m,offset", [
    ("zipf_head", 5_242_880, 600_001, 0),
    ("all_distinct", 5_242_880, 600_000, 0),
    ("hot_among_distinct", 5_242_880, 600_001, 2),
    ("zipf_head", "limit", 100_003, 0),
    ("zipf_head", "limit + 1", 100_003, 0),
    ("uniform", "limit", 50_001, 1),
    ("zipf_head", 1_000_003, 200_002, 1),    # 4 bytes past the allocation
    ("zipf_head", 1_000_003, 200_003, 3)])
def test_observe_scatter_table_modes(cuda, kind, n_blocks, m, offset):
    """Each table mode exact against the plain version, with and without a
    keep mask (its words aligned with the ids' vectors or not), at cursor
    0 and at period - 1."""
    limit = os_kernel.shared_limit()
    if isinstance(n_blocks, str):
        n_blocks = limit + (n_blocks == "limit + 1")
    rng = np.random.default_rng(m + offset)
    ids = torch.from_numpy(_observe_ids(kind, rng, n_blocks, m + offset)
                           ).to(cuda)[offset:]
    keep_a = torch.from_numpy(rng.random(m + offset) < 0.6).to(cuda)[offset:]
    keep_b = torch.from_numpy(rng.random(m + 1) < 0.6).to(cuda)[1:]
    mode = os_kernel.table_mode(n_blocks)
    assert mode == ("direct" if n_blocks <= limit else "hashed")
    before = os_kernel.LAUNCHES, dict(os_kernel.MODE_LAUNCHES)
    calls = 0
    for cur in (0, 400):
        cursor = torch.tensor(cur, dtype=torch.int32, device=cuda)
        for km in (None, keep_a, keep_b):
            got = observe_scatter(ids, cursor, n_blocks=n_blocks, period=401,
                                  keep=km)
            calls += 1
            ref = observe_scatter(ids, cursor, n_blocks=n_blocks, period=401,
                                  keep=km, backend=PLAIN)
            for g, r in zip(got, ref):
                assert torch.equal(g, r), (cur, km is None)
    assert os_kernel.LAUNCHES == before[0] + calls
    assert os_kernel.MODE_LAUNCHES[mode] == before[1][mode] + calls


@pytest.mark.cuda
@pytest.mark.parametrize("n_global,world,rank,mode", [
    (50_000, 2, 1, "direct"),       # 25,000 bins: the direct table
    (5_242_880, 3, 2, "hashed"),    # the paper's pages, the last range
    (5_242_880, 2, 0, "hashed")])
def test_observe_scatter_block_range_matches_plain(cuda, n_global, world,
                                                   rank, mode):
    """A sharded rank's call (``lo``, ``n_global``) exact against its plain
    version and against the whole histogram cut to the range, on the table
    mode its range's length picks."""
    from repro_torch.core.shard import split
    lo, hi = split(n_global, world, rank)
    assert os_kernel.table_mode(hi - lo) == mode
    rng = np.random.default_rng(n_global + rank)
    ids = torch.from_numpy(_observe_ids("zipf_head", rng, n_global, 300_001)
                           ).to(cuda)
    keep = torch.from_numpy(rng.random(ids.numel()) < 0.6).to(cuda)
    cursor = torch.tensor(400, dtype=torch.int32, device=cuda)
    before = dict(os_kernel.MODE_LAUNCHES)
    for km in (None, keep):
        got = observe_scatter(ids, cursor, n_blocks=hi - lo, period=401,
                              keep=km, lo=lo, n_global=n_global)
        ref = observe_scatter(ids, cursor, n_blocks=hi - lo, period=401,
                              keep=km, lo=lo, n_global=n_global,
                              backend=PLAIN)
        whole = observe_scatter(ids, cursor, n_blocks=n_global, period=401,
                                keep=km, backend=PLAIN)
        for g, r, w in zip(got, ref, whole):
            assert torch.equal(g, r) and torch.equal(g, w[lo:hi])
    assert os_kernel.MODE_LAUNCHES[mode] == before[mode] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("n_blocks", [88, 5_000, "limit"])
def test_observe_scatter_mode_is_what_runs(cuda, n_blocks):
    """The table mode the wrapper passes is the one the kernel runs: the
    hashed table, asked for below the direct-map limit, is exact too; the
    direct table above the limit is refused and counts no launch."""
    limit = os_kernel.shared_limit()
    n_blocks = limit if n_blocks == "limit" else n_blocks
    rng = np.random.default_rng(n_blocks)
    ids = torch.from_numpy(_observe_ids("zipf_head", rng, n_blocks, 70_001)
                           ).to(cuda)
    keep = torch.from_numpy(rng.random(ids.numel()) < 0.6).to(cuda)
    cursor = torch.tensor(400, dtype=torch.int32, device=cuda)
    before = dict(os_kernel.MODE_LAUNCHES)
    for km in (None, keep):
        got = os_kernel._launch("hashed", ids, cursor, n_blocks=n_blocks,
                                period=401, keep=km)
        ref = observe_scatter(ids, cursor, n_blocks=n_blocks, period=401,
                              keep=km, backend=PLAIN)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    assert os_kernel.MODE_LAUNCHES == {**before,
                                       "hashed": before["hashed"] + 2}
    launches = os_kernel.LAUNCHES
    with pytest.raises(RuntimeError, match="launch failed"):
        os_kernel._launch("direct", ids, cursor, n_blocks=limit + 1,
                          period=401)
    assert os_kernel.LAUNCHES == launches


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


def _every_pass_keys(rng, shape):
    """Keys whose bytes come from {0, 1, 254, 255}: the search needs every
    pass (tests/test_torch_kernel_designs.py)."""
    b = rng.choice(np.asarray([0, 1, 254, 255], np.uint32), size=shape + (4,))
    u = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    return u.astype(np.uint32).view(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 5])
@pytest.mark.parametrize("n", [5, 6, 7, 100_001, 100_002, 100_003])
def test_hist_select_unaligned_rows_and_padding(cuda, rows, n):
    """n % 4 != 0: rows after the first start off a 16-byte boundary (a
    scalar head and tail); S=3 with padding; k = 0 and k = |segment|; rows
    that stop after one pass (one tie value) and rows that need every
    pass."""
    rng = np.random.default_rng(n + rows)
    keys = rng.integers(-5, 6, (rows, n)).astype(np.int32)
    keys[:, ::3] = rng.integers(-2 ** 31, 2 ** 31 - 1, keys[:, ::3].shape,
                                dtype=np.int64)
    ties = np.where(rng.random((rows, n)) < 0.02, 7, 0).astype(np.float32)
    hard = _every_pass_keys(rng, (rows, n))
    seg = np.minimum(np.arange(n) * 3 // n, 2).astype(np.int32)
    seg[1::7] = -1
    seg[-1] = -1
    lens = [int((seg == s).sum()) for s in range(3)]
    seg_t = torch.from_numpy(seg).to(cuda)
    before = hs_kernel.LAUNCHES
    calls = 0
    for x in (keys, ties.view(np.int32), hard):
        x_t = torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
        for sg, ks in ((None, (0,)), (None, (1,)), (None, (n // 2 + 1,)),
                       (None, (n,)), (seg_t, (lens[0], 0, lens[2]))):
            got = kth_key(x_t, sg, ks)
            calls += 1
            assert torch.equal(got, kth_key(x_t, sg, ks, backend=PLAIN)), \
                (ks, sg is None)
    assert hs_kernel.LAUNCHES == before + calls


@pytest.mark.cuda
def test_hist_select_offset_row(cuda):
    """One row that starts 4 bytes past an allocation (a 12-byte head)."""
    rng = np.random.default_rng(4)
    flat = torch.from_numpy(rng.integers(-9, 9, 70_004).astype(np.int32)
                            ).to(cuda)
    row = flat[1:].view(1, -1)
    for k in (1, 12_345, 70_003):
        assert torch.equal(kth_key(row, None, (k,)),
                           kth_key(row, None, (k,), backend=PLAIN))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ids,b", [("zipf", 5_000), ("uniform", 3_000),
                                   ("zipf", 1), ("hot", 640),
                                   ("ragged", 999)])
def test_embedding_bag_tiled_route_equals_per_bag(cuda, dtype, ids, b):
    """D=256 at L=16 takes the tiled route: within the plain version's
    tolerance, and equal to the per-bag route bit for bit (counters too);
    uniform ids overflow the on-chip rows of a tile."""
    rng = np.random.default_rng(b)
    n, d, l = 50_000, 256, 16
    storage = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)) \
        .to(cuda, dtype)
    if ids == "zipf":
        idx = (rng.zipf(1.3, (b, l)) - 1) % n
    elif ids == "ragged":                 # L % 4 != 0: entries one by one
        idx = (rng.zipf(1.3, (b, 13)) - 1) % n
    elif ids == "hot":
        idx = rng.integers(0, 200, (b, l))
    else:
        idx = rng.integers(0, n, (b, l))
    idx = torch.from_numpy(idx.astype(np.int32)).to(cuda)
    l = idx.shape[1]
    w = torch.from_numpy(rng.uniform(0.5, 1.5, (b, l)).astype(np.float32)) \
        .to(cuda)
    counts = torch.full((n // 4,), 3, dtype=torch.int32, device=cuda)
    assert eb_kernel.route(dtype, d, l, True) == "tiled"
    before = dict(eb_kernel.ROUTE_LAUNCHES)
    got = embedding_bag(storage, idx, counts, w, block_rows=4)
    assert eb_kernel.ROUTE_LAUNCHES == {"tiled": before["tiled"] + 1,
                                        "per_bag": before["per_bag"]}
    old = eb_kernel._launch("per_bag", storage, idx, w, counts, block_rows=4)
    ref = embedding_bag(storage, idx, counts, w, block_rows=4, backend=PLAIN)
    assert torch.equal(got[0], old[0]) and torch.equal(got[1], old[1])
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got[0].float(), ref[0].float(), rtol=tol,
                               atol=tol)
    assert torch.equal(got[1], ref[1])


@pytest.mark.cuda
@pytest.mark.parametrize("d,l", [(250, 16), (20, 16), (256, 1_500)])
def test_embedding_bag_per_bag_route_shapes(cuda, d, l):
    """Rows that are not whole 128-byte slices, and bags longer than a
    tile, take the per-bag route; the tiled kernel refuses them.  (The
    float32 atol grows with L: an L-term sum in two orders.)"""
    rng = np.random.default_rng(d + l)
    n, b = 10_000, 37
    storage = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)) \
        .to(cuda)
    idx = torch.from_numpy(rng.integers(0, n, (b, l)).astype(np.int32)) \
        .to(cuda)
    counts = torch.zeros(n // 4, dtype=torch.int32, device=cuda)
    assert eb_kernel.route(storage.dtype, d, l, True) == "per_bag"
    before = eb_kernel.ROUTE_LAUNCHES["per_bag"]
    got = embedding_bag(storage, idx, counts, None, block_rows=4)
    assert eb_kernel.ROUTE_LAUNCHES["per_bag"] == before + 1
    ref = embedding_bag(storage, idx, counts, None, block_rows=4,
                        backend=PLAIN)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-5 * l / 16)
    assert torch.equal(got[1], ref[1])
    with pytest.raises(RuntimeError, match="launch failed"):
        eb_kernel._launch(
            "tiled", storage, idx, torch.ones_like(idx, dtype=torch.float32),
            counts, block_rows=4)


def _grad_call(name, cuda, requires_grad):
    """One call of a kernel's public function on CUDA inputs whose floats
    require grad (or not) -> (the call, the kernel module)."""
    gen = torch.Generator().manual_seed(3)

    def f(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(cuda, dtype) \
            .requires_grad_(requires_grad)
    if name == "flash_attention":
        q, k, v = (f(2, 64, 64, dtype=torch.bfloat16) for _ in range(3))
        return lambda: flash_attention(q, k, v), fa_kernel
    idx = torch.arange(32, dtype=torch.int32, device=cuda)
    counts = torch.zeros(16, dtype=torch.int32, device=cuda)
    storage = f(64, 128)
    if name == "embedding_bag":
        w = f(4, 8)
        return (lambda: embedding_bag(storage, idx.reshape(4, 8), counts, w,
                                      block_rows=4), eb_kernel)
    return (lambda: gather_count(storage, idx, counts, block_rows=4),
            gc_kernel)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash_attention", "embedding_bag",
                                  "gather_count"])
def test_kernels_refuse_a_gradient_they_cannot_carry(cuda, name):
    """Inputs that require grad: the kernel's direct call raises before it
    launches; the same call under no_grad launches it; so does a call
    whose inputs do not require grad.  (``flash_train`` carries attention's
    gradient through ``FlashAttentionFn``: the test below.)"""
    call, mod = _grad_call(name, cuda, True)
    before = mod.LAUNCHES
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    assert mod.LAUNCHES == before
    with torch.no_grad():
        call()
    assert mod.LAUNCHES == before + 1
    _grad_call(name, cuda, False)[0]()
    assert mod.LAUNCHES == before + 2


@pytest.mark.cuda
def test_small_run_identical_on_gpu_and_cpu(cuda):
    scen = dict(n_epochs=3, batches_per_epoch=2, shift_at=1)
    a = run_scenario(DLRMScenario(**scen), hints=True, sync_every=2)
    b = run_scenario(DLRMScenario(**scen), hints=True, sync_every=2,
                     device="cpu")
    assert a == b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,m", [(64, 256, 0), (64, 256, 1),
                                   (1_000, 256, 127), (1_000, 10, 5_000),
                                   (999, 3, 333)])
def test_gather_count_kernel_matches_plain(cuda, dtype, n, d, m):
    rng = np.random.default_rng(n + d + m)
    storage = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)) \
        .to(cuda, dtype)
    idx = np.where(rng.random(m) < 0.5, rng.zipf(1.3, m) % n,
                   rng.integers(0, n, m))
    idx = torch.from_numpy(idx.astype(np.int32)).to(cuda)
    counts = torch.full(((n + 3) // 4,), 5, dtype=torch.int32, device=cuda)
    before = gc_kernel.LAUNCHES
    got = gather_count(storage, idx, counts, block_rows=4)
    ref = gather_count(storage, idx, counts, block_rows=4, backend=PLAIN)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert torch.equal(counts, torch.full_like(counts, 5))   # not in place
    assert gc_kernel.LAUNCHES == before + (m > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,l,n,d", [(3, 5, 128, 128), (64, 16, 1_000, 256),
                                     (7, 40, 500, 20), (5, 3, 100, 250)])
def test_embedding_bag_kernel_matches_plain(cuda, dtype, tol, b, l, n, d):
    rng = np.random.default_rng(b * l + d)
    storage = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)) \
        .to(cuda, dtype)
    idx = torch.from_numpy(rng.integers(0, n, (b, l)).astype(np.int32)) \
        .to(cuda)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, (b, l)).astype(np.float32)) \
        .to(cuda)
    counts = torch.full(((n + 7) // 8,), 2, dtype=torch.int32, device=cuda)
    before = eb_kernel.LAUNCHES
    for weights in (w, None):
        got = embedding_bag(storage, idx, counts, weights, block_rows=8)
        ref = embedding_bag(storage, idx, counts, weights, block_rows=8,
                            backend=PLAIN)
        assert got[0].dtype == dtype
        torch.testing.assert_close(got[0].float(), ref[0].float(), rtol=tol,
                                   atol=tol)
        assert torch.equal(got[1], ref[1])
    assert eb_kernel.LAUNCHES == before + 2


@pytest.mark.cuda
def test_small_example_identical_on_gpu_and_cpu(cuda):
    spec = dlrm_tiering.SMALL
    table = (np.random.default_rng(3).normal(size=(spec.n_rows, spec.emb_dim))
             * 0.05).astype(np.float32)
    out = {dev: dlrm_tiering.run(spec, bag=4, table=table, device=dev)
           for dev in ("cuda", "cpu")}
    g, c = out["cuda"], out["cpu"]
    torch.testing.assert_close(g.pop("pooled").cpu(), c.pop("pooled"),
                               rtol=1e-5, atol=1e-5)
    assert sorted(g) == sorted(c)
    for key in g:
        assert np.array_equal(g[key], c[key]), key
    assert g["gathered_equal"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol_of_max", [
    (torch.float32, 2e-5, None), (torch.bfloat16, 2 ** -7, 1e-3)])
@pytest.mark.parametrize("bh,kvh,sq,sk,d,causal,window", [
    (14, 2, 200, 200, 64, True, None),      # qwen2-0.5b heads, ragged S
    (4, 4, 19, 19, 16, True, None),         # the KV scenario's prefill
    (16, 8, 130, 130, 128, True, 33),       # internlm2 heads, a window
    (2, 1, 70, 45, 256, False, None),       # MQA, non-causal, Sq != Sk
])
def test_flash_attention_kernel_matches_plain(cuda, dtype, rtol, atol_of_max,
                                              bh, kvh, sq, sk, d, causal,
                                              window):
    rng = np.random.default_rng(sq * d + sk)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                * scale).to(cuda, dtype)
               for shape, scale in (((bh, sq, d), 3.0), ((kvh, sk, d), 1.0),
                                    ((kvh, sk, d), 1.0)))
    before = fa_kernel.LAUNCHES
    got = flash_attention(q, k, v, q_per_kv=bh // kvh, causal=causal,
                          window=window)
    ref = flash_attention(q, k, v, q_per_kv=bh // kvh, causal=causal,
                          window=window, backend=PLAIN)
    assert got.dtype == dtype and got.shape == q.shape
    atol = (rtol if atol_of_max is None
            else atol_of_max * float(ref.float().abs().max()))
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                               atol=atol)
    if dtype == torch.bfloat16:
        assert float((got != ref).float().mean()) <= 0.01
    assert fa_kernel.LAUNCHES == before + 1


def _bf16_check(got, ref):
    """The bfloat16 rule above: one bfloat16 step plus 1e-3 of the largest
    output, at most 1 % of the outputs differing."""
    atol = 1e-3 * float(ref.float().abs().max())
    torch.testing.assert_close(got.float(), ref.float(), rtol=2 ** -7,
                               atol=atol)
    assert float((got != ref).float().mean()) <= 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 80, 112, 128])
@pytest.mark.parametrize("bh,kvh,sq,sk,causal,window", [
    (14, 2, 1, 1, True, None),          # a one-token prompt
    (14, 2, 19, 19, True, None),        # shorter than one tile
    (16, 8, 130, 130, True, None),      # one tile and two rows
    (14, 2, 200, 200, True, None),      # ragged second tile
    (16, 8, 200, 200, True, 33),        # a window edge inside a tile
    (8, 2, 200, 130, False, None),      # non-causal, Sq > Sk
    (8, 2, 130, 300, False, None),      # non-causal, Sq < Sk
])
def test_flash_attention_tensor_core_route_matches_plain(cuda, d, bh, kvh, sq,
                                                        sk, causal, window):
    """bfloat16 at d = 64, 80, 112 and 128 runs on the tensor cores (and
    only there), within the bfloat16 rule of the plain version (at 80 and
    112 the last 64-column panel runs past d)."""
    rng = np.random.default_rng(sq * d + sk)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                * scale).to(cuda, torch.bfloat16)
               for shape, scale in (((bh, sq, d), 3.0), ((kvh, sk, d), 1.0),
                                    ((kvh, sk, d), 1.0)))
    before = dict(fa_kernel.ROUTE_LAUNCHES)
    got = flash_attention(q, k, v, q_per_kv=bh // kvh, causal=causal,
                          window=window)
    ref = flash_attention(q, k, v, q_per_kv=bh // kvh, causal=causal,
                          window=window, backend=PLAIN)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _bf16_check(got, ref)
    assert fa_kernel.ROUTE_LAUNCHES == {
        "tensor_core": before["tensor_core"] + 1,
        "tf32x3": before["tf32x3"],
        "cuda_core": before["cuda_core"]}


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("bh,kvh,sq,sk,causal,window", [
    (14, 2, 1, 1, True, None),          # a one-token prompt
    (14, 2, 19, 19, True, None),        # shorter than one tile
    (16, 8, 130, 130, True, None),      # one tile and two rows
    (14, 2, 200, 200, True, None),      # ragged second tile
    (16, 8, 200, 200, True, 33),        # a window edge inside a tile
    (8, 2, 200, 130, False, None),      # non-causal, Sq > Sk
    (8, 2, 130, 300, False, None),      # non-causal, Sq < Sk
])
def test_flash_attention_tf32x3_route_matches_plain(cuda, d, bh, kvh, sq, sk,
                                                   causal, window):
    """float32 at d = 64 and 128 runs on the TF32 tensor cores (3xTF32),
    within 2e-5 of the plain version; the CUDA-core kernel, named through
    ``_launch`` on the same input, is within 2e-5 too."""
    rng = np.random.default_rng(sq * d + sk)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                * scale).to(cuda)
               for shape, scale in (((bh, sq, d), 3.0), ((kvh, sk, d), 1.0),
                                    ((kvh, sk, d), 1.0)))
    kw = dict(q_per_kv=bh // kvh, causal=causal, window=window)
    before = dict(fa_kernel.ROUTE_LAUNCHES)
    got = flash_attention(q, k, v, **kw)
    assert fa_kernel.ROUTE_LAUNCHES == {
        "tensor_core": before["tensor_core"],
        "tf32x3": before["tf32x3"] + 1,
        "cuda_core": before["cuda_core"]}
    ref = flash_attention(q, k, v, backend=PLAIN, **kw)
    old = fa_kernel._launch("cuda_core", q, k, v, **kw)
    assert got.dtype == torch.float32 and got.shape == q.shape
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(old, ref, rtol=2e-5, atol=2e-5)
    assert fa_kernel.ROUTE_LAUNCHES["cuda_core"] == before["cuda_core"] + 1


@pytest.mark.cuda
def test_flash_attention_tf32x3_refuses_what_it_does_not_take(cuda):
    """cp.async needs 16-byte-aligned q, k and v; the TF32 and tensor-core
    kernels take only their own (dtype, d); a refusal launches nothing."""
    buf = torch.zeros(14 * 64 * 64 + 1, device=cuda)
    q = buf[1:].view(14, 64, 64)                    # 4 bytes off
    k = torch.zeros(2, 64, 64, device=cuda)
    before = fa_kernel.LAUNCHES
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q, k, k, q_per_kv=7)
    with pytest.raises(ValueError, match="tf32x3"):
        fa_kernel._launch("tf32x3", q.bfloat16(), k.bfloat16(), k.bfloat16(),
                          q_per_kv=7)
    with pytest.raises(ValueError, match="tensor_core"):
        fa_kernel._launch("tensor_core", q, k, k, q_per_kv=7)
    qb, kb = torch.zeros(14, 64, 64, device=cuda, dtype=torch.bfloat16), \
        torch.zeros(2, 64, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="cuda_core"):
        fa_kernel._launch("cuda_core", qb, kb, kb, q_per_kv=7)
    assert fa_kernel.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,kvh,d", [(8, 8, 80),      # zamba2-2.7b
                                      (16, 2, 112)])   # kimi-k2
def test_flash_attention_head_dims_80_and_112(cuda, dtype, bh, kvh, d):
    """float32 runs on the TF32 route, bfloat16 on the tensor cores (the
    route ``kernel.route`` names); the CUDA-core kernel, named through
    ``_launch`` on the same input, passes the same rule."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                * scale).to(cuda, dtype)
               for shape, scale in (((bh, 150, d), 3.0), ((kvh, 150, d), 1.0),
                                    ((kvh, 150, d), 1.0)))
    route = fa_kernel.route(dtype, d)
    assert route == ("tensor_core" if dtype == torch.bfloat16
                     else "tf32x3")
    before = dict(fa_kernel.ROUTE_LAUNCHES)
    got = flash_attention(q, k, v, q_per_kv=bh // kvh)
    assert fa_kernel.ROUTE_LAUNCHES == {
        r: n + (r == route) for r, n in before.items()}
    ref = flash_attention(q, k, v, q_per_kv=bh // kvh, backend=PLAIN)
    old = fa_kernel._launch("cuda_core", q, k, v, q_per_kv=bh // kvh)
    if dtype == torch.bfloat16:
        _bf16_check(got, ref)
        _bf16_check(old, ref)
    else:
        torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(old, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 80, 112, 128, 256])
@pytest.mark.parametrize("bh,kvh,sq,sk,causal,window", [
    (14, 2, 200, 200, True, None),      # GQA, a ragged KV tile
    (16, 8, 200, 200, True, 33),        # a window edge inside a tile
    (8, 2, 200, 130, False, None),      # non-causal, Sq > Sk
    (8, 2, 130, 300, False, None),      # non-causal, Sq < Sk
])
def test_flash_attention_every_head_dim_on_its_route(cuda, dtype, d, bh, kvh,
                                                     sq, sk, causal, window):
    """Every (dtype, d) of ``HEAD_DIMS`` runs on the route ``kernel.route``
    names (the tensor cores in bfloat16, the TF32 route in float32; never
    the CUDA cores), within the plain version's tolerance."""
    rng = np.random.default_rng(sq * d + sk)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                * scale).to(cuda, dtype)
               for shape, scale in (((bh, sq, d), 3.0), ((kvh, sk, d), 1.0),
                                    ((kvh, sk, d), 1.0)))
    kw = dict(q_per_kv=bh // kvh, causal=causal, window=window)
    route = fa_kernel.route(dtype, d)
    assert route == ("tensor_core" if dtype == torch.bfloat16 else "tf32x3")
    before = dict(fa_kernel.ROUTE_LAUNCHES)
    got = flash_attention(q, k, v, **kw)
    assert fa_kernel.ROUTE_LAUNCHES == {
        r: n + (r == route) for r, n in before.items()}
    ref = flash_attention(q, k, v, backend=PLAIN, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.bfloat16:
        _bf16_check(got, ref)
    else:
        torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_kv_scenario_prefill_launches_flash_attention_per_layer(cuda):
    scen = KVCacheScenario(batch=2, n_epochs=2, batches_per_epoch=2)
    before = fa_kernel.LAUNCHES
    eps = list(scen.epochs())
    assert fa_kernel.LAUNCHES == before + scen.cfg.n_layers
    cpu = KVCacheScenario(batch=2, n_epochs=2, batches_per_epoch=2,
                          device="cpu")
    list(cpu.epochs())
    np.testing.assert_allclose(scen.masses, cpu.masses, rtol=1e-3, atol=1e-3)
    assert len(eps) == 2


def _fleet_mix_scenarios(cuda):
    from repro_torch.examples import fleet_mix
    # the KV and MoE tenants' streams are made once on the card; both
    # devices' fleets replay them
    return fleet_mix, fleet_mix.make_scenarios(device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("capacity,hs_per_epoch", [
    ("shared", 2), ("partition", 4), ("weighted", 4)])
def test_fleet_step_on_the_card_equals_the_cpu_step(cuda, capacity,
                                                     hs_per_epoch):
    """The example's 4-tenant mix (dlrm, kv, moe, scanner), hints on, K=3:
    the card's run equals the CPU's field for field, tenant rows included.
    hist_select launches per epoch: with quotas the segment mask, the
    select, the hot set and the tenants' hot sets; shared, the select and
    the tenants' hot sets."""
    from repro_torch.fleet import run_fleet
    fleet_mix, sc = _fleet_mix_scenarios(cuda)
    fleet = fleet_mix.fleet(sc, capacity)
    eps = list(fleet.epochs())
    os0, hs0 = os_kernel.LAUNCHES, hs_kernel.LAUNCHES
    gpu = run_fleet(fleet, hints=True, sync_every=3, epochs=eps)
    assert os_kernel.LAUNCHES - os0 == sum(len(e) for e in eps)
    assert hs_kernel.LAUNCHES - hs0 == hs_per_epoch * len(eps)
    cpu = run_fleet(fleet_mix.fleet(sc, capacity), hints=True, sync_every=3,
                    epochs=eps, device="cpu")
    assert gpu == cpu


@pytest.mark.cuda
def test_segment_select_on_fleet_key_rows_matches_plain(cuda):
    """hist_select's segment route (S = T) on key rows made from the
    fleet's own stream: the kernel's thresholds and the whole segment mask
    equal the plain versions'."""
    from repro_torch.core import selectk
    fleet_mix, sc = _fleet_mix_scenarios(cuda)
    fleet = fleet_mix.fleet(sc, "weighted")
    ep = next(iter(fleet.epochs()))
    h = [torch.bincount(torch.from_numpy(row.astype(np.int64)).to(cuda),
                        minlength=fleet.n_blocks).to(torch.int32)
         for row in ep]
    hf = h[0].to(torch.float32)
    rows = torch.stack([
        h[0], (h[0] > 0).to(torch.int32), selectk.sortable_key(0.5 * hf),
        selectk.sortable_key(h[1].to(torch.float32) / h[1].max())]
    ).contiguous()
    ten = fleet.tenancy
    seg = torch.from_numpy(ten.block_tenants()).to(cuda)
    for ks in (ten.caps, ten.hot_k):
        before = hs_kernel.LAUNCHES
        got = kth_key(rows, seg, ks)
        assert hs_kernel.LAUNCHES == before + 1
        assert torch.equal(got, kth_key(rows, seg, ks, backend=PLAIN))
        assert torch.equal(
            selectk.segment_top_k_mask(rows, ten.offsets, ks),
            selectk.segment_top_k_mask(rows, ten.offsets, ks, backend=PLAIN))


@pytest.mark.cuda
def test_tenancy_over_the_segment_cap_refused_at_construction(cuda):
    """A tenancy of more tenants than one hist_select call takes fails when
    the runtime is built on the card, naming both numbers; the same
    tenancy builds on the CPU (the plain versions have no cap)."""
    from repro_torch.core.runtime import EpochRuntime, Tenancy
    cap = hs_kernel.max_segments()
    t = cap + 1
    ten = Tenancy(offsets=tuple(range(0, 2 * t + 1, 2)), hot_k=(1,) * t)
    with pytest.raises(ValueError, match=f"{t} tenants.*{cap} segments"):
        EpochRuntime(2 * t, t, policies=("hmu_oracle",), tenancy=ten)
    EpochRuntime(2 * t, t, policies=("hmu_oracle",), tenancy=ten,
                 device="cpu")


# ------------------------------------------------------ degraded telemetry
_ALL_FAULTS = dict(pebs_drop_p=0.3, reset_p=(0.5, 0.5, 0.5), nb_stall_p=0.5,
                   hmu_counter_bits=12, stale_epochs=1, seed=7)
_HARD = dict(fallback={"hmu_oracle": "pebs", "hinted": "hmu",
                       "nb_two_touch": "hmu"}, demote_hysteresis=2)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_prng_on_the_card_equals_the_cpu(cuda, seed):
    """The Threefry words, splits, uniforms and Bernoulli draws are the
    same on the card as on the CPU, bit for bit."""
    from repro_torch.faults import prng
    kc, kg = prng.prng_key(seed), prng.prng_key(seed, device=cuda)
    assert torch.equal(prng.split(kg, 3).cpu(), prng.split(kc, 3))
    for shape in ((), (3,), (2, 5), (1_000_003,)):
        assert torch.equal(prng.random_bits(kg, shape).cpu(),
                           prng.random_bits(kc, shape))
        assert torch.equal(prng.uniform(kg, shape).cpu().view(torch.int32),
                           prng.uniform(kc, shape).view(torch.int32))
        assert torch.equal(prng.bernoulli(kg, 0.3, shape).cpu(),
                           prng.bernoulli(kc, 0.3, shape))


@pytest.mark.cuda
@pytest.mark.parametrize("n_blocks,m,drop", [(5_000, 30_001, 0.3),
                                             (5_242_880, 2_400_000, 0.1)])
def test_observe_scatter_on_the_prng_keep_mask_matches_plain(cuda, n_blocks,
                                                             m, drop):
    """observe_scatter with the fault model's own keep draw (the faulty
    observe path's mask: ``uniform >= pebs_drop_p`` from a split key)."""
    from repro_torch.faults import prng
    rng = np.random.default_rng(m)
    ids = torch.from_numpy(((rng.zipf(1.2, m) - 1) % n_blocks)
                           .astype(np.int32)).to(cuda)
    key = prng.split(prng.prng_key(7, device=cuda), 3)[1]
    keep = prng.uniform(key, (m,)) >= drop
    cursor = torch.tensor(3, dtype=torch.int32, device=cuda)
    before = os_kernel.LAUNCHES
    got = observe_scatter(ids, cursor, n_blocks=n_blocks, period=101,
                          keep=keep)
    assert os_kernel.LAUNCHES == before + 1
    ref = observe_scatter(ids, cursor, n_blocks=n_blocks, period=101,
                          keep=keep, backend=PLAIN)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("hardened", [False, True])
@pytest.mark.parametrize("sync_every", [1, 4])
def test_faulty_small_run_identical_on_gpu_and_cpu(cuda, hardened,
                                                   sync_every):
    """SMALL under every fault at once, with and without hardening: the
    card's run equals the CPU's; every batch launches observe_scatter with
    its keep mask, and the hot set adds one hist_select call an epoch."""
    from repro_torch.faults import FaultModel, Hardening
    scen = dict(n_epochs=4, batches_per_epoch=2, shift_at=2)

    def run(device):
        return run_scenario(
            DLRMScenario(**scen), hints=True, sync_every=sync_every,
            device=device, pebs_period=101,
            faults=FaultModel.create(n_blocks=DLRMScenario().n_blocks,
                                     **_ALL_FAULTS),
            hardening=Hardening.make(**_HARD) if hardened else None)

    os0, hs0 = os_kernel.LAUNCHES, hs_kernel.LAUNCHES
    gpu = run(cuda)
    assert os_kernel.LAUNCHES - os0 == 4 * 2
    assert hs_kernel.LAUNCHES - hs0 == 4 * 2
    assert gpu == run("cpu")


@pytest.mark.cuda
def test_faulty_fused_step_makes_no_sync_inside_an_epoch(cuda):
    """Under ``set_sync_debug_mode("error")`` a faulty, hardened run makes
    no host sync but its record pulls: every draw, reset, stall, swap and
    ring read stays on the card."""
    from repro_torch.core import runtime
    from repro_torch.faults import FaultModel, Hardening
    from repro_torch.scenarios import build_hints
    scen = DLRMScenario(n_epochs=4, batches_per_epoch=2, shift_at=2)
    eps = list(scen.epochs())
    pipeline = build_hints(scen)
    fm = FaultModel.create(n_blocks=scen.n_blocks,
                           **dict(_ALL_FAULTS, stale_epochs=2))
    with runtime.counting() as c:
        torch.cuda.set_sync_debug_mode("error")
        try:
            run_scenario(scen, hints=pipeline, sync_every=4, epochs=eps,
                         faults=fm, hardening=Hardening.make(**_HARD))
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert c.dispatch["record_sync"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("sync_every", [1, 4])
def test_traced_exported_small_run_identical_on_gpu_and_cpu(cuda,
                                                            sync_every):
    """SMALL with tracing and export on: the card's run gives the CPU's
    output, the CPU's wire records in order, and the CPU's span sequence
    (name, epoch, args, depth, thread) on the host thread."""
    from repro_torch.export import ExportClient, MemorySink
    from repro_torch.obs import trace as obs_trace
    scen = dict(n_epochs=4, batches_per_epoch=2, shift_at=2)

    def run(device):
        sink = MemorySink()
        client = ExportClient(sink)
        try:
            with obs_trace.tracing(profiler_annotations=True) as tr:
                out = run_scenario(DLRMScenario(**scen), hints=True,
                                   sync_every=sync_every, device=device,
                                   export=client)
            client.flush(timeout=60)
        finally:
            client.close()
        spans = [(s.name, s.epoch, s.args, s.depth, s.tid) for s in tr.spans
                 if not s.name.startswith("export.write")]
        return out, sink.snapshot(), spans

    gpu, cpu = run(cuda), run("cpu")
    assert gpu[0] == cpu[0]
    assert gpu[1] == cpu[1] and len(gpu[1]) > 0
    assert gpu[2] == cpu[2]
    names = [s[0] for s in gpu[2]]
    assert names.count("observe_all") == names.count("epoch_step") == 4
    assert names.count("record_sync") == -(-4 // sync_every)


@pytest.mark.cuda
def test_elapsed_s_waits_for_a_cuda_tensor(cuda):
    """``elapsed_s`` on a tensor queued behind a spin of the card waits for
    the spin (about 50 ms); without the tensor it reads the clock at
    once."""
    from repro_torch.obs import trace as obs_trace
    x = torch.ones(16, device=cuda)
    torch.cuda.synchronize()
    t0 = obs_trace.now_s()
    torch.cuda._sleep(100_000_000)
    y = x + 1
    no_wait = obs_trace.elapsed_s(t0)
    waited = obs_trace.elapsed_s(t0, y)
    assert waited > 0.02 and waited > no_wait
    assert torch.equal(y, x + 1)


# ------------------------------------------------ the per-lane reference path
@pytest.mark.cuda
@pytest.mark.parametrize("hints", [False, True])
def test_reference_path_on_the_card_equals_the_cpu(cuda, hints):
    """``run_scenario(fused=False)`` on SMALL: byte-identical GPU vs CPU
    and equal to the fused run; on the card one observe_scatter launch a
    batch and one hist_select launch a lane and epoch (each eager policy's
    top-k)."""
    import json
    from repro_torch.dlrm import datagen
    scen = DLRMScenario(spec=datagen.SMALL, n_epochs=4, shift_at=2)
    eps = list(scen.epochs())
    os0, hs0 = os_kernel.LAUNCHES, hs_kernel.LAUNCHES
    gpu = run_scenario(scen, hints=hints, fused=False, epochs=eps)
    assert os_kernel.LAUNCHES - os0 == sum(len(e) for e in eps)
    assert hs_kernel.LAUNCHES - hs0 == 6 * len(eps)
    cpu = run_scenario(scen, hints=hints, fused=False, epochs=eps,
                       device="cpu")
    assert json.dumps(gpu, sort_keys=True) == json.dumps(cpu, sort_keys=True)
    fused = run_scenario(scen, hints=hints, epochs=eps)
    assert fused["trajectory"] == gpu["trajectory"]


@pytest.mark.cuda
@pytest.mark.parametrize("capacity,hs_per_epoch", [
    ("shared", 6), ("weighted", 0)])
def test_fleet_reference_path_on_the_card_equals_the_cpu(cuda, capacity,
                                                         hs_per_epoch):
    """The example's mix on the reference path: GPU == CPU, tenant rows
    included.  Under quotas the lanes select by numpy stable sorts, as the
    reference's, so no hist_select launches; shared, one a lane."""
    from repro_torch.fleet import run_fleet
    fleet_mix, sc = _fleet_mix_scenarios(cuda)
    eps = list(fleet_mix.fleet(sc, capacity).epochs())
    hs0 = hs_kernel.LAUNCHES
    gpu = run_fleet(fleet_mix.fleet(sc, capacity), hints=True, fused=False,
                    epochs=eps)
    assert hs_kernel.LAUNCHES - hs0 == hs_per_epoch * len(eps)
    cpu = run_fleet(fleet_mix.fleet(sc, capacity), hints=True, fused=False,
                    epochs=eps, device="cpu")
    assert gpu == cpu


# ----------------------------------------------------------------- MoE
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.3])
def test_moe_block_on_the_card_matches_the_cpu(cuda, arch, capacity_factor):
    """moe_block in float32 on the same weights and input: counts exact,
    output and balance loss within 2e-5 (the same float32 products summed
    in another order), no host sync inside; at capacity 0.3 tokens drop."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as tm
    from repro_torch.models.moe import moe_block
    cfg = get_smoke_config(arch)
    params = tm.init_params(cfg, 0, device="cpu")
    par = tm.moe_params(tm.layer_params(params, 0))
    par = par._replace(**{k: v.float() for k, v in par._asdict().items()
                          if v is not None})
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3, 40, cfg.d_model)).astype(np.float32))
    cpu_out, cpu_aux = moe_block(x, par, top_k=cfg.moe.top_k,
                                 capacity_factor=capacity_factor)
    gpar = type(par)(*[None if v is None else v.to(cuda) for v in par])
    gx = x.to(cuda)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = moe_block(gx, gpar, top_k=cfg.moe.top_k,
                             capacity_factor=capacity_factor)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(aux["counts"].cpu(), cpu_aux["counts"])
    np.testing.assert_allclose(out.cpu().numpy(), cpu_out.numpy(),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(aux["aux_loss"]),
                               float(cpu_aux["aux_loss"]), rtol=2e-5)


@pytest.mark.cuda
def test_moe_scenario_on_the_card_follows_the_cpu(cuda):
    """MoEExpertScenario's stream on the card: the kimi-k2 smoke forward
    launches flash_attention once a layer a batch, on the route
    ``kernel.route`` names (bfloat16 at d 16: the tensor cores); every row has the CPU's length and lies within an L1 distance
    of 2 % of it of the CPU's row; each batch's forward again on both
    devices gives (L, E) counts within 2 % of the routings (the same
    totals per layer) and hidden states (6e-2) and logits (1e-2) within
    tolerance on at least 97 % of the elements (tests/test_torch_moe.py's
    bfloat16 bounds: a bf16 rounding may flip a routing near-tie); and
    run_scenario fed the CPU's stream equals the CPU's run."""
    import json
    from repro_torch.models.model import forward, logits_fn
    from repro_torch.scenarios import MoEExpertScenario
    kw = dict(n_epochs=3, batches_per_epoch=2, shift_at=1, batch=2)
    gpu_sc = MoEExpertScenario(**kw)
    route = fa_kernel.route(gpu_sc.cfg.activ_dtype, gpu_sc.cfg.head_dim)
    before = dict(fa_kernel.ROUTE_LAUNCHES)
    gpu_eps = list(gpu_sc.epochs())
    assert fa_kernel.ROUTE_LAUNCHES == {
        r: n + (gpu_sc.cfg.n_layers * 6 if r == route else 0)
        for r, n in before.items()}
    cpu_sc = MoEExpertScenario(device="cpu", **kw)
    cpu_eps = list(cpu_sc.epochs())
    assert [e.shape for e in gpu_eps] == [e.shape for e in cpu_eps]
    for ge, ce in zip(gpu_eps, cpu_eps):
        for gr, cr in zip(ge, ce):
            l1 = np.abs(np.bincount(gr, minlength=gpu_sc.n_blocks)
                        - np.bincount(cr, minlength=gpu_sc.n_blocks)).sum()
            assert l1 <= 0.02 * gpu_sc.batch_len, l1
    g_par, c_par = gpu_sc.model_params(), cpu_sc.model_params()
    with torch.no_grad():
        for toks in gpu_sc.token_batches():
            t = torch.from_numpy(toks)
            gh, g_aux = forward(g_par, gpu_sc.cfg, tokens=t.to(cuda))
            ch, c_aux = forward(c_par, cpu_sc.cfg, tokens=t)
            gc, cc = g_aux["expert_counts"].cpu(), c_aux["expert_counts"]
            assert torch.equal(gc.sum(-1), cc.sum(-1))
            assert int((gc - cc).abs().sum()) <= 0.02 * int(cc.sum())
            for g, c, tol in (
                    (gh, ch, 6e-2),
                    (logits_fn(g_par, gpu_sc.cfg, gh),
                     logits_fn(c_par, cpu_sc.cfg, ch), 1e-2)):
                g, c = g.float().cpu(), c.float()
                assert bool(torch.isfinite(g).all())
                within = ((g - c).abs() <= tol + tol * c.abs()).float()
                assert float(within.mean()) >= 0.97
    gpu = run_scenario(gpu_sc, hints=True, epochs=cpu_eps)
    cpu = run_scenario(cpu_sc, hints=True, epochs=cpu_eps, device="cpu")
    assert json.dumps(gpu, sort_keys=True) == json.dumps(cpu, sort_keys=True)


def _recurrent_run(params, cfg, toks, dev):
    """forward and prefill over toks[:, :-3], then 3 decode steps, under
    the sync check -> (outputs by name, launches by route in the prefill,
    in the decode steps)."""
    from repro_torch.models.model import forward, logits_fn
    from repro_torch.serve import engine
    s = toks.shape[1] - 3
    toks = torch.from_numpy(toks).to(dev)
    out, routes = {}, []
    sync_check = dev.type == "cuda"
    if sync_check:
        torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            h, _ = forward(params, cfg, tokens=toks[:, :s])
            out["hidden"], out["logits"] = h, logits_fn(params, cfg, h[:, -1:])
            before = dict(fa_kernel.ROUTE_LAUNCHES)
            out["prefill_logits"], cache = engine.prefill(
                params, cfg, tokens=toks[:, :s], max_len=s + 3)
            routes.append({r: n - before[r] for r, n in
                           fa_kernel.ROUTE_LAUNCHES.items()})
            for k in range(3):
                out[f"decode_logits_{k}"], cache, aux = engine.decode_step(
                    params, cfg, cache, toks[:, s + k])
                assert aux == {}
            routes.append({r: n - before[r] - routes[0][r] for r, n in
                           fa_kernel.ROUTE_LAUNCHES.items()})
    finally:
        if sync_check:
            torch.cuda.set_sync_debug_mode(0)
    out.update({"cache_" + k: v for k, v in cache.items()})
    return {k: v.cpu() for k, v in out.items()}, routes


@pytest.mark.cuda
@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-2.7b"])
def test_recurrent_family_on_the_card_matches_the_cpu(cuda, arch, act):
    """The smoke model on perturbed weights (every leaf drawn, not the
    init's zeros): forward and prefill at S 150 (three chunks, the last
    padded), then 3 decode steps, with no host sync inside on the card;
    zamba2's prefill launches flash_attention once per shared-block
    invocation, on the route ``kernel.route`` names (d 32: the tensor
    cores in bfloat16, the TF32 route in float32), its decode none; rwkv6
    none.  Every output and cache leaf against the CPU's: float32 1e-4,
    relative and absolute (the same float32 products summed in another
    order, through the layers and the carried state); bfloat16 within 6e-2
    (logits and float32 states 1e-2) on at least 99 % of the elements and
    twice that everywhere (tests/_torch_recurrent.py's rule: two bfloat16
    runs that round at other places)."""
    import dataclasses
    from _perturbed_weights import perturbed_tree
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.model import iter_schema
    cfg = dataclasses.replace(get_smoke_config(arch), activ_dtype=act)
    tree = perturbed_tree(iter_schema(cfg), 0)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 153))
    got, routes = _recurrent_run(params_from_numpy(tree, device=cuda), cfg,
                                 toks, cuda)
    want, _ = _recurrent_run(params_from_numpy(tree, device="cpu"), cfg,
                             toks, torch.device("cpu"))
    n_fa = cfg.n_shared_attn if arch == "zamba2-2.7b" else 0
    route = fa_kernel.route(act, cfg.head_dim)
    assert routes == [{r: n_fa if r == route else 0
                       for r in ("tensor_core", "tf32x3", "cuda_core")},
                      {"tensor_core": 0, "tf32x3": 0, "cuda_core": 0}]
    assert got.keys() == want.keys()
    for key, g in got.items():
        w = want[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if key == "cache_pos":
            assert torch.equal(g, w)
            continue
        g, w = g.float(), w.float()
        if act == torch.float32:
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4, msg=key)
            continue
        tol = 1e-2 if "logits" in key or key in ("cache_wkv",
                                                 "cache_ssm") else 6e-2
        diff, bound = (g - w).abs(), tol + tol * w.abs()
        assert bool((diff <= 2 * bound).all()), key
        assert float((diff <= bound).float().mean()) >= 0.99, key


# the training path: FlashAttentionFn's gradients (the kernel's forward,
# the backward kernels) against autograd of the plain version in float32,
# each gradient rounded once to the inputs' dtype (the reference's f32
# autodiff); float32 within 2e-5 of each tensor's largest magnitude,
# bfloat16 by the rule of _bf16_check
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64), (torch.bfloat16, 80),
                                     (torch.bfloat16, 112),
                                     (torch.bfloat16, 128),
                                     (torch.float32, 64), (torch.float32, 128),
                                     (torch.float32, 16)])
@pytest.mark.parametrize("b,h,kvh,s,window,block", [
    (2, 14, 2, 300, None, 128),     # GQA 7:1, ragged blocks
    (1, 8, 8, 257, 40, 64),         # a window, a last block of one row
])
def test_flash_train_gradient_on_the_card(cuda, dtype, d, b, h, kvh, s,
                                          window, block):
    from repro_torch.kernels.flash_attention import attention_ref
    rng = np.random.default_rng(s * d + h)
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                    * scale).to(cuda, dtype)
                   for shape, scale in (((b, h, s, d), 3.0),
                                        ((b, kvh, s, d), 1.0),
                                        ((b, kvh, s, d), 1.0),
                                        ((b, h, s, d), 1.0)))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(fa_kernel.ROUTE_LAUNCHES)
    b_before = dict(fa_kernel.BWD_ROUTE_LAUNCHES)
    out = flash_train(*leaves, window=window, block_k=block)
    got = torch.autograd.grad(out, leaves, do)
    routes = {r: fa_kernel.ROUTE_LAUNCHES[r] - before[r] for r in before}
    assert routes[fa_kernel.route(dtype, d)] == 1 and sum(routes.values()) == 1
    b_routes = {r: fa_kernel.BWD_ROUTE_LAUNCHES[r] - b_before[r]
                for r in b_before}
    assert b_routes[fa_kernel.route(dtype, d)] == 1 \
        and sum(b_routes.values()) == 1
    ref_in = [t.reshape(-1, s, d).float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        attention_ref(*ref_in, q_per_kv=h // kvh, window=window), ref_in,
        do.reshape(-1, s, d).float())
    for g, w in zip(got, want):
        w = w.reshape(g.shape).to(dtype)
        assert g.dtype == dtype
        if dtype == torch.float32:
            assert float((g - w).abs().max()) <= 2e-5 * float(w.abs().max())
        else:
            _bf16_check(g, w)


# the backward kernels alone against the plain backward, attention_bwd_ref,
# on the same card inputs (both round one float32 result once): float32
# within 2e-5 of each gradient's largest magnitude, bfloat16 by the rule of
# _bf16_check; GQA with ragged S, rows without any key (dq 0 there), and
# non-causal Sq < Sk with a window
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", fa_kernel.HEAD_DIMS)
@pytest.mark.parametrize("b,h,kvh,sq,sk,causal,window", [
    (2, 14, 2, 300, 300, True, None),
    (1, 4, 1, 190, 70, True, 3),        # rows 73-189 see no key
    (1, 4, 2, 130, 200, False, 17),
])
def test_flash_attention_bwd_kernel_matches_plain(cuda, monkeypatch, dtype,
                                                  d, b, h, kvh, sq, sk,
                                                  causal, window):
    """One backward call adds one to its route's BWD_ROUTE_LAUNCHES (and
    nothing to the forward's counts) and reaches no plain code; a second
    call on the same input gives the same bits."""
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     flash_attention_bwd)
    from repro_torch.kernels.flash_attention import ops as fa_ops
    rng = np.random.default_rng(sq * d + sk)
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                    * scale).to(cuda, dtype)
                   for shape, scale in (((b * h, sq, d), 3.0),
                                        ((b * kvh, sk, d), 1.0),
                                        ((b * kvh, sk, d), 1.0),
                                        ((b * h, sq, d), 1.0)))
    kw = dict(q_per_kv=h // kvh, causal=causal, window=window)

    def plain(*a, **k):
        raise AssertionError("the plain backward ran on the card")

    before = (dict(fa_kernel.BWD_ROUTE_LAUNCHES), fa_kernel.LAUNCHES)
    with monkeypatch.context() as mp:
        mp.setattr(fa_ops, "attention_bwd_ref", plain)
        got = flash_attention_bwd(q, k, v, do, **kw)
        torch.cuda.synchronize()
        b_routes = {r: n - before[0][r]
                    for r, n in fa_kernel.BWD_ROUTE_LAUNCHES.items()}
        again = flash_attention_bwd(q, k, v, do, **kw)
    want = dict.fromkeys(b_routes, 0)
    want[fa_kernel.route(dtype, d)] = 1
    assert b_routes == want and fa_kernel.LAUNCHES == before[1]
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    ref = attention_bwd_ref(q, k, v, do, **kw)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        if dtype == torch.float32:
            assert float((g - r).abs().max()) <= 2e-5 * float(r.abs().max())
        else:
            _bf16_check(g, r)
    keyless = [i for i in range(sq) if (min(i, sk - 1) if causal else sk - 1)
               < (0 if window is None else max(0, i - window))]
    assert not got[0][:, keyless].any()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mixtral-8x22b",
                                  "zamba2-2.7b"])
def test_train_step_on_the_card_equals_the_cpu(cuda, arch):
    """One float32 train step of a smoke config on the card (no host sync
    inside) and on the CPU, the same weights and batch: loss and gradient
    norm within 1e-4 (abs + rel), the updated params by the rule of
    ``test_torch_train.py``, the flash_attention launches 2 an attention
    (remat) on the route for the config's head dim."""
    import dataclasses
    from _perturbed_weights import perturbed_tree
    from repro_torch.configs import get_optimizer_name, get_smoke_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.model import iter_schema
    from repro_torch.optim import cosine_schedule, get_optimizer
    from repro_torch.pytree import leaves
    from repro_torch.train.steps import make_train_step
    cfg = dataclasses.replace(get_smoke_config(arch),
                              activ_dtype=torch.float32)
    tree = perturbed_tree(iter_schema(cfg), 0)
    rng = np.random.default_rng(2)
    batch = {key: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64))
                                   .astype(np.int32))
             for key in ("tokens", "labels")}
    opt = get_optimizer(get_optimizer_name(arch))
    step = make_train_step(cfg, opt, cosine_schedule(1e-3, 10, 100))
    out = []
    for dev in (cuda, torch.device("cpu")):
        params = params_from_numpy(tree, device=dev)
        b = {key: t.to(dev) for key, t in batch.items()}
        before = dict(fa_kernel.ROUTE_LAUNCHES)
        b_before = dict(fa_kernel.BWD_ROUTE_LAUNCHES)
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            out.append(step(params, opt.init(params), b))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if dev.type == "cuda":
            n_attn = (cfg.n_shared_attn if cfg.family == "zamba2"
                      else cfg.n_layers)
            routes = {r: fa_kernel.ROUTE_LAUNCHES[r] - before[r]
                      for r in before}
            want = dict.fromkeys(routes, 0)
            want[fa_kernel.route(torch.float32, cfg.head_dim)] = 2 * n_attn
            assert routes == want
            b_routes = {r: fa_kernel.BWD_ROUTE_LAUNCHES[r] - b_before[r]
                        for r in b_before}
            want = dict.fromkeys(b_routes, 0)
            want[fa_kernel.route(torch.float32, cfg.head_dim)] = n_attn
            assert b_routes == want
    (gp, _, gm), (cp, _, cm) = out
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(gm[key].cpu(), cm[key], rtol=1e-4,
                                   atol=1e-4)
    # AdamW's first step moves a weight by about lr * sign(g): where g is
    # at the float32 noise floor the two devices may step opposite ways
    # (test_torch_train.py's rule)
    lr = float(cm["lr"])
    diff = torch.cat([(g.cpu() - c).abs().reshape(-1)
                      for g, c in zip(leaves(gp), leaves(cp))])
    assert float(diff.max()) <= 2 * lr
    assert float((diff <= 1e-6).float().mean()) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mixtral-8x22b"])
def test_sharded_step_at_w1_on_the_card_equals_the_meshless_step(
        cuda, tmp_path, arch):
    """Two steps of ``train.sharded.make_sharded_train_step`` on a 1-rank
    NCCL group and a (1, 1) ("data", "model") mesh, in turns with the
    meshless ``make_train_step`` from the same weights and batches
    (qwen2-0.5b's smoke config: tied, qkv bias; mixtral-8x22b's: MoE at
    its own capacity factor, so its routing takes the batch slices'
    counts; bf16 activations): losses, grad norms and every param and
    optimizer leaf equal bit for bit, every leaf on its named placements,
    2 flash_attention launches an attention on the route for its head
    dim, no host sync inside a step; then the meshless state restored
    onto the mesh bit for bit."""
    import torch.distributed as dist
    from _perturbed_weights import perturbed_tree
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import iter_schema
    from repro_torch.optim import cosine_schedule, get_optimizer
    from repro_torch.pytree import leaves
    from repro_torch.train import sharded
    from repro_torch.train.steps import make_train_step
    cfg = get_smoke_config(arch)
    params = params_from_numpy(perturbed_tree(iter_schema(cfg), 0),
                               device=cuda)
    opt = get_optimizer("adamw")
    sched = cosine_schedule(1e-3, 10, 100)
    state = opt.init(params)
    rng = np.random.default_rng(3)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        shardings = sharded.state_shardings(mesh, cfg, state)
        d_params, d_state = sh.distribute((params, state), shardings)
        step = make_train_step(cfg, opt, sched)
        s_step = sharded.make_sharded_train_step(cfg, opt, sched, mesh)
        per = []
        for _ in range(2):
            batch = {k: torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (4, 64)).astype(np.int32)).to(cuda)
                for k in ("tokens", "labels")}
            d_batch = sh.distribute(batch, sh.named(
                mesh, sh.batch_specs(mesh, cfg, batch)))
            before = dict(fa_kernel.ROUTE_LAUNCHES)
            c0 = dict(sh.COLLECTIVES)
            torch.cuda.set_sync_debug_mode("error")
            try:
                d_params, d_state, ms = s_step(d_params, d_state, d_batch)
                params, state, mm = step(params, state, batch)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            routes = {r: fa_kernel.ROUTE_LAUNCHES[r] - before[r]
                      for r in before}
            want = dict.fromkeys(routes, 0)
            want[fa_kernel.route(cfg.activ_dtype, cfg.head_dim)] = \
                2 * 2 * cfg.n_layers       # both steps, 2 a layer (remat)
            assert routes == want
            per.append({k: sh.COLLECTIVES[k] - c0[k] for k in c0})
            assert torch.equal(ms["loss"], mm["loss"])
            assert torch.equal(ms["grad_norm"], mm["grad_norm"])
            assert sorted(ms) == sorted(mm)
            if "expert_counts" in mm:
                assert torch.equal(ms["expert_counts"], mm["expert_counts"])
            assert all(torch.equal(a, b) for a, b in zip(
                leaves(sh.gather((d_params, d_state))),
                leaves((params, state))))
            assert all(tuple(x.placements) == s.placements for x, s in zip(
                leaves((d_params, d_state)), leaves(shardings)))
        # one rank: every leaf is its own full tensor, so nothing is
        # gathered; the gradients still ride the batch axis' all-reduce
        assert per[0] == per[1] and per[0]["all_reduce"] > 0
        assert per[0]["all_gather"] == 0
        ck = CheckpointManager(tmp_path / "ckpt")
        ck.save(2, {"params": params, "opt": state}, block=True)
        got, _ = ck.restore(shardings={"params": shardings[0],
                                       "opt": shardings[1]})
        assert all(torch.equal(a.to_local(), b) for a, b in zip(
            leaves(got), leaves({"params": params, "opt": {
                "step": state.step, "inner": state.inner}})))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_expert_parallel_sharded_step_on_the_card(cuda, tmp_path):
    """``chip_smoke.py`` phase 27b's twin: two sharded train steps of the
    kimi-k2 smoke model (float32) with expert parallelism at a (1, 2)
    ("data", "model") mesh, two gloo ranks of CUDA tensors on the one card
    (``_torch_moe_ep_worker.cuda_train_worker``), AdamW and Adafactor at
    the config's capacity factor, against the one-device step with each
    MoE layer per group (``one_device_steps``) at PERF.md §2's train-step
    bounds: the loss 1e-5 relative, the gradient norm 1e-4 relative, the
    params and optimizer state within 2·lr a step taken and within 1e-6 on
    99.9 % of the elements; counts, placements and each step's collectives
    exact."""
    import json
    import multiprocessing
    import os
    import _torch_moe_ep_worker as ew

    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=ew.cuda_train_worker,
                         args=(r, str(tmp_path / "store"), str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
    errors = [f for f in os.listdir(tmp_path) if f.endswith(".error")]
    for name in errors:
        print(name, (tmp_path / name).read_text())
    assert not errors and all(p.exitcode == 0 for p in procs), errors
    for opt_name in ew.OPTIMIZERS:
        case = f"cuda-train-{opt_name}"
        per_rank = [json.loads((tmp_path / f"{case}.{r}.json").read_text())
                    for r in range(2)]
        with np.load(tmp_path / f"{case}.npz") as z:
            got = dict(z)
        want, want_m, drops = ew.one_device_steps(opt_name, 1.25, (1, 2),
                                                  cuda)
        assert sum(drops) > 0
        lr_sum = 0.0
        for i, wm in enumerate(want_m):
            gm = per_rank[0]["metrics"][i]
            assert abs(gm["loss"] - float(wm["loss"])) \
                <= 1e-5 * abs(float(wm["loss"]))
            assert abs(gm["grad_norm"] - float(wm["grad_norm"])) \
                <= 1e-4 * abs(float(wm["grad_norm"]))
            assert gm["expert_counts"] == wm["expert_counts"].tolist()
            lr_sum += float(wm["lr"])
            keys = [k for k in want if k[:2] in (f"p{i + 1}", f"s{i + 1}")]
            diff = np.concatenate([np.abs(got[k] - want[k]).ravel()
                                   for k in keys])
            assert diff.max() <= 2 * lr_sum
            assert (diff <= 1e-6).mean() >= 0.999
        for res in per_rank:
            assert res["metrics"] == per_rank[0]["metrics"]
            assert all(all(ok) for ok in res["placements_ok"])
            per = res["collectives"]
            assert per[0] == per[1] == per_rank[0]["collectives"][0]
            assert per[0]["all_to_all"] == 6 * 2      # 2 layers, remat


@pytest.mark.cuda
def test_dry_run_counts_the_card_step(cuda):
    """``chip_smoke.py`` phase 28a's twin at a shorter cut: qwen2-0.5b at
    its published widths with 2 of its 24 layers (bf16 activations, remat
    "full", AdamW), B 2, S 512.  ``launch.dryrun.count_step`` on meta
    tensors against the same step on the card under ``FlopCounterMode``
    (which cannot see the ctypes kernels): the card's FLOPs plus the meta
    routes' charge for each recorded launch and backward call equal the dry
    run's exactly; the launches and backward calls equal the dry run's
    calls, shape by shape (2 and 1 a layer, tensor-core route); the dry
    run's argument bytes equal the storage of the card's params, optimizer
    state and batch."""
    import dataclasses
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeSpec, input_specs
    from repro_torch.models.model import abstract_params, init_params
    from repro_torch.optim import cosine_schedule, get_optimizer
    from repro_torch.pytree import leaves
    from repro_torch.train.steps import make_train_step

    cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=2)
    b, s = 2, 512
    opt = get_optimizer("adamw")
    step = make_train_step(cfg, opt, cosine_schedule(3e-4, 1, 12))
    meta = abstract_params(cfg)
    rec = dryrun.count_step(step, (meta, opt.init(meta), input_specs(
        cfg, ShapeSpec("train_card", s, b, "train"))))
    params = init_params(cfg, 0, cuda)
    state = opt.init(params)
    toks = np.random.default_rng(28).integers(0, cfg.vocab_size, (b, s))
    batch = {k: torch.from_numpy(toks.astype(np.int32)).to(cuda)
             for k in ("tokens", "labels")}
    assert rec["memory"]["argument_bytes"] == sum(
        t.untyped_storage().nbytes() for t in leaves((params, state, batch)))
    params, state, _ = step(params, state, batch)        # warm-up
    seen, seen_bwd = {}, {}
    real, real_bwd = fa_ops.flash_attention_cuda, fa_ops.flash_attention_bwd_cuda

    def recorded(q, k, v, **kw):
        key = fa_kernel.meta_key(q, k, q_per_kv=kw["q_per_kv"],
                                 causal=kw["causal"], window=kw["window"])
        seen[key] = seen.get(key, 0) + 1
        return real(q, k, v, **kw)

    def recorded_bwd(q, k, v, do, **kw):
        key = fa_kernel.meta_key(q, k, q_per_kv=kw["q_per_kv"],
                                 causal=kw["causal"], window=kw["window"])
        seen_bwd[key] = seen_bwd.get(key, 0) + 1
        return real_bwd(q, k, v, do, **kw)

    before = dict(fa_kernel.ROUTE_LAUNCHES)
    b_before = dict(fa_kernel.BWD_ROUTE_LAUNCHES)
    fa_ops.flash_attention_cuda = recorded
    fa_ops.flash_attention_bwd_cuda = recorded_bwd
    try:
        with FlopCounterMode(display=False) as fc:
            step(params, state, batch)
        torch.cuda.synchronize()
    finally:
        fa_ops.flash_attention_cuda = real
        fa_ops.flash_attention_bwd_cuda = real_bwd
    charged = sum(n * fa_kernel.charge(key)[0] for key, n in seen.items()) \
        + sum(n * fa_kernel.bwd_charge(key)[0] for key, n in seen_bwd.items())
    assert fc.get_total_flops() + charged == rec["executed"]["flops"]
    for calls, name in ((seen, "flash_attention"),
                        (seen_bwd, "flash_attention_bwd")):
        kern = rec["kernels"][name]
        assert {key[:-1] + (str(key[-1]).split(".")[-1],): n
                for key, n in calls.items()} == {
            (c["bh"], c["sq"], c["sk"], c["d"], c["q_per_kv"], c["causal"],
             c["window"], c["dtype"]): c["calls"] for c in kern["calls"]}
    assert rec["kernels"]["flash_attention"]["launches"] == 2 * cfg.n_layers
    assert rec["kernels"]["flash_attention_bwd"]["launches"] == cfg.n_layers
    assert fa_kernel.ROUTE_LAUNCHES["tensor_core"] \
        - before["tensor_core"] == 2 * cfg.n_layers
    assert fa_kernel.BWD_ROUTE_LAUNCHES["tensor_core"] \
        - b_before["tensor_core"] == cfg.n_layers
