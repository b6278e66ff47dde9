"""The designs of two of the port's hand-written kernels, on the CPU (no GPU,
no JAX): numpy models of what ``hist_select`` and ``embedding_bag``'s tiled
route compute, step by step, held against the port's plain versions, and
the route rule that picks embedding_bag's kernel.  The kernels themselves
are held on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

``hist_select`` (``csrc/hist_select.cu``): each (row, segment) keeps its
candidates as an interval [lo, hi] of u = key + 2**31; a pass histograms the
candidates on the digit just below the interval's common prefix, with each
bin's smallest and largest key; the resolve picks the bin that holds the
k-th largest by a suffix scan, and its [min, max] is the next interval; a
(row, segment) is done when min == max.  Tolerance: exact.

``embedding_bag``'s tiled route (``csrc/embedding_bag_tiled.cuh``): a tile
of bags, its distinct rows in a hash table, counters bumped once per
distinct row, distinct rows placed on chip (three or more lookups first,
then two, then one, up to the capacity; the rest read from global
memory), each bag
pooled l = 0 .. L-1 in order.  The pooled rows: 1e-5 of the plain version
(float32: the same products summed in another order and without fused
multiply-adds); the plan's own per-bag order gives the per-bag route's
bits; counters exact."""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402
_torch_threads.limit()
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.kernels.embedding_bag import embedding_bag  # noqa: E402
from repro_torch.kernels.embedding_bag import kernel as eb_kernel  # noqa: E402
from repro_torch.kernels.hist_select.ref import kth_key_ref  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
ALL_ONES = 0xFFFFFFFF


def _constants(path: Path) -> dict:
    """``constexpr int kName = value;`` lines of a CUDA source."""
    text = path.read_text()
    return {m[0]: int(m[1]) for m in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}


HS = _constants(CSRC / "hist_select" / "csrc" / "hist_select.cu")
EB = _constants(CSRC / "embedding_bag" / "csrc" / "embedding_bag_tiled.cuh")


# ------------------------------------------------------------- hist_select
def row_partition(first_elem: int, n: int):
    """The kernel's split of a row that starts ``first_elem`` int32s past a
    16-byte boundary: (head, number of 16-byte vectors, tail)."""
    head = min((4 - first_elem % 4) % 4, n)
    nvec = (n - head) // 4
    return head, nvec, n - head - 4 * nvec


def hist_select_model(keys, seg, ks, bits=8):
    """numpy model of the kernel: -> ((B, S) int64 thresholds, (B, S)
    passes each (row, segment) read keys in)."""
    u = keys.astype(np.int64) + (1 << 31)
    rows, n = u.shape
    segs = len(ks)
    seg = np.zeros(n, np.int64) if seg is None else seg.astype(np.int64)
    n_bins = 1 << bits
    n_passes = -(-32 // bits)
    out = np.full((rows, segs), -1, np.int64)
    passes = np.zeros((rows, segs), np.int64)
    for b in range(rows):
        for s, k in enumerate(ks):
            if k == 0:                       # resolved before any pass
                out[b, s] = ALL_ONES
                continue
            lo, hi, krem = 0, ALL_ONES, k
            member = u[b][seg == s]
            for p in range(n_passes):
                hb = (lo ^ hi).bit_length() - 1
                shift = max(hb - bits + 1, 0)
                mask = (1 << (hb - shift + 1)) - 1
                assert mask < n_bins
                cand = member[(member >= lo) & (member <= hi)]
                digit = (cand >> shift) & mask
                counts = np.bincount(digit, minlength=n_bins)
                passes[b, s] += 1
                suffix = np.cumsum(counts[::-1])[::-1]
                if suffix[0] < krem:         # k beyond the segment
                    out[b, s] = 0
                    break
                j = int(np.nonzero(suffix >= krem)[0].max())
                above = int(suffix[j + 1]) if j + 1 < n_bins else 0
                krem -= above
                in_bin = cand[digit == j]
                lo, hi = int(in_bin.min()), int(in_bin.max())
                if lo == hi:
                    out[b, s] = lo
                    break
            assert out[b, s] >= 0, "every cell resolves within the passes"
    return out, passes


def _ref(keys, seg, ks):
    return kth_key_ref(torch.from_numpy(keys),
                       None if seg is None else torch.from_numpy(seg),
                       ks).numpy()


def _paper_like(rng, n):
    """Rows shaped like the online path's: access counts that are mostly 0
    (about 98 % one tie value), their mask, and float scores as keys."""
    h = np.where(rng.random(n) < 0.02, np.minimum(rng.zipf(1.5, n), 577),
                 0).astype(np.int32)
    hf = h.astype(np.float32)
    score = np.where(h > 0, hf / hf.max(), np.float32(-1.0)).astype(np.float32)
    return np.stack([h, (h > 0).astype(np.int32),
                     (0.5 * hf).view(np.int32), score.view(np.int32)])


def every_pass_keys(rng, shape):
    """Keys whose four bytes each come from {0, 1, 254, 255}: every bin the
    search picks still holds keys that differ in the next byte, so the
    search needs every pass."""
    b = rng.choice(np.asarray([0, 1, 254, 255], np.uint32), size=shape + (4,))
    u = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    return u.astype(np.uint32).view(np.int32)


def test_constants_match_the_kernel():
    """The model's default digit width is the kernel's, and the pass count
    follows from it."""
    assert HS["kThreads"] % 32 == 0 and HS["kUnroll"] >= 1
    src = (CSRC / "hist_select" / "csrc" / "hist_select.cu").read_text()
    assert HS["kBits"] == 8
    assert "kPasses = (32 + kBits - 1) / kBits" in src


@pytest.mark.parametrize("bits", [8, 11])
@pytest.mark.parametrize("kind", ["ties", "uniform", "paper"])
def test_hist_select_model_matches_plain(bits, kind):
    rng = np.random.default_rng(bits + len(kind))
    n = 4_099                                        # n % 4 == 3
    if kind == "ties":
        keys = rng.integers(-3, 4, (3, n)).astype(np.int32)
    elif kind == "uniform":
        keys = rng.integers(-2 ** 31, 2 ** 31 - 1, (3, n),
                            dtype=np.int64).astype(np.int32)
    else:
        keys = _paper_like(rng, n)
    for k in (0, 1, 7, n // 3, n):
        got, _ = hist_select_model(keys, None, (k,), bits)
        np.testing.assert_array_equal(got, _ref(keys, None, (k,)),
                                      err_msg=f"k={k}")


@pytest.mark.parametrize("bits", [8, 11])
def test_hist_select_model_segments_with_padding(bits):
    rng = np.random.default_rng(3)
    n = 1_001                                        # n % 4 == 1
    keys = rng.integers(-50, 50, (2, n)).astype(np.int32)
    keys[:, ::5] = rng.integers(-2 ** 31, 2 ** 31 - 1, (2, len(keys[0, ::5])),
                                dtype=np.int64)
    seg = np.minimum(np.arange(n) * 3 // n, 2).astype(np.int32)
    seg[1::7] = -1
    seg[-3:] = 5                                     # outside [0, S): padding
    lens = [int((seg == s).sum()) for s in range(3)]
    for ks in ((0, lens[1], 1), (lens[0], 0, lens[2] // 2),
               (1, 1, lens[2])):
        got, _ = hist_select_model(keys, seg, ks, bits)
        np.testing.assert_array_equal(got, _ref(keys, seg, ks),
                                      err_msg=f"ks={ks}")


def test_hist_select_model_degenerate_k_gives_zero():
    """k beyond the segment: 0, as the byte-level search of the reference
    kernel degenerates (and 0xFFFFFFFF for k = 0 on an empty segment)."""
    keys = np.arange(12, dtype=np.int32).reshape(1, 12)
    seg = np.asarray([0] * 5 + [1] * 7, np.int32)
    got, passes = hist_select_model(keys, seg, (6, 0))
    assert got.tolist() == [[0, ALL_ONES]]
    assert passes.tolist() == [[1, 0]]
    got, _ = hist_select_model(keys, np.full(12, -1, np.int32), (3,))
    assert got.tolist() == [[0]]


def test_hist_select_model_stops_early_on_tie_heavy_rows():
    """The online path's rows: the float rows resolve in one pass, the
    integer rows in the passes their small range needs; distinct uniform
    keys need every pass at 8 bits."""
    rng = np.random.default_rng(12)
    n = 20_003
    keys = _paper_like(rng, n)
    k = n // 10                       # beyond the non-zero counts: the tie
    got, passes = hist_select_model(keys, None, (k,))
    np.testing.assert_array_equal(got, _ref(keys, None, (k,)))
    assert passes[2:, 0].tolist() == [1, 1]
    assert passes[1, 0] == 2          # 0 / 1: [2**31, 2**31 + 1] after one
    assert passes[0, 0] <= 3          # counts up to 577: two more bytes
    for bits, want in ((8, 4), (11, 3)):
        hard = every_pass_keys(rng, (1, n))
        got, passes = hist_select_model(hard, None, (n // 2,), bits)
        np.testing.assert_array_equal(got, _ref(hard, None, (n // 2,)))
        assert passes[0, 0] == want


@settings(max_examples=60, deadline=None)
@given(n=st.integers(1, 300), rows=st.integers(1, 3),
       spread=st.sampled_from([2, 50, 2 ** 31]), bits=st.sampled_from([8, 11]),
       data=st.data())
def test_hist_select_model_any_input(n, rows, spread, bits, data):
    rng = np.random.default_rng(data.draw(st.integers(0, 2 ** 16)))
    lo = -min(spread, 2 ** 31)
    keys = rng.integers(lo, min(spread, 2 ** 31 - 1), (rows, n),
                        dtype=np.int64).astype(np.int32)
    seg = rng.integers(-1, 3, n).astype(np.int32)
    lens = [int((seg == s).sum()) for s in range(3)]
    ks = tuple(data.draw(st.integers(0, m)) for m in lens)
    got, _ = hist_select_model(keys, seg, ks, bits)
    np.testing.assert_array_equal(got, _ref(keys, seg, ks))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 1_000_001, 1_000_002,
                               1_000_003])
@pytest.mark.parametrize("first", [0, 1, 2, 3])
def test_row_partition_covers_the_row_once(n, first):
    """Rows start at keys + b * n: with n % 4 != 0 they start off a 16-byte
    boundary; head + 16-byte body + tail read every key once, the body on
    16-byte boundaries, and the head and tail fit the lanes given them."""
    head, nvec, tail = row_partition(first, n)
    assert head + 4 * nvec + tail == n and 0 <= head <= 3 and 0 <= tail <= 3
    if nvec:
        assert (first + head) % 4 == 0


def _thread_runs(c, u):
    """The pass's counting for one warp's 32 lanes, each with its keys' bin
    ids ``c`` (-1 for no candidate) and keys ``u``: a lane counts the first
    bin it meets in registers (count, smallest, largest key) and adds keys
    of any other bin to the warp's shared bins one at a time.  Returns the
    per-bin (count, min, max) after the flush and the shared-memory adds."""
    cnt = np.zeros(256, np.int64)
    lo = np.full(256, ALL_ONES, np.int64)
    hi = np.full(256, -1, np.int64)
    adds = 0
    for lane_c, lane_u in zip(c, u):
        run = None
        for ci, ui in zip(lane_c, lane_u):
            if ci < 0:
                continue
            if run is None:
                run = [int(ci), 0, int(ui), int(ui)]
            if ci == run[0]:
                run[1] += 1
                run[2], run[3] = min(run[2], ui), max(run[3], ui)
            else:
                cnt[ci] += 1
                lo[ci], hi[ci] = min(lo[ci], ui), max(hi[ci], ui)
                adds += 1
        if run is not None:                          # the flush
            b_, n_, l_, h_ = run
            cnt[b_] += n_
            lo[b_], hi[b_] = min(lo[b_], l_), max(hi[b_], h_)
    return cnt, lo, hi, adds


@pytest.mark.parametrize("share", [1.0, 0.984, 0.5])
def test_thread_runs_count_every_key(share):
    """Every candidate is counted once, each bin keeps its smallest and
    largest key, and keys of a lane's first bin cost no shared add: on
    rows of one tie value a warp makes no shared add at all."""
    rng = np.random.default_rng(int(share * 1000))
    tie = np.where(rng.random((64, 32, 16)) < share, 1, 0)
    u = np.where(tie, 7 << 24 | 5,
                 rng.integers(0, 2 ** 32, (64, 32, 16), dtype=np.int64))
    c = np.where(rng.random(u.shape) < 0.01, -1, u >> 24)
    want_cnt = np.zeros(256, np.int64)
    want_lo = np.full(256, ALL_ONES, np.int64)
    want_hi = np.full(256, -1, np.int64)
    keep = c >= 0
    np.add.at(want_cnt, c[keep], 1)
    np.minimum.at(want_lo, c[keep], u[keep])
    np.maximum.at(want_hi, c[keep], u[keep])
    got_cnt = np.zeros(256, np.int64)
    got_lo = np.full(256, ALL_ONES, np.int64)
    got_hi = np.full(256, -1, np.int64)
    adds = 0
    for wc, wu in zip(c, u):
        cnt, lo, hi, a = _thread_runs(wc, wu)
        got_cnt += cnt
        got_lo, got_hi = np.minimum(got_lo, lo), np.maximum(got_hi, hi)
        adds += a
    np.testing.assert_array_equal(got_cnt, want_cnt)
    np.testing.assert_array_equal(got_lo, want_lo)
    np.testing.assert_array_equal(got_hi, want_hi)
    if share == 1.0:
        assert adds == 0


# ------------------------------------------------ embedding_bag's tile plan
def tile_hash(row: int) -> int:
    return ((row * 2654435761) & 0xFFFFFFFF) >> (32 - EB["kHashBits"])


def tile_plan(ids, block_rows, n_counts):
    """One tile's plan: (per-lookup resident index or -1, resident rows,
    counter increments), as the kernel builds it."""
    slots = 1 << EB["kHashBits"]
    table_row = np.full(slots, -1, np.int64)
    table_cnt = np.zeros(slots, np.int64)
    where = np.empty(len(ids), np.int64)
    for i, row in enumerate(ids):
        h = tile_hash(int(row))
        probes = 0
        while table_row[h] not in (-1, row):
            h = (h + 1) & (slots - 1)
            probes += 1
            assert probes < slots
        table_row[h] = row
        table_cnt[h] += 1
        where[i] = h
    used = table_row >= 0
    inc = np.zeros(n_counts, np.int64)
    np.add.at(inc, table_row[used] // block_rows, table_cnt[used])
    resident, res_of = [], np.full(slots, -1, np.int64)
    for need in (lambda c: c >= 3, lambda c: c == 2, lambda c: c == 1):
        for h in np.nonzero(used & need(table_cnt))[0]:
            if len(resident) < EB["kResident"]:
                res_of[h] = len(resident)
                resident.append(int(table_row[h]))
    return res_of[where], np.asarray(resident, np.int64), inc


def tiled_model(storage, idx, w, counts, block_rows):
    """The tiled route in numpy float32, per tile and 128-byte slice: the
    resident rows' slices staged, every bag summed in order."""
    b, l = idx.shape
    d = storage.shape[1]
    per_tile = EB["kTileLookups"] // l
    slice_elems = EB["kSliceBytes"] // storage.itemsize
    out = np.zeros((b, d), np.float32)
    counts = counts.astype(np.int64).copy()
    overflowed = False
    for b0 in range(0, b, per_tile):
        ids = idx[b0:b0 + per_tile].reshape(-1)
        where, resident, inc = tile_plan(ids, block_rows, len(counts))
        counts += inc
        overflowed |= len(np.unique(ids)) > EB["kResident"]
        for c0 in range(0, d, slice_elems):
            stage = storage[resident, c0:c0 + slice_elems]
            for bb in range(min(per_tile, b - b0)):
                acc = np.zeros(slice_elems, np.float32)
                for j in range(l):
                    i = bb * l + j
                    x = (stage[where[i]] if where[i] >= 0 else
                         storage[ids[i], c0:c0 + slice_elems])
                    acc = acc + np.float32(w[b0 + bb, j]) * x
                out[b0 + bb, c0:c0 + slice_elems] = acc
    return out, counts.astype(np.int32), overflowed


def per_bag_model(storage, idx, w):
    """Each bag summed in order straight from the storage (the per-bag
    route's arithmetic)."""
    out = np.zeros((idx.shape[0], storage.shape[1]), np.float32)
    for bb in range(idx.shape[0]):
        acc = np.zeros(storage.shape[1], np.float32)
        for j in range(idx.shape[1]):
            acc = acc + np.float32(w[bb, j]) * storage[idx[bb, j]]
        out[bb] = acc
    return out


@pytest.mark.parametrize("ids_kind,b,l", [("zipf", 130, 16), ("uniform", 70, 16),
                                          ("zipf", 5, 1_000), ("zipf", 1, 16),
                                          ("hot", 64, 16)])
def test_tile_plan_matches_plain(ids_kind, b, l):
    rng = np.random.default_rng(b + l)
    n, d, block_rows = 4_000, 128, 4
    storage = rng.normal(size=(n, d)).astype(np.float32)
    if ids_kind == "zipf":
        idx = ((rng.zipf(1.3, (b, l)) - 1) % n).astype(np.int32)
    elif ids_kind == "hot":              # 200 rows: every repeat on chip
        idx = rng.integers(0, 200, (b, l)).astype(np.int32)
    else:
        idx = rng.permutation(n)[:b * l].reshape(b, l).astype(np.int32)
    w = rng.uniform(0.5, 1.5, (b, l)).astype(np.float32)
    carry = rng.integers(0, 5, n // block_rows).astype(np.int32)
    got, got_counts, overflowed = tiled_model(storage, idx, w, carry,
                                              block_rows)
    ref, ref_counts = embedding_bag(torch.from_numpy(storage),
                                    torch.from_numpy(idx),
                                    torch.from_numpy(carry),
                                    torch.from_numpy(w),
                                    block_rows=block_rows)
    if l <= 16:
        np.testing.assert_allclose(got, ref.numpy(), rtol=1e-5, atol=1e-5)
    # any L: within the float32 bound of an L-term sum, against float64
    terms = w[:, :, None].astype(np.float64) * storage[idx].astype(np.float64)
    exact = terms.sum(axis=1)
    bound = l * 2.0 ** -24 * np.abs(terms).sum(axis=1)
    assert np.all(np.abs(got - exact) <= bound)
    assert np.all(np.abs(ref.numpy() - exact) <= bound)
    np.testing.assert_array_equal(got_counts, ref_counts.numpy())
    # the same order of sums as the per-bag route: the same bits
    np.testing.assert_array_equal(got, per_bag_model(storage, idx, w))
    if ids_kind == "hot":
        assert overflowed is False


def test_tile_plan_overflow_and_priority():
    """More distinct rows than places: rows looked up three times or more
    take places first, then twice, then once; the rest are read from global
    memory, and every lookup still pools its own row."""
    cap = EB["kResident"]
    twice = np.arange(1_000, 1_000 + cap - 60)      # looked up twice
    thrice = np.arange(5_000, 5_000 + 40)           # 40 rows looked up 3x
    once = np.arange(9_000, 9_000 + 100)            # 100 rows looked up once
    ids = np.concatenate([np.repeat(twice, 2), np.repeat(thrice, 3), once])
    ids = np.random.default_rng(0).permutation(ids)
    assert len(ids) <= EB["kTileLookups"]
    where, resident, inc = tile_plan(ids, 4, 3_000)
    assert len(resident) == cap
    assert set(thrice) <= set(resident.tolist())
    placed = where >= 0
    np.testing.assert_array_equal(resident[where[placed]], ids[placed])
    assert set(twice) <= set(resident.tolist())
    assert (~placed).sum() == 80                     # 80 of the 100 singles
    assert inc.sum() == len(ids)


def test_tile_sizes_fit_the_hash_and_shared_memory():
    assert EB["kTileLookups"] <= (1 << EB["kHashBits"]) // 2
    assert EB["kSliceBytes"] % 16 == 0                 # 16 bytes a lane
    assert EB["kTileThreads"] % (EB["kSliceBytes"] // 16) == 0
    assert eb_kernel.TILE_LOOKUPS == EB["kTileLookups"]
    assert eb_kernel.SLICE_BYTES == EB["kSliceBytes"]
    # TileSmem: the stage, weights, hash rows and values, places, resident
    # rows and a counter; three blocks an SM (228 KB, 1 KB each reserved)
    smem = (EB["kResident"] * EB["kSliceBytes"] + EB["kTileLookups"] * 6
            + (1 << EB["kHashBits"]) * 8 + EB["kResident"] * 4 + 16)
    assert 3 * (smem + 1024) <= 233_472

# ------------------------------------------------------------ route rules
@pytest.mark.parametrize("dtype,d,l,aligned,want", [
    (torch.float32, 256, 16, True, "tiled"),         # the paper shape
    (torch.bfloat16, 256, 16, True, "tiled"),
    (torch.float32, 64, 1, True, "tiled"),
    (torch.float32, 128, 1_024, True, "tiled"),
    (torch.bfloat16, 128, 3, True, "tiled"),
    (torch.float32, 96, 16, True, "tiled"),          # three slices
    (torch.bfloat16, 64, 16, True, "tiled"),         # one slice
    (torch.float32, 250, 16, True, "per_bag"),       # not whole slices
    (torch.float32, 20, 16, True, "per_bag"),
    (torch.bfloat16, 100, 16, True, "per_bag"),
    (torch.float32, 256, 1_025, True, "per_bag"),    # beyond a tile
    (torch.float32, 256, 0, True, "per_bag"),
    (torch.float32, 256, 16, False, "per_bag"),      # misaligned storage
])
def test_embedding_bag_route(dtype, d, l, aligned, want):
    assert eb_kernel.route(dtype, d, l, aligned) == want


def test_embedding_bag_route_refuses_other_dtypes():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        eb_kernel.route(torch.float16, 256, 16, True)
