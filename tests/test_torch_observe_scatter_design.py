"""The design of observe_scatter's Hopper kernel on the CPU (no GPU, no
JAX): a numpy model of how ``csrc/observe_scatter.cu`` splits a batch and
sums it on chip, held against the port's plain version.  The kernel itself
is held on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

The model: the launch's grid and contiguous chunks of 16-byte vectors (a
scalar head and tail in block 0), the warp rounds whose lanes merge equal
ids, each block's table (direct: slot = id; hashed: open addressing with a
probe limit, an id that finds no slot sending its counts straight to the
outputs), and the flush of every used slot.  Its blocks insert in one order
the card may run them in: rounds in order, lanes in order.  The outputs
(flushed counts plus the overflow's) are integers: exact against the plain
version, in any order.  The model also counts the global atomics each
address receives."""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402
_torch_threads.limit()

from _hypothesis_compat import given, settings, st  # noqa: E402
from repro_torch.dlrm import datagen  # noqa: E402
from repro_torch.kernels.observe_scatter.ref import observe_scatter_ref  # noqa: E402

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "observe_scatter" / "csrc" / "observe_scatter.cu")

# the model's constants; test_constants_match_the_kernel holds them to the
# source's
THREADS = 256
SLOT_BITS = 12
PROBES = 8
FIRST_ROUND_CLAIMS = 512
HASH_MUL = 2654435761
BLOCKS_PER_SM = 4
MIN_CHUNK = 2048
DIRECT_MAX_BINS = 29_056
KERNEL = dict(slot_bits=SLOT_BITS, probes=PROBES, min_chunk=MIN_CHUNK,
              direct_max=DIRECT_MAX_BINS, first_round=FIRST_ROUND_CLAIMS)
# the H100: 132 SMs, 228 KB of shared memory an SM, 1 KB of it reserved per
# block, 2,048 threads an SM
SMS, SM_SHARED, BLOCK_RESERVED, SM_THREADS = 132, 233_472, 1_024, 2_048
# a small table that overflows on small inputs (hypothesis cases)
TINY = dict(slot_bits=3, probes=2, min_chunk=8, direct_max=6,
            first_round=4)


def _source_constants() -> dict:
    return {m[0]: int(m[1]) for m in re.findall(
        r"constexpr (?:int|unsigned) (k\w+) = (\d+)u?;", SOURCE.read_text())}


def test_constants_match_the_kernel():
    k = _source_constants()
    assert k["kThreads"] == THREADS
    assert k["kSlotBits"] == SLOT_BITS
    assert k["kProbes"] == PROBES
    assert k["kFirstRoundClaims"] == FIRST_ROUND_CLAIMS
    assert k["kHashMul"] == HASH_MUL
    assert k["kBlocksPerSm"] == BLOCKS_PER_SM
    assert k["kMinChunk"] == MIN_CHUNK
    assert k["kDirectMaxBins"] == DIRECT_MAX_BINS
    # the direct table of kDirectMaxBins bins fills a block's shared memory
    assert 2 * 4 * _pad4(DIRECT_MAX_BINS) == 232_448
    src = SOURCE.read_text()
    # the grid and chunk rule the model's plan() follows
    for line in ("return direct ? 2 * pad4(n_blocks) : 3 * kSlots + 4;",
                 "const bool claiming = *b.claimed <= kFirstRoundClaims;",
                 "if (!b.claiming) break;",
                 "long long grid = (m + kMinChunk - 1) / kMinChunk;",
                 "grid = grid < 1 ? 1 : (grid > cap ? cap : grid);",
                 "long long head = (16 - (long long)((uintptr_t)ids & 15)) "
                 "% 16 / 4;",
                 "const long long vec_per_block = (n_vec + grid - 1) / grid;",
                 "slot = ((unsigned)bin * kHashMul) >> (32 - kSlotBits);",
                 "slot = (slot + 1) & (kSlots - 1);",
                 "if (n_blocks > kDirectMaxBins) return (int)"
                 "cudaErrorInvalidValue;"):
        assert line in src, line
    # the wrapper picks the mode the model's plan() picks
    assert ('return "direct" if n_blocks <= shared_limit() else "hashed"'
            in (SOURCE.parent.parent / "kernel.py").read_text())


def _pad4(n):
    return (n + 3) // 4 * 4


def plan(m, n_blocks, first_elem=0, c=KERNEL):
    """The launch: (direct, grid, head, n_vec, vectors per block) for ``m``
    ids whose first lies ``first_elem`` int32s past a 16-byte boundary."""
    direct = n_blocks <= c["direct_max"]
    smem = 4 * (2 * _pad4(n_blocks) if direct else (3 << c["slot_bits"]) + 4)
    per_sm = max(1, min(BLOCKS_PER_SM, SM_SHARED // (smem + BLOCK_RESERVED),
                        SM_THREADS // THREADS))
    grid = min(max(-(-m // c["min_chunk"]), 1), per_sm * SMS)
    head = min((4 - first_elem % 4) % 4, m)
    n_vec = (m - head) // 4
    return direct, grid, head, n_vec, -(-n_vec // grid)


def rounds(m, head, n_vec, vpb, grid):
    """(block, round) of every id: the head and tail are block 0's round
    -1; vector v of a chunk goes to round ((v - v0) // 32) * 4 + j for its
    j-th id (one warp's lanes, one id each)."""
    block = np.zeros(m, np.int64)
    rnd = np.full(m, -1, np.int64)
    v = np.arange(n_vec)
    b = v // vpb if n_vec else v
    for j in range(4):
        block[head + 4 * v + j] = b
        rnd[head + 4 * v + j] = ((v - b * vpb) // 32) * 4 + j
    assert (b < grid).all()
    return block, rnd


def slot_of(key, c):
    return ((key * HASH_MUL) & 0xFFFFFFFF) >> (32 - c["slot_bits"])


def _hashed_inserts(keys, rnds, c):
    """One block's inserts into the hashed table, in order -> whether each
    landed in a slot (else it goes straight out).  A key's first insert
    claims or finds its slot (keys never move), so its later ones land
    there too, or go out too.  The first round (the warps' first vectors:
    rounds below 32, and the head and tail) decides: after more than
    ``c["first_round"]`` claims the block claims no more slots, and a key
    without one goes out."""
    mask = (1 << c["slot_bits"]) - 1
    table, where, placed, claiming = set(), {}, [], None
    for k, r in zip(keys, rnds):
        if r >= 32 and claiming is None:
            claiming = len(table) <= c["first_round"]
        if k not in where and claiming is not False:
            s, where[k] = slot_of(k, c), False
            for _ in range(c["probes"]):
                if s not in table:
                    table.add(s)
                    where[k] = True
                    break
                s = (s + 1) & mask
        placed.append(where.get(k, False))
    assert len(table) <= mask + 1
    return np.array(placed, bool)


def model(ids, cursor, n_blocks, period, keep=None, first_elem=0, c=KERNEL):
    """-> (hist, pebs, hist_atomics, pebs_atomics, grid): the outputs and
    the global atomics each address receives."""
    m = ids.size
    direct, grid, head, n_vec, vpb = plan(m, n_blocks, first_elem, c)
    block, rnd = rounds(m, head, n_vec, vpb, grid)
    bins = np.where(ids < 0, ids.astype(np.int64) + n_blocks, ids)
    valid = (bins >= 0) & (bins < n_blocks)
    pos = (np.int64(cursor) + np.arange(m)).astype(np.int32)   # int32 wrap
    hit = valid & (pos % period == 0)
    if keep is not None:
        hit &= keep.astype(bool)
    out = [np.zeros(n_blocks, np.int64) for _ in range(4)]
    hist, pebs, h_at, p_at = out
    order = np.lexsort((np.arange(m), rnd, block))   # block, round, lane
    order = order[valid[order]]
    edges = np.searchsorted(block[order], np.arange(grid + 1))
    for b in range(grid):
        sel = order[edges[b]:edges[b + 1]]
        if sel.size == 0:
            continue
        key, r, h = bins[sel], rnd[sel], hit[sel]
        # the warp merge: one insert per (round, distinct id), in the order
        # of their first lanes
        _, first, inv = np.unique(r * n_blocks + key, return_index=True,
                                  return_inverse=True)
        by_first = np.argsort(first, kind="stable")
        ins_key, ins_r = key[first][by_first], r[first][by_first]
        ins_w = (np.bincount(inv)[by_first],
                 np.bincount(inv, weights=h).astype(np.int64)[by_first])
        if direct:
            placed = np.ones(ins_key.size, bool)
        else:
            placed = _hashed_inserts(ins_key.tolist(), ins_r.tolist(), c)
        for arr, at, w in ((hist, h_at, ins_w[0]), (pebs, p_at, ins_w[1])):
            # overflow: each insert with a count sends it on its own
            off = ~placed & (w > 0)
            np.add.at(arr, ins_key[off], w[off])
            np.add.at(at, ins_key[off], 1)
            # flush: one atomic per used slot (direct: bin) with a count
            keys, kinv = np.unique(ins_key[placed], return_inverse=True)
            tot = np.bincount(kinv, weights=w[placed],
                              minlength=keys.size).astype(np.int64)
            arr[keys] += tot
            at[keys[tot > 0]] += 1
    return hist, pebs, h_at, p_at, grid


def _plain(ids, cursor, n_blocks, period, keep=None):
    h, p = observe_scatter_ref(
        torch.from_numpy(ids), torch.tensor(cursor, dtype=torch.int32),
        n_blocks=n_blocks, period=period,
        keep=None if keep is None else torch.from_numpy(keep))
    return h.numpy(), p.numpy()


def _check(ids, cursor, n_blocks, period, keep=None, first_elem=0,
           c=KERNEL):
    got = model(ids, cursor, n_blocks, period, keep, first_elem, c)
    want = _plain(ids, cursor, n_blocks, period, keep)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    return got


@settings(max_examples=60, deadline=None)
@given(m=st.integers(0, 600), n_blocks=st.integers(1, 40),
       spread=st.integers(0, 3), period=st.integers(1, 9),
       cursor=st.integers(-2 ** 31, 2 ** 31 - 1), first=st.integers(0, 3),
       seed=st.integers(0, 2 ** 31 - 1), tiny=st.integers(0, 1))
def test_model_matches_plain_on_any_input(m, n_blocks, spread, period,
                                          cursor, first, seed, tiny):
    """Ids out of range on both sides (negatives wrap once), any cursor
    (int32 wrap), any start within a vector, a keep mask; with the kernel's
    table and with a tiny one that overflows and takes the hashed mode from
    n_blocks = 7."""
    rng = np.random.default_rng(seed)
    lo, hi = [(0, 1), (-n_blocks - 2, n_blocks + 3), (0, n_blocks),
              (-1, 2)][spread]
    ids = rng.integers(lo, hi, m).astype(np.int32)
    keep = rng.random(m) < 0.6
    c = TINY if tiny else KERNEL
    for km in (None, keep):
        _check(ids, cursor, n_blocks, period, km, first, c)


@pytest.mark.parametrize("kind", ["all_distinct", "one_page", "quarter_hot",
                                  "five_percent_hot"])
@pytest.mark.parametrize("c", [KERNEL, TINY], ids=["kernel", "tiny"])
def test_model_chunks_that_overflow_or_merge(kind, c):
    """All-distinct ids overflow every table; one page merges into one slot
    per block; a quarter, or a twentieth, of the ids on one page among
    distinct ones: the blocks stop claiming after their first round, and
    with the kernel's table the hot page still takes one atomic a block."""
    rng = np.random.default_rng(1)
    n_blocks, m = 1_000_003, 20_011
    share = {"quarter_hot": 0.25, "five_percent_hot": 0.05}.get(kind, 0.0)
    if kind == "one_page":
        ids = np.full(m, 777)
    else:
        ids = np.where(rng.random(m) < share, 777,
                       rng.permutation(n_blocks)[:m])
    ids = ids.astype(np.int32)
    hist, pebs, h_at, p_at, grid = _check(ids, 5, n_blocks, 7,
                                          rng.random(m) < 0.5, 1, c)
    _, _, _, n_vec, vpb = plan(m, n_blocks, 1, c)
    blocks = -(-n_vec // vpb)           # blocks with ids
    if kind == "one_page":
        assert h_at[777] == h_at.sum() == blocks
    if kind == "all_distinct":          # every id its own atomic
        assert h_at.sum() == m
    if share and c is KERNEL:
        assert h_at[777] == blocks


@pytest.mark.parametrize("n_blocks", [DIRECT_MAX_BINS, DIRECT_MAX_BINS + 1])
def test_model_at_the_direct_map_limit(n_blocks):
    rng = np.random.default_rng(n_blocks)
    m = 3 * n_blocks + 5
    ids = rng.integers(-3, n_blocks + 3, m).astype(np.int32)
    direct = plan(m, n_blocks)[0]
    assert direct == (n_blocks <= DIRECT_MAX_BINS)
    _check(ids, 400, n_blocks, 401, rng.random(m) < 0.7, 3)


def test_plan_covers_the_stream_once():
    for m in (0, 1, 3, 4, 5, 2_047, 2_400_001, 40_003):
        for first in range(4):
            for n_blocks in (88, 5_000, 5_242_880):
                direct, grid, head, n_vec, vpb = plan(m, n_blocks, first)
                assert 1 <= grid <= BLOCKS_PER_SM * SMS
                assert 0 <= m - head - 4 * n_vec <= 3 and head <= 3
                assert grid * vpb >= n_vec
                if m:
                    block, _ = rounds(m, head, n_vec, vpb, grid)
                    assert block.max() < grid


def test_paper_scale_grid():
    """Phase 12's shapes: the paper batch takes a persistent grid of four
    blocks an SM; SMALL and the KV scenario the direct table, sized by m;
    the direct-map limit one block an SM (its table fills the SM)."""
    assert plan(2_400_000, 5_242_880)[:2] == (False, BLOCKS_PER_SM * SMS)
    assert plan(40_000, 5_000)[:2] == (True, 20)
    assert plan(16_384, 88)[:2] == (True, 8)
    assert plan(2_400_000, DIRECT_MAX_BINS)[:2] == (True, SMS)


def test_paper_draw_hottest_page_takes_one_atomic_per_block():
    """The online path's first paper-scale batch (Zipf 1.31 over 5,242,880
    pages): the hottest page (a quarter of the ids) receives at most one
    access atomic per block, and a batch sends about 0.44 M access
    atomics, against 1.4 M after the warp merge alone."""
    spec = datagen.DLRMTraceSpec(n_params=5_368_709_120)
    ids = next(iter(datagen.phase_shift_epochs(
        spec, n_epochs=1, batches_per_epoch=1, shift_at=1)))[0]
    n = spec.n_pages
    hist, pebs, h_at, p_at, grid = _check(ids, 0, n, 401)
    hot = int(np.argmax(hist))
    assert hist[hot] > 0.25 * ids.size
    assert h_at[hot] <= grid and p_at[hot] <= grid
    assert h_at.max() <= grid
    assert 400_000 < h_at.sum() < 480_000
    # without the table: one atomic per (warp round, distinct id)
    merged = sum(np.unique(ids[i:i + 32]).size
                 for i in range(0, ids.size, 32))
    assert merged > 3 * h_at.sum()
    assert math.isclose(h_at[hot], grid, rel_tol=0.01)
