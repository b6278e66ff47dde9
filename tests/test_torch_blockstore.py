"""TieredStore: the port's vectorised promote/demote vs the reference's
sequential loops, on the same inputs.

Tolerance: exact.  Storage rows are copies and the maps are integers, so
the port's storage and both maps must be bit-identical to the reference's
after every call (duplicates, -1 padding, already-fast ids, overflow past
n_slots and eviction write-back included)."""
import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import TieredStore as JStore  # noqa: E402
from repro_torch.core import TieredStore  # noqa: E402


def make_pair(n_rows=64, dim=8, block_rows=4, n_slots=4, seed=None):
    if seed is None:
        data = np.arange(n_rows * dim, dtype=np.float32).reshape(n_rows, dim)
    else:
        data = np.random.default_rng(seed).normal(
            size=(n_rows, dim)).astype(np.float32)
    return (data,
            JStore.create(jnp.asarray(data), block_rows=block_rows,
                          n_slots=n_slots),
            TieredStore.create(torch.from_numpy(data), block_rows=block_rows,
                               n_slots=n_slots))


def assert_same(j, t):
    np.testing.assert_array_equal(t.storage.numpy(), np.asarray(j.storage))
    np.testing.assert_array_equal(t.slot_to_block.numpy(),
                                  np.asarray(j.slot_to_block))
    np.testing.assert_array_equal(t.block_to_slot.numpy(),
                                  np.asarray(j.block_to_slot))
    assert t.slot_to_block.dtype == t.block_to_slot.dtype == torch.int32


@pytest.mark.parametrize("steps", [
    [[0, 7, 15]],                                  # free slots only
    [[3, -1, 5, -1]],                              # -1 padding
    [[2, 2, 9, 2, 9]],                             # duplicates
    [[1, 6], [6, 1, 11]],                          # already-fast ids
    [[0, 1, 2, 3, 4, 5, 6]],                       # overflow past n_slots
    [[0, 1], [4, 5, 6, 7, 8], [8, 12, 13]],        # eviction of occupants
    [[1, 2, 3], [3, 10, 10, 11, 12, 13, 14]],      # dup + overflow + evict
])
def test_promote_sequences_match_reference(steps):
    data, j, t = make_pair(seed=len(steps))
    for ids in steps:
        j = j.promote(jnp.asarray(ids, jnp.int32))
        t = t.promote(torch.tensor(ids, dtype=torch.int32))
        assert_same(j, t)
        assert int(t.fast_occupancy()) == int(j.fast_occupancy())
    rows = np.arange(64)
    np.testing.assert_array_equal(t.gather(torch.from_numpy(rows)).numpy(),
                                  data)


def test_demote_migrate_scatter_update_match_reference():
    _, j, t = make_pair(seed=3)
    for op in (
        lambda s, a: s.promote(a([2, 5, 9, 14])),
        lambda s, a: s.demote(a([5, 5, -1, 7, 14])),        # dup, -1, slow
        lambda s, a: s.migrate(a([1, 3, 3, 8, 9]), a([2])),
        lambda s, a: s.migrate(a([0, 4, 6, 10, 11]), None),  # evicts
    ):
        j = op(j, lambda ids: jnp.asarray(ids, jnp.int32))
        t = op(t, lambda ids: torch.tensor(ids, dtype=torch.int32))
        assert_same(j, t)
    # write-through update lands in whichever tier each row lives in, and
    # an eviction afterwards writes the fast copy back
    rows = np.array([0, 17, 40, 63], np.int32)
    vals = np.random.default_rng(4).normal(size=(4, 8)).astype(np.float32)
    j = j.scatter_update(jnp.asarray(rows), jnp.asarray(vals))
    t2 = t.scatter_update(torch.from_numpy(rows), torch.from_numpy(vals))
    assert t2.storage is not t.storage                  # a copy, as in JAX
    assert_same(j, t2)
    j = j.promote(jnp.asarray([12, 13, 14, 15], jnp.int32))
    t2 = t2.promote(torch.tensor([12, 13, 14, 15], dtype=torch.int32))
    assert_same(j, t2)
    np.testing.assert_array_equal(t2.gather(torch.from_numpy(rows)).numpy(),
                                  vals)


def test_empty_plan_is_a_no_op():
    """(The reference's jitted loop cannot index an empty id array, so
    this one has no reference run.)"""
    data, _, t = make_pair(seed=2)
    t = t.promote(torch.tensor([1, 2], dtype=torch.int32))
    before = (t.storage.clone(), t.slot_to_block.clone(),
              t.block_to_slot.clone())
    for st_ in (t.promote(torch.zeros(0, dtype=torch.int32)),
                t.demote(torch.zeros(0, dtype=torch.int32))):
        for a, b in zip((st_.storage, st_.slot_to_block, st_.block_to_slot),
                        before):
            assert torch.equal(a, b)


def test_resolve_and_is_fast_match_reference():
    _, j, t = make_pair(seed=5)
    j = j.promote(jnp.asarray([1, 9, 3], jnp.int32))
    t = t.promote(torch.tensor([1, 9, 3], dtype=torch.int32))
    rows = np.arange(64, dtype=np.int32)
    got = t.resolve(torch.from_numpy(rows))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(j.resolve(rows)))
    np.testing.assert_array_equal(t.is_fast(torch.from_numpy(rows)).numpy(),
                                  np.asarray(j.is_fast(rows)))


def test_bfloat16_store_matches_reference():
    data = np.random.default_rng(6).normal(size=(32, 16)).astype(np.float32)
    j = JStore.create(jnp.asarray(data, jnp.bfloat16), block_rows=2,
                      n_slots=3)
    t = TieredStore.create(torch.from_numpy(data).to(torch.bfloat16),
                           block_rows=2, n_slots=3)
    for ids in ([4, 4, 9], [1, 2, 3, 15]):
        j = j.promote(jnp.asarray(ids, jnp.int32))
        t = t.promote(torch.tensor(ids, dtype=torch.int32))
    np.testing.assert_array_equal(t.storage.to(torch.float32).numpy(),
                                  np.asarray(j.storage, np.float32))
    np.testing.assert_array_equal(t.slot_to_block.numpy(),
                                  np.asarray(j.slot_to_block))


@settings(max_examples=25, deadline=None)
@given(
    blocks=st.lists(st.integers(min_value=-1, max_value=15), min_size=1,
                    max_size=12),
    rows=st.lists(st.integers(min_value=0, max_value=63), min_size=1,
                  max_size=16),
)
def test_property_promotion_never_changes_reads(blocks, rows):
    """``tests/test_core_tiering.py``'s property, with the port's storage
    and both maps held bit-identical to the reference's as well."""
    data, j, t = make_pair()
    j = j.promote(jnp.array(blocks, dtype=jnp.int32))
    t = t.promote(torch.tensor(blocks, dtype=torch.int32))
    assert_same(j, t)
    got = t.gather(torch.tensor(rows))
    np.testing.assert_array_equal(got.numpy(), data[rows])
    b2s, s2b = t.block_to_slot.numpy(), t.slot_to_block.numpy()
    for blk, slot in enumerate(b2s):
        if slot >= 0:
            assert s2b[slot] == blk
    for slot, blk in enumerate(s2b):
        if blk >= 0:
            assert b2s[blk] == slot
    assert (b2s >= 0).sum() == (s2b >= 0).sum() <= t.n_slots


def test_create_validates_geometry():
    with pytest.raises(ValueError, match="multiple"):
        TieredStore.create(torch.zeros(10, 4), block_rows=4, n_slots=1)
    with pytest.raises(ValueError, match="larger"):
        TieredStore.create(torch.zeros(8, 4), block_rows=4, n_slots=3)
