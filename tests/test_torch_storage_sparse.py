"""The port's hashed-COO view storage ≡ the reference's, bit for bit.

``repro_torch.core.storage`` against ``repro.core.storage`` on the same
numpy inputs, following ``tests/test_storage.py`` case by case: the hash
primitives (tables, slots, found and placed flags, under contention for one
slot, a full table, ids below 0, zombies after deletes, both probe forms),
every ``SparseRelation`` operation (key tables and payload planes compared,
not only values) and the storage planner's choices and capacities.
Payloads are integer-valued float32, so every accumulation order is exact.
On the CPU the port's hash primitives are the plain versions of the
``hash_probe`` and ``hash_insert`` kernels (``tests/test_torch_cuda.py``
holds the kernels to them on the card).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as P  # noqa: E402

P.cap_torch_threads()
jnp = pytest.importorskip("jax.numpy")

from benchmarks import common as bc  # noqa: E402
from repro.core import DenseRelation as RDense  # noqa: E402
from repro.core import IVMEngine as RefEngine  # noqa: E402
from repro.core import Query as RQuery  # noqa: E402
from repro.core import SparseRelation as RSparse  # noqa: E402
from repro.core import storage as rstorage  # noqa: E402
from repro.core import sum_ring as rsum  # noqa: E402
from repro.core.contraction import BatchedDelta as RDelta  # noqa: E402
from repro.core.rings import DegreeMRing as RDegree  # noqa: E402
from repro.core import COOUpdate as RCOO  # noqa: E402
from repro_torch.core import COOUpdate, DenseRelation, IVMEngine, Query  # noqa: E402
from repro_torch.core import storage  # noqa: E402
from repro_torch.core import sum_ring  # noqa: E402
from repro_torch.core.contraction import BatchedDelta  # noqa: E402
from repro_torch.core.rings import DegreeMRing  # noqa: E402
from repro_torch.core.storage import SparseRelation  # noqa: E402
from repro_torch.data import synth  # noqa: E402
from repro_torch.kernels import hash_table  # noqa: E402

DOMS = (5, 4, 3)
SCHEMA = ("A", "B", "C")


def _t(a):
    return torch.tensor(np.asarray(a))


def _rand_batch(rng, b, doms=DOMS):
    keys = np.stack([rng.integers(0, d, size=b) for d in doms],
                    axis=1).astype(np.int32)
    vals = rng.integers(-3, 4, size=b).astype(np.float32)  # deletes included
    return keys, vals


def _zeros(capacity, schema=SCHEMA, doms=DOMS, ring=None):
    """(reference, port) empty sparse relations of one layout."""
    return (RSparse.zeros(schema, ring or rsum(), doms, capacity=capacity),
            SparseRelation.zeros(schema, ring or sum_ring(), doms,
                                 capacity=capacity, device="cpu"))


def _scatter(pair, keys, vals):
    r, t = pair
    return (r.scatter_add(jnp.asarray(keys), {"v": jnp.asarray(vals)}),
            t.scatter_add(_t(keys), {"v": _t(vals)}))


def assert_same_relation(r, t):
    """The same table (slot for slot) and the same payload plane."""
    assert t.capacity == r.capacity
    np.testing.assert_array_equal(t.table.numpy(), np.asarray(r.table))
    for c in r.payload:
        np.testing.assert_array_equal(t.payload[c].numpy(),
                                      np.asarray(r.payload[c]), err_msg=c)
    # the plane's zero row, which missed probes read, stays zero
    assert not t.plane[t.capacity].any()


def assert_same_dense(r, t):
    for c in r.payload:
        np.testing.assert_array_equal(t.to_dense().payload[c].numpy(),
                                      np.asarray(r.to_dense().payload[c]))


# ---------------------------------------------------------------------------
# hash primitives
# ---------------------------------------------------------------------------
def _insert_case(case, rng):
    """(capacity, table before, distinct ids) of one named case."""
    if case == "contention":  # every id hashes to one slot of 8
        ids = [i * 8 for i in range(6)]
        return 8, np.full(8, -1, np.int32), np.array(ids, np.int32)
    if case == "full":  # 20 ids into 16 slots, a third taken already
        table = np.asarray(rstorage._insert_ids(
            jnp.full((16,), -1, jnp.int32),
            jnp.asarray(np.arange(100, 105, dtype=np.int32)))[0])
        return 16, table, rng.permutation(np.arange(20)).astype(np.int32)
    if case == "sentinels":  # ids below 0 skip
        ids = np.array([5, -1, 9, -1, 300, 17], np.int32)
        return 32, np.full(32, -1, np.int32), ids
    ids = np.unique(rng.integers(0, 5000, size=600)).astype(np.int32)
    ids = rng.permutation(np.concatenate([ids, [-1, -1]])).astype(np.int32)
    pre = np.unique(rng.integers(0, 5000, size=300)).astype(np.int32)
    table = np.asarray(rstorage._insert_ids(jnp.full((1024,), -1, jnp.int32),
                                            jnp.asarray(pre))[0])
    return 1024, table, ids


@pytest.mark.parametrize("case", ["contention", "full", "sentinels", "random"])
def test_hash_insert_and_probe_match_reference(case):
    """Insert builds the reference's table slot for slot (lowest row wins a
    contended slot; a full table reports placed False and slot 0); both
    probe forms give the reference's slots and found flags for present,
    absent and sentinel ids."""
    rng = np.random.default_rng(3)
    C, table, ids = _insert_case(case, rng)
    r_table, r_slot, r_placed = rstorage._insert_ids(jnp.asarray(table),
                                                     jnp.asarray(ids))
    t_table = _t(table)
    t_slot, t_placed = storage._insert_ids(t_table, _t(ids))
    np.testing.assert_array_equal(t_table.numpy(), np.asarray(r_table))
    np.testing.assert_array_equal(t_slot.numpy(), np.asarray(r_slot))
    np.testing.assert_array_equal(t_placed.numpy(), np.asarray(r_placed))
    if case == "full":
        assert not t_placed.all() and (t_table >= 0).all()
    queries = np.concatenate([ids, [-1, 7, 4999],
                              rng.integers(0, 5000, 12)]).astype(np.int32)
    for name in ("_find_slots", "_probe_slots"):
        r_s, r_f = getattr(rstorage, name)(r_table, jnp.asarray(queries))
        t_s, t_f = getattr(storage, name)(t_table, _t(queries))
        np.testing.assert_array_equal(t_s.numpy(), np.asarray(r_s), err_msg=name)
        np.testing.assert_array_equal(t_f.numpy(), np.asarray(r_f), err_msg=name)


def test_hash_ids_match_reference():
    ids = np.array([0, 1, 7, 2 ** 31 - 1, 123456789, 65535], np.int32)
    for C in (2, 64, 2 ** 17):
        np.testing.assert_array_equal(
            storage._hash_ids(_t(ids), C).numpy(),
            np.asarray(rstorage._hash_ids(jnp.asarray(ids), C)))


def test_hash_wrappers_check_their_inputs():
    with pytest.raises(ValueError, match="power of two"):
        hash_table.hash_probe(torch.full((6,), -1, dtype=torch.int32),
                              torch.zeros(2, dtype=torch.int32))
    with pytest.raises(TypeError, match="dtype"):
        hash_table.hash_insert(torch.full((8,), -1, dtype=torch.int64),
                               torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("seed", [0, 1])
def test_rank_and_dedup_match_reference(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, 12, size=40).astype(np.int32)
    vals = rng.integers(-3, 4, size=(40, 3)).astype(np.float32)
    for got, want in zip(storage._rank_ids(_t(ids)),
                         rstorage._rank_ids(jnp.asarray(ids))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(storage._dedup_ids(_t(ids), _t(vals)),
                         rstorage._dedup_ids(jnp.asarray(ids), jnp.asarray(vals))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# SparseRelation operations
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scatter_gather_match_reference(seed):
    rng = np.random.default_rng(seed)
    pair = _zeros(64)
    dense = DenseRelation.zeros(SCHEMA, sum_ring(), DOMS, device="cpu")
    for _ in range(3):  # duplicate keys across and within batches
        keys, vals = _rand_batch(rng, 16)
        pair = _scatter(pair, keys, vals)
        dense = dense.scatter_add(_t(keys), {"v": _t(vals)})
    r, t = pair
    assert_same_relation(r, t)
    torch.testing.assert_close(t.to_dense().payload["v"], dense.payload["v"],
                               rtol=0, atol=0)
    probe, _ = _rand_batch(rng, 16)
    for read in ("gather", "gather_batched"):
        np.testing.assert_array_equal(
            getattr(t, read)(_t(probe))["v"].numpy(),
            np.asarray(getattr(r, read)(jnp.asarray(probe))["v"]))
    assert t.num_slots_used_sync() == r.num_slots_used_sync()
    assert t.num_keys_sync() == r.num_keys_sync() == dense.num_keys_sync()


@pytest.mark.parametrize("seed", [0, 1])
def test_marginalize_contract_transpose_match_reference(seed):
    rng = np.random.default_rng(seed)
    keys, vals = _rand_batch(rng, 20)
    r = RSparse.from_coo(SCHEMA, rsum(), DOMS, jnp.asarray(keys),
                         {"v": jnp.asarray(vals)})
    t = SparseRelation.from_coo(SCHEMA, sum_ring(), DOMS, _t(keys),
                                {"v": _t(vals)})
    assert_same_relation(r, t)
    lift = np.arange(DOMS[1], dtype=np.float32)
    for r_lift, t_lift in ((None, None),
                           (RDense(("B",), rsum(), {"v": jnp.asarray(lift)}),
                            DenseRelation(("B",), sum_ring(), {"v": _t(lift)}))):
        assert_same_relation(r.marginalize("B", r_lift), t.marginalize("B", t_lift))
    other = rng.integers(-2, 3, DOMS[2]).astype(np.float32)
    assert_same_relation(
        r.contract(RDense(("C",), rsum(), {"v": jnp.asarray(other)}), marg=("C",)),
        t.contract(DenseRelation(("C",), sum_ring(), {"v": _t(other)}),
                   marg=("C",)))
    assert_same_relation(r.transpose(("C", "A", "B")), t.transpose(("C", "A", "B")))


def test_from_dense_add_and_add_dense_match_reference():
    rng = np.random.default_rng(5)
    mult = (rng.random(DOMS) < 0.2).astype(np.float32) * rng.integers(1, 4, DOMS)
    r = RSparse.from_dense(RDense(SCHEMA, rsum(), {"v": jnp.asarray(mult)}))
    t = SparseRelation.from_dense(DenseRelation(SCHEMA, sum_ring(),
                                                {"v": _t(mult.astype(np.float32))}))
    assert_same_relation(r, t)
    keys, vals = _rand_batch(rng, 10)
    r2, t2 = _scatter(_zeros(32), keys, vals)
    # the port's ⊎ writes into the relation it is given: chain the results
    r, t = r.add(r2), t.add(t2)
    assert_same_relation(r, t)
    delta = rng.integers(-1, 2, DOMS).astype(np.float32)
    assert_same_relation(
        r.add(RDense(SCHEMA, rsum(), {"v": jnp.asarray(delta)})),
        t.add(DenseRelation(SCHEMA, sum_ring(), {"v": _t(delta)})))


@pytest.mark.parametrize("seed", [0, 1])
def test_growth_and_rehash_match_reference(seed):
    rng = np.random.default_rng(seed)
    r, t = _zeros(4)  # tiny
    for _ in range(4):
        keys, vals = _rand_batch(rng, 12)
        r = rstorage.grow_if_loaded(r, budget=12)
        t = storage.grow_if_loaded(t, budget=12)
        r, t = _scatter((r, t), keys, vals)
        assert_same_relation(r, t)
    assert t.capacity > 4
    for cap in (None, 4 * t.capacity):
        assert_same_relation(r.rehash(cap), t.rehash(cap))
    compact = t.rehash()
    assert compact.num_slots_used_sync() == compact.num_keys_sync()


def test_insert_overflow_drops_not_corrupts():
    keys = np.arange(10, dtype=np.int32)[:, None]
    vals = np.ones((10,), np.float32)
    r, t = _scatter(_zeros(4, ("A",), (64,)), keys, vals)
    assert_same_relation(r, t)
    assert t.num_keys_sync() == 4  # extra rows dropped, table intact
    assert float(t.to_dense().payload["v"].sum()) == 4.0


def test_fused_gather_mul_scatter_dedups_duplicate_keys():
    keys = np.array([[7], [7], [7], [0], [0]], np.int32)
    src = np.array([[2.0], [3.0]], np.float32)
    in_ids = np.array([0, 1, 0, 1, 1], np.int32)
    scale = np.array([1.0, 1.0, 2.0, 1.0, 0.0], np.float32)
    r, t = _zeros(16, ("A",), (64,))
    r = r.gather_mul_scatter(jnp.asarray(keys), jnp.asarray(src),
                             jnp.asarray(in_ids), jnp.asarray(scale))
    t = t.gather_mul_scatter(_t(keys), _t(src), _t(in_ids), _t(scale))
    assert_same_relation(r, t)
    assert t.num_slots_used_sync() == 2  # one slot per distinct key
    assert float(t.gather(_t(keys[:1]))["v"][0]) == 9.0
    # the fused chain's slot claim: the same slots, the table written once
    r_tab, r_tgt = r.fused_slot_targets(jnp.asarray(keys))
    t_tab, t_tgt = t.fused_slot_targets(_t(keys))
    np.testing.assert_array_equal(t_tgt.numpy(), np.asarray(r_tgt))
    np.testing.assert_array_equal(t_tab.numpy(), np.asarray(r_tab))


def test_read_after_delete_reads_ring_zero_on_both_probe_paths():
    keys = np.array([[7], [9], [23]], np.int32)
    r, t = _scatter(_zeros(16, ("A",), (64,)), keys,
                    np.array([2.0, 3.0, 5.0], np.float32))
    r, t = _scatter((r, t), keys[1:2], np.array([-3.0], np.float32))
    assert_same_relation(r, t)
    assert t.num_slots_used_sync() == 3 and t.num_keys_sync() == 2
    for read in (t.gather, t.gather_batched):
        np.testing.assert_array_equal(read(_t(keys))["v"].numpy(), [2.0, 0.0, 5.0])
    for probe in (t.lookup, t.probe):
        _, found = probe(_t(keys))
        assert bool(found[1])  # the zombie slot is still found


def test_num_keys_is_device_scalar_and_layout_helpers():
    t = SparseRelation.zeros(("A",), sum_ring(), (8,), capacity=8, device="cpu")
    nk = t.num_keys()
    assert isinstance(nk, torch.Tensor) and nk.shape == ()
    assert isinstance(t.num_keys_sync(), int)
    assert storage.export_layout(t) == {"kind": "sparse", "capacity": 8}
    tmpl = storage.layout_template(
        DenseRelation.zeros(("A",), sum_ring(), (8,), device="cpu"),
        {"kind": "sparse", "capacity": 32})
    assert isinstance(tmpl, SparseRelation) and tmpl.capacity == 32
    t.scatter_add(_t(np.array([[3]], np.int32)), {"v": _t(np.array([-1.0], np.float32))})
    assert storage.occupancy_report({"V": t, "D": tmpl.to_dense()}) == {
        "V": {"capacity": 8, "slots_used": 1, "keys": 1}}
    assert storage.view_nbytes(t) == 8 * 4 + 9 * 4  # the zero row included
    # the host form of a table is its dense form's (ported since)
    from repro_torch.core.rings import PyNumberRing

    assert t.to_py(PyNumberRing()).data == t.to_dense().to_py(PyNumberRing()).data
    # the shard surface (ported since): the slot axis, the capacity, and
    # a placement per leaf of the reference's leaves (the key table stays
    # whole on every rank; the payload rows split)
    assert t.shard_axis() == 0 and t.shard_extent() == 8
    places = t.leaf_shardings(None, "view", True)
    assert [p.kind for p in torch.utils._pytree.tree_leaves(places)] == [
        "replicate", "split"]
    assert len(torch.utils._pytree.tree_leaves(places)) == len(
        torch.utils._pytree.tree_leaves(t))


@pytest.mark.parametrize("sparse_sibling", [False, True])
def test_nonscalar_ring_defers_sibling_gather(sparse_sibling):
    """A degree-2 delta joined with a (sparse) sibling defers the gather
    and applies as the reference does."""
    rng = np.random.default_rng(11)
    sib = {"c": rng.integers(0, 3, 5).astype(np.float32),
           "s": rng.integers(-2, 3, (5, 2)).astype(np.float32),
           "Q": rng.integers(-2, 3, (5, 2, 2)).astype(np.float32)}
    b = 6
    keys = np.stack([rng.integers(0, 5, size=b), rng.integers(0, 4, size=b)],
                    axis=1).astype(np.int32)
    delta = {"c": rng.integers(-2, 3, b).astype(np.float32),
             "s": rng.integers(-2, 3, (b, 2)).astype(np.float32),
             "Q": rng.integers(-2, 3, (b, 2, 2)).astype(np.float32)}
    rring, tring = RDegree(2), DegreeMRing(2)
    r_sib = RDense(("A",), rring, {c: jnp.asarray(v) for c, v in sib.items()})
    t_sib = DenseRelation(("A",), tring, {c: _t(v) for c, v in sib.items()})
    if sparse_sibling:
        r_sib, t_sib = RSparse.from_dense(r_sib), SparseRelation.from_dense(t_sib)
    r_j = RDelta.from_coo(rring, RCOO(("A", "B"), jnp.asarray(keys),
                                      {c: jnp.asarray(v) for c, v in delta.items()}
                                      )).join_dense(r_sib)
    t_j = BatchedDelta.from_coo(tring, COOUpdate(("A", "B"), _t(keys),
                                                 {c: _t(v) for c, v in delta.items()}
                                                 )).join_dense(t_sib)
    assert t_j.pending_gather is not None
    for target in ("dense", "sparse"):
        r_view = RDense.zeros(("A", "B"), rring, (5, 4))
        t_view = DenseRelation.zeros(("A", "B"), tring, (5, 4), device="cpu")
        if target == "sparse":
            r_view, t_view = RSparse.from_dense(r_view), SparseRelation.from_dense(t_view)
        got, want = t_j.apply_to(t_view), r_j.apply_to(r_view)
        for c in rring.components:
            np.testing.assert_array_equal(got.to_dense().payload[c].numpy(),
                                          np.asarray(want.to_dense().payload[c]))


def test_mixed_delta_into_sparse_view_enumerates_its_grid():
    """A delta with dense axes ⊎ into a sparse view (the grid-enumerating
    apply) fills the reference's table."""
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 5, size=(4, 1)).astype(np.int32)
    pay = rng.integers(-2, 3, size=(4, 4, 3)).astype(np.float32)
    r_d = RDelta(("A",), ("B", "C"), jnp.asarray(keys), rsum(),
                 {"v": jnp.asarray(pay)}, (4, 3))
    t_d = BatchedDelta(("A",), ("B", "C"), _t(keys), sum_ring(), {"v": _t(pay)},
                       (4, 3))
    r, t = _zeros(64)
    assert_same_relation(r_d.apply_to(r), t_d.apply_to(t))


# ---------------------------------------------------------------------------
# adversarial: zombies, near-capacity occupancy, growth racing deletes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
def test_rehash_under_high_zombie_ratio(seed):
    rng = np.random.default_rng(seed)
    pair = _zeros(128)
    inserted = []
    for _ in range(3):
        keys, vals = _rand_batch(rng, 16)
        vals = np.abs(vals) + 1  # strict inserts
        pair = _scatter(pair, keys, vals)
        inserted.append((keys, vals))
    for keys, vals in inserted:  # delete ~90%: exact negations
        n = max(1, int(0.9 * len(keys)))
        pair = _scatter(pair, keys[:n], -vals[:n])
    r, t = pair
    assert t.num_slots_used_sync() > t.num_keys_sync()  # zombies
    for cap in (t.capacity, 2 * t.capacity, 16):
        assert_same_relation(r.rehash(cap), t.rehash(cap))
        compact = t.rehash(cap)
        assert compact.num_slots_used_sync() == compact.num_keys_sync()
    assert_same_relation(r, t)


@pytest.mark.parametrize("seed", [0, 1])
def test_rehash_at_near_capacity_occupancy(seed):
    rng = np.random.default_rng(seed)
    cap = 32
    budget = int(storage.LOAD_FACTOR * cap)
    seen: set = set()
    while len(seen) < budget:
        keys, _ = _rand_batch(rng, 8)
        for k in keys:
            if len(seen) < budget:
                seen.add(tuple(int(x) for x in k))
    keys = np.array(sorted(seen), np.int32)
    r, t = _scatter(_zeros(cap), keys,
                    rng.integers(1, 4, size=len(seen)).astype(np.float32))
    assert t.num_keys_sync() == budget
    assert_same_relation(r.rehash(cap), t.rehash(cap))
    assert_same_relation(r.rehash(2 * cap), t.rehash(2 * cap))
    upd_k, upd_v = _rand_batch(rng, 6)
    assert_same_relation(*_scatter((r, t), upd_k, np.zeros_like(upd_v)))


@pytest.mark.parametrize("seed", [0, 1])
def test_eager_autogrow_racing_deletes(seed):
    rng = np.random.default_rng(seed)
    r, t = _zeros(4)
    live: list = []
    for step in range(6):
        if step % 2 == 0 or not live:
            keys, vals = _rand_batch(rng, 12)
            vals = np.abs(vals) + 1
            live.append((keys, vals))
        else:
            keys, vals = live.pop(int(rng.integers(0, len(live))))
            vals = -vals
        r = rstorage.grow_if_loaded(r, budget=len(keys))
        t = storage.grow_if_loaded(t, budget=len(keys))
        r, t = _scatter((r, t), keys, vals)
        assert_same_relation(r, t)
    assert t.capacity > 4


# ---------------------------------------------------------------------------
# the storage planner
# ---------------------------------------------------------------------------
def test_planner_thresholds_and_overrides(monkeypatch):
    keys = np.stack([np.arange(20), np.zeros(20)], 1).astype(np.int32)
    ones = np.ones((20,), np.float32)
    views = {"V0@A": DenseRelation.from_coo(("A", "B"), sum_ring(), (4096, 2),
                                            _t(keys), {"v": _t(ones)}),
             "V1@C": DenseRelation.from_coo(("C",), sum_ring(), (8,),
                                            _t(keys[:5, :1]), {"v": _t(ones[:5])})}
    plan = storage.plan_storage(views, mode="auto")
    assert plan["V0@A"] == storage.StorageSpec("sparse", 64)
    assert plan["V1@C"].kind == "dense"
    plan = storage.plan_storage(views, mode="dense")
    assert {s.kind for s in plan.values()} == {"dense"}
    plan = storage.plan_storage(views, mode="dense", overrides={"V1@C": "sparse"})
    assert plan["V1@C"] == storage.StorageSpec("sparse", 8)  # capped at next_pow2(S)
    monkeypatch.setenv(storage.ENV_VAR, "sparse")
    plan = storage.plan_storage(views)
    assert {s.kind for s in plan.values()} == {"sparse"}
    monkeypatch.setenv(storage.ENV_VAR, "tiled")
    with pytest.raises(ValueError, match="storage mode"):
        storage.plan_storage(views)
    # the reference's planner on the same views
    monkeypatch.delenv(storage.ENV_VAR)
    rviews = {n: RDense(v.schema, rsum(), {"v": jnp.asarray(v.payload["v"].numpy())})
              for n, v in views.items()}
    assert rstorage.plan_storage(rviews, mode="auto") == {
        n: rstorage.StorageSpec(s.kind, s.capacity)
        for n, s in storage.plan_storage(views, mode="auto").items()}


def _housing_case(n_active=128):
    doms = dict(synth.HOUSING_DOMS)
    rq = RQuery(relations=bc.HOUSING_RELATIONS, free_vars=(), ring=rsum(),
                domains=doms, lifts={"h2": ("value",)})
    tq = Query(relations=synth.HOUSING_RELATIONS, free_vars=(), ring=sum_ring(),
               domains=doms, lifts={"h2": ("value",)})
    rdb, _ = bc.synth_low_fill_db(bc.HOUSING_RELATIONS, doms, rq.ring,
                                  np.random.default_rng(0), "pc", n_active=n_active)
    return rq, tq, rdb, bc.housing_vo(), synth.housing_vo()


def _retailer_case():
    rq = RQuery(relations=bc.RETAILER_RELATIONS, free_vars=(), ring=rsum(),
                domains=bc.RETAILER_DOMS, lifts={"units": ("value",)})
    tq = Query(relations=synth.RETAILER_RELATIONS, free_vars=(), ring=sum_ring(),
               domains=synth.RETAILER_DOMS, lifts={"units": ("value",)})
    rdb = bc.synth_db(bc.RETAILER_RELATIONS, bc.RETAILER_DOMS, rq.ring,
                      np.random.default_rng(0), density=0.02)
    return rq, tq, rdb, bc.retailer_vo(), synth.retailer_vo()


@pytest.mark.parametrize("schema,mode", [("housing", "auto"), ("housing", "sparse"),
                                         ("retailer", "auto")])
def test_planner_choices_match_reference(schema, mode):
    """The engine's plan (kinds and capacities) on the housing star at
    pc = 4,096 with 128 active postcodes (fill 3.1 %) and on the retailer
    snowflake (``sparse`` there: ``tests/test_torch_engine_sparse.py``);
    and the bytes it holds."""
    rq, tq, rdb, rvo, tvo = (_housing_case if schema == "housing"
                             else _retailer_case)()
    from repro_torch import convert

    tdb = convert.database_from_numpy(P.db_to_numpy(rdb), tq.ring, device="cpu")
    ref = RefEngine.build(rq, rdb, var_order=rvo, strategy="fivm", storage=mode)
    eng = IVMEngine.build(tq, tdb, var_order=tvo, strategy="fivm", storage=mode,
                          device="cpu")
    want = {n: (s.kind, s.capacity) for n, s in ref.storage_plan.items()}
    assert {n: (s.kind, s.capacity) for n, s in eng.storage_plan.items()} == want
    if schema == "housing" and mode == "auto":
        assert sorted(k for k, _ in want.values()) == ["dense"] + ["sparse"] * 6
    n_sparse = sum(isinstance(v, SparseRelation) for v in eng.views.values())
    # a sparse view also holds its plane's zero row (d = 1 float here)
    assert eng.memory_bytes() == ref.memory_bytes() + 4 * n_sparse
    for name, v in eng.views.items():
        if isinstance(v, SparseRelation):
            assert_same_relation(ref.views[name], v)


def test_storage_mode_env_var_reaches_the_engine(monkeypatch):
    rq, tq, rdb, rvo, tvo = _housing_case()
    from repro_torch import convert

    tdb = convert.database_from_numpy(P.db_to_numpy(rdb), tq.ring, device="cpu")
    monkeypatch.setenv(storage.ENV_VAR, "dense")
    eng = IVMEngine.build(tq, tdb, var_order=tvo, device="cpu")
    assert {s.kind for s in eng.storage_plan.values()} == {"dense"}
    monkeypatch.delenv(storage.ENV_VAR)
    eng = IVMEngine.build(tq, tdb, var_order=tvo, device="cpu",
                          storage_overrides={"V1@h1": "dense"},
                          storage_opts=dict(headroom=4.0))
    assert eng.storage_plan["V1@h1"].kind == "dense"
    assert eng.storage_plan["V2@s1"] == storage.StorageSpec("sparse", 1024)
