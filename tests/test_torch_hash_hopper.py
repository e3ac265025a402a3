"""The redesigned hash kernels' plain versions ≡ the reference, bit for bit.

``hash_insert_targets`` claims slots for a batch's raw ids, duplicates and
sentinels included, in one launch, the smallest id winning a contended
slot; its plain version (``hash_table.insert_targets_ref``) must build the
reference's table and give every row the reference's target, where the
reference runs ``_rank_ids`` → ``_insert_ids`` → ``where(placed, slot,
EMPTY)[rank]`` (``repro.core.storage``, as ``fused_slot_targets`` does).
The keyed probe (``hash_table.probe_keys_ref``) must equal the reference's
``linear_ids`` → ``_find_slots`` → ``where(found, slot, C)`` for keys taken
from columns of a wider key matrix.  Then the sparse relation's claim and
read paths, which now take a delta's key matrix as it is, against the
reference's on stacked keys; the insert's route choice; keys wider than
the kernels linearize (a four-column group-by view); and the widest key
of the port's plans against the kernels' limit.  The kernels themselves are
held to these plain versions on the card (``tests/test_torch_cuda.py``).
The reference's loops are run under ``jax.jit`` here, one compile a shape.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as P  # noqa: E402

P.cap_torch_threads()
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from _hypothesis_compat import given, settings, strategies as st  # noqa: E402
from repro.core import SparseRelation as RSparse  # noqa: E402
from repro.core import storage as rstorage  # noqa: E402
from repro.core import sum_ring as rsum  # noqa: E402
from repro_torch.core import storage  # noqa: E402
from repro_torch.core import sum_ring  # noqa: E402
from repro_torch.core.storage import SparseRelation  # noqa: E402
from repro_torch.kernels import hash_table  # noqa: E402

EMPTY = -1
#: the hypothesis tests' table capacities and batch (fixed shapes: one
#: reference compile each)
CAPS = (8, 16, 64)
B = 24
PREFILL = 12


def _t(a):
    return torch.tensor(np.asarray(a))


@jax.jit
def _ref_targets(table, ids):
    """The reference's claim of a batch's raw ids: table and row targets."""
    rank, uniq = rstorage._rank_ids(ids)
    table, slots, placed = rstorage._insert_ids(table, uniq)
    return table, jnp.where(placed, slots, EMPTY)[rank]


@jax.jit
def _ref_prefill(table, ids):
    return rstorage._insert_ids(table, ids)[0]


@jax.jit
def _ref_probe_rows(table, ids):
    slot, found = rstorage._find_slots(table, ids)
    return slot, found, jnp.where(found, slot, table.shape[0])


def _colliding(C: int, n: int) -> np.ndarray:
    """The first ``n`` ids whose hash is slot 0 of a table of C slots."""
    ids = np.arange(64 * C * n, dtype=np.int32)
    return ids[np.asarray(rstorage._hash_ids(jnp.asarray(ids), C)) == 0][:n]


def _table(C: int, pre: np.ndarray) -> np.ndarray:
    """A table of C slots holding the distinct ids ``pre`` (EMPTY-padded to
    PREFILL), inserted by the reference."""
    pad = np.full(PREFILL, EMPTY, np.int32)
    pad[:len(pre)] = pre[:PREFILL]
    return np.asarray(_ref_prefill(jnp.full((C,), EMPTY, jnp.int32), jnp.asarray(pad)))


def _targets_case(C, n_pre, pool, draws, seed):
    """(table, ids) of one drawn case: ids from a wide range (few
    duplicates), a narrow one (duplicates; small tables fill up) or ids
    that all hash to slot 0 (contention), a sentinel where a draw is a
    multiple of 7, and n_pre prefilled ids (some of them in the batch)."""
    rng = np.random.default_rng(seed)
    values = (rng.integers(0, 1 << 20, size=64), rng.integers(0, 2 * C, size=64),
              _colliding(C, 16))[pool].astype(np.int32)
    ids = np.array([values[d % len(values)] for d in draws], np.int32)
    ids[np.array(draws) % 7 == 0] = -1 - np.array(draws)[np.array(draws) % 7 == 0] % 3
    pre = np.unique(np.concatenate([rng.choice(values, size=n_pre // 2),
                                    rng.integers(0, 1 << 20, size=n_pre - n_pre // 2)]))
    return _table(C, rng.permutation(pre[:min(n_pre, C)]).astype(np.int32)), ids


def _check_targets(table, ids):
    r_table, r_target = _ref_targets(jnp.asarray(table), jnp.asarray(ids))
    for claim in (hash_table.insert_targets_ref, hash_table.hash_insert_targets):
        t_table = _t(table)
        got = claim(t_table, _t(ids))
        np.testing.assert_array_equal(t_table.numpy(), np.asarray(r_table),
                                      err_msg=claim.__name__)
        np.testing.assert_array_equal(got.numpy(), np.asarray(r_target),
                                      err_msg=claim.__name__)
    return np.asarray(r_target)


@settings(max_examples=40, deadline=None)
@given(st.integers(0, len(CAPS) - 1), st.integers(0, PREFILL), st.integers(0, 2),
       st.lists(st.integers(0, 10 ** 6), min_size=B, max_size=B),
       st.integers(0, 2 ** 16))
def test_insert_targets_plain_matches_reference_composition(cap, n_pre, pool, draws,
                                                            seed):
    """The plain version of ``hash_insert_targets`` (and the wrapper, which
    takes it on the CPU) builds the reference's table
    slot for slot and gives every row the reference's target, under
    duplicates, sentinels, prefilled tables, contention and tables that
    fill up."""
    _check_targets(*_targets_case(CAPS[cap], n_pre, pool, draws, seed))


@pytest.mark.parametrize("case", ["duplicates", "contention", "full", "sentinels"])
def test_insert_targets_named_cases_match_reference(case):
    """Named cases of the drawn test above, each checked for the property
    that names it: repeated ids share their target; ids that hash to one
    slot take consecutive slots, smallest first; a full table gives EMPTY
    to the ids it cannot hold; sentinels get EMPTY."""
    rng = np.random.default_rng(5)
    C = 16 if case != "full" else 8
    if case == "duplicates":
        ids = rng.permutation(np.repeat(np.array([3, 40, 7, 123456, 9], np.int32), 5))[:B]
        table = _table(C, np.array([7, 1000], np.int32))
    elif case == "contention":
        ids = rng.permutation(np.resize(_colliding(C, 6), B)).astype(np.int32)
        table = _table(C, np.zeros(0, np.int32))
    elif case == "full":
        ids = rng.permutation(np.arange(100, 100 + B)).astype(np.int32)
        table = _table(C, np.array([5, 6, 7], np.int32))
    else:
        ids = np.where(np.arange(B) % 3 == 0, -1, rng.integers(0, 50, size=B)).astype(np.int32)
        table = _table(C, np.zeros(0, np.int32))
    target = _check_targets(table, ids)
    if case == "duplicates":
        for v in np.unique(ids):
            assert len(set(target[ids == v])) == 1
    elif case == "contention":
        assert [target[ids == v][0] for v in np.unique(ids)] == list(range(6))
    elif case == "full":
        assert (target == EMPTY).sum() == B - (C - 3)
    else:
        assert (target[ids < 0] == EMPTY).all()


def _probe_case(seed, C, fill):
    """A table of C slots filled to ``fill`` with linearized keys over
    domains (5, 4, 3), and a key matrix of 6 columns whose columns 4, 1 and
    2 (in that order) are the view's key, rows present and absent."""
    rng = np.random.default_rng(seed)
    doms = (5, 4, 3)
    n = min(int(fill * C), int(np.prod(doms)))
    present = rng.choice(int(np.prod(doms)), size=n, replace=False).astype(np.int32)
    table = np.full((C,), EMPTY, np.int32)
    for lo in range(0, n, PREFILL):
        table = _table_from(table, present[lo:lo + PREFILL])
    keys = rng.integers(0, 9, size=(40, 6)).astype(np.int32)
    view_keys = np.stack([rng.integers(0, d, size=40) for d in doms], axis=1)
    keys[:, [4, 1, 2]] = view_keys
    return table, keys, doms


def _table_from(table, ids):
    pad = np.full(PREFILL, EMPTY, np.int32)
    pad[:len(ids)] = ids
    return np.asarray(_ref_prefill(jnp.asarray(table), jnp.asarray(pad)))


@pytest.mark.parametrize("seed,C,fill", [(0, 64, 0.3), (1, 64, 0.7), (2, 16, 1.0),
                                         (3, 128, 0.45), (4, 8, 1.0)])
def test_keyed_probe_plain_matches_reference(seed, C, fill):
    """``probe_keys_ref`` (view columns 4, 1, 2 of a 6-column key matrix,
    row-major strides of domains (5, 4, 3)) gives the reference's slot,
    found flag and gather row for present and absent keys, on tables that
    fill up (a full table's misses end where they began), and the storage
    strides are the reference's linearization."""
    table, keys, doms = _probe_case(seed, C, fill)
    cols, strides = (4, 1, 2), storage.row_major_strides(doms)
    assert strides == (12, 3, 1)
    ref_ids = rstorage.linear_ids(jnp.asarray(keys[:, list(cols)]), doms)
    want = _ref_probe_rows(jnp.asarray(table), ref_ids)
    for probe in (hash_table.probe_keys_ref, hash_table.hash_probe_keys):
        got = probe(_t(table), _t(keys), cols, strides)
        for g, w, name in zip(got, want, ("slot", "found", "rows")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_array_equal(
        hash_table.linearize_ref(_t(keys), cols, strides).numpy(), np.asarray(ref_ids))


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 3), st.integers(0, 2 ** 16))
def test_keyed_probe_drawn_arity_matches_reference(arity, seed):
    """Drawn key arities and column orders: the keyed probe's plain version
    against the reference's linear_ids and probe."""
    rng = np.random.default_rng(seed)
    doms = tuple(int(d) for d in rng.integers(2, 9, size=arity))
    cols = tuple(int(c) for c in rng.permutation(5)[:arity])
    keys = rng.integers(0, 9, size=(B, 5)).astype(np.int32)
    for j, c in enumerate(cols):
        keys[:, c] = rng.integers(0, doms[j], size=B)
    S = int(np.prod(doms))
    table = _table(64, rng.choice(S, size=min(S, PREFILL), replace=False).astype(np.int32))
    ref_ids = rstorage.linear_ids(jnp.asarray(keys[:, list(cols)]), doms)
    want = _ref_probe_rows(jnp.asarray(table), ref_ids)
    got = hash_table.probe_keys_ref(_t(table), _t(keys), cols,
                                    storage.row_major_strides(doms))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# the sparse relation's claim and read paths on a delta's key matrix
# ---------------------------------------------------------------------------
DOMS = (5, 4, 3)
SCHEMA = ("A", "B", "C")


def _pair(rng, C=64, n=20):
    keys = np.stack([rng.integers(0, d, size=n) for d in DOMS], axis=1).astype(np.int32)
    vals = rng.integers(-3, 4, size=n).astype(np.float32)
    r = RSparse.zeros(SCHEMA, rsum(), DOMS, capacity=C).scatter_add(
        jnp.asarray(keys), {"v": jnp.asarray(vals)})
    t = SparseRelation.zeros(SCHEMA, sum_ring(), DOMS, capacity=C, device="cpu")
    t.scatter_add(_t(keys), {"v": _t(vals)})
    return r, t


def _delta_keys(rng, n=30):
    """A delta's key matrix over (X, C, A, B): the view's columns are 2, 3, 1."""
    keys = np.stack([rng.integers(0, 7, size=n), rng.integers(0, 3, size=n),
                     rng.integers(0, 5, size=n), rng.integers(0, 4, size=n)],
                    axis=1).astype(np.int32)
    return keys, (2, 3, 1)


def _refuse(*args, **kwargs):
    raise AssertionError("a keyed path stacked, linearized or ranked its keys")


@pytest.mark.parametrize("seed", [0, 1])
def test_sparse_claims_and_reads_take_the_delta_key_matrix(seed, monkeypatch):
    """``fused_slot_targets``, ``gather_mul_scatter``, ``lookup``,
    ``gather_rows`` and ``gather`` on a delta's key matrix and the view's
    columns in it equal the reference's calls on the stacked view keys
    (tables, targets, planes, slots), without ``linear_ids`` or the rank
    prepass."""
    rng = np.random.default_rng(seed)
    keys, cols = _delta_keys(rng)
    stacked = keys[:, list(cols)]
    (r, t), (r2, t2) = _pair(rng), _pair(rng)
    monkeypatch.setattr(storage, "linear_ids", _refuse)
    monkeypatch.setattr(storage, "_rank_ids", _refuse)
    r_table, r_target = r.fused_slot_targets(jnp.asarray(stacked))
    t_table, t_target = t.fused_slot_targets(_t(keys), cols)
    np.testing.assert_array_equal(t_table.numpy(), np.asarray(r_table))
    np.testing.assert_array_equal(t_target.numpy(), np.asarray(r_target))

    r, t = r2, t2
    src = rng.integers(-3, 4, size=(9, 1)).astype(np.float32)
    in_ids = rng.integers(0, 9, size=len(keys)).astype(np.int32)
    scale = rng.integers(-2, 3, size=len(keys)).astype(np.float32)
    r = r.gather_mul_scatter(jnp.asarray(stacked), jnp.asarray(src), jnp.asarray(in_ids),
                             jnp.asarray(scale))
    t.gather_mul_scatter(_t(keys), _t(src), _t(in_ids), _t(scale), cols=cols)
    np.testing.assert_array_equal(t.table.numpy(), np.asarray(r.table))
    np.testing.assert_array_equal(t.payload["v"].numpy(), np.asarray(r.payload["v"]))

    r_slot, r_found = r.lookup(jnp.asarray(stacked))
    for got in (t.lookup(_t(keys), cols), t.lookup(_t(stacked))):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(r_slot))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(r_found))
    np.testing.assert_array_equal(
        t.gather_rows(_t(keys), cols).numpy(),
        np.where(np.asarray(r_found), np.asarray(r_slot), t.capacity))
    np.testing.assert_array_equal(t.gather(_t(keys), cols)["v"].numpy(),
                                  np.asarray(r.gather(jnp.asarray(stacked))["v"]))


# ---------------------------------------------------------------------------
# the insert's routes and the kernels' key limits
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("C,B,route", [
    (8192, 1000, "cta"), (16384, 8192, "cta"), (2048, 64, "cta"),
    (32768, 1000, "global"), (8192, 8193, "global"),
    (1 << 17, 1 << 16, "global"), (1 << 18, 1000, "global"),
    (1 << 19, 1000, "global"), (64, 1 << 18, "global")])
def test_insert_route_by_size(C, B, route):
    """The cta route while one block holds the table and its threads the
    rows (8 a thread); else global."""
    assert hash_table.insert_route(C, B) == route


def test_key_spec_layout_and_limits():
    """The kernels' key spec: the matrix's row stride, the columns and
    strides in order; a key wider than MAX_KEY_ARITY columns is read as
    ids, linearized as ``storage.linear_ids`` does; a non-int32 matrix, a
    stride beyond int32 or a column outside the matrix raise."""
    keys = torch.tensor(np.random.default_rng(3).integers(0, 4, size=(7, 6)),
                        dtype=torch.int32)
    src, spec = hash_table.key_source(keys, (4, 1, 2), (12, 3, 1))
    assert src is keys and (spec.arity, spec.row_stride) == (3, 6)
    assert list(spec.col)[:3] == [4, 1, 2] and list(spec.stride)[:3] == [12, 3, 1]
    src, spec = hash_table.key_source(keys, (0, 1, 2, 3), (64, 16, 4, 1))
    assert spec.arity == 0
    assert torch.equal(src, storage.linear_ids(keys[:, :4], (4, 4, 4, 4)))
    table = torch.full((8,), EMPTY, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        hash_table.hash_probe_keys(table, keys.long(), (0,), (1,))
    with pytest.raises(ValueError, match="int32"):
        hash_table.hash_insert_targets_keys(table, keys, (0, 1), (2 ** 31, 1))
    with pytest.raises(ValueError, match="outside"):
        hash_table.hash_probe_keys(table, keys, (6,), (1,))


WIDE_DOMS = (5, 3, 4, 6, 2)


@pytest.mark.parametrize("cols", [(0, 1, 2, 3), (4, 0, 3, 1, 2)])
def test_wide_keys_match_reference(cols):
    """Keys of 4 and 5 columns (wider than the kernels linearize): the
    keyed claim builds the reference's table and targets, and the keyed
    probe gives the reference's ``linear_ids`` → ``_find_slots`` slots,
    flags and gather rows."""
    rng = np.random.default_rng(len(cols))
    doms = [WIDE_DOMS[c] for c in cols]
    strides = storage.row_major_strides(doms)
    keys = np.stack([rng.integers(0, d, size=40) for d in WIDE_DOMS], axis=1)
    keys = keys.astype(np.int32)
    ids = np.asarray(rstorage.linear_ids(jnp.asarray(keys[:, list(cols)]), tuple(doms)))
    C = 64
    r_table, r_target = _ref_targets(jnp.full((C,), EMPTY, jnp.int32), jnp.asarray(ids))
    t_table = torch.full((C,), EMPTY, dtype=torch.int32)
    got = hash_table.hash_insert_targets_keys(t_table, _t(keys), cols, strides)
    np.testing.assert_array_equal(t_table.numpy(), np.asarray(r_table))
    np.testing.assert_array_equal(got.numpy(), np.asarray(r_target))
    queries = np.concatenate([keys, keys[::-1] % 2]).astype(np.int32)
    q_ids = np.asarray(rstorage.linear_ids(jnp.asarray(queries[:, list(cols)]), tuple(doms)))
    want = _ref_probe_rows(r_table, jnp.asarray(q_ids))
    got = hash_table.hash_probe_keys(t_table, _t(queries), cols, strides)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _wide_group_by(rng):
    """A group-by over four key columns (free variables A, B, C, D), every
    view forced sparse, both packages' queries, database and a stream."""
    from repro.core import COOUpdate as RCOO
    from repro.core import DenseRelation as RDense
    from repro.core import Query as RQuery
    from repro_torch import convert
    from repro_torch.core import Query

    doms = dict(A=4, B=3, C=5, D=6, E=3)
    kw = dict(relations={"R": ("A", "B", "C", "D"), "S": ("D", "E")},
              free_vars=("A", "B", "C", "D"), domains=doms, lifts={"E": ("value",)})
    rq, tq = RQuery(ring=rsum(), **kw), Query(ring=sum_ring(), **kw)
    rdb = {}
    for name, sch in rq.relations.items():
        mult = (rng.random(tuple(doms[v] for v in sch)) < 0.3).astype(np.float32)
        rdb[name] = RDense(tuple(sch), rq.ring, {"v": jnp.asarray(mult)})
    stream = []
    for rel in ("R", "S", "R", "S", "R"):
        sch = rq.relations[rel]
        keys = np.stack([rng.integers(0, doms[v], size=9) for v in sch], axis=1)
        vals = rng.integers(-2, 3, size=9).astype(np.float32)
        stream.append((rel, RCOO(sch, jnp.asarray(keys.astype(np.int32)),
                                 {"v": jnp.asarray(vals)})))
    tdb = convert.database_from_numpy(P.db_to_numpy(rdb), tq.ring, device="cpu")
    vo = (["A", "B", "C", "D"], {"D": [["E"]]})
    return rq, tq, rdb, tdb, stream, vo


def test_four_column_sparse_view_matches_reference():
    """A sparse view keyed by four columns (a group-by's root view): its
    probes and claims go through the wide-key path and every view, key
    tables included, stays bitwise equal to the reference's."""
    from repro.core import IVMEngine as RefEngine
    from repro.core import chain as rchain
    from repro_torch.core import IVMEngine, chain

    rq, tq, rdb, tdb, stream, (order, below) = _wide_group_by(np.random.default_rng(5))
    ref = RefEngine.build(rq, rdb, var_order=rchain(order, below), storage="sparse")
    eng = IVMEngine.build(tq, tdb, var_order=chain(order, below), storage="sparse",
                          device="cpu")
    wide = [n for n, v in eng.views.items()
            if isinstance(v, SparseRelation) and len(v.schema) > hash_table.MAX_KEY_ARITY]
    assert wide, {n: v.schema for n, v in eng.views.items()}
    for i, (rel, upd) in enumerate(stream):
        ref.apply_update(rel, upd)
        eng.apply_update(rel, P.port_update(upd, tq.ring))
        P.assert_sparse_views_equal(P.sparse_views(ref), eng, f"update {i}")


def test_widest_key_of_the_port_plans_fits_the_kernels():
    """Every view of the retailer and housing plans, stored sparse, has a
    key the kernels linearize: the widest, 3 columns, is the kernels'
    limit (MAX_KEY_ARITY)."""
    from repro_torch.core import IVMEngine, Query
    from repro_torch.data import synth

    widest = 0
    for rels, doms, vo, lifts in (
            (synth.RETAILER_RELATIONS, synth.RETAILER_DOMS, synth.retailer_vo(),
             {"units": ("value",)}),
            (synth.HOUSING_RELATIONS, synth.HOUSING_DOMS, synth.housing_vo(),
             {"h2": ("value",)})):
        q = Query(relations=rels, free_vars=(), ring=sum_ring(), domains=doms, lifts=lifts)
        db = synth.synth_db(rels, doms, q.ring, np.random.default_rng(0), device="cpu")
        eng = IVMEngine.build(q, db, var_order=vo, device="cpu", storage="sparse")
        widest = max(widest, *(len(v.schema) for v in eng.views.values()))
    assert widest == hash_table.MAX_KEY_ARITY == 3
