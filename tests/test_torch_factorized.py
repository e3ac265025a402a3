"""The port's factorized updates ≡ the reference's (paper Sec. 5).

``FactorizedUpdate``, the factorized trigger kind (plans, the factor-list
interpreter, dense and sparse outer-product ⊎), ``propagate_factorized``
and the converter, fed the same numpy inputs through ``repro`` and
``repro_torch`` (on the CPU).  Integer-valued data must match bit for bit
(every sum is exact in float32, whatever its order); normal data within
1e-6 of the largest magnitude, the North star's bound for a reordered
float32 sum.  Also: :func:`repro_torch.core.plan.factorized_route` on every
shape of its table, and the two kernel routes against the reference's
absorb / marginalize / apply forms they replace.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as P  # noqa: E402

P.cap_torch_threads()
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.core import DenseRelation as RDense  # noqa: E402
from repro.core import FactorizedUpdate as RFact  # noqa: E402
from repro.core import IVMEngine as REngine  # noqa: E402
from repro.core import Query as RQuery  # noqa: E402
from repro.core import chain as rchain  # noqa: E402
from repro.core import plan as rplan  # noqa: E402
from repro.core import propagate_factorized as rpropagate  # noqa: E402
from repro.core import sum_ring as rsum  # noqa: E402
from repro.core.storage import SparseRelation as RSparse  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import (DegreeMRing, DenseRelation, FactorizedUpdate,  # noqa: E402
                              IVMEngine, Query, SparseRelation, chain,
                              count_ring, propagate_factorized, sum_ring)
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core import stream as tstream  # noqa: E402

#: the reference's example query of tests/test_ivm_core.py
DOMS = dict(A=4, B=5, C=3, D=6, E=4)
RELATIONS = {"R": ("A", "B"), "S": ("A", "C", "E"), "T": ("C", "D")}
LIFTS = {"B": ("value",), "D": ("value",), "E": ("value",)}
#: normal data: within this share of the largest magnitude (a reordered
#: float32 sum of a few terms rounds far below it)
RTOL = 1e-6
STRATEGIES = ["fivm", "fivm_1", "dbt", "reeval"]


def _queries():
    rq = RQuery(relations=RELATIONS, free_vars=("A", "C"), ring=rsum(),
                domains=DOMS, lifts=LIFTS)
    tq = Query(relations=RELATIONS, free_vars=("A", "C"), ring=sum_ring(),
               domains=DOMS, lifts=LIFTS)
    return rq, tq


def _vo(pkg_chain):
    return pkg_chain(["A", "C"], {"A": [["B"]], "C": [["D"], ["E"]]})


def _values(rng, shape, data):
    if data == "ints":
        return rng.integers(-2, 3, size=shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _db(rng, data):
    return {name: RDense(sch, rsum(), {"v": jnp.asarray(_values(
                rng, tuple(DOMS[v] for v in sch), data))})
            for name, sch in RELATIONS.items()}


def _ref_update(rng, rel, data):
    """A reference FactorizedUpdate to ``rel``: one 1-D factor a variable."""
    sch = RELATIONS[rel]
    return RFact(sch, tuple(RDense((v,), rsum(), {"v": jnp.asarray(
        _values(rng, (DOMS[v],), data))}) for v in sch))


def _assert_views(ref, eng, data, where):
    if data == "ints":
        P.assert_views_equal(ref, eng, where)
    else:
        P.assert_views_close(ref, eng, RTOL, where)


@pytest.mark.parametrize("data", ["ints", "normal"])
def test_densify_matches_reference(data):
    rng = np.random.default_rng(0)
    parts = [(("A",), (4,)), ((), ()), (("C", "E"), (3, 4))]
    arrays = [_values(rng, shape, data) for _, shape in parts]
    ref = RFact(("E", "A", "C"), tuple(
        RDense(sch, rsum(), {"v": jnp.asarray(a)})
        for (sch, _), a in zip(parts, arrays)))
    port = convert.factorized_update_from_numpy(
        ref.schema, [(sch, {"v": a}) for (sch, _), a in zip(parts, arrays)],
        sum_ring(), device="cpu")
    want = ref.densify(rsum())
    got = port.densify(sum_ring())
    assert got.schema == tuple(want.schema) == ("E", "A", "C")
    # one rounded product an element, in the same order: bitwise on any data
    np.testing.assert_array_equal(got.payload["v"].numpy(),
                                  np.asarray(want.payload["v"]))
    assert port.factor_for("C").schema == ("C", "E")
    with pytest.raises(KeyError):
        port.factor_for("B")


def test_factor_schemas_must_cover_disjointly():
    ring = sum_ring()
    a = DenseRelation(("A",), ring, {"v": torch.ones(4)})
    ac = DenseRelation(("A", "C"), ring, {"v": torch.ones(4, 3)})
    with pytest.raises(ValueError, match="disjoint"):
        FactorizedUpdate(("A", "C"), (a, ac))
    with pytest.raises(ValueError, match="cover"):
        FactorizedUpdate(("A", "C"), (a,))
    with pytest.raises(AssertionError):  # the reference asserts the same
        RFact(("A", "C"), (RDense(("A",), rsum(), {"v": jnp.ones(4)}),))


@pytest.mark.parametrize("data", ["ints", "normal"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_factorized_updates_match_reference(strategy, data):
    """The reference's test_factorized_updates_equal_dense query: a
    factorized update to each relation in turn (S's, a product of three
    vectors, twice), every view compared after every update, and the
    compiled plans' text."""
    rng = np.random.default_rng(11)
    rq, tq = _queries()
    rdb = _db(rng, data)
    ref = REngine.build(rq, rdb, var_order=_vo(rchain), strategy=strategy,
                        storage="dense")
    eng = IVMEngine.build(tq, convert.database_from_numpy(
        P.db_to_numpy(rdb), tq.ring, device="cpu"), var_order=_vo(chain),
        strategy=strategy, storage="dense", device="cpu")
    _assert_views(ref, eng, data, "build")
    for i, rel in enumerate(["S", "R", "T", "S"]):
        upd = _ref_update(rng, rel, data)
        tupd = P.port_update(upd, tq.ring)
        want = ref.trigger_plan(rel, upd).pretty().replace(" indicators=[]", "")
        assert eng.trigger_plan(rel, tupd).pretty() == want
        ref.apply_update(rel, upd)
        eng.apply_update(rel, tupd)
        _assert_views(ref, eng, data, f"update {i} ({rel})")
        # base relations add the densified product: bitwise on any data
        for name, rb in ref.base.items():
            np.testing.assert_array_equal(eng.base[name].payload["v"].numpy(),
                                          np.asarray(rb.payload["v"]))


def test_factorized_plan_kinds_and_write_sets():
    rq, tq = _queries()
    rng = np.random.default_rng(2)
    rdb = _db(rng, "ints")
    db = convert.database_from_numpy(P.db_to_numpy(rdb), tq.ring, device="cpu")
    kinds = {}
    for strategy in STRATEGIES:
        eng = IVMEngine.build(tq, db, var_order=_vo(chain), strategy=strategy,
                              storage="dense", device="cpu")
        p = eng.plans.lookup_sig(eng, "S", ("factorized", ("A", "C", "E")))
        kinds[strategy] = (p.kind, p.batch)
        assert eng.plans.write_sets(eng, "S") == (p.write_views, p.write_base,
                                                  p.write_indicators)
        assert tplan.read_sets([p]) == p.read_views()
        # a factorized lookup hits the cached plan
        upd = P.port_update(_ref_update(rng, "S", "ints"), tq.ring)
        assert eng.trigger_plan("S", upd) is p
    # 1-IVM densifies the update over its whole domain grid
    assert kinds == {"fivm": ("factorized", None), "dbt": ("factorized", None),
                     "fivm_1": ("first_order", 4 * 3 * 4),
                     "reeval": ("reeval", None)}


def test_fusion_leaves_factorized_plans_alone():
    rq, tq = _queries()
    db = convert.database_from_numpy(
        P.db_to_numpy(_db(np.random.default_rng(3), "ints")), tq.ring,
        device="cpu")
    sig = ("factorized", ("A", "C", "E"))
    texts = []
    for mode in ("off", "on"):
        with tplan.use_fusion(mode):
            eng = IVMEngine.build(tq, db, var_order=_vo(chain),
                                  storage="dense", device="cpu")
            p = eng.plans.lookup_sig(eng, "S", sig)
            assert tplan.fuse_trigger_ops(p, tq, eng.views) is p
            assert not any(isinstance(op, tplan.FusedChain) for op in p.ops)
            texts.append(p.pretty())
    assert texts[0] == texts[1]


def test_propagate_factorized_matches_reference():
    rng = np.random.default_rng(5)
    rq, tq = _queries()
    rdb = _db(rng, "ints")
    ref = REngine.build(rq, rdb, var_order=_vo(rchain), storage="dense")
    eng = IVMEngine.build(tq, convert.database_from_numpy(
        P.db_to_numpy(rdb), tq.ring, device="cpu"), var_order=_vo(chain),
        storage="dense", device="cpu")
    upd = _ref_update(rng, "S", "ints")
    want = rpropagate(ref.tree, ref.views, rq, "S", upd)
    got = propagate_factorized(eng.tree, eng.views, tq, "S",
                               P.port_update(upd, tq.ring))
    assert set(got.updated) == set(want.updated)
    assert list(got.deltas) == list(want.deltas)
    for name, rv in want.updated.items():
        np.testing.assert_array_equal(got.updated[name].payload["v"].numpy(),
                                      np.asarray(rv.payload["v"]))
    for name, rd in want.deltas.items():
        np.testing.assert_array_equal(
            got.deltas[name].densify(tq.ring).payload["v"].numpy(),
            np.asarray(rd.densify(rq.ring).payload["v"]))


def test_stream_executor_refuses_factorized_updates():
    rq, tq = _queries()
    rng = np.random.default_rng(4)
    db = convert.database_from_numpy(P.db_to_numpy(_db(rng, "ints")), tq.ring,
                                     device="cpu")
    eng = IVMEngine.build(tq, db, var_order=_vo(chain), device="cpu")
    upd = P.port_update(_ref_update(rng, "S", "ints"), tq.ring)
    with pytest.raises(TypeError, match="apply_update"):
        tstream.prepare_stream(eng, [("S", upd)])


def test_converter_carries_reference_factors():
    rng = np.random.default_rng(6)
    ref = _ref_update(rng, "S", "normal")
    for ring, dtype in ((sum_ring(), torch.float32),
                        (sum_ring(torch.float64), torch.float64)):
        port = convert.factorized_update_from_numpy(ref.schema, ref.factors,
                                                    ring, device="cpu")
        assert isinstance(port, FactorizedUpdate)
        assert port.schema == ("A", "C", "E")
        for f, rf in zip(port.factors, ref.factors):
            assert f.schema == tuple(rf.schema) and f.ring is ring
            assert f.payload["v"].dtype == dtype
            assert f.payload["v"].device.type == "cpu"
            np.testing.assert_array_equal(
                f.payload["v"].numpy(),
                np.asarray(rf.payload["v"]).astype(f.payload["v"].numpy().dtype))


# ---------------------------------------------------------------------------
# sparse factorized ⊎ (the reference's tests/test_plan.py:473-532)
# ---------------------------------------------------------------------------
def _sparse_pair(rng):
    keys = np.stack([rng.integers(0, 6, 8), rng.integers(0, 5, 8)],
                    1).astype(np.int32)
    vals = rng.integers(-2, 3, 8).astype(np.float32)
    rdense = RDense.from_coo(("X", "Y"), rsum(), (6, 5), jnp.asarray(keys),
                             {"v": jnp.asarray(vals)})
    tdense = DenseRelation.from_coo(("X", "Y"), sum_ring(), (6, 5),
                                    torch.tensor(keys), {"v": torch.tensor(vals)})
    return (rdense, RSparse.from_dense(rdense, capacity=64),
            tdense, SparseRelation.from_dense(tdense, capacity=64))


def test_sparse_factorized_apply_matches_reference():
    rng = np.random.default_rng(1)
    rdense, rsparse, tdense, tsparse = _sparse_pair(rng)
    u = np.zeros(6, np.float32)
    u[[1, 4]] = [2.0, -3.0]
    v = np.zeros(5, np.float32)
    v[[0, 2, 3]] = [1.0, 5.0, -1.0]
    arrays = [(("X",), u), ((), np.float32(2.5)), (("Y",), v)]
    rfactors = [RDense(s, rsum(), {"v": jnp.asarray(a)}) for s, a in arrays]
    tfactors = [DenseRelation(s, sum_ring(), {"v": torch.tensor(a)})
                for s, a in arrays]
    before = tsparse.num_slots_used_sync()
    want = rplan.apply_factorized(rsparse, rfactors, rsum())
    got = tplan.apply_factorized(tsparse, tfactors, sum_ring())
    dense = tplan.apply_factorized(tdense, tfactors, sum_ring())
    np.testing.assert_array_equal(got.to_dense().payload["v"].numpy(),
                                  dense.payload["v"].numpy())
    np.testing.assert_array_equal(dense.payload["v"].numpy(),
                                  np.asarray(rplan.apply_factorized(
                                      rdense, rfactors, rsum()).payload["v"]))
    # the reference's table, slot for slot: at most 2 × 3 fresh keys
    np.testing.assert_array_equal(got.table.numpy(), np.asarray(want.table))
    np.testing.assert_array_equal(got.payload["v"].numpy(),
                                  np.asarray(want.payload["v"]))
    assert got.num_slots_used_sync() <= before + 2 * 3


def test_zero_factor_inserts_nothing():
    ring = sum_ring()
    sparse = SparseRelation.zeros(("X", "Y"), ring, (8, 8), capacity=16,
                                  device="cpu")
    factors = [DenseRelation(("X",), ring, {"v": torch.zeros(8)}),
               DenseRelation(("Y",), ring, {"v": torch.ones(8)})]
    out = tplan.apply_factorized(sparse, factors, ring)
    assert out.num_slots_used_sync() == 0
    with pytest.raises(ValueError, match="cover"):
        tplan.apply_factorized(sparse, factors[:1], ring)


def test_insert_budget_matches_reference():
    """A factorized update's growth budget: the product of its factors'
    active key counts (the sparse lowering's inserts)."""
    rng = np.random.default_rng(8)
    rq, tq = _queries()
    rdb = _db(rng, "ints")
    ref = REngine.build(rq, rdb, var_order=_vo(rchain), storage="sparse")
    eng = IVMEngine.build(tq, convert.database_from_numpy(
        P.db_to_numpy(rdb), tq.ring, device="cpu"), var_order=_vo(chain),
        storage="sparse", device="cpu")
    upd = _ref_update(rng, "S", "ints")
    tupd = P.port_update(upd, tq.ring)
    budgets = {name: eng._insert_budget(v, "S", tupd)
               for name, v in eng.views.items()}
    assert any(budgets.values())
    assert budgets == {name: ref._insert_budget(v, "S", upd)
                       for name, v in ref.views.items()}
    ref.apply_update("S", upd)
    eng.apply_update("S", tupd)
    P.assert_views_close(ref, eng, 0.0, "sparse S")


# ---------------------------------------------------------------------------
# the kernel routes
# ---------------------------------------------------------------------------
def _vec(var, n, ring=None, dtype=torch.float32):
    ring = ring or sum_ring(dtype)
    return DenseRelation((var,), ring, {"v": torch.arange(1.0, n + 1, dtype=dtype)})


def _mat(schema, shape, ring=None):
    ring = ring or sum_ring()
    return DenseRelation(schema, ring, {"v": torch.ones(shape, dtype=ring.dtype)})


def _route_query(lift=("one",), ring=None):
    return Query(relations={"A": ("x", "y")}, free_vars=("x", "y"),
                 ring=ring or sum_ring(), domains=dict(x=4, y=3, z=2),
                 lifts={} if lift == ("one",) else {"x": lift})


JOIN = tplan.JoinContract("V", ("x", "y"), "dense")
LIFT_X = tplan.Lift("x", ("one",))
MARG_X = tplan.Marginalize("x", "factor")
SCATTER = tplan.ScatterAccum("V", "dense")


@pytest.mark.parametrize("case,want", [
    ("join_x_second", "matvec"),
    ("join_x_first", "matvec"),
    ("scatter_two_vectors", "outer"),
    ("join_value_lift", "plain"),
    ("join_no_marg_after", "plain"),
    ("join_marg_other_var", "plain"),
    ("join_two_touching", "plain"),
    ("join_2d_factor", "plain"),
    ("scatter_scalar_factor", "plain"),
    ("scatter_three_factors", "plain"),
    ("scatter_one_2d_factor", "plain"),
    ("degree_ring", "plain"),
    ("count_ring", "plain"),
    ("float64", "plain"),
    ("sparse_view", "plain"),
    ("view_3d", "plain"),
])
def test_factorized_route(case, want):
    q = _route_query()
    V = _mat(("x", "y"), (4, 3))
    op, factors, following = JOIN, [_vec("x", 4), _vec("z", 2)], (LIFT_X, MARG_X)
    if case == "join_x_first":
        V = _mat(("y", "x"), (3, 4))
    elif case == "scatter_two_vectors":
        op, factors = SCATTER, [_vec("y", 3), _vec("x", 4)]
    elif case == "join_value_lift":
        q = _route_query(lift=("value",))
        following = (tplan.Lift("x", ("value",)), MARG_X)
    elif case == "join_no_marg_after":
        following = (tplan.ScatterAccum("W:V", "dense"), LIFT_X)
    elif case == "join_marg_other_var":
        following = (tplan.Lift("z", ("one",)), tplan.Marginalize("z", "factor"))
    elif case == "join_two_touching":
        factors = [_vec("x", 4), _vec("y", 3)]
    elif case == "join_2d_factor":
        factors = [_mat(("x", "z"), (4, 2))]
    elif case == "scatter_scalar_factor":
        op = SCATTER
        factors = [_vec("x", 4), DenseRelation((), sum_ring(), {"v": torch.tensor(2.0)}),
                   _vec("y", 3)]
    elif case == "scatter_three_factors":
        op, V = SCATTER, _mat(("x", "y", "z"), (4, 3, 2))
        factors = [_vec("x", 4), _vec("y", 3), _vec("z", 2)]
    elif case == "scatter_one_2d_factor":
        op, factors = SCATTER, [_mat(("x", "y"), (4, 3))]
    elif case == "degree_ring":
        ring = DegreeMRing(2)
        q = _route_query(ring=ring)
        V = DenseRelation(("x", "y"), ring, ring.ones((4, 3), device="cpu"))
        factors = [DenseRelation(("x",), ring, ring.ones((4,), device="cpu"))]
    elif case == "count_ring":
        ring = count_ring()
        q = _route_query(ring=ring)
        V, factors = _mat(("x", "y"), (4, 3), ring), [_vec("x", 4, ring, torch.int32)]
    elif case == "float64":
        ring = sum_ring(torch.float64)
        q = _route_query(ring=ring)
        V, factors = _mat(("x", "y"), (4, 3), ring), [_vec("x", 4, ring, torch.float64)]
    elif case == "sparse_view":
        V = SparseRelation.from_dense(V)
    elif case == "view_3d":
        V = _mat(("x", "y", "z"), (4, 3, 2))
    assert tplan.factorized_route(op, factors, V, q, following) == want


@pytest.mark.parametrize("data", ["ints", "normal"])
@pytest.mark.parametrize("x_axis", [0, 1])
def test_matvec_route_equals_absorb_then_marginalize(x_axis, data):
    """The matvec route (here the kernel's plain version) against the
    reference's absorb then marginalize: bitwise on integer-valued data,
    within RTOL of the largest magnitude otherwise."""
    rng = np.random.default_rng(9 + x_axis)
    schema = ("x", "y") if x_axis == 0 else ("y", "x")
    shape = (37, 29) if x_axis == 0 else (29, 37)
    V = _values(rng, shape, data)
    f = _values(rng, (37,), data)
    w = _values(rng, (5,), data)
    rq = RQuery(relations={"A": schema}, free_vars=(), ring=rsum(),
                domains=dict(x=37, y=29, z=5), lifts={})
    tq = Query(relations={"A": schema}, free_vars=(), ring=sum_ring(),
               domains=dict(x=37, y=29, z=5), lifts={})
    rfactors = [RDense(("z",), rsum(), {"v": jnp.asarray(w)}),
                RDense(("x",), rsum(), {"v": jnp.asarray(f)})]
    rplan.absorb_factor(rfactors, RDense(schema, rsum(), {"v": jnp.asarray(V)}),
                        rsum())
    rplan.marginalize_factor(rfactors, "x", rq)
    tfactors = [DenseRelation(("z",), sum_ring(), {"v": torch.tensor(w)}),
                DenseRelation(("x",), sum_ring(), {"v": torch.tensor(f)})]
    view = DenseRelation(schema, sum_ring(), {"v": torch.tensor(V)})
    assert tplan.factorized_route(JOIN, tfactors, view, tq,
                                  (LIFT_X, MARG_X)) == "matvec"
    tplan._matvec_join(tfactors, view)
    assert [f.schema for f in tfactors] == [tuple(f.schema) for f in rfactors]
    got, want = tfactors[1].payload["v"].numpy(), np.asarray(rfactors[1].payload["v"])
    np.testing.assert_array_equal(tfactors[0].payload["v"].numpy(), w)
    if data == "ints":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


@pytest.mark.parametrize("order", ["xy", "yx"])
def test_outer_route_equals_apply_factorized(order):
    """The outer route (the kernel's plain version) is the reference's
    contract-then-add bit for bit on normal data: one rounded product and
    one rounded add an element."""
    rng = np.random.default_rng(12)
    V = rng.standard_normal((37, 29)).astype(np.float32)
    u = rng.standard_normal(37).astype(np.float32)
    v = rng.standard_normal(29).astype(np.float32)
    pairs = [(("x",), u), (("y",), v)]
    if order == "yx":
        pairs.reverse()
    want = rplan.apply_factorized(
        RDense(("x", "y"), rsum(), {"v": jnp.asarray(V)}),
        [RDense(s, rsum(), {"v": jnp.asarray(a)}) for s, a in pairs], rsum())
    view = DenseRelation(("x", "y"), sum_ring(), {"v": torch.tensor(V)})
    tfactors = [DenseRelation(s, sum_ring(), {"v": torch.tensor(a)}) for s, a in pairs]
    assert tplan.factorized_route(SCATTER, tfactors, view, _route_query()) == "outer"
    got = tplan._outer_scatter(view, tfactors)
    np.testing.assert_array_equal(got.payload["v"].numpy(), np.asarray(want.payload["v"]))
    np.testing.assert_array_equal(view.payload["v"].numpy(), V)  # out of place
