"""The port's indicator projections (paper Sec. 6) and host rings ≡ the
reference's.

GYO reduction, Fig. 7's annotation, ``indicator_of``, ``IndicatorState``
(init and the transition-count update, padding rows and 0↔non-0 flips
included), the sparse-hostile profile, the host rings, ``PyRelation`` and
``to_py``, each fed the same numpy inputs through ``repro`` and
``repro_torch`` (on the CPU).  Integer-valued data: bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as P  # noqa: E402

P.cap_torch_threads()
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.core import COOUpdate as RCOO  # noqa: E402
from repro.core import DenseRelation as RDense  # noqa: E402
from repro.core import Query as RQuery  # noqa: E402
from repro.core import build_view_tree as rbuild  # noqa: E402
from repro.core import chain as rchain  # noqa: E402
from repro.core import indicators as rind  # noqa: E402
from repro.core import materialize as rmat  # noqa: E402
from repro.core import rings as rrings  # noqa: E402
from repro.core import sum_ring as rsum  # noqa: E402
from repro.core.apps import regression as rreg  # noqa: E402
from repro.core.relations import PyRelation as RPy  # noqa: E402
from repro.core.storage import SparseRelation as RSparse  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import (DenseRelation, PyRelation, Query,  # noqa: E402
                              SparseRelation, build_view_tree, chain,
                              gather_scatter_profile, sum_ring)
from repro_torch.core import indicators as tind  # noqa: E402
from repro_torch.core import rings as trings  # noqa: E402
from repro_torch.core.apps import regression as treg  # noqa: E402

N = 6
TRIANGLE = {"R": ("A", "B"), "S": ("B", "C"), "T": ("C", "A")}
GYO_CASES = {
    "triangle": ["AB", "BC", "CA"],
    "example_1_1": ["AB", "ACE", "CD"],
    "four_cycle": ["AB", "BC", "CD", "DA"],
    "four_cycle_chord": ["AB", "BC", "CD", "DA", "AC"],
    "star": ["AB", "AC", "AD"],
    "one_edge": ["ABC"],
    "contained": ["AB", "ABC", "BC"],
    "two_triangles": ["AB", "BC", "CA", "CD", "DE", "EC"],
}


@pytest.mark.parametrize("case", sorted(GYO_CASES))
def test_gyo_residual_and_acyclicity_match_reference(case):
    edges = [frozenset(e) for e in GYO_CASES[case]]
    assert tind.gyo_residual(list(edges)) == rind.gyo_residual(list(edges))
    assert tind.is_acyclic(list(edges)) == rind.is_acyclic(list(edges))


#: (relations, variable order) pairs for Fig. 7's annotation
ANNOTATE_CASES = {
    "triangle_abc": (TRIANGLE, ["A", "B", "C"]),
    "triangle_cab": (TRIANGLE, ["C", "A", "B"]),
    "four_cycle": ({"R": ("A", "B"), "S": ("B", "C"), "T": ("C", "D"),
                    "U": ("D", "A")}, ["A", "B", "C", "D"]),
    "acyclic": ({"R": ("A", "B"), "S": ("A", "C", "E"), "T": ("C", "D")},
                ["A", "C", "B", "D", "E"]),
}


def _queries(rels, n=N, ring="sum"):
    doms = {v: n for sch in rels.values() for v in sch}
    if ring == "sum":
        return (RQuery(relations=rels, free_vars=(), ring=rsum(), domains=doms,
                       lifts={}),
                Query(relations=rels, free_vars=(), ring=sum_ring(),
                      domains=doms, lifts={}))
    return rreg.cofactor_query(rels, doms), treg.cofactor_query(rels, doms)


@pytest.mark.parametrize("case", sorted(ANNOTATE_CASES))
def test_add_indicators_matches_reference(case):
    rels, order = ANNOTATE_CASES[case]
    rq, tq = _queries(rels)
    rtree = rind.add_indicators(rbuild(rq, rchain(order), fuse_chains=False), rq)
    ttree = tind.add_indicators(build_view_tree(tq, chain(order),
                                                fuse_chains=False), tq)
    want = [(n.name, n.indicator, n.rels) for n in rtree.walk()]
    assert [(n.name, n.indicator, n.rels) for n in ttree.walk()] == want
    assert ttree.pretty() == rtree.pretty()
    updatable = tuple(rels)
    assert gather_scatter_profile(ttree, updatable) == \
        rmat.gather_scatter_profile(rtree, updatable)


def _rel_pair(arr, schema, rq, tq):
    """The same multiplicity array as a reference and a port relation."""
    if isinstance(tq.ring, trings.DegreeMRing):
        ref = rreg.relation_from_multiplicities(schema, rq.ring, jnp.asarray(arr))
        port = treg.relation_from_multiplicities(schema, tq.ring,
                                                 torch.tensor(arr))
        return ref, port
    return (RDense(schema, rq.ring, {"v": jnp.asarray(arr)}),
            DenseRelation(schema, tq.ring, {"v": torch.tensor(arr)}))


def _assert_state_equal(port, ref):
    np.testing.assert_array_equal(port.counts.numpy(), np.asarray(ref.counts))
    assert port.counts.dtype == torch.int32
    assert port.dense.schema == ref.dense.schema
    for c, a in ref.dense.payload.items():
        np.testing.assert_array_equal(port.dense.payload[c].numpy(), np.asarray(a))


@pytest.mark.parametrize("ring", ["sum", "cofactor"])
@pytest.mark.parametrize("proj", [("A", "B"), ("B", "A"), ("A",), ("B",)])
def test_indicator_state_init_matches_reference(proj, ring):
    rq, tq = _queries({"R": ("A", "B")}, ring=ring)
    arr = (np.random.default_rng(3).integers(-1, 2, size=(N, N + 1))
           * (np.arange(N + 1) % 3 != 0)).astype(np.float32)
    rrel, trel = _rel_pair(arr, ("A", "B"), rq, tq)
    ref = rind.IndicatorState.init("R", rrel, proj, rq)
    port = tind.IndicatorState.init("R", trel, proj, tq)
    _assert_state_equal(port, ref)
    want = rind.indicator_of(rrel, proj, rq)
    got = tind.indicator_of(trel, proj, tq)
    for c, a in want.payload.items():
        np.testing.assert_array_equal(got.payload[c].numpy(), np.asarray(a))


def _flip_batch(rng, arr, ring_comps, n_pad, with_origin=False):
    """A duplicate-free batch over R(A, B) whose rows switch keys on (0 to
    ±1), off (to 0) and between non-zero values, then ``n_pad`` padding
    rows (key 0, a ring-zero payload) as the stream executor pads; with
    ``with_origin`` the first real row is at key 0 too."""
    flat = rng.choice(np.arange(1, arr.size), size=8, replace=False)
    if with_origin:
        flat[0] = 0
    keys = np.stack(np.unravel_index(flat, arr.shape), axis=1).astype(np.int32)
    old = arr[tuple(keys.T)]
    vals = np.where(old != 0, -old, rng.choice([-1.0, 1.0], size=8))
    vals[:2] = np.where(old[:2] != 0, 1.0, 2.0)  # non-zero stays non-zero
    vals = vals.astype(np.float32)
    keys = np.concatenate([keys, np.zeros((n_pad, 2), np.int32)])
    vals = np.concatenate([vals, np.zeros(n_pad, np.float32)])
    payload = {c: np.zeros((len(vals),) + shp, np.float32)
               for c, shp in ring_comps.items()}
    payload["c" if "c" in payload else "v"] = vals
    return keys, payload


@pytest.mark.parametrize("ring", ["sum", "cofactor"])
@pytest.mark.parametrize("proj", [("A", "B"), ("B", "A")])
def test_delta_for_update_matches_reference(proj, ring):
    """Counts, the 0/1 plane and δ∃ after batches with 0↔non-0 flips and
    padding rows (whose key 0 a real row of the batch flips too)."""
    rng = np.random.default_rng(7)
    rq, tq = _queries({"R": ("A", "B")}, ring=ring)
    arr = rng.integers(0, 2, size=(N, N)).astype(np.float32)
    rrel, trel = _rel_pair(arr, ("A", "B"), rq, tq)
    ref = rind.IndicatorState.init("R", rrel, proj, rq)
    port = tind.IndicatorState.init("R", trel, proj, tq)
    for step in range(4):
        # step 1: a real row on the padding rows' key 0
        keys, payload = _flip_batch(rng, arr, rq.ring.components, n_pad=3,
                                    with_origin=step == 1)
        rupd = RCOO(("A", "B"), jnp.asarray(keys),
                    {c: jnp.asarray(v) for c, v in payload.items()})
        tupd = P.port_update(rupd, tq.ring)
        ref, rd = ref.delta_for_update(rq, rupd, rrel)
        port, td = port.delta_for_update(tq, tupd, trel.gather(tupd.keys))
        rrel = rrel.scatter_add(rupd.keys, rupd.payload)
        trel = trel.scatter_add(tupd.keys, tupd.payload)
        np.add.at(arr, tuple(keys.T), payload["c" if "c" in payload else "v"])
        _assert_state_equal(port, ref)
        assert td.schema == rd.schema
        np.testing.assert_array_equal(td.keys.numpy(), np.asarray(rd.keys))
        for c, a in rd.payload.items():
            np.testing.assert_array_equal(td.payload[c].numpy(), np.asarray(a))
        # and a recount from the relation as it now is
        counts = (arr != 0).astype(np.int32)
        if proj == ("B", "A"):
            counts = counts.T
        np.testing.assert_array_equal(port.counts.numpy(), counts)


def test_delta_for_update_touches_state_in_place():
    """The counts and the plane are the state's own tensors after an
    update (the stream executor's graphs write them where they were)."""
    rq, tq = _queries({"R": ("A", "B")})
    arr = np.eye(N, dtype=np.float32)
    _, trel = _rel_pair(arr, ("A", "B"), rq, tq)
    st = tind.IndicatorState.init("R", trel, ("A", "B"), tq)
    leaves = [t.data_ptr() for t in st.leaves()]
    keys = torch.tensor([[0, 0], [1, 2]], dtype=torch.int32)
    upd = P.port_update(RCOO(("A", "B"), jnp.asarray(keys.numpy()),
                             {"v": jnp.asarray([-1.0, 1.0], jnp.float32)}),
                        tq.ring)
    new, _ = st.delta_for_update(tq, upd, trel.gather(upd.keys))
    assert [t.data_ptr() for t in new.leaves()] == leaves
    assert new.counts[0, 0] == 0 and new.counts[1, 2] == 1


# ---------------------------------------------------------------------------
# Host rings, PyRelation, to_py
# ---------------------------------------------------------------------------
def _py_payloads(name, rng):
    if name == "number":
        return [int(x) for x in rng.integers(-3, 4, size=3)]
    if name == "degree":
        return [(float(rng.integers(-2, 3)), rng.integers(-2, 3, 3).astype(float),
                 rng.integers(-2, 3, (3, 3)).astype(float)) for _ in range(3)]
    return [{((v, int(x)),): int(m) for v, x, m in zip(
        "XY", rng.integers(0, 3, 2), rng.integers(1, 3, 2))} for _ in range(3)]


RING_PAIRS = {
    "number": (lambda: trings.PyNumberRing(), lambda: rrings.PyNumberRing()),
    "degree": (lambda: trings.PyDegreeMRing(3), lambda: rrings.PyDegreeMRing(3)),
    "relational": (lambda: trings.PyRelationalRing(tagged=True),
                   lambda: rrings.PyRelationalRing(tagged=True)),
}


def _same(a, b):
    if isinstance(a, tuple) and a and isinstance(a[1], np.ndarray):
        return all(np.array_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("name", sorted(RING_PAIRS))
def test_host_rings_match_reference(name):
    port, ref = (f() for f in RING_PAIRS[name])
    a, b, c = _py_payloads(name, np.random.default_rng(1))
    for op in ("add", "mul"):
        assert _same(getattr(port, op)(a, b), getattr(ref, op)(a, b))
        assert _same(getattr(port, op)(getattr(port, op)(a, b), c),
                     getattr(ref, op)(getattr(ref, op)(a, b), c))
    assert _same(port.neg(a), ref.neg(a))
    assert _same(port.zero(), ref.zero()) and _same(port.one(), ref.one())
    assert port.is_zero(port.zero()) and not port.is_zero(port.one())
    if name == "degree":
        assert _same(port.lift(3.0, var_index=1), ref.lift(3.0, var_index=1))
    else:
        assert _same(port.lift(3), ref.lift(3))
    assert port.name == ref.name


def test_pyrelation_algebra_matches_reference():
    rng = np.random.default_rng(4)
    pr, rr = trings.PyNumberRing(), rrings.PyNumberRing()

    def pair(schema, n):
        data = {tuple(int(x) for x in rng.integers(0, 3, len(schema))):
                int(rng.integers(1, 4)) for _ in range(n)}
        return PyRelation(schema, pr, data), RPy(schema, rr, data)

    (p1, r1), (p2, r2) = pair(("A", "B"), 6), pair(("B", "C"), 6)
    assert p1.join(p2).data == r1.join(r2).data
    assert p1.join(p2).schema == r1.join(r2).schema
    lift = lambda x: x + 1  # noqa: E731
    assert p1.marginalize("B", lift).data == r1.marginalize("B", lift).data
    assert p1.union(p1).data == r1.union(r1).data
    assert p1.reorder(("B", "A")).data == r1.reorder(("B", "A")).data
    assert p1.equals(p1.reorder(("B", "A")))
    assert len(p1) == len(r1)


@pytest.mark.parametrize("storage", ["dense", "sparse"])
@pytest.mark.parametrize("ring", ["sum", "cofactor"])
def test_to_py_matches_reference(ring, storage):
    rq, tq = _queries({"R": ("A", "B")}, ring=ring)
    arr = (np.random.default_rng(6).integers(-1, 3, size=(N, N))
           * (np.random.default_rng(7).random((N, N)) < 0.4)).astype(np.float32)
    rrel, trel = _rel_pair(arr, ("A", "B"), rq, tq)
    if storage == "sparse":
        rrel, trel = RSparse.from_dense(rrel), SparseRelation.from_dense(trel)
    py_ref = (rrings.PyNumberRing() if ring == "sum"
              else rrings.PyDegreeMRing(2))
    py_port = (trings.PyNumberRing() if ring == "sum"
               else trings.PyDegreeMRing(2))
    want, got = rrel.to_py(py_ref), trel.to_py(py_port)
    assert set(got.data) == set(want.data) and got.data
    for k, v in want.data.items():
        assert _same(tuple(np.asarray(x) for x in got.data[k]) if ring != "sum"
                     else got.data[k],
                     tuple(np.asarray(x) for x in v) if ring != "sum" else v)


def test_indicator_state_crosses_from_numpy():
    """``convert.indicator_from_numpy`` starts the port from the
    reference's state: equal counts and plane, its own tensors."""
    rq, tq = _queries({"R": ("A", "B")}, ring="cofactor")
    arr = np.random.default_rng(8).integers(0, 2, size=(N, N)).astype(np.float32)
    rrel, _ = _rel_pair(arr, ("A", "B"), rq, tq)
    ref = rind.IndicatorState.init("R", rrel, ("A", "B"), rq)
    port = convert.indicator_from_numpy(
        "R", ref.proj, np.asarray(ref.counts),
        {c: np.asarray(a) for c, a in ref.dense.payload.items()}, tq.ring,
        device="cpu")
    _assert_state_equal(port, ref)
    assert port.rel_name == "R" and port.proj == ("A", "B")


def test_partial_projection_batch_matches_reference():
    """∃_A R(A, B) under one batch of two new tuples with the same A: the
    reference's plane reaches 2 at that key (each row sees the count cross
    0 → 2 and emits +1; ROADMAP Queue 3), and the port equals it, counts,
    plane and δ∃.  The triangle query's projections are whole keys, which
    this cannot reach."""
    rq, tq = _queries({"R": ("A", "B")})
    arr = np.zeros((N, N), np.float32)
    rrel, trel = _rel_pair(arr, ("A", "B"), rq, tq)
    ref = rind.IndicatorState.init("R", rrel, ("A",), rq)
    port = tind.IndicatorState.init("R", trel, ("A",), tq)
    rupd = RCOO(("A", "B"), jnp.asarray([[0, 1], [0, 2]], jnp.int32),
                {"v": jnp.ones(2, jnp.float32)})
    tupd = P.port_update(rupd, tq.ring)
    ref, rd = ref.delta_for_update(rq, rupd, rrel)
    port, td = port.delta_for_update(tq, tupd, trel.gather(tupd.keys))
    _assert_state_equal(port, ref)
    np.testing.assert_array_equal(td.payload["v"].numpy(), np.asarray(rd.payload["v"]))
    assert float(port.dense.payload["v"][0]) == 2.0
