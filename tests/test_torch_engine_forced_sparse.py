"""Engines with every eligible view forced sparse: the port ≡ the reference.

``storage="sparse"`` keeps every view whose domain allows it as a hashed-COO
table, so triggers take the paths the housing star's ``auto`` plan
(``tests/test_torch_engine_sparse.py``) does not: the densifying joins, the
per-row sparse gathers and the grid-enumerating mixed apply on the retailer
snowflake at ``RETAILER_DOMS``, and the executor's three dispatch modes
over ``tests/test_storage.py``'s mixed engine (one view flipped back to
dense).  Both engines take the same numpy arrays and updates; views are
compared bit for bit, key tables included.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as P  # noqa: E402

P.cap_torch_threads()
jnp = pytest.importorskip("jax.numpy")

from benchmarks import common as bc  # noqa: E402
from repro.core import IVMEngine as RefEngine  # noqa: E402
from repro.core import Query as RQuery  # noqa: E402
from repro.core import StreamExecutor as RefExecutor  # noqa: E402
from repro.core import stream as rstream  # noqa: E402
from repro.core import sum_ring as rsum  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import IVMEngine, Query, StreamExecutor  # noqa: E402
from repro_torch.core import prepare_stream, sum_ring  # noqa: E402
from repro_torch.data import synth  # noqa: E402


MIXED_DOMS = dict(A=4, B=5, C=3, D=6, E=4)


def _mixed_queries():
    from repro.core import Query as RQ

    kw = dict(relations={"R": ("A", "B"), "S": ("A", "C", "E"), "T": ("C", "D")},
              free_vars=("A", "C"), domains=MIXED_DOMS,
              lifts={"B": ("value",), "D": ("value",), "E": ("value",)})
    return RQ(ring=rsum(), **kw), Query(ring=sum_ring(), **kw)


@pytest.mark.parametrize("schedule,mode", [
    (["S"] * 5, "scan"),
    (["R", "S", "T"] * 3, "rounds"),
    (["R", "S", "T", "S", "R", "R", "T"], "switch"),
])
def test_mixed_engine_roundtrips_executor(schedule, mode):
    """``tests/test_storage.py``'s mixed engine (forced sparse, one view
    flipped back to dense) through the executor in each dispatch mode,
    against the reference's."""
    from repro.core import COOUpdate as RCOO
    from repro.core import DenseRelation as RDense
    from repro.core import chain as rchain
    from repro_torch.core import chain

    rq, tq = _mixed_queries()
    rng = np.random.default_rng(7)
    rdb = {}
    for name, sch in rq.relations.items():
        mult = rng.integers(0, 3, size=tuple(MIXED_DOMS[v] for v in sch))
        rdb[name] = RDense(tuple(sch), rq.ring, {"v": jnp.asarray(mult.astype(np.float32))})
    stream = []
    for rel in schedule:
        sch, b = rq.relations[rel], int(rng.integers(1, 8))
        keys = np.stack([rng.integers(0, MIXED_DOMS[v], size=b) for v in sch],
                        axis=1).astype(np.int32)
        vals = rng.integers(-2, 3, size=b).astype(np.float32)
        stream.append((rel, RCOO(sch, jnp.asarray(keys), {"v": jnp.asarray(vals)})))
    vo = dict(order=["A", "C"], below={"A": [["B"]], "C": [["D"], ["E"]]})
    tdb = convert.database_from_numpy(P.db_to_numpy(rdb), tq.ring, device="cpu")
    # the first sparse view of the all-sparse plan (the port's; the views'
    # kinds are held to the reference's below)
    probe = IVMEngine.build(tq, tdb, var_order=chain(vo["order"], vo["below"]),
                            device="cpu", storage="sparse")
    first = [n for n, s in probe.storage_plan.items() if s.kind == "sparse"][0]
    kw = dict(storage="sparse", storage_overrides={first: "dense"})
    ref = RefEngine.build(rq, rdb, var_order=rchain(vo["order"], vo["below"]), **kw)
    eng = IVMEngine.build(tq, tdb, var_order=chain(vo["order"], vo["below"]),
                          device="cpu", **kw)
    assert {s.kind for s in eng.storage_plan.values()} == {"dense", "sparse"}
    upds = [(r, P.port_update(u, tq.ring)) for r, u in stream]
    prepared = prepare_stream(eng, upds)
    assert prepared.mode == mode
    StreamExecutor(eng).run(prepared)
    RefExecutor(ref).run(rstream.prepare_stream(ref, stream))
    P.assert_sparse_views_equal(P.sparse_views(ref), eng)


def test_retailer_sparse_stream_matches_reference():
    """``storage="sparse"`` at ``RETAILER_DOMS``: every eligible view is a
    hash table, so triggers take the densifying joins, the per-row sparse
    gathers and the grid-enumerating mixed apply; plans print as the
    reference's and views stay bitwise equal."""
    rq = RQuery(relations=bc.RETAILER_RELATIONS, free_vars=(), ring=rsum(),
                domains=bc.RETAILER_DOMS, lifts={"units": ("value",)})
    tq = Query(relations=synth.RETAILER_RELATIONS, free_vars=(), ring=sum_ring(),
               domains=synth.RETAILER_DOMS, lifts={"units": ("value",)})
    rng = np.random.default_rng(0)
    rdb = bc.synth_db(bc.RETAILER_RELATIONS, bc.RETAILER_DOMS, rq.ring, rng,
                      density=0.02)
    stream = bc.update_stream(bc.RETAILER_RELATIONS, bc.RETAILER_DOMS, rq.ring,
                              rng, 16, 5)
    tdb = convert.database_from_numpy(P.db_to_numpy(rdb), tq.ring, device="cpu")
    ref = RefEngine.build(rq, rdb, var_order=bc.retailer_vo(), storage="sparse")
    eng = IVMEngine.build(tq, tdb, var_order=synth.retailer_vo(), storage="sparse",
                          device="cpu")
    assert {n: (s.kind, s.capacity) for n, s in eng.storage_plan.items()} == {
        n: (s.kind, s.capacity) for n, s in ref.storage_plan.items()}
    labels = set()
    for i, (rel, upd) in enumerate(stream):
        tupd = P.port_update(upd, tq.ring)
        got = eng.trigger_plan(rel, tupd).pretty()
        assert got.replace(" torch", " jnp") == ref.trigger_plan(
            rel, upd).pretty().replace(" indicators=[]", "")
        labels |= {op.label() for op in eng.trigger_plan(rel, tupd).ops}
        ref.apply_update(rel, upd)
        eng.apply_update(rel, tupd)
        P.assert_sparse_views_equal(P.sparse_views(ref), eng, f"update {i}")
    assert any("sparse" in lb and "densify" in lb for lb in labels), labels
    assert any("Scatter" in lb and "sparse" in lb and "mixed" in lb
               for lb in labels), labels
