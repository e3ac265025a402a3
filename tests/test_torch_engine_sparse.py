"""Engines over sparse views: the port ≡ the reference on the same streams.

The housing star at ``pc = 4,096`` with 128 active postcodes (fill 3.1 %,
which ``auto`` plans sparse: six hashed-COO views and the dense root; the
forced ``storage="sparse"`` cases are
``tests/test_torch_engine_forced_sparse.py``).  Both engines are built
from the same numpy arrays and fed the same updates; after every update the
sum-ring views are compared bit for bit, key tables included, and the
degree-8 cofactor ring's within 1e-6 of each view's largest magnitude.
Eager growth (``grow_if_loaded``) and the executor's ``capacity_segments``
are each held to their own counterpart in the reference (the two paths size
tables by different budgets), and the CPU executor runs the segment loop.
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
from repro.core.apps import regression as ref_regression  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import IVMEngine, Query, StreamExecutor, plan  # noqa: E402
from repro_torch.core import prepare_stream, sum_ring  # noqa: E402
from repro_torch.core import stream as tstream  # noqa: E402
from repro_torch.core.apps import regression  # noqa: E402
from repro_torch.core.storage import SparseRelation  # noqa: E402
from repro_torch.data import synth  # noqa: E402

DOMS = dict(synth.HOUSING_DOMS)
N_ACTIVE = 128


def _sum_queries():
    rq = RQuery(relations=bc.HOUSING_RELATIONS, free_vars=(), ring=rsum(),
                domains=DOMS, lifts={"h2": ("value",)})
    tq = Query(relations=synth.HOUSING_RELATIONS, free_vars=(), ring=sum_ring(),
               domains=DOMS, lifts={"h2": ("value",)})
    return rq, tq


def _housing(pool_extra=0, batch=32, n_batches=6):
    """Sum-ring query pair, the reference's low-fill database, and a stream
    whose postcodes come from the active pool and ``pool_extra`` more."""
    rq, tq = _sum_queries()
    rdb, active = bc.synth_low_fill_db(bc.HOUSING_RELATIONS, DOMS, rq.ring,
                                       np.random.default_rng(0), "pc",
                                       n_active=N_ACTIVE)
    pool = np.sort(np.concatenate([
        active, np.setdiff1d(np.arange(DOMS["pc"]), active)[:pool_extra]]))
    stream = bc.update_stream(bc.HOUSING_RELATIONS, DOMS, rq.ring,
                              np.random.default_rng(1), batch, n_batches,
                              key_pools={"pc": pool})
    return rq, tq, rdb, stream


def _build(rq, tq, rdb, **kw):
    ref = RefEngine.build(rq, rdb, var_order=bc.housing_vo(), strategy="fivm",
                          **kw)
    return ref, _build_port(tq, rdb, **kw)


def _build_port(tq, rdb, **kw):
    tdb = convert.database_from_numpy(P.db_to_numpy(rdb), tq.ring, device="cpu")
    return IVMEngine.build(tq, tdb, var_order=synth.housing_vo(),
                           strategy="fivm", device="cpu", **kw)


# The reference's eager ``apply_update`` over hash tables compiles its probe
# and insert loops anew on every call (about a second each on the CPU), so
# each reference run below happens once a module and is shared by the cases
# that hold the port to it (the port's fusion mode does not reach the
# reference).
@pytest.fixture(scope="module")
def housing_ref():
    """``_housing()`` through the reference's eager engine: its views after
    every update, its result and its printed plans after the stream."""
    rq, tq, rdb, stream = _housing()
    ref = RefEngine.build(rq, rdb, var_order=bc.housing_vo(), strategy="fivm")
    after = []
    for rel, upd in stream:
        ref.apply_update(rel, upd)
        after.append(P.sparse_views(ref))
    return dict(after=after, result=np.asarray(ref.result().payload["v"]),
                plans=[ref.trigger_plan(rel, upd).pretty() for rel, upd in stream])


@pytest.fixture(scope="module")
def growth_ref():
    """The stream from 1,024 postcodes through the reference twice from the
    built state: the executor (``capacity_segments``, the audit's message,
    the final views), then the eager engine (views after every update)."""
    rq, tq, rdb, stream = _housing(pool_extra=1024 - N_ACTIVE, batch=200,
                                   n_batches=12)
    ref = RefEngine.build(rq, rdb, var_order=bc.housing_vo(), strategy="fivm")
    built = ref.state
    segments = [(len(s), g) for s, g in rstream.capacity_segments(ref, stream)]
    with pytest.raises(rstream.StreamCapacityError) as err:
        rstream.check_stream_capacity(ref, stream)
    RefExecutor(ref).run(stream)  # segment 0 copies the built state
    executor = P.sparse_views(ref)
    ref.set_state(built)
    after = []
    for rel, upd in stream:
        ref.apply_update(rel, upd)
        after.append(P.sparse_views(ref))
    return dict(segments=segments, audit=str(err.value), executor=executor,
                after=after)


@pytest.mark.parametrize("fusion", ["off", "on"])
def test_housing_sum_stream_matches_reference(fusion, housing_ref):
    """Eager triggers with ``auto`` storage: the reference's plan (six
    sparse views, the root dense) and its views, key tables included,
    after every update; under fusion the chains gather from and ⊎ into the
    hash tables."""
    rq, tq, rdb, stream = _housing()
    eng = _build_port(tq, rdb)
    assert sum(isinstance(v, SparseRelation) for v in eng.views.values()) == 6
    with plan.use_fusion(fusion):
        for i, (rel, upd) in enumerate(stream):
            eng.apply_update(rel, P.port_update(upd, tq.ring))
            P.assert_sparse_views_equal(housing_ref["after"][i], eng, f"update {i}")
        if fusion == "on":
            p = eng.trigger_plan("House", P.port_update(stream[0][1], tq.ring))
            assert any(isinstance(op, plan.FusedChain) for op in p.ops)
        else:  # the op-by-op plans print as the reference's, backends aside
            for (rel, upd), want in zip(stream, housing_ref["plans"]):
                got = eng.trigger_plan(rel, P.port_update(upd, tq.ring)).pretty()
                assert got.replace(" torch", " jnp") == want.replace(
                    " indicators=[]", "")
    np.testing.assert_array_equal(eng.result().payload["v"].numpy(),
                                  housing_ref["result"])


def _cofactor_inputs():
    """Multiplicities of the low-fill housing star (8 rows an active
    postcode) for the degree-8 cofactor ring, and the active postcodes."""
    rels, rng = synth.HOUSING_RELATIONS, np.random.default_rng(0)
    active = np.sort(rng.choice(DOMS["pc"], size=N_ACTIVE, replace=False))
    mult = {}
    for name, sch in rels.items():
        m = np.zeros(tuple(DOMS[v] for v in sch), np.float32)
        cols = [rng.choice(active, size=8 * N_ACTIVE) if v == "pc"
                else rng.integers(0, DOMS[v], size=8 * N_ACTIVE) for v in sch]
        np.add.at(m, tuple(cols), 1.0)
        mult[name] = np.minimum(m, 1.0)
    return mult, active


@pytest.fixture(scope="module")
def cofactor_ref():
    """The cofactor stream through the reference's eager engine: its
    storage plan, the stream and the views after it."""
    mult, active = _cofactor_inputs()
    ref = ref_regression.build_cofactor_engine(
        bc.HOUSING_RELATIONS, DOMS, {n: jnp.asarray(m) for n, m in mult.items()},
        var_order=bc.housing_vo())
    storage_plan = {n: (s.kind, s.capacity) for n, s in ref.storage_plan.items()}
    stream = bc.update_stream(bc.HOUSING_RELATIONS, DOMS, ref.query.ring,
                              np.random.default_rng(1), 32, 6,
                              key_pools={"pc": active})
    for rel, upd in stream:
        ref.apply_update(rel, upd)
    return dict(mult=mult, storage_plan=storage_plan, stream=stream,
                views=P.sparse_views(ref))


@pytest.mark.parametrize("fusion", ["off", "on"])
def test_housing_cofactor_stream_within_tolerance(fusion, cofactor_ref):
    """The degree-8 cofactor ring (d = 73) over the low-fill housing star:
    within 1e-6 of each view's largest magnitude (lifted postcodes square
    past 2^24, where float32 sums round in either package's order)."""
    eng = regression.build_cofactor_engine(
        synth.HOUSING_RELATIONS, DOMS,
        {n: torch.tensor(m) for n, m in cofactor_ref["mult"].items()},
        var_order=synth.housing_vo(), device="cpu")
    assert eng.query.ring.m == 8
    assert sum(s.kind == "sparse" for s in eng.storage_plan.values()) == 6
    assert {n: (s.kind, s.capacity) for n, s in eng.storage_plan.items()} == (
        cofactor_ref["storage_plan"])
    with plan.use_fusion(fusion):
        for rel, upd in cofactor_ref["stream"]:
            eng.apply_update(rel, P.port_update(upd, eng.query.ring))
    for name, (_, table, payload) in cofactor_ref["views"].items():
        tv = eng.views[name]
        assert isinstance(tv, SparseRelation) == (table is not None), name
        if table is not None:
            np.testing.assert_array_equal(tv.table.numpy(), table)
        for c, arr in payload.items():
            want = arr.astype(np.float64)
            scale = max(np.abs(want).max(), 1.0)
            np.testing.assert_allclose(tv.payload[c].numpy(), want, rtol=0,
                                       atol=1e-6 * scale, err_msg=f"{name}.{c}")


def _growth():
    """The stream from 1,024 postcodes (batches of 200) that outgrows the
    planned tables, with the port's engine and its updates."""
    rq, tq, rdb, stream = _housing(pool_extra=1024 - N_ACTIVE, batch=200,
                                   n_batches=12)
    return tq, _build_port(tq, rdb), [(r, P.port_update(u, tq.ring))
                                      for r, u in stream]


def test_eager_growth_matches_reference(growth_ref):
    """Batches from 1,024 postcodes outgrow the planned tables: the eager
    engine rehashes through ``grow_if_loaded`` exactly when and to what
    capacity the reference does."""
    _, eng, upds = _growth()
    before = {n: v.capacity for n, v in eng.views.items()
              if isinstance(v, SparseRelation)}
    for i, (rel, upd) in enumerate(upds):
        eng.apply_update(rel, upd)
        P.assert_sparse_views_equal(growth_ref["after"][i], eng, f"update {i}")
    after = {n: v.capacity for n, v in eng.views.items()
             if isinstance(v, SparseRelation)}
    assert all(after[n] > before[n] for n in before), (before, after)


def test_capacity_segments_and_audit_match_reference(growth_ref):
    """``capacity_segments`` (segment boundaries and ``grow_caps``) and the
    prepared-stream audit (``check_stream_capacity``) on the same stream."""
    tq, eng, upds = _growth()
    got = tstream.capacity_segments(eng, upds)
    assert [(len(s), g) for s, g in got] == growth_ref["segments"]
    assert len(got) > 1 and any(g for _, g in got)
    with pytest.raises(tstream.StreamCapacityError) as t_err:
        tstream.check_stream_capacity(eng, upds)
    assert str(t_err.value) == growth_ref["audit"]
    with pytest.raises(tstream.StreamCapacityError):
        prepare_stream(eng, upds)
    # a stream from the active pool fits the planned tables
    _, _, _, small = _housing()
    tstream.check_stream_capacity(eng, [(r, P.port_update(u, tq.ring))
                                        for r, u in small])


@pytest.mark.parametrize("fusion", ["off", "on"])
def test_executor_over_capacity_segments_matches_reference(fusion, growth_ref):
    """A raw stream that outgrows the tables runs segment by segment on the
    CPU (rehash, recompile, run): views and tables equal the reference
    executor's."""
    _, eng, upds = _growth()
    with plan.use_fusion(fusion):
        ex = StreamExecutor(eng)
        ex.run(upds)
    P.assert_sparse_views_equal(growth_ref["executor"], eng)
    segs = ex.last_segment_stats
    assert len(segs) > 1 and any(s["grow"] for s in segs)
    assert sum(s["updates"] for s in segs) == len(upds)


def test_replayed_prepared_stream_keeps_sparse_state_in_place():
    """A prepared stream from the active pool through the executor: the
    key tables and planes are state leaves written in place (the same
    tensors after the run), and the result equals the reference
    executor's over the same two runs."""
    rq, tq, rdb, stream = _housing(n_batches=12)
    ref, eng = _build(rq, tq, rdb)
    upds = [(r, P.port_update(u, tq.ring)) for r, u in stream]
    ex = StreamExecutor(eng)
    ex.run(upds)  # the engine's state: a copy, updated in place
    leaves = plan.state_leaves(eng.state)
    assert len(leaves) == len(plan.state_write_mask(eng.state, set(), set()))
    prepared = prepare_stream(eng, upds)
    assert prepared.mode == "rounds"
    ex.run(prepared, donate_input=True)
    assert all(a is b for a, b in zip(leaves, plan.state_leaves(eng.state)))
    rex = RefExecutor(ref)
    rex.run(stream)
    rex.run(rstream.prepare_stream(ref, stream), donate_input=True)
    P.assert_sparse_views_equal(P.sparse_views(ref), eng)
