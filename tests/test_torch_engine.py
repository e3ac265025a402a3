"""The port's IVMEngine ≡ the reference's, bit for bit, on sum aggregates.

The retailer snowflake (``RETAILER_DOMS``) and the housing star (``pc`` cut
to 64) from ``benchmarks/common.py``, built for both engines from the same
numpy arrays, under the same update stream; every materialized view is
compared after every update.  Densities keep every value below 2**24, so
float32 sums are exact in any order.  Also: the compiled trigger plans are
the reference's, and the caller's database is never written.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as P  # noqa: E402

P.cap_torch_threads()
pytest.importorskip("jax")

from benchmarks import common as bc  # noqa: E402
from repro.core import IVMEngine as RefEngine  # noqa: E402
from repro.core import Query as RefQuery  # noqa: E402
from repro.core import sum_ring as ref_sum_ring  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import IVMEngine, Query, sum_ring  # noqa: E402
from repro_torch.data import synth  # noqa: E402

HOUSING_DOMS = dict(bc.HOUSING_DOMS, pc=64)


def _retailer(seed=0, batch=32, n_batches=7, density=0.05):
    rng = np.random.default_rng(seed)
    rq = RefQuery(relations=bc.RETAILER_RELATIONS, free_vars=(),
                  ring=ref_sum_ring(), domains=bc.RETAILER_DOMS,
                  lifts={"units": ("value",)})
    tq = Query(relations=synth.RETAILER_RELATIONS, free_vars=(),
               ring=sum_ring(), domains=synth.RETAILER_DOMS,
               lifts={"units": ("value",)})
    db = bc.synth_db(bc.RETAILER_RELATIONS, bc.RETAILER_DOMS, rq.ring, rng,
                     density=density)
    stream = bc.update_stream(bc.RETAILER_RELATIONS, bc.RETAILER_DOMS,
                              rq.ring, rng, batch, n_batches)
    return rq, tq, db, stream


@pytest.mark.parametrize("strategy", ["fivm", "reeval", "dbt", "fivm_1"])
def test_retailer_sum_stream_matches_reference(strategy):
    rq, tq, db, stream = _retailer()
    ref_eng, port_eng = P.run_parity(rq, tq, db, stream, bc.retailer_vo(),
                                     synth.retailer_vo(), strategy)
    assert port_eng.memory_bytes() == ref_eng.memory_bytes()


def test_housing_sum_stream_matches_reference():
    rng = np.random.default_rng(1)
    rq = RefQuery(relations=bc.HOUSING_RELATIONS, free_vars=(),
                  ring=ref_sum_ring(), domains=HOUSING_DOMS,
                  lifts={"h2": ("value",)})
    tq = Query(relations=synth.HOUSING_RELATIONS, free_vars=(),
               ring=sum_ring(), domains=HOUSING_DOMS, lifts={"h2": ("value",)})
    db = bc.synth_db(bc.HOUSING_RELATIONS, HOUSING_DOMS, rq.ring, rng)
    stream = bc.update_stream(bc.HOUSING_RELATIONS, HOUSING_DOMS, rq.ring,
                              rng, 48, 8)
    P.run_parity(rq, tq, db, stream, bc.housing_vo(), synth.housing_vo(),
                 "fivm")


def test_make_trigger_replays_apply_update():
    """Threading the state through per-relation triggers ≡ apply_update."""
    rq, tq, db, stream = _retailer(n_batches=6)
    port_db = convert.database_from_numpy(P.db_to_numpy(db), tq.ring,
                                          device="cpu")
    engines = [IVMEngine.build(tq, port_db, var_order=synth.retailer_vo(),
                               strategy="fivm", storage="dense", device="cpu")
               for _ in range(2)]
    triggers = {rel: engines[1].make_trigger(rel) for rel in tq.relations}
    state = engines[1].state
    for rel, upd in stream:
        engines[0].apply_update(rel, P.port_update(upd, tq.ring))
        state = triggers[rel](state, P.port_update(upd, tq.ring))
    for name, view in engines[0].views.items():
        assert torch.equal(view.payload["v"], state[0][name].payload["v"])


def test_propagate_coo_matches_reference():
    """The standalone delta propagation updates the same views, with the
    same deltas, as the reference's."""
    from repro.core import propagate_coo as ref_propagate_coo
    from repro_torch.core import propagate_coo

    rq, tq, db, stream = _retailer(n_batches=5)
    ref_eng = RefEngine.build(rq, db, var_order=bc.retailer_vo(),
                              strategy="fivm", storage="dense")
    port_db = convert.database_from_numpy(P.db_to_numpy(db), tq.ring,
                                          device="cpu")
    port_eng = IVMEngine.build(tq, port_db, var_order=synth.retailer_vo(),
                               strategy="fivm", storage="dense", device="cpu")
    # the port updates the views it is given in place, so both sides carry
    # the updated views forward
    ref_views, port_views = dict(ref_eng.views), dict(port_eng.views)
    for rel, upd in stream:
        want = ref_propagate_coo(ref_eng.tree, ref_views, rq, rel, upd)
        got = propagate_coo(port_eng.tree, port_views, tq, rel,
                            P.port_update(upd, tq.ring))
        ref_views.update(want.updated)
        port_views.update(got.updated)
        assert list(got.deltas) == list(want.deltas)
        assert sorted(got.updated) == sorted(want.updated)
        for name, view in want.updated.items():
            np.testing.assert_array_equal(
                got.updated[name].payload["v"].numpy(),
                np.asarray(view.payload["v"]), err_msg=f"{rel} {name}")


def _plan_text(plan) -> str:
    """The plan's stable text with the reference's CPU backend name and
    indicator write set mapped onto the port's."""
    return (plan.pretty().replace(" jnp", " torch")
            .replace(" indicators=[]", ""))


@pytest.mark.parametrize("strategy", ["fivm", "dbt", "fivm_1", "reeval"])
def test_trigger_plans_match_reference(strategy):
    rq, tq, db, stream = _retailer(n_batches=5)
    ref_eng = RefEngine.build(rq, db, var_order=bc.retailer_vo(),
                              strategy=strategy, storage="dense")
    port_db = convert.database_from_numpy(P.db_to_numpy(db), tq.ring,
                                          device="cpu")
    port_eng = IVMEngine.build(tq, port_db, var_order=synth.retailer_vo(),
                               strategy=strategy, storage="dense", device="cpu")
    assert sorted(port_eng.materialized_names) == sorted(ref_eng.materialized_names)
    for rel, upd in stream:
        rp = ref_eng.trigger_plan(rel, upd)
        tp = port_eng.trigger_plan(rel, P.port_update(upd, tq.ring))
        assert [type(op).__name__ for op in tp.ops] == \
            [type(op).__name__ for op in rp.ops]
        assert [getattr(op, "view", None) for op in tp.ops] == \
            [getattr(op, "view", None) for op in rp.ops]
        assert _plan_text(tp) == _plan_text(rp)
    assert port_eng.plans.stats()["plans"] == 5


def test_count_ring_stream_keeps_reference_dtypes():
    """A count-ring (int32) engine: after a stream its views have the
    reference's dtypes and values.  The port's int32 ``Ring.mul`` product
    (the reference's comes back float32) stays inside the trigger."""
    import jax.numpy as jnp
    from repro.core import COOUpdate as RefCOOUpdate
    from repro.core import DenseRelation as RefDenseRelation
    from repro.core import count_ring as ref_count_ring
    from repro_torch.core import count_ring

    rng = np.random.default_rng(5)
    rq = RefQuery(relations=bc.RETAILER_RELATIONS, free_vars=(),
                  ring=ref_count_ring(), domains=bc.RETAILER_DOMS)
    tq = Query(relations=synth.RETAILER_RELATIONS, free_vars=(),
               ring=count_ring(), domains=synth.RETAILER_DOMS)

    def as_int(p):
        return {c: jnp.asarray(v, jnp.int32) for c, v in p.items()}

    db = {n: RefDenseRelation(r.schema, rq.ring, as_int(r.payload))
          for n, r in bc.synth_db(bc.RETAILER_RELATIONS, bc.RETAILER_DOMS,
                                  rq.ring, rng, density=0.05).items()}
    stream = [(rel, RefCOOUpdate(u.schema, u.keys, as_int(u.payload)))
              for rel, u in bc.update_stream(bc.RETAILER_RELATIONS,
                                             bc.RETAILER_DOMS, rq.ring, rng,
                                             16, 5)]
    ref_eng, port_eng = P.run_parity(rq, tq, db, stream, bc.retailer_vo(),
                                     synth.retailer_vo(), "fivm")
    for name, view in ref_eng.views.items():
        assert port_eng.views[name].payload["v"].dtype == torch.int32, name
        assert np.asarray(view.payload["v"]).dtype == np.int32, name


def test_callers_database_is_never_written():
    """Views are updated in place, so the engine must own copies of the
    database relations its views and base relations start from."""
    rq, tq, db, stream = _retailer(n_batches=6)
    for strategy in ("fivm", "dbt", "reeval"):
        port_db = convert.database_from_numpy(P.db_to_numpy(db), tq.ring,
                                              device="cpu")
        before = {r: rel.payload["v"].clone() for r, rel in port_db.items()}
        eng = IVMEngine.build(tq, port_db, var_order=synth.retailer_vo(),
                              strategy=strategy, storage="dense", device="cpu")
        root = eng.result().payload["v"].clone()
        for rel, upd in stream:
            eng.apply_update(rel, P.port_update(upd, tq.ring))
        assert not torch.equal(eng.result().payload["v"], root), strategy
        for r, rel in port_db.items():
            assert torch.equal(rel.payload["v"], before[r]), (strategy, r)
