"""Plan fusion in the port ≡ the reference's, bit for bit.

Engines of both packages built from the same numpy arrays run the same
update stream; with ``use_fusion("on")`` the port's engine runs its
``FusedChain`` ops through the plain ``fused_apply`` (CPU tensors) and
must equal, view by view after every update, the reference's fused engine
and its unfused engine.  Streams: the retailer sum aggregate and the
degree-10 cofactor ring at ``RETAILER_DOMS`` (fivm, dense), and the
regression engine of ``tests/test_plan.py``.  Values stay below 2**24, so
float32 sums are exact in any order and equality is bitwise.  Also: the
fused chains (boundaries and inner ops) are the reference's, the fusion
switch resolves as documented, and flipping it recompiles.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as P  # noqa: E402

P.cap_torch_threads()
jnp = pytest.importorskip("jax.numpy")

from benchmarks import common as bc  # noqa: E402
from repro.core import IVMEngine as RefEngine  # noqa: E402
from repro.core import Query as RefQuery  # noqa: E402
from repro.core import chain as ref_chain  # noqa: E402
from repro.core import plan as rplan  # noqa: E402
from repro.core import sum_ring as ref_sum_ring  # noqa: E402
from repro.core.apps import regression as ref_regression  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import COOUpdate, IVMEngine, Query, chain, sum_ring  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core.apps import regression  # noqa: E402
from repro_torch.core.storage import SparseRelation  # noqa: E402
from repro_torch.data import synth  # noqa: E402
from repro_torch.kernels import ring_fused  # noqa: E402


@pytest.fixture(autouse=True)
def _no_fusion_env(monkeypatch):
    monkeypatch.delenv(tplan.FUSION_ENV_VAR, raising=False)
    monkeypatch.delenv(rplan.FUSION_ENV_VAR, raising=False)


def _labels(ops):
    """Op labels with the reference's CPU backend name mapped onto the
    port's."""
    return [op.label().replace(" jnp", " torch") for op in ops]


def _chains(plan_mod, plan):
    return [_labels(op.ops) for op in plan.ops
            if isinstance(op, plan_mod.FusedChain)]


def _retailer(kind, batch=32, n_batches=5):
    rng = np.random.default_rng(0)
    if kind == "sum":
        rq = RefQuery(relations=bc.RETAILER_RELATIONS, free_vars=(),
                      ring=ref_sum_ring(), domains=bc.RETAILER_DOMS,
                      lifts={"units": ("value",)})
        tq = Query(relations=synth.RETAILER_RELATIONS, free_vars=(),
                   ring=sum_ring(), domains=synth.RETAILER_DOMS,
                   lifts={"units": ("value",)})
    else:
        rq = ref_regression.cofactor_query(bc.RETAILER_RELATIONS,
                                           bc.RETAILER_DOMS)
        tq = regression.cofactor_query(synth.RETAILER_RELATIONS,
                                       synth.RETAILER_DOMS)
    db = bc.synth_db(bc.RETAILER_RELATIONS, bc.RETAILER_DOMS, rq.ring, rng,
                     density=0.05)
    stream = bc.update_stream(bc.RETAILER_RELATIONS, bc.RETAILER_DOMS,
                              rq.ring, rng, batch, n_batches)
    return rq, tq, db, stream


def _fused_parity(ref_build, port_build, stream, ring):
    """Replay ``stream`` through the reference unfused and fused and the
    port fused; compare after every update.  Returns both fused engines and
    the fused chain labels per relation of their last plans."""
    with rplan.use_fusion("off"):
        ref_off = ref_build()
    with rplan.use_fusion("on"):
        ref_on = ref_build()
    port = port_build()
    ref_chains, port_chains = {}, {}
    for i, (rel, upd) in enumerate(stream):
        with rplan.use_fusion("off"):
            ref_off.apply_update(rel, upd)
        with rplan.use_fusion("on"):
            ref_on.apply_update(rel, upd)
            rp = ref_on.trigger_plan(rel, upd)
        with tplan.use_fusion("on"):
            pu = P.port_update(upd, ring)
            port.apply_update(rel, pu)
            tp = port.trigger_plan(rel, pu)
        # fused plans flatten to the unfused op sequence
        assert _labels(tplan.iter_flat_ops(tp.ops)) == \
            _labels(rplan.iter_flat_ops(rp.ops))
        ref_chains[rel], port_chains[rel] = _chains(rplan, rp), _chains(tplan, tp)
        P.assert_views_equal(ref_on, port, f"fused update {i} ({rel})")
        P.assert_views_equal(ref_off, port, f"unfused update {i} ({rel})")
    return ref_on, port, ref_chains, port_chains


@pytest.mark.parametrize("kind,n_chains", [("sum", 8), ("cofactor", 10)])
def test_fused_retailer_stream_matches_reference(kind, n_chains):
    rq, tq, db, stream = _retailer(kind)
    port_db = convert.database_from_numpy(P.db_to_numpy(db), tq.ring,
                                          device="cpu")

    def ref_build():
        return RefEngine.build(rq, db, var_order=bc.retailer_vo(),
                               strategy="fivm", storage="dense")

    def port_build():
        return IVMEngine.build(tq, port_db, var_order=synth.retailer_vo(),
                               strategy="fivm", storage="dense", device="cpu")

    ref_eng, port_eng, ref_chains, port_chains = _fused_parity(
        ref_build, port_build, stream, tq.ring)
    assert port_chains == ref_chains
    assert any(port_chains.values())
    # the plans at batch 1000 (the chip run's batch): the same chains, over
    # Inventory, Weather and Location; Item and Census densify, unfused
    with rplan.use_fusion("on"):
        ref_plans = ref_eng.precompile(1000)
    with tplan.use_fusion("on"):
        port_plans = port_eng.precompile(1000)
    chains = {rel: _chains(tplan, p) for rel, p in port_plans.items()}
    assert chains == {rel: _chains(rplan, p) for rel, p in ref_plans.items()}
    assert sum(map(len, chains.values())) == n_chains
    assert chains["Item"] == chains["Census"] == []


def _regression_engines(storage="dense"):
    rng = np.random.default_rng(0)
    rels = {"R": ("A", "B"), "S": ("A", "C")}
    doms = dict(A=3, B=4, C=5)
    mult = {n: rng.integers(0, 2, size=tuple(doms[v] for v in sch))
            .astype(np.float32) for n, sch in rels.items()}

    def ref_build():
        return ref_regression.build_cofactor_engine(
            rels, doms, {n: jnp.asarray(m) for n, m in mult.items()},
            var_order=ref_chain(["A"], {"A": [["B"], ["C"]]}),
            **({} if storage == "dense" else dict(storage=storage)))

    def port_build():
        return regression.build_cofactor_engine(
            rels, doms, {n: torch.tensor(m) for n, m in mult.items()},
            var_order=chain(["A"], {"A": [["B"], ["C"]]}), storage=storage,
            device="cpu")

    return ref_build, port_build


def _regression_stream(ring_r, schedule, b=4, seed=42):
    """``tests/test_plan.py``'s stream: only the count component is set."""
    from repro.core import COOUpdate as RefCOOUpdate

    rng = np.random.default_rng(seed)
    relations = {"R": ("A", "B"), "S": ("A", "C")}
    doms = dict(A=3, B=4, C=5)
    out = []
    for r in schedule:
        sch = relations[r]
        keys = np.stack([rng.integers(0, doms[v], size=b) for v in sch],
                        1).astype(np.int32)
        payload = {**ring_r.zeros((b,)),
                   "c": jnp.asarray(rng.integers(-2, 3, b).astype(np.float32))}
        out.append((r, RefCOOUpdate(sch, jnp.asarray(keys), payload)))
    return out


def test_fused_regression_engine_matches_reference():
    ref_build, port_build = _regression_engines()
    ring_r = ref_build().query.ring
    stream = _regression_stream(ring_r, ["R", "S", "R", "R", "S"])
    _, _, ref_chains, port_chains = _fused_parity(
        ref_build, port_build, stream, port_build().query.ring)
    assert port_chains == ref_chains
    assert len(port_chains["R"]) == 2


def _size_free(text):
    return re.sub(r" (vmem|smem)=\d+B", "", text).replace(" jnp", " torch")


def test_fused_plan_text_matches_reference():
    """The fused plan's text is the reference's golden one but for the size
    field (``smem=`` from the H100 model) and the backend strings."""
    ref_build, port_build = _regression_engines()
    with rplan.use_fusion("on"):
        ref_eng = ref_build()
        rp = ref_eng.plans.lookup_sig(ref_eng, "R", ("coo", ("A", "B"), 4))
    with tplan.use_fusion("on"):
        eng = port_build()
        tp = eng.plans.lookup_sig(eng, "R", ("coo", ("A", "B"), 4))
    assert _size_free(tp.pretty()) == _size_free(
        rp.pretty().replace(" indicators=[]", ""))
    chains = [op for op in tp.ops if isinstance(op, tplan.FusedChain)]
    smem = ring_fused.chain_smem_bytes(1 + 3 + 9)
    assert [c.smem_bytes for c in chains] == [smem, smem]
    assert f"smem={smem}B" in tp.pretty()
    # the first chain's end delta feeds the second; the last feeds nothing
    assert [c.carries for c in chains] == [True, False]
    assert tp.read_views() == frozenset({"V1@C"})
    assert set(tp.write_views) == {"V0@B", "V2@A"}


def test_fusion_mode_resolution(monkeypatch):
    assert tplan.fusion_mode("cpu") == "off"  # auto: the CPU stays unfused
    assert tplan.fusion_mode("cuda") == "on"  # auto: the card fuses
    with tplan.use_fusion("on"):
        assert tplan.fusion_mode("cpu") == "on"
    monkeypatch.setenv(tplan.FUSION_ENV_VAR, "on")
    assert tplan.fusion_mode("cpu") == "on"
    with tplan.use_fusion("off"):  # an override beats the env
        assert tplan.fusion_mode("cuda") == "off"
    # the reference's variable is not the port's
    monkeypatch.setenv(tplan.FUSION_ENV_VAR, "auto")
    monkeypatch.setenv(rplan.FUSION_ENV_VAR, "on")
    assert tplan.fusion_mode("cpu") == "off"
    with pytest.raises(ValueError):
        tplan.set_fusion("always")


def _regression_upd(ring, b=4):
    keys = np.stack([np.arange(b) % 3, np.arange(b) % 4], 1).astype(np.int32)
    payload = {**ring.zeros((b,), device="cpu"),
               "c": torch.ones(b, dtype=torch.float32)}
    return COOUpdate(("A", "B"), torch.tensor(keys), payload)


def test_fusion_flip_is_a_cache_miss():
    _, port_build = _regression_engines()
    eng = port_build()
    upd = _regression_upd(eng.query.ring)
    with tplan.use_fusion("off"):
        eng.apply_update("R", upd)
        eng.apply_update("R", upd)  # same key: a hit
        off = eng.trigger_plan("R", upd)
    assert (eng.plans.miss_new, eng.plans.miss_invalidated) == (1, 0)
    with tplan.use_fusion("on"):
        eng.apply_update("R", upd)
        on = eng.trigger_plan("R", upd)
    assert (eng.plans.miss_new, eng.plans.miss_invalidated) == (1, 1)
    assert not any(isinstance(op, tplan.FusedChain) for op in off.ops)
    assert any(isinstance(op, tplan.FusedChain) for op in on.ops)


def test_write_sets_track_fusion_flip():
    _, port_build = _regression_engines()
    eng = port_build()
    with tplan.use_fusion("off"):
        off_sets = eng.plans.write_sets(eng, "R")
        misses = eng.plans.misses
        assert eng.plans.write_sets(eng, "R") == off_sets
        assert eng.plans.misses == misses
    with tplan.use_fusion("on"):
        on_sets = eng.plans.write_sets(eng, "R")
        assert eng.plans.misses == misses + 1  # a fresh derivation
    assert on_sets == off_sets == (frozenset({"V0@B", "V2@A"}), frozenset(),
                                   frozenset())


def test_chain_deltas_materialize_lazily_and_match_unfused():
    """Deltas emitted inside fused chains come back on demand
    (``PropagationResult.delta``) equal to the unfused run's."""
    _, port_build = _regression_engines()
    upd = _regression_upd(port_build().query.ring)
    results = {}
    for mode in ("off", "on"):
        eng = port_build()
        with tplan.use_fusion(mode):
            plan = eng.trigger_plan("R", upd)
        results[mode] = tplan.run_coo_ops(plan.ops, eng.views, eng.query, upd)
    off, on = results["off"], results["on"]
    assert list(on.deltas) == list(off.deltas) == ["R", "V0@B", "V2@A"]
    assert any(callable(d) for d in on.deltas.values())
    for name in off.deltas:
        want, got = off.delta(name), on.delta(name)
        assert got.coo_schema == want.coo_schema, name
        assert torch.equal(got.keys, want.keys), name
        for c, t in want.payload.items():
            assert torch.equal(got.payload[c], t), (name, c)


def test_first_order_and_int_ring_plans_stay_unfused():
    _, port_build = _regression_engines()
    eng = port_build()
    eng.strategy = "fivm_1"
    eng.plans = tplan.PlanCache()
    with tplan.use_fusion("on"):
        p = eng.plans.lookup_sig(eng, "R", ("coo", ("A", "B"), 4))
    assert p.kind == "first_order"
    assert not any(isinstance(op, tplan.FusedChain) for op in p.ops)
    from repro_torch.core import count_ring

    q = Query(relations={"R": ("A", "B")}, free_vars=(), ring=count_ring(),
              domains=dict(A=3, B=4))
    db = {"R": count_ring().ones((3, 4), device="cpu")}
    from repro_torch.core import DenseRelation

    eng = IVMEngine.build(q, {"R": DenseRelation(("A", "B"), q.ring, db["R"])},
                          device="cpu")
    with tplan.use_fusion("on"):
        p = eng.plans.lookup_sig(eng, "R", ("coo", ("A", "B"), 4))
    assert not any(isinstance(op, tplan.FusedChain) for op in p.ops)


def test_fused_chain_over_sparse_storage_raises():
    """Sparse views are ported now, and fused chains run over them: with
    every view a hash table the fused chains gather from sparse planes
    (missed probes read the zero row) and ⊎ into claimed slots, equal after
    every update to the reference's unfused and fused engines, key tables
    included.  (The name is kept from when such a chain refused.)"""
    ref_build, port_build = _regression_engines(storage="sparse")
    ring_r = ref_build().query.ring
    stream = _regression_stream(ring_r, ["R", "S", "R", "R", "S"])
    ref_on, port, _, port_chains = _fused_parity(
        ref_build, port_build, stream, port_build().query.ring)
    assert len(port_chains["R"]) == 2
    chains = [op for p in port.plans.plans.values() for op in p.ops
              if isinstance(op, tplan.FusedChain)]
    assert any(inner.storage == "sparse" for c in chains for inner in c.ops
               if isinstance(inner, tplan.Gather))
    for name, v in port.views.items():
        if isinstance(v, SparseRelation):
            np.testing.assert_array_equal(v.table.numpy(),
                                          np.asarray(ref_on.views[name].table))
