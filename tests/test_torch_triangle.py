"""The triangle query with maintained indicator projections (paper Sec. 6,
Fig. 11) in the port ≡ the reference.

R(A,B), S(B,C), T(C,A) at n = 6 a variable (the reference fixtures' size),
the sum ring and the degree-3 cofactor ring, var order chain(A, B, C),
``use_indicators=True``: the same numpy database and updates go through
``repro`` (``JAX_PLATFORMS=cpu``) and ``repro_torch`` (``device="cpu"``),
and every view, stored base relation, indicator count and plane and plan
text must match bit for bit (integer data).  Also: forced sparse storage,
the stream executor with padded indicator rows, the host oracle
(``PyIVM``), the build's fold (no [A, B, C] product) and the base read
before the in-place base ⊎.
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
from repro.core import IVMEngine as REngine  # noqa: E402
from repro.core import PyRelation as RPy  # noqa: E402
from repro.core import Query as RQuery  # noqa: E402
from repro.core import StreamExecutor as RExecutor  # noqa: E402
from repro.core import chain as rchain  # noqa: E402
from repro.core import plan as rplan  # noqa: E402
from repro.core import propagate_coo as rpropagate  # noqa: E402
from repro.core import sum_ring as rsum  # noqa: E402
from repro.core.apps import regression as rreg  # noqa: E402
from repro.core.py_engine import PyEngineSpec as RSpec  # noqa: E402
from repro.core.py_engine import PyIVM as RPyIVM  # noqa: E402
from repro.core.rings import PyNumberRing as RPyNumber  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import (IVMEngine, PyEngineSpec, PyIVM,  # noqa: E402
                              PyNumberRing, PyRelation, Query,
                              StreamExecutor, chain, propagate_coo, sum_ring)
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core.apps import regression as treg  # noqa: E402

N = 6
RELS = {"R": ("A", "B"), "S": ("B", "C"), "T": ("C", "A")}
ORDER = ["A", "B", "C"]


@pytest.fixture(autouse=True)
def _no_fusion_env(monkeypatch):
    monkeypatch.delenv(tplan.FUSION_ENV_VAR, raising=False)
    monkeypatch.delenv(rplan.FUSION_ENV_VAR, raising=False)


def _queries(ring, n=N):
    doms = dict(A=n, B=n, C=n)
    if ring == "sum":
        return (RQuery(relations=RELS, free_vars=(), ring=rsum(), domains=doms,
                       lifts={}),
                Query(relations=RELS, free_vars=(), ring=sum_ring(),
                      domains=doms, lifts={}))
    return rreg.cofactor_query(RELS, doms), treg.cofactor_query(RELS, doms)


def _payload(ring, vals):
    """Numpy ring payload: ``vals`` in v (sum ring) or c (cofactor ring)."""
    if set(ring.components) == {"v"}:
        return {"v": vals}
    out = {c: np.zeros((len(vals),) + tuple(shp), np.float32)
           for c, shp in ring.components.items()}
    out["c"] = vals
    return out


def _db(rq, rng, n=N):
    """0/1 multiplicities over n × n, as reference relations (copies: a
    jax array on the CPU may share a numpy array's memory, and the tests
    update ``mults`` as their oracle)."""
    mults = {r: rng.integers(0, 2, size=(n, n)).astype(np.float32) for r in RELS}
    if set(rq.ring.components) == {"v"}:
        db = {r: RDense(sch, rq.ring, {"v": jnp.array(mults[r])})
              for r, sch in RELS.items()}
    else:
        db = {r: rreg.relation_from_multiplicities(sch, rq.ring,
                                                   jnp.array(mults[r]))
              for r, sch in RELS.items()}
    return db, mults


def _stream(rq, rng, mults, batches, n=N):
    """Round-robin R, S, T updates with distinct keys a batch and values in
    {-1, 0, 1} (the reference's own test); ``mults`` follows them."""
    out = []
    for step, b in enumerate(batches):
        rel = "RST"[step % 3]
        flat = rng.choice(n * n, size=b, replace=False)
        keys = np.stack([flat // n, flat % n], axis=1).astype(np.int32)
        vals = rng.integers(-1, 2, size=b).astype(np.float32)
        np.add.at(mults[rel], (keys[:, 0], keys[:, 1]), vals)
        out.append((rel, RCOO(RELS[rel], jnp.asarray(keys), {
            c: jnp.asarray(v) for c, v in _payload(rq.ring, vals).items()})))
    return out


def _port_engine(tq, rdb, **kw):
    return IVMEngine.build(tq, convert.database_from_numpy(
        P.db_to_numpy(rdb), tq.ring, device="cpu"), var_order=chain(ORDER),
        device="cpu", **kw)


def _engines(ring, strategy, rng, storage="dense", eager_twin=False):
    """(rq, tq, reference engine, port engine, multiplicities) of one
    database; with ``eager_twin``, a second port engine of it appended."""
    rq, tq = _queries(ring)
    rdb, mults = _db(rq, rng)
    kw = dict(strategy=strategy, use_indicators=True, fuse_chains=False,
              storage=storage)
    ref = REngine.build(rq, rdb, var_order=rchain(ORDER), **kw)
    out = (rq, tq, ref, _port_engine(tq, rdb, **kw), mults)
    return out + (_port_engine(tq, rdb, **kw),) if eager_twin else out


def assert_port_states_equal(a, b):
    """Two port engines' states, every leaf bitwise."""
    sa, sb = convert.state_to_numpy(a), convert.state_to_numpy(b)
    for part in ("views", "base"):
        assert set(sa[part]) == set(sb[part])
        for name, comps in sa[part].items():
            for c, arr in comps.items():
                np.testing.assert_array_equal(sb[part][name][c], arr)
    for name, ind in sa["indicators"].items():
        np.testing.assert_array_equal(sb["indicators"][name]["counts"],
                                      ind["counts"])
        for c, arr in ind["dense"].items():
            np.testing.assert_array_equal(sb["indicators"][name]["dense"][c], arr)


def assert_state_equal(ref, port, where=""):
    """Views, stored base relations and indicators, bitwise."""
    P.assert_views_equal(ref, port, where)
    got = convert.state_to_numpy(port)
    assert set(got["base"]) == set(ref.base)
    for name, rel in ref.base.items():
        for c, a in rel.payload.items():
            np.testing.assert_array_equal(got["base"][name][c], np.asarray(a),
                                          err_msg=f"{where} base {name}.{c}")
    assert set(got["indicators"]) == set(ref.indicators)
    for name, ind in ref.indicators.items():
        np.testing.assert_array_equal(got["indicators"][name]["counts"],
                                      np.asarray(ind.counts),
                                      err_msg=f"{where} ∃{name} counts")
        for c, a in ind.dense.payload.items():
            np.testing.assert_array_equal(got["indicators"][name]["dense"][c],
                                          np.asarray(a),
                                          err_msg=f"{where} ∃{name}.{c}")


def _triangle_total(mults):
    return float(np.einsum("ab,bc,ca->", mults["R"], mults["S"], mults["T"]))


def _plan_text(plan) -> str:
    return plan.pretty().replace(" jnp", " torch").replace(" indicators=[]", "")


@pytest.mark.parametrize("ring", ["sum", "cofactor"])
@pytest.mark.parametrize("strategy", ["fivm", "dbt", "reeval"])
def test_triangle_state_matches_reference_after_9_updates(strategy, ring):
    rng = np.random.default_rng(11)
    rq, tq, ref, port, mults = _engines(ring, strategy, rng)
    assert port.indicators and set(port.indicators) == set(ref.indicators)
    assert port.materialized_names == ref.materialized_names
    assert port.tree.pretty() == ref.tree.pretty()
    assert_state_equal(ref, port, "build")
    for step, (rel, upd) in enumerate(_stream(rq, rng, mults, [4] * 9)):
        ref.apply_update(rel, upd)
        port.apply_update(rel, P.port_update(upd, tq.ring))
        assert_state_equal(ref, port, f"step {step} ({rel})")
    c = port.result().payload["v" if ring == "sum" else "c"]
    assert float(c) == _triangle_total(mults)
    assert port.memory_bytes() == ref.memory_bytes()


@pytest.mark.parametrize("strategy", ["fivm", "dbt", "fivm_1", "reeval"])
def test_triangle_plan_texts_match_reference(strategy):
    """Every trigger's text (indicator sections included) is the
    reference's; 1-IVM refuses indicators in both packages."""
    rng = np.random.default_rng(2)
    if strategy == "fivm_1":
        rq, tq = _queries("cofactor")
        rdb, _ = _db(rq, rng)
        with pytest.raises(AssertionError):
            REngine.build(rq, rdb, var_order=rchain(ORDER), strategy=strategy,
                          use_indicators=True)
        with pytest.raises(ValueError, match="1-IVM"):
            IVMEngine.build(tq, convert.database_from_numpy(
                P.db_to_numpy(rdb), tq.ring, device="cpu"),
                var_order=chain(ORDER), strategy=strategy,
                use_indicators=True, device="cpu")
        return
    rq, tq, ref, port, _ = _engines("cofactor", strategy, rng)
    for rel in RELS:
        for b in (1, 5):
            sig = ("coo", RELS[rel], b)
            want = ref.plans.lookup_sig(ref, rel, sig)
            got = port.plans.lookup_sig(port, rel, sig)
            assert got.pretty() == _plan_text(want)
            assert got.write_sets() == want.write_sets()
            assert port.plans.write_sets(port, rel) == ref.plans.write_sets(ref, rel)
    if strategy != "reeval":
        r_plan = port.plans.lookup_sig(port, "R", ("coo", RELS["R"], 1))
        assert r_plan.ind_ops and r_plan.write_indicators == {"V0@C"}
        assert "∃V0@C" in port.plans.lookup_sig(
            port, "S", ("coo", RELS["S"], 1)).read_views()


def test_triangle_forced_sparse_matches_reference():
    rng = np.random.default_rng(5)
    rq, tq, ref, port, mults = _engines("sum", "fivm", rng, storage="sparse")
    assert {n: (s.kind, s.capacity) for n, s in port.storage_plan.items()} == \
        {n: (s.kind, s.capacity) for n, s in ref.storage_plan.items()}
    assert any(s.kind == "sparse" for s in port.storage_plan.values())
    for step, (rel, upd) in enumerate(_stream(rq, rng, mults, [5] * 9)):
        ref.apply_update(rel, upd)
        port.apply_update(rel, P.port_update(upd, tq.ring))
        assert_state_equal(ref, port, f"step {step}")
        assert _plan_text(ref.trigger_plan(rel, upd)) == \
            port.trigger_plan(rel, P.port_update(upd, tq.ring)).pretty()
    assert float(port.result().payload["v"]) == _triangle_total(mults)


@pytest.mark.parametrize("strategy", ["fivm", "dbt"])
def test_triangle_executor_with_padded_indicator_rows(strategy):
    """Batches of 3 and 4 rows (so every position pads): the executor's
    state equals the eager engine's and the reference executor's bitwise."""
    rng = np.random.default_rng(11)
    rq, tq, ref, port, mults, eager = _engines("cofactor", strategy, rng,
                                              eager_twin=True)
    stream = _stream(rq, rng, mults, [3 + i % 2 for i in range(9)])
    RExecutor(ref).run(stream)
    tstream = [(rel, P.port_update(u, tq.ring)) for rel, u in stream]
    ex = StreamExecutor(port)
    ex.run(tstream)
    assert ex.last_run_stats["mode"] == "rounds"
    for rel, upd in tstream:
        eager.apply_update(rel, upd)
    assert_state_equal(ref, port, "executor vs reference executor")
    assert_port_states_equal(eager, port)
    assert float(port.result().payload["c"]) == _triangle_total(mults)


def test_triangle_executor_restores_indicators_without_update_engine():
    rng = np.random.default_rng(4)
    rq, tq, _, port, mults, twin = _engines("sum", "fivm", rng, eager_twin=True)
    stream = [(rel, P.port_update(u, tq.ring))
              for rel, u in _stream(rq, rng, mults, [4] * 6)]
    views, base, indicators = StreamExecutor(port).run(stream,
                                                       update_engine=False)
    assert_port_states_equal(twin, port)  # the engine kept its state
    assert float(views[port.tree.name].payload["v"]) == _triangle_total(mults)
    counts = {r: (m != 0).astype(np.int32) for r, m in mults.items()}
    np.testing.assert_array_equal(indicators["V0@C"].counts.numpy(), counts["R"])


def test_build_never_forms_a_cubic_product(monkeypatch):
    """The engine build sums C inside the join of S(B,C) with T(C,A) (C's
    degree lift multiplied into T first) and joins ∃R(A,B) after the sum:
    no einsum of the build (one a bilinear term of the degree-3 ring, the
    largest a 3 × 3 block a key) makes more than 9 n² values, where the
    reference's join-then-sum forms S ⊗ T over [B, C, A] (9 n³; at n =
    4096 that is 6.2e11 values in Q alone)."""
    sizes = []
    einsum = torch.einsum

    def recording(*args, **kw):
        out = einsum(*args, **kw)
        sizes.append(out.numel())
        return out

    n = 16
    rq, tq = _queries("cofactor", n)
    rdb, mults = _db(rq, np.random.default_rng(9), n)
    tdb = convert.database_from_numpy(P.db_to_numpy(rdb), tq.ring, device="cpu")
    monkeypatch.setattr(torch, "einsum", recording)
    eng = IVMEngine.build(tq, tdb, var_order=chain(ORDER), use_indicators=True,
                          fuse_chains=False, device="cpu")
    assert sizes and max(sizes) <= 9 * n * n
    assert float(eng.result().payload["c"]) == _triangle_total(mults)
    monkeypatch.setattr(torch, "einsum", einsum)
    ref = REngine.build(rq, rdb, var_order=rchain(ORDER), use_indicators=True,
                        fuse_chains=False)
    P.assert_views_equal(ref, eng, "build")


@pytest.mark.parametrize("ring", ["sum", "cofactor"])
def test_indicator_update_reads_base_before_the_bump(ring):
    """A batch to R, the indicator's own relation, that switches keys off
    (and others on): the port's base ⊎ writes in place, so the indicator
    section must read R's payload from before it, or the 1→0 transitions
    are lost.  Counts equal a recount from the final base; views, base and
    indicators equal the reference's."""
    rng = np.random.default_rng(3)
    rq, tq, ref, port, mults = _engines(ring, "fivm", rng)
    on = np.argwhere(mults["R"] != 0)[:3]
    off = np.argwhere(mults["R"] == 0)[:2]
    keys = np.concatenate([on, off]).astype(np.int32)
    vals = np.array([-1, -1, -1, 1, 1], np.float32)
    np.add.at(mults["R"], (keys[:, 0], keys[:, 1]), vals)
    upd = RCOO(RELS["R"], jnp.asarray(keys), {
        c: jnp.asarray(v) for c, v in _payload(rq.ring, vals).items()})
    ref.apply_update("R", upd)
    port.apply_update("R", P.port_update(upd, tq.ring))
    assert_state_equal(ref, port, "zeroing batch")
    np.testing.assert_array_equal(port.indicators["V0@C"].counts.numpy(),
                                  (mults["R"] != 0).astype(np.int32))
    comp = "v" if ring == "sum" else "c"
    np.testing.assert_array_equal(
        port.indicators["V0@C"].dense.payload[comp].numpy(),
        (mults["R"] != 0).astype(np.float32))
    assert float(port.result().payload[comp]) == _triangle_total(mults)


def test_propagate_coo_with_indicators_matches_reference():
    rng = np.random.default_rng(6)
    rq, tq, ref, port, mults = _engines("sum", "fivm", rng)
    ind_ref = {n: s.dense for n, s in ref.indicators.items()}
    ind_port = {n: s.dense for n, s in port.indicators.items()}
    ref_views, port_views = dict(ref.views), dict(port.views)
    for rel, upd in _stream(rq, rng, mults, [4] * 3):
        want = rpropagate(ref.tree, ref_views, rq, rel, upd, indicators=ind_ref)
        got = propagate_coo(port.tree, port_views, tq, rel,
                            P.port_update(upd, tq.ring), indicators=ind_port)
        ref_views.update(want.updated)
        port_views.update(got.updated)
        assert list(got.deltas) == list(want.deltas)
        for name, view in want.updated.items():
            np.testing.assert_array_equal(got.updated[name].payload["v"].numpy(),
                                          np.asarray(view.payload["v"]))


def test_py_ivm_oracle_matches_reference_and_engine():
    """The host oracle on the triangle with indicators: every view and ∃
    relation equal to the reference's ``PyIVM`` and the root to the card
    engine's (here on the CPU) after 9 updates."""
    rng = np.random.default_rng(12)
    rq, tq, ref, port, mults = _engines("sum", "fivm", rng)
    tree_r, tree_p = ref.tree, port.tree

    def py_db(cls, ring, m):
        return {r: cls(RELS[r], ring, {tuple(int(x) for x in k): int(m[r][tuple(k)])
                                       for k in np.argwhere(m[r] != 0)})
                for r in RELS}

    start = {r: m.copy() for r, m in mults.items()}
    oracle_r = RPyIVM(tree_r, py_db(RPy, RPyNumber(count=True), start),
                      RSpec(RPyNumber(count=True), {}))
    oracle_p = PyIVM(tree_p, py_db(PyRelation, PyNumberRing(count=True), start),
                     PyEngineSpec(PyNumberRing(count=True), {}))
    for rel, upd in _stream(rq, rng, mults, [4] * 9):
        port.apply_update(rel, P.port_update(upd, tq.ring))
        keys, vals = np.asarray(upd.keys), np.asarray(upd.payload["v"])
        for cls, ring, oracle in ((RPy, RPyNumber(count=True), oracle_r),
                                  (PyRelation, PyNumberRing(count=True),
                                   oracle_p)):
            d = cls(RELS[rel], ring)
            for k, v in zip(keys, vals):
                if v:
                    d.data[tuple(int(x) for x in k)] = int(v)
            oracle.apply_update(rel, d)
    assert set(oracle_p.views) == set(oracle_r.views)
    for name, rv in oracle_r.views.items():
        assert oracle_p.views[name].schema == rv.schema
        assert oracle_p.views[name].data == rv.data, name
    assert oracle_p.result().data.get((), 0) == float(port.result().payload["v"])


@pytest.mark.parametrize("strategy", ["fivm", "dbt"])
def test_triangle_fused_plans_keep_the_reference_state(strategy):
    """Plan fusion on (``auto`` on the card): the R trigger's main path
    fuses and its indicator section never does; every view, base relation
    and indicator stays bitwise equal to the reference's unfused run."""
    rng = np.random.default_rng(8)
    with tplan.use_fusion("on"):
        rq, tq, ref, port, mults = _engines("cofactor", strategy, rng)
        for step, (rel, upd) in enumerate(_stream(rq, rng, mults, [4] * 9)):
            ref.apply_update(rel, upd)
            port.apply_update(rel, P.port_update(upd, tq.ring))
            assert_state_equal(ref, port, f"fused step {step}")
        r_plan = port.plans.lookup_sig(port, "R", ("coo", RELS["R"], 4))
    assert any(isinstance(op, tplan.FusedChain) for op in r_plan.ops)
    assert r_plan.ind_ops and not any(isinstance(op, tplan.FusedChain)
                                      for op in r_plan.ind_ops)
    assert float(port.result().payload["c"]) == _triangle_total(mults)
