"""The port's matrix-chain app ≡ the reference's (paper Sec. 7.1).

``repro_torch.core.apps.matrix_chain`` against ``repro.core.apps.
matrix_chain`` on the same numpy matrices, on the CPU: the query, the
variable order and the compiled plans; the static chain; rank-1, row and
rank-r updates through ``IVMEngine.apply_update`` under every strategy;
sparse storage against dense.  Integer-valued data must match bit for bit;
normal data within 1e-6 of the largest magnitude (the North star's bound
for a reordered float32 sum).  Rank-r updates come from an SVD, whose
singular vectors are unique only up to sign, so the port's decomposition
is held to the reference's by what it reconstructs.  Also: on the CPU the
engine sends each rank-1 join and ⊎ through the kernel routes
(``plan.factorized_route``) as often as the plan says, and the example
module prints OK.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as P  # noqa: E402

P.cap_torch_threads()
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.core.apps import matrix_chain as rmc  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core.apps import matrix_chain as tmc  # noqa: E402
from repro_torch.core.storage import SparseRelation  # noqa: E402

#: normal data: within this share of the largest magnitude
RTOL = 1e-6
#: the reference's chain test: four matrices of mixed sizes
DIMS = [5, 6, 4, 7, 5]
STRATEGIES = ["fivm", "fivm_1", "dbt", "reeval"]


def _mats(rng, dims, data):
    shapes = [(dims[i], dims[i + 1]) for i in range(len(dims) - 1)]
    if data == "ints":
        return [rng.integers(-3, 4, size=s).astype(np.float32) for s in shapes]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _vector(rng, n, data):
    if data == "ints":
        return rng.integers(-3, 4, size=n).astype(np.float32)
    return rng.standard_normal(n).astype(np.float32)


def _engines(mats, **kw):
    ref = rmc.build_chain_engine([jnp.asarray(m) for m in mats], **kw)
    eng = tmc.build_chain_engine(mats, device="cpu", **kw)
    return ref, eng


def _assert_same(ref, eng, data, where=""):
    want = np.asarray(rmc.result_matrix(ref))
    got = tmc.result_matrix(eng).numpy()
    assert got.shape == want.shape
    if data == "ints":
        np.testing.assert_array_equal(got, want, err_msg=where)
        P.assert_views_close(ref, eng, 0.0, where)
    else:
        P.assert_views_close(ref, eng, RTOL, where)


def test_query_order_and_database_match_reference():
    rq = rmc.chain_query(DIMS)
    tq = tmc.chain_query(DIMS)
    assert dict(tq.relations) == dict(rq.relations)
    assert dict(tq.domains) == dict(rq.domains)
    assert tuple(tq.free_vars) == tuple(rq.free_vars) == ("X1", "X5")
    assert tq.ring.name == "sum" and tq.ring.dtype == torch.float32

    def shape(order):
        def rec(node):
            return (node.var, tuple(rec(c) for c in node.children))
        return tuple(rec(r) for r in order.roots)

    for n in (1, 2, 3, 4, 7):
        assert shape(tmc.balanced_order(n)) == shape(rmc.balanced_order(n))
    mats = _mats(np.random.default_rng(0), DIMS, "normal")
    db = tmc.matrices_to_db(tq.ring, mats)
    rdb = rmc.matrices_to_db(rq.ring, [jnp.asarray(m) for m in mats])
    for name, rel in rdb.items():
        assert db[name].schema == tuple(rel.schema)
        np.testing.assert_array_equal(db[name].payload["v"].numpy(),
                                      np.asarray(rel.payload["v"]))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_chain_plans_match_reference(strategy):
    """Every relation's factorized and COO plan text, as the reference
    compiles it (the reference's golden GOLDEN_CHAIN_A2 among them)."""
    mats = _mats(np.random.default_rng(1), [4, 3, 5, 2], "ints")
    ref, eng = _engines(mats, strategy=strategy)
    for rel, sch in eng.query.relations.items():
        for sig in (("factorized", sch), ("coo", sch, 3)):
            want = ref.plans.lookup_sig(ref, rel, sig).pretty()
            got = eng.plans.lookup_sig(eng, rel, sig).pretty()
            # the ⊎ backend of a COO scatter is the port's own torch path
            assert got == want.replace(" indicators=[]", "").replace(
                " jnp", " torch"), (rel, sig)


GOLDEN_CHAIN_A2 = """\
trigger A2 kind=factorized strategy=fivm schema=[X2,X3] batch=- densify=no cost=0
  Leaf factors[X2,X3]
  Emit[A2]
  Scatter[A2 dense]
  Join[A3 dense]
  Lift[X3 one]
  Marg[X3 factor]
  Emit[V0@X3]
  Scatter[V0@X3 dense]
  Join[A1 dense]
  Lift[X2 one]
  Marg[X2 factor]
  Emit[V3@X1]
  Scatter[V3@X1 dense]
  writes: views=[A2,V0@X3,V3@X1] base=[]"""


@pytest.mark.parametrize("fusion", ["off", "on"])
def test_golden_chain_plan_under_either_fusion(fusion):
    """The reference's golden chain plan (tests/test_plan.py), which plan
    fusion leaves as it is."""
    rng = np.random.default_rng(0)
    mats = [rng.random((4, 3)).astype(np.float32),
            rng.random((3, 5)).astype(np.float32),
            rng.random((5, 2)).astype(np.float32)]
    with tplan.use_fusion(fusion):
        eng = tmc.build_chain_engine(mats, device="cpu")
        p = eng.plans.lookup_sig(eng, "A2", ("factorized", ("X2", "X3")))
    assert p.pretty() == GOLDEN_CHAIN_A2


@pytest.mark.parametrize("data", ["ints", "normal"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_static_and_rank1(seed, data):
    """The reference's test_chain_static_and_rank1, held to the reference
    rather than to numpy."""
    rng = np.random.default_rng(seed)
    mats = _mats(rng, DIMS, data)
    ref, eng = _engines(mats)
    _assert_same(ref, eng, data, "static")
    expect = np.linalg.multi_dot([m.astype(np.float64) for m in mats])
    np.testing.assert_allclose(tmc.result_matrix(eng).numpy(), expect,
                               rtol=1e-5, atol=1e-5)
    for k in (2, 1, 4, 3):
        u = _vector(rng, DIMS[k - 1], data)
        v = _vector(rng, DIMS[k], data)
        ref.apply_update(f"A{k}", rmc.rank1_update(k, jnp.asarray(u), jnp.asarray(v),
                                                   ref.query.ring))
        eng.apply_update(f"A{k}", tmc.rank1_update(k, torch.tensor(u), torch.tensor(v),
                                                   eng.query.ring))
        _assert_same(ref, eng, data, f"rank-1 A{k}")


@pytest.mark.parametrize("data", ["ints", "normal"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_chain_row_updates_under_every_strategy(strategy, data):
    rng = np.random.default_rng(4)
    p = 8
    mats = _mats(rng, [p, p, p, p], data)
    ref, eng = _engines(mats, updatable=("A1", "A2"), strategy=strategy)
    for k, row in ((2, 3), (1, 0), (2, 7)):
        delta = _vector(rng, p, data)
        ref.apply_update(f"A{k}", rmc.row_update(k, row, jnp.asarray(delta), p,
                                                 ref.query.ring))
        upd = tmc.row_update(k, row, torch.tensor(delta), p, eng.query.ring)
        assert upd.factors[0].payload["v"].tolist() == [float(i == row) for i in range(p)]
        eng.apply_update(f"A{k}", upd)
        _assert_same(ref, eng, data, f"{strategy} row A{k}[{row}]")


def test_rank_r_updates():
    """decompose_rank_r: the port's terms reconstruct what the reference's
    do (float32 SVDs of two libraries: within 1e-5 of the largest entry);
    the engines, given the same terms, agree within RTOL."""
    rng = np.random.default_rng(4)
    p = 8
    mats = _mats(rng, [p, p, p, p], "normal")
    ref, eng = _engines(mats)
    delta = rng.standard_normal((p, p)).astype(np.float32)
    delta = (delta[:, :2] @ delta[:2, :]).astype(np.float32)  # exact rank 2
    terms = tmc.decompose_rank_r(torch.tensor(delta), 2)
    rterms = rmc.decompose_rank_r(jnp.asarray(delta), 2)
    assert len(terms) == len(rterms) == 2
    got = sum(np.outer(u.numpy(), v.numpy()) for u, v in terms)
    want = sum(np.outer(np.asarray(u), np.asarray(v)) for u, v in rterms)
    scale = np.abs(delta).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.abs(got - delta).max() <= 1e-5 * scale
    assert len(tmc.decompose_rank_r(torch.tensor(delta), 20)) == p
    for u, v in rterms:
        u, v = np.asarray(u), np.asarray(v)
        ref.apply_update("A2", rmc.rank1_update(2, jnp.asarray(u), jnp.asarray(v),
                                                ref.query.ring))
        eng.apply_update("A2", tmc.rank1_update(2, torch.tensor(u), torch.tensor(v),
                                                eng.query.ring))
    _assert_same(ref, eng, "normal", "rank-2")
    m2 = mats[1].astype(np.float64) + delta
    expect = mats[0].astype(np.float64) @ m2 @ mats[2]
    np.testing.assert_allclose(tmc.result_matrix(eng).numpy(), expect,
                               rtol=1e-4, atol=1e-4)


def test_sparse_chain_engine_matches_dense_and_reference():
    """The reference's test_sparse_chain_engine_rank1_updates_match_dense:
    sparse storage takes the per-factor active-key lowering; bitwise to
    dense storage and to the reference's sparse engine, table for table."""
    rng = np.random.default_rng(7)
    mats = [rng.random((6, 5)).astype(np.float32),
            rng.random((5, 4)).astype(np.float32)]
    ref_s = rmc.build_chain_engine([jnp.asarray(m) for m in mats], storage="sparse")
    eng_d = tmc.build_chain_engine(mats, storage="dense", device="cpu")
    eng_s = tmc.build_chain_engine(mats, storage="sparse", device="cpu")
    assert any(s.kind == "sparse" for s in eng_s.storage_plan.values())
    assert {n: (s.kind, s.capacity) for n, s in eng_s.storage_plan.items()} == {
        n: (s.kind, s.capacity) for n, s in ref_s.storage_plan.items()}
    ring = eng_d.query.ring
    for k, p in ((1, 6), (2, 5), (1, 6)):
        u = np.zeros(p, np.float32)
        u[rng.integers(0, p)] = float(rng.integers(1, 4))
        w = np.zeros(mats[k - 1].shape[1], np.float32)
        w[rng.integers(0, w.size)] = float(rng.integers(1, 4))
        ref_s.apply_update(f"A{k}", rmc.rank1_update(k, jnp.asarray(u), jnp.asarray(w),
                                                     ref_s.query.ring))
        for eng in (eng_d, eng_s):
            eng.apply_update(f"A{k}", tmc.rank1_update(k, torch.tensor(u),
                                                       torch.tensor(w), ring))
    np.testing.assert_array_equal(tmc.result_matrix(eng_s).numpy(),
                                  tmc.result_matrix(eng_d).numpy())
    P.assert_sparse_views_equal(P.sparse_views(ref_s), eng_s, "sparse chain")
    assert any(isinstance(v, SparseRelation) for v in eng_s.views.values())


@pytest.mark.parametrize("updatable,scatters", [(("A2",), 1), (None, 3)])
def test_rank1_updates_take_the_kernel_routes(monkeypatch, updatable, scatters):
    """On the CPU the routes run the kernels' plain versions: each rank-1
    update makes one matvec a (Join, Lift, Marg) triple of its plan and one
    outer accumulate a ⊎ into a 2-D view, and nothing takes the einsum
    forms.  With A2 alone updatable only the root is maintained; with
    every relation updatable, A2 and A2·A3 too."""
    counts = dict(matvec=0, outer=0, plain=0)

    def counted(name, fn):
        def wrapper(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(tplan, "_matvec_join", counted("matvec", tplan._matvec_join))
    monkeypatch.setattr(tplan, "_outer_scatter", counted("outer", tplan._outer_scatter))
    monkeypatch.setattr(tplan, "absorb_factor", counted("plain", tplan.absorb_factor))
    monkeypatch.setattr(tplan, "apply_factorized", counted("plain", tplan.apply_factorized))
    rng = np.random.default_rng(3)
    n = 16
    mats = _mats(rng, [n] * 4, "ints")
    ref, eng = _engines(mats, updatable=updatable)
    plan = eng.plans.lookup_sig(eng, "A2", ("factorized", ("X2", "X3")))
    joins = sum(isinstance(op, tplan.JoinContract) for op in plan.ops)
    assert joins == 2
    assert sum(isinstance(op, tplan.ScatterAccum) for op in plan.ops) == scatters
    updates = 3
    for _ in range(updates):
        u, v = _vector(rng, n, "ints"), _vector(rng, n, "ints")
        ref.apply_update("A2", rmc.rank1_update(2, jnp.asarray(u), jnp.asarray(v),
                                                ref.query.ring))
        eng.apply_update("A2", tmc.rank1_update(2, torch.tensor(u), torch.tensor(v),
                                                eng.query.ring))
    assert counts == dict(matvec=joins * updates, outer=scatters * updates, plain=0)
    _assert_same(ref, eng, "ints", "routes")


def test_example_prints_ok(capsys):
    from repro_torch.examples import matrix_chain as example

    example.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK")
    assert "static chain OK" in out


def test_chain_build_never_forms_a_cubic_product(monkeypatch):
    """The engine build sums each inner index inside its join (an identity
    lift): no einsum of the build makes more than p² values, where the
    reference's join-then-sum forms p³ (p = 8192 would need 2 TiB)."""
    sizes = []
    einsum = torch.einsum

    def recording(*args, **kw):
        out = einsum(*args, **kw)
        sizes.append(out.numel())
        return out

    monkeypatch.setattr(torch, "einsum", recording)
    p = 24
    mats = _mats(np.random.default_rng(5), [p] * 5, "ints")
    eng = tmc.build_chain_engine(mats, device="cpu")
    assert sizes and max(sizes) <= p * p
    expect = np.linalg.multi_dot([m.astype(np.float64) for m in mats])
    np.testing.assert_array_equal(tmc.result_matrix(eng).numpy(), expect)
