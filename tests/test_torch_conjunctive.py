"""The conjunctive-query app (paper Sec. 7.3, Fig. 13) in the port ≡ the
reference, and the ported regression learner and examples.

Listing payloads on the host (``PyIVM`` over the tagged relational ring),
the factorized representation on the device engine (the premarg ``W:``
views, ``IVMEngine.build(premarg=True)``), enumeration from the ``W:``
payloads, and the cell counts, each fed the same numpy inputs through
``repro`` and ``repro_torch`` (on the CPU) and held to ``cq_oracle``, the
reference tests' brute force.  ``W:`` views: bitwise (integer data).
"""
import importlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as P  # noqa: E402

P.cap_torch_threads()
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.core import COOUpdate as RCOO  # noqa: E402
from repro.core import PyRelation as RPy  # noqa: E402
from repro.core import chain as rchain  # noqa: E402
from repro.core.apps import conjunctive as rconj  # noqa: E402
from repro.core.apps import regression as rreg  # noqa: E402
from repro.core.rings import PyRelationalRing as RRelational  # noqa: E402
from repro_torch.core import PyRelation, chain  # noqa: E402
from repro_torch.core.apps import conjunctive as tconj  # noqa: E402
from repro_torch.core.apps import regression as treg  # noqa: E402
from repro_torch.core.rings import PyRelationalRing  # noqa: E402

sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
from test_apps import cq_fixture, cq_oracle  # noqa: E402

HOUSING = {"House": ("pc", "h1"), "Shop": ("pc", "s1"), "Rest": ("pc", "r1")}


def _vo(chain_fn):
    return chain_fn(["A", "C"], {"A": [["B"]], "C": [["D"], ["E"]]})


def _py_db(cls, ring, rels, data):
    """Base relations for the relational ring: payload {() -> mult}."""
    return {name: cls(sch, ring, {tuple(int(k) for k in key):
                                  {(): int(data[name][tuple(key)])}
                                  for key in np.argwhere(data[name] != 0)})
            for name, sch in rels.items()}


def _fixture(seed):
    doms, rels, data, free, _ = cq_fixture(np.random.default_rng(seed))
    return doms, rels, data, free


def _engines(doms, rels, data, free):
    """(reference listing, port listing, reference factorized, port
    factorized) engines with their trees."""
    rl, rtree = rconj.make_listing_engine(
        rels, free, _py_db(RPy, RRelational(tagged=True), rels, data),
        _vo(rchain), doms)
    tl, ttree = tconj.make_listing_engine(
        rels, free, _py_db(PyRelation, PyRelationalRing(tagged=True), rels,
                           data), _vo(chain), doms)
    rf, _ = rconj.make_factorized_engine(rels, {k: v.copy() for k, v in data.items()},
                                         _vo(rchain), doms)
    tf, _ = tconj.make_factorized_engine(rels, data, _vo(chain), doms,
                                         device="cpu")
    return (rl, rtree), (tl, ttree), rf, tf


def _assert_W_views_equal(ref, port):
    assert {n for n in port.views if n.startswith("W:")} == \
        {n for n in ref.views if n.startswith("W:")} != set()
    P.assert_views_equal(ref, port)


def test_listing_and_factorized_payloads_match_reference_and_oracle():
    doms, rels, data, free = _fixture(9)
    (rl, rtree), (tl, ttree), rf, tf = _engines(doms, rels, data, free)
    expect = cq_oracle(data, doms)
    lst = tconj.listing_result(tl, free, ttree)
    assert lst == rconj.listing_result(rl, free, rtree)
    assert set(lst) == expect
    assert tconj.listing_payload_order(ttree, free) == \
        rconj.listing_payload_order(rtree, free)
    _assert_W_views_equal(rf, tf)
    payloads = tconj.factorized_payloads_from_engine(tf)
    assert payloads == rconj.factorized_payloads_from_engine(rf)
    assert tconj.enumerate_factorized(tf.tree, payloads, free) == expect
    assert tconj.factorized_cells(payloads) == rconj.factorized_cells(payloads)
    assert tconj.listing_cells(lst, len(free)) == rconj.listing_cells(lst, len(free))


@pytest.mark.parametrize("storage", ["dense", "sparse"])
def test_factorized_and_listing_ivm_updates_match_reference(storage):
    """Single-tuple ±1 updates (a key switches on or off): the ``W:``
    views, plan texts, enumeration and listing after each equal the
    reference's and the oracle."""
    rng = np.random.default_rng(10)
    doms, rels, data, free = _fixture(10)
    (rl, rtree), (tl, ttree), rf, tf = _engines(doms, rels, data, free)
    if storage == "sparse":  # the same engines with every eligible view sparse
        rf, _ = rconj.make_factorized_engine(
            rels, {k: v.copy() for k, v in data.items()}, _vo(rchain), doms,
            storage="sparse")
        tf, _ = tconj.make_factorized_engine(rels, data, _vo(chain), doms,
                                             device="cpu", storage="sparse")
        assert {n: s.kind for n, s in tf.storage_plan.items()} == \
            {n: s.kind for n, s in rf.storage_plan.items()}
    for step in range(6):
        rel = ["R", "S", "T", "S", "R", "T"][step]
        sch = rels[rel]
        keys = tuple(int(rng.integers(0, doms[v])) for v in sch)
        delta = 1 if data[rel][keys] == 0 else -1
        data[rel][keys] += delta
        upd = RCOO(sch, jnp.asarray([list(keys)], jnp.int32),
                   {"v": jnp.asarray([float(delta)], jnp.float32)})
        rf.apply_update(rel, upd)
        tupd = P.port_update(upd, tf.query.ring)
        tf.apply_update(rel, tupd)
        assert tf.trigger_plan(rel, tupd).pretty() == rf.trigger_plan(
            rel, upd).pretty().replace(" jnp", " torch").replace(
                " indicators=[]", "")
        for eng, cls, ring in ((rl, RPy, rl.spec.ring), (tl, PyRelation,
                                                         tl.spec.ring)):
            d = cls(sch, ring)
            d.data[keys] = {(): delta}
            eng.apply_update(rel, d)
        _assert_W_views_equal(rf, tf)
        expect = cq_oracle(data, doms)
        payloads = tconj.factorized_payloads_from_engine(tf)
        assert tconj.enumerate_factorized(tf.tree, payloads, free) == expect, step
        lst = tconj.listing_result(tl, free, ttree)
        assert lst == rconj.listing_result(rl, free, rtree)
        assert set(lst) == expect, step


def test_housing_W_views_match_reference_under_batches():
    """The bench's Housing star (pc, attr 6) at pc = 32, batches of
    distinct-key ±1 updates: every ``W:`` view and the root bitwise."""
    rng = np.random.default_rng(0)
    doms = dict(pc=32, h1=6, s1=6, r1=6)
    data = {n: (rng.random(tuple(doms[v] for v in sch)) < 0.5).astype(np.int64)
            for n, sch in HOUSING.items()}
    vo = (["pc"], {"pc": [["h1"], ["s1"], ["r1"]]})
    rf, _ = rconj.make_factorized_engine(HOUSING, {k: v.copy() for k, v in data.items()},
                                         rchain(*vo), doms)
    tf, _ = tconj.make_factorized_engine(HOUSING, data, chain(*vo), doms,
                                         device="cpu")
    for step in range(6):
        rel = list(HOUSING)[step % 3]
        shape = data[rel].shape
        flat = rng.choice(int(np.prod(shape)), size=16, replace=False)
        keys = np.stack(np.unravel_index(flat, shape), axis=1).astype(np.int32)
        vals = np.where(data[rel][tuple(keys.T)] == 0, 1.0, -1.0).astype(np.float32)
        data[rel][tuple(keys.T)] += vals.astype(np.int64)
        upd = RCOO(HOUSING[rel], jnp.asarray(keys), {"v": jnp.asarray(vals)})
        rf.apply_update(rel, upd)
        tf.apply_update(rel, P.port_update(upd, tf.query.ring))
    _assert_W_views_equal(rf, tf)
    want = float(np.einsum("ph,ps,pr->", *(data[n] for n in HOUSING)))
    assert float(tf.result().payload["v"]) == want


def test_fused_factorized_engine_keeps_the_reference_W_views():
    """Plan fusion on (``auto`` on the card): the sibling gathers into
    ``W:V@pc`` fuse into one chain a trigger; the ``W:`` views stay
    bitwise equal to the reference's unfused engine."""
    from repro_torch.core import plan as tplan

    rng = np.random.default_rng(4)
    doms = dict(pc=32, h1=6, s1=6, r1=6)
    data = {n: (rng.random(tuple(doms[v] for v in sch)) < 0.5).astype(np.int64)
            for n, sch in HOUSING.items()}
    vo = (["pc"], {"pc": [["h1"], ["s1"], ["r1"]]})
    rf, _ = rconj.make_factorized_engine(HOUSING, {k: v.copy() for k, v in data.items()},
                                         rchain(*vo), doms)
    with tplan.use_fusion("on"):
        tf, _ = tconj.make_factorized_engine(HOUSING, data, chain(*vo), doms,
                                             device="cpu")
        for i in range(6):
            rel = list(HOUSING)[i % 3]
            shape = data[rel].shape
            flat = rng.choice(int(np.prod(shape)), size=8, replace=False)
            keys = np.stack(np.unravel_index(flat, shape), axis=1).astype(np.int32)
            vals = np.where(data[rel][tuple(keys.T)] == 0, 1.0, -1.0).astype(np.float32)
            upd = RCOO(HOUSING[rel], jnp.asarray(keys), {"v": jnp.asarray(vals)})
            rf.apply_update(rel, upd)
            tupd = P.port_update(upd, tf.query.ring)
            tf.apply_update(rel, tupd)
            assert any(isinstance(op, tplan.FusedChain)
                       for op in tf.trigger_plan(rel, tupd).ops)
    _assert_W_views_equal(rf, tf)


def test_learn_linear_model_matches_reference():
    """Gradient descent on the statistics of a small integer design
    matrix: θ within 1e-5 of the reference's after 2000 steps (float32
    matrix-vector products summed in another order)."""
    rng = np.random.default_rng(3)
    m = 5
    X = rng.integers(-3, 4, size=(40, m)).astype(np.float32)
    c, s, Q = np.float32(len(X)), X.sum(0), X.T @ X
    rstats = rreg.CofactorStats(c=jnp.asarray(c), s=jnp.asarray(s), Q=jnp.asarray(Q))
    tstats = treg.CofactorStats(c=torch.tensor(c), s=torch.tensor(s),
                                Q=torch.tensor(Q))
    for label, features in ((3, [1, 4]), (0, [2])):
        want = np.asarray(rreg.learn_linear_model(rstats, label, features,
                                                  lr=0.01, steps=2000))
        got = treg.learn_linear_model(tstats, label, features, lr=0.01,
                                      steps=2000).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        assert got[1 + label] == -1.0


@pytest.mark.parametrize("name", ["quickstart", "learn_regression"])
def test_examples_print_ok(name, capsys):
    module = importlib.import_module(f"repro_torch.examples.{name}")
    module.main(["--device", "cpu"])
    assert "OK" in capsys.readouterr().out.splitlines()[-1]
