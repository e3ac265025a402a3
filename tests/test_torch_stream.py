"""The port's stream executor ≡ its eager engine ≡ the reference's executor.

``repro_torch.core.stream`` runs a prepared stream step by step through
the same trigger bodies on the CPU (the card captures each step body as a
CUDA graph; ``tests/test_torch_cuda.py`` holds those cases).  Here, on
integer-valued data, so float32 sums are exact in any order:

* the executor equals the port's eager ``apply_update`` bitwise, for the
  four strategies, in scan, rounds, rounds with a tail and switch mode,
  with heterogeneous batch sizes (padding) and plan fusion off and on;
* it equals the reference's ``StreamExecutor`` (JAX on the CPU) on the
  same numpy-seeded streams: bitwise for the sum ring, within 1e-6
  relative for a degree-m cofactor ring;
* the host-side helpers equal the reference's on the same inputs;
* a run reads nothing back from the device, copies nothing from the host,
  leaves the caller's database and (with ``update_engine=False``) the
  engine alone, and the graph runner's capture/replay bookkeeping holds;
* ``storage.linear_ids`` equals the reference's and builds no tensor from
  host data;
* a capture runs no garbage collection (a dropped program's graphs are
  freed outside captures), and releasing the executor releases its
  graphs.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as P  # noqa: E402

P.cap_torch_threads()
jnp = pytest.importorskip("jax.numpy")

from benchmarks import common as bc  # noqa: E402
from repro.core import COOUpdate as RefUpdate  # noqa: E402
from repro.core import DenseRelation as RefRelation  # noqa: E402
from repro.core import IVMEngine as RefEngine  # noqa: E402
from repro.core import Query as RefQuery  # noqa: E402
from repro.core import StreamExecutor as RefExecutor  # noqa: E402
from repro.core import chain as ref_chain  # noqa: E402
from repro.core import plan as rplan  # noqa: E402
from repro.core import prepare_stream as ref_prepare  # noqa: E402
from repro.core import storage as rstorage  # noqa: E402
from repro.core import stream as rstream  # noqa: E402
from repro.core import sum_ring as ref_sum_ring  # noqa: E402
from repro.core.apps import regression as ref_regression  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import (IVMEngine, Query, StreamExecutor, chain,  # noqa: E402
                              prepare_stream, sum_ring)
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core import relations as trelations  # noqa: E402
from repro_torch.core import storage as tstorage  # noqa: E402
from repro_torch.core import stream as tstream  # noqa: E402
from repro_torch.core.apps import regression  # noqa: E402
from repro_torch.data import synth  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402

DOMS = dict(A=4, B=5, C=3, D=6, E=4)
RELS = {"R": ("A", "B"), "S": ("A", "C", "E"), "T": ("C", "D")}
LIFTS = {"B": ("value",), "D": ("value",), "E": ("value",)}
SCHEDULES = {
    "scan": ["S"] * 4,
    "rounds": ["R", "S", "T"] * 3,
    "rounds_tail": ["R", "S", "T"] * 3 + ["R", "S"],
    "switch": ["R", "S", "T", "S", "R", "R", "T"],
}
STRATEGIES = ["fivm", "dbt", "fivm_1", "reeval"]


@pytest.fixture(autouse=True)
def _no_fusion_env(monkeypatch):
    monkeypatch.delenv(tplan.FUSION_ENV_VAR, raising=False)
    monkeypatch.delenv(rplan.FUSION_ENV_VAR, raising=False)


def _vo(chain_fn):
    return chain_fn(["A", "C"], {"A": [["B"]], "C": [["D"], ["E"]]})


def _queries(kind):
    """(reference query, port query) of the example schema."""
    if kind == "sum":
        return (RefQuery(relations=RELS, free_vars=("A", "C"), ring=ref_sum_ring(),
                         domains=DOMS, lifts=LIFTS),
                Query(relations=RELS, free_vars=("A", "C"), ring=sum_ring(),
                      domains=DOMS, lifts=LIFTS))
    return (ref_regression.cofactor_query(RELS, DOMS),
            regression.cofactor_query(RELS, DOMS))


def _payload(ring, lead_shape, values):
    """Numpy ring payload: ``values`` in v (sum ring) or c (cofactor ring),
    zeros elsewhere."""
    if set(ring.components) == {"v"}:
        return {"v": values}
    out = {c: np.zeros(tuple(lead_shape) + tuple(shp), np.float32)
           for c, shp in ring.components.items()}
    out["c"] = values
    return out


def _np_case(kind, schedule, seed=0, batches=None):
    """Numpy database and stream of the example schema: small integer
    multiplicities and ±1/±2 update rows, batch sizes 1–7 unless given."""
    rng = np.random.default_rng(seed)
    rq, _ = _queries(kind)
    db = {}
    for name, sch in RELS.items():
        shape = tuple(DOMS[v] for v in sch)
        db[name] = (sch, _payload(rq.ring, shape,
                                  rng.integers(0, 3, size=shape).astype(np.float32)))
    batches = batches or [int(rng.integers(1, 8)) for _ in schedule]
    stream = []
    for rel, B in zip(schedule, batches):
        sch = RELS[rel]
        keys = np.stack([rng.integers(0, DOMS[v], size=B) for v in sch],
                        axis=1).astype(np.int32)
        vals = rng.integers(-2, 3, size=B).astype(np.float32)
        stream.append((rel, sch, keys, _payload(rq.ring, (B,), vals)))
    return db, stream


def _port(kind, db, stream, strategy="fivm"):
    _, tq = _queries(kind)
    port_db = convert.database_from_numpy(db, tq.ring, device="cpu")
    upds = [(rel, convert.update_from_numpy(sch, keys, pay, tq.ring, device="cpu"))
            for rel, sch, keys, pay in stream]

    def build():
        return IVMEngine.build(tq, port_db, var_order=_vo(chain), strategy=strategy,
                               storage="dense", device="cpu")

    return build, port_db, upds


def _ref(kind, db, stream, strategy="fivm"):
    rq, _ = _queries(kind)
    ref_db = {n: RefRelation(sch, rq.ring, {c: jnp.asarray(v) for c, v in pay.items()})
              for n, (sch, pay) in db.items()}
    upds = [(rel, RefUpdate(sch, jnp.asarray(keys),
                            {c: jnp.asarray(v) for c, v in pay.items()}))
            for rel, sch, keys, pay in stream]
    eng = RefEngine.build(rq, ref_db, var_order=_vo(ref_chain), strategy=strategy,
                          storage="dense")
    return eng, upds


def _views_equal(a, b, where=""):
    assert set(a.views) == set(b.views)
    for name in a.views:
        for c, t in a.views[name].payload.items():
            assert torch.equal(t, b.views[name].payload[c]), f"{where} {name}.{c}"


# ---------------------------------------------------------------------------
# executor ≡ eager engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fusion", ["off", "on"])
@pytest.mark.parametrize("mode", list(SCHEDULES))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_executor_matches_eager_engine(strategy, mode, fusion):
    db, stream = _np_case("sum", SCHEDULES[mode], seed=len(mode))
    build, _, upds = _port("sum", db, stream, strategy)
    with tplan.use_fusion(fusion):
        fused, seq = build(), build()
        prepared = prepare_stream(fused, upds)
        want_mode = "rounds" if mode == "rounds_tail" else mode
        assert prepared.mode == want_mode
        assert prepared.tail_len == (2 if mode == "rounds_tail" else 0)
        ex = StreamExecutor(fused)
        state = ex.run(prepared)
        for rel, upd in upds:
            seq.apply_update(rel, upd)
    assert state[0] is fused.views
    _views_equal(fused, seq, f"{strategy} {mode} fusion {fusion}")
    assert ex.last_run_stats["eager_steps"] == prepared.n_steps
    chains = any(isinstance(op, tplan.FusedChain) for p in prepared.plans for op in p.ops)
    assert chains == (fusion == "on" and strategy in ("fivm", "dbt"))


def test_executor_runs_a_raw_stream_and_an_explicit_state():
    db, stream = _np_case("sum", SCHEDULES["rounds"], seed=5)
    build, _, upds = _port("sum", db, stream)
    seq = build()
    for rel, upd in upds:
        seq.apply_update(rel, upd)
    raw = build()
    StreamExecutor(raw).run(upds)
    _views_equal(raw, seq, "raw stream")
    explicit = build()
    before = {n: v.payload["v"].clone() for n, v in explicit.views.items()}
    state = StreamExecutor(explicit).run(upds, state=explicit.state,
                                         update_engine=False)
    for name, v in explicit.views.items():
        assert torch.equal(v.payload["v"], before[name]), name
        assert torch.equal(state[0][name].payload["v"], seq.views[name].payload["v"])


#: a second schedule of the first one's signature: in switch mode the same
#: relations, first seen in the same order, in another aperiodic order
_SECOND_SCHEDULES = {**SCHEDULES, "switch": ["R", "S", "T", "R", "T", "S", "R"]}


@pytest.mark.parametrize("runner", ["eager", "graph"])
@pytest.mark.parametrize("mode", list(SCHEDULES))
def test_one_executor_runs_two_streams_of_one_signature(request, runner, mode):
    """Two streams with one signature through one executor: each run
    applies its own stream's inputs, tail and schedule.  With the graph
    runner the second stream only replays the first one's graphs."""
    captures = request.getfixturevalue("graph_runner") if runner == "graph" else None
    batches = [7, 3, 5, 2, 6, 4, 1, 7, 2, 5, 3][:len(SCHEDULES[mode])]
    db, first = _np_case("sum", SCHEDULES[mode], seed=21, batches=batches)
    _, second = _np_case("sum", _SECOND_SCHEDULES[mode], seed=22, batches=batches)
    build, _, upds1 = _port("sum", db, first)
    upds2 = _port("sum", db, second)[2]
    eng, seq = build(), build()
    p1, p2 = prepare_stream(eng, upds1), prepare_stream(eng, upds2)
    assert p1.signature == p2.signature
    assert (p1.schedule != p2.schedule) == (mode == "switch")
    ex = StreamExecutor(eng)
    ex.run(p1)
    ex.run(p2, donate_input=True)
    if captures is not None:
        assert ex.last_run_stats["eager_steps"] == 0
        assert ex.last_run_stats["replays"] == p2.n_steps
    ex.run(upds1)  # a raw stream, prepared anew
    assert len(ex._compiled) == 1
    for rel, upd in upds1 + upds2 + upds1:
        seq.apply_update(rel, upd)
    _views_equal(eng, seq, f"{mode} {runner}")


# ---------------------------------------------------------------------------
# executor ≡ the reference's executor
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["sum", "cofactor"])
@pytest.mark.parametrize("mode", ["scan", "rounds_tail", "switch"])
def test_executor_matches_reference_executor(kind, mode):
    db, stream = _np_case(kind, SCHEDULES[mode], seed=11)
    ref_eng, ref_upds = _ref(kind, db, stream)
    RefExecutor(ref_eng).run(ref_upds)
    build, _, upds = _port(kind, db, stream)
    port = build()
    StreamExecutor(port).run(upds)
    if kind == "sum":
        P.assert_views_equal(ref_eng, port, mode)
        return
    got = convert.state_to_numpy(port)["views"]
    for name, rv in ref_eng.views.items():
        for c, arr in rv.payload.items():
            want = np.asarray(arr)
            scale = max(np.abs(want).max(initial=0.0), 1.0)
            np.testing.assert_allclose(got[name][c], want, rtol=0, atol=1e-6 * scale,
                                       err_msg=f"{mode} {name}.{c}")


def _retailer_case(kind, n_batches=7, batch=8, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "sum":
        rq = RefQuery(relations=bc.RETAILER_RELATIONS, free_vars=(), ring=ref_sum_ring(),
                      domains=bc.RETAILER_DOMS, lifts={"units": ("value",)})
        tq = Query(relations=synth.RETAILER_RELATIONS, free_vars=(), ring=sum_ring(),
                   domains=synth.RETAILER_DOMS, lifts={"units": ("value",)})
    else:
        rq = ref_regression.cofactor_query(bc.RETAILER_RELATIONS, bc.RETAILER_DOMS)
        tq = regression.cofactor_query(synth.RETAILER_RELATIONS, synth.RETAILER_DOMS)
    db = bc.synth_db(bc.RETAILER_RELATIONS, bc.RETAILER_DOMS, rq.ring, rng, density=0.05)
    # Inventory and Weather alternate: both gather V8@zip, which neither
    # writes (in a round over all five relations every gathered view is
    # written by another position)
    pair = {r: bc.RETAILER_RELATIONS[r] for r in ("Inventory", "Weather")}
    stream = bc.update_stream(pair, bc.RETAILER_DOMS, rq.ring, rng, batch, n_batches)
    port_db = convert.database_from_numpy(P.db_to_numpy(db), tq.ring, device="cpu")
    return rq, tq, db, port_db, stream


@pytest.mark.parametrize("fusion", ["off", "on"])
def test_retailer_rounds_with_shared_planes_match_reference(fusion):
    """A retailer stream in rounds mode whose positions share sibling planes
    (the step's CSE memo), with a tail, against the reference's executor
    and the port's eager engine."""
    rq, tq, db, port_db, stream = _retailer_case("sum")
    with rplan.use_fusion(fusion):
        ref_eng = RefEngine.build(rq, db, var_order=bc.retailer_vo(), storage="dense")
        RefExecutor(ref_eng).run(stream)
    upds = [(rel, P.port_update(u, tq.ring)) for rel, u in stream]
    with tplan.use_fusion(fusion):
        port, seq = (IVMEngine.build(tq, port_db, var_order=synth.retailer_vo(),
                                     storage="dense", device="cpu") for _ in range(2))
        ex = StreamExecutor(port)
        ex.run(upds)
        for rel, upd in upds:
            seq.apply_update(rel, upd)
    assert ex.last_shared_ops, "the retailer rounds share sibling planes"
    P.assert_views_equal(ref_eng, port, f"fusion {fusion}")
    _views_equal(port, seq)


# ---------------------------------------------------------------------------
# host-side helpers ≡ the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("schedule,batches", [
    (SCHEDULES["scan"], [3, 7, 2, 7]),
    (["R", "S"] * 3, [2, 5] * 3),
    (["R", "S", "R", "R"], [2] * 4),
    (SCHEDULES["rounds_tail"], [3] * 11),
    (["S", "R"] * 3 + ["S"], [2] * 7),
    (SCHEDULES["switch"], [1, 4, 2, 6, 3, 5, 7]),
])
def test_prepare_stream_matches_reference(schedule, batches):
    db, stream = _np_case("sum", schedule, seed=2, batches=batches)
    ref_eng, ref_upds = _ref("sum", db, stream)
    build, _, upds = _port("sum", db, stream)
    want = ref_prepare(ref_eng, ref_upds)
    got = prepare_stream(build(), upds)
    for field in ("mode", "rel_order", "schemas", "pattern", "buckets", "n_steps",
                  "tail_len", "n_tuples"):
        assert getattr(got, field) == getattr(want, field), field
    if got.mode == "switch":
        keys, payload = got.xs
        np.testing.assert_array_equal(keys.numpy(), np.asarray(want.xs[1]))
        np.testing.assert_array_equal(payload["v"].numpy(), np.asarray(want.xs[2]["v"]))
        assert got.schedule == tuple(np.asarray(want.xs[0]).tolist())


@pytest.mark.parametrize("schedule", [
    [], ["R"], ["R"] * 5, ["R", "S"], ["R", "S", "R"], ["R", "S", "R", "S"],
    ["S", "R", "S", "R", "S"], ["R", "S", "T", "R", "S"], list("RSTRSRSTT"),
    list("ABCDEFGHIJKLMNOPQ") * 2, list("ABCDEFGHIJKLMNOP") * 2 + ["A"],
])
def test_schedule_period_matches_reference(schedule):
    assert tstream._schedule_period(schedule) == rstream._schedule_period(schedule)


@pytest.mark.parametrize("max_updates", [None, 1, 3, 4, 20])
def test_split_segments_matches_reference(max_updates):
    segments = [(list(range(10)), {"V": 8}), (list(range(3)), {}), ([7], {"W": 2})]
    assert (tstream.split_segments(segments, max_updates)
            == rstream.split_segments(segments, max_updates))


def test_capacity_helpers_on_dense_views():
    db, stream = _np_case("sum", SCHEDULES["rounds"], seed=3)
    build, _, upds = _port("sum", db, stream)
    eng = build()
    assert tstream.capacity_segments(eng, upds) == [(upds, {})]
    assert tstream.check_stream_capacity(eng, upds) is None
    assert tplan.storage_signature(eng.views) == rplan.storage_signature(
        _ref("sum", db, stream)[0].views)


@pytest.mark.parametrize("fusion", ["off", "on"])
@pytest.mark.parametrize("kind", ["sum", "cofactor"])
def test_shared_prep_ops_and_write_mask_match_reference(kind, fusion):
    rq, tq, db, port_db, stream = _retailer_case(kind)
    with rplan.use_fusion(fusion):
        ref_eng = RefEngine.build(rq, db, var_order=bc.retailer_vo(), storage="dense")
        want = ref_prepare(ref_eng, stream)
    with tplan.use_fusion(fusion):
        port = IVMEngine.build(tq, port_db, var_order=synth.retailer_vo(),
                               storage="dense", device="cpu")
        got = prepare_stream(port, [(rel, P.port_update(u, tq.ring)) for rel, u in stream])
    assert got.mode == want.mode == "rounds"
    shared = tplan.shared_prep_ops(got.plans)
    assert shared and shared == rplan.shared_prep_ops(want.plans)
    wv = set().union(*(p.write_views for p in got.plans))
    wb = set().union(*(p.write_base for p in got.plans))
    assert wv == set().union(*(p.write_views for p in want.plans))
    assert (tplan.state_write_mask(port.state, wv, wb)
            == rplan.state_write_mask(ref_eng.state, wv, wb, set()))
    assert len(tplan.state_leaves(port.state)) == len(
        tplan.state_write_mask(port.state, wv, wb))
    memo = tplan.build_prep_memo(shared, port.views)
    for form, name in shared:  # owned views: the memo is the view's own plane
        first = next(iter(tq.ring.components))
        assert memo[(form, name)].data_ptr() == port.views[name].payload[first].data_ptr()


@pytest.mark.parametrize("strategy", ["fivm_1", "reeval"])
def test_write_mask_names_base_relations(strategy):
    db, stream = _np_case("sum", SCHEDULES["rounds"], seed=4)
    ref_eng, ref_upds = _ref("sum", db, stream, strategy)
    build, _, upds = _port("sum", db, stream, strategy)
    port = build()
    got, want = prepare_stream(port, upds), ref_prepare(ref_eng, ref_upds)
    wv = set().union(*(p.write_views for p in got.plans))
    wb = set().union(*(p.write_base for p in got.plans))
    assert wb == {"R", "S", "T"}
    mask = tplan.state_write_mask(port.state, wv, wb)
    assert mask == rplan.state_write_mask(ref_eng.state, wv, wb, set())
    assert sum(mask) == len(wv) + len(wb)
    assert tplan.shared_prep_ops(got.plans) == rplan.shared_prep_ops(want.plans) == ()


# ---------------------------------------------------------------------------
# what a run must not do
# ---------------------------------------------------------------------------
def test_replay_reads_nothing_back_and_copies_nothing_from_the_host(monkeypatch):
    db, stream = _np_case("sum", SCHEDULES["rounds_tail"], seed=6)
    build, _, upds = _port("sum", db, stream)
    eng, seq = build(), build()
    prepared = prepare_stream(eng, upds)
    ex = StreamExecutor(eng)

    def refuse(*args, **kwargs):
        raise AssertionError("a host round trip during a stream run")

    for obj, name in ((trelations, "host_payload"),
                      (trelations.DenseRelation, "payload_sync"),
                      (trelations.DenseRelation, "num_keys_sync"),
                      (torch.Tensor, "item"), (torch.Tensor, "tolist"),
                      (torch.Tensor, "cpu"), (torch, "tensor")):
        monkeypatch.setattr(obj, name, refuse)
    ex.run(prepared)
    monkeypatch.undo()
    for rel, upd in upds:
        seq.apply_update(rel, upd)
    _views_equal(eng, seq)


def test_run_leaves_database_and_engine_alone():
    db, stream = _np_case("sum", SCHEDULES["switch"], seed=7)
    build, port_db, upds = _port("sum", db, stream, "reeval")
    eng = build()
    db_before = {n: r.payload["v"].clone() for n, r in port_db.items()}
    views_before = dict(eng.views)
    values_before = {n: v.payload["v"].clone() for n, v in eng.views.items()}
    state = StreamExecutor(eng).run(upds, update_engine=False)
    assert eng.views == views_before  # the very same relation objects
    for name, v in eng.views.items():
        assert torch.equal(v.payload["v"], values_before[name]), name
    for name, r in port_db.items():
        assert torch.equal(r.payload["v"], db_before[name]), name
    assert not torch.equal(state[0][eng.tree.name].payload["v"],
                           values_before[eng.tree.name])
    # the default run copies the engine's state: the old tensors stay as
    # they were, the engine holds the result
    old = eng.views[eng.tree.name].payload["v"]
    StreamExecutor(eng).run(upds)
    assert torch.equal(old, values_before[eng.tree.name])
    assert torch.equal(eng.views[eng.tree.name].payload["v"],
                       state[0][eng.tree.name].payload["v"])


def test_update_engine_false_restores_the_engine_when_a_run_raises(monkeypatch):
    db, stream = _np_case("sum", SCHEDULES["rounds"], seed=8)
    build, _, upds = _port("sum", db, stream)
    eng = build()
    views_before, base_before = dict(eng.views), dict(eng.base)
    calls = dict(n=0)
    real = tplan.execute_trigger

    def failing(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 4:
            raise RuntimeError("boom mid-stream")
        return real(*args, **kwargs)

    monkeypatch.setattr(tplan, "execute_trigger", failing)
    values_before = {n: v.payload["v"].clone() for n, v in eng.views.items()}
    ex = StreamExecutor(eng)
    with pytest.raises(RuntimeError, match="boom"):
        ex.run(upds, update_engine=False)
    assert eng.views == views_before and eng.base == base_before
    for name, v in eng.views.items():
        assert torch.equal(v.payload["v"], values_before[name]), name
    with pytest.raises(ValueError, match="donating"):
        ex.run(upds, update_engine=False, donate_input=True)


@pytest.mark.parametrize("arg,item", [("shard", 14), ("registry", 17)])
def test_unported_executor_features_raise(arg, item):
    """Both attach, as ported since: ``shard`` (item 14; a one-rank plan
    outside any group: nothing is split, so the run equals the unsharded
    executor's, in the same program), and ``registry`` (item 17, the
    serving plane: a run publishes a generation a segment)."""
    db, stream = _np_case("sum", SCHEDULES["scan"])
    build, _, upds = _port("sum", db, stream)
    eng = build()
    if arg == "shard":
        from repro_torch.core import plan_shards

        plan = plan_shards(eng)
        assert plan.n_devices == 1 and plan.sharded_views()
        ex = StreamExecutor(eng, **{arg: plan})
        assert ex.shard is plan
        ex.run(upds)
        plain = build()
        StreamExecutor(plain).run(upds)
        for name, v in eng.views.items():
            assert torch.equal(v.payload["v"], plain.views[name].payload["v"])
        assert ex.last_run_stats["program"] == "eager"  # CPU tensors
        return
    from repro_torch.serve import SnapshotRegistry

    reg = SnapshotRegistry(segment_updates=2)
    ex = StreamExecutor(eng, registry=reg)
    assert ex.registry is reg
    ex.run(upds)
    segments = -(-len(upds) // 2)
    assert reg.generation == segments - 1 and reg.publishes == segments
    assert [s["generation"] for s in ex.last_segment_stats] == list(range(segments))
    assert reg.latest().offset == len(upds)
    for name, v in eng.views.items():
        assert torch.equal(reg.latest().views[name].payload["v"], v.payload["v"])


def test_unported_executor_paths_raise():
    """The segment loop (sparse view storage reaches it): two segments
    leave the views of one run.  (Resume is ported:
    ``tests/test_torch_recovery.py``.)"""
    db, stream = _np_case("sum", SCHEDULES["scan"])
    build, _, upds = _port("sum", db, stream)
    ex = StreamExecutor(build())
    ex._run_segmented([(upds[:2], {}), (upds[2:], {})])
    assert [s["updates"] for s in ex.last_segment_stats] == [2, len(upds) - 2]
    whole = StreamExecutor(build())
    whole.run(upds)
    for name, v in whole.engine.views.items():
        assert torch.equal(ex.engine.views[name].payload["v"], v.payload["v"]), name
    with pytest.raises(ValueError, match="empty"):
        prepare_stream(ex.engine, [])


# ---------------------------------------------------------------------------
# the card's runner, with each graph's replay standing in as a call of the
# body it captured
# ---------------------------------------------------------------------------
class _Replay:
    def __init__(self, body, state, counter):
        self.body, self.state, self.counter = body, state, counter

    def replay(self):
        self.body(self.state, self.counter)


@pytest.fixture
def graph_runner(monkeypatch):
    """Route the executor through ``_GraphProgram`` on the CPU; a capture
    records the body, the state and the counter it was given, and executes
    nothing (as a CUDA graph capture does)."""
    captures = []

    def capture(self, u, state):
        captures.append(u)
        launches = _cuda.CapturedLaunches()
        launches.close()
        return _Replay(self.bodies[u], state, self._counter), launches

    monkeypatch.setattr(tstream._GraphProgram, "_capture", capture)
    monkeypatch.setattr(tstream.StreamExecutor, "_build",
                        lambda self, p: tstream._GraphProgram(self, p))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    return captures


@pytest.mark.parametrize("mode", list(SCHEDULES))
def test_graph_runner_warms_captures_then_replays(graph_runner, mode):
    db, stream = _np_case("sum", SCHEDULES[mode], seed=9)
    build, _, upds = _port("sum", db, stream, "fivm_1")
    eng, seq = build(), build()
    prepared = prepare_stream(eng, upds)
    ex = StreamExecutor(eng)
    bodies = len(set(prepared.schedule)) if mode == "switch" else 1
    steps = prepared.n_steps

    ex.run(prepared)  # a new copy of the state: warm up, capture, replay
    st = ex.last_run_stats
    assert (st["eager_steps"], st["replays"], st["graphs"]) == (bodies, steps - bodies, bodies)
    assert len(graph_runner) == bodies
    leaves = [t.data_ptr() for t in tplan.state_leaves(eng.state)]
    for rel, upd in upds:
        seq.apply_update(rel, upd)
    _views_equal(eng, seq, "first run")

    ex.run(prepared, donate_input=True)  # the same state: replays only
    st = ex.last_run_stats
    assert (st["eager_steps"], st["replays"]) == (0, steps)
    assert len(graph_runner) == bodies
    assert [t.data_ptr() for t in tplan.state_leaves(eng.state)] == leaves
    for rel, upd in upds:
        seq.apply_update(rel, upd)
    _views_equal(eng, seq, "replayed run")

    ex.run(prepared)  # another copy: captured anew
    assert ex.last_run_stats["eager_steps"] == bodies
    assert len(graph_runner) == 2 * bodies
    ex.release()
    assert ex._compiled == {}


def test_captured_launches_count_replays():
    kernel = _cuda.KERNELS[0]
    start = kernel.launches
    launches = _cuda.CapturedLaunches()
    kernel.launches += 3  # three wrapper calls while a graph is captured
    launches.close()
    assert kernel.launches == start and launches.counts == {kernel: 3}
    for _ in range(4):
        launches.replayed()
    assert kernel.launches == start + 12
    kernel.launches = start


# ---------------------------------------------------------------------------
# linear_ids (ROADMAP Queue 3: it built its strides with torch.tensor)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(6))
def test_linear_ids_matches_reference_and_builds_no_host_tensor(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    cases = []
    for k in range(5):
        for B in (0, 1, 33):
            doms = tuple(int(d) for d in rng.integers(1, 40, size=k))
            keys = (np.stack([rng.integers(0, d, size=B) for d in doms], axis=1)
                    if k else np.zeros((B, 0))).astype(np.int32)
            cases.append((keys, doms, torch.from_numpy(keys)))

    def refuse(*args, **kwargs):
        raise AssertionError("linear_ids built a tensor from host data")

    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", refuse)
    got = [(tstorage.linear_ids(t, doms), tstorage.linear_ids(t.long(), doms))
           for _, doms, t in cases]
    monkeypatch.undo()
    for (keys, doms, _), (a, b) in zip(cases, got):
        want = np.asarray(rstorage.linear_ids(jnp.asarray(keys), doms))
        assert a.dtype == b.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), want)
        np.testing.assert_array_equal(b.numpy(), want)


# ---------------------------------------------------------------------------
# capture and the garbage collector (a dropped program's graphs)
# ---------------------------------------------------------------------------
def test_graph_capture_collects_first_and_holds_the_collector(monkeypatch):
    """``_GraphProgram._capture`` runs no collection during a capture (a
    program is a reference cycle, so a dropped one frees its CUDA graphs
    when the collector runs, and a graph destroyed mid-capture invalidates
    the capture): pending garbage is collected after it, by the collector
    it restores, not during it; the capture is thread-local (another
    thread's CUDA calls, a boundary save's writer, cannot invalidate it);
    ``StreamExecutor.release`` releases each program's graphs at once."""
    import contextlib
    import gc

    events = []

    class Cycle:
        def __init__(self):
            self.me = self

        def __del__(self):
            events.append("collected")

    @contextlib.contextmanager
    def fake_graph(graph, pool=None, capture_error_mode="global"):
        events.append(("capture", gc.isenabled(), capture_error_mode))
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: "graph")
    monkeypatch.setattr(torch.cuda, "graph", fake_graph)
    prog = object.__new__(tstream._GraphProgram)
    prog.bodies = [lambda state, counter: events.append(("body", gc.isenabled()))]
    prog._pool = prog._counter = None
    Cycle()
    assert gc.isenabled()
    graph, _ = prog._capture(0, None)
    assert graph == "graph" and gc.isenabled()
    # thread-local capture: a boundary save's writer thread runs beside it
    assert events == [("capture", False, "thread_local"), ("body", False)]
    gc.collect()
    assert events[2:] == ["collected"]

    released = []
    ex = object.__new__(tstream.StreamExecutor)
    ex._compiled = {"sig": types.SimpleNamespace(release=lambda: released.append(1))}
    ex.release()
    assert released == [1] and ex._compiled == {}
