"""The port's audited Reevaluate and graceful degradation ≡ the
reference's (``tests/test_integrity.py``, pillars 3 and 4; admission and
snapshots are ``test_torch_integrity.py``, the ``StreamSupervisor``
escalation ladder ``test_torch_ladder.py``).

The same numpy inputs go through ``repro`` (JAX on the CPU) and
``repro_torch`` (on the CPU); the port is held to the reference's
``audit_log`` and ``degrade_log`` entries (wall times aside), repaired
sparse tables slot for slot, and the final views, bitwise (integer-valued float32 payloads).  Beside them, the
port's own: an in-place audit repair keeps the live tensors (the
executor's CUDA graphs are bound to them), and a sparse repair that must
grow replaces them.
"""
import dataclasses

import numpy as np
import pytest

from _torch_durable import (BOTH, PORT, REF, disarm_faults,  # noqa: F401
                            jnp, torch)
from _torch_durable import audit_entries as _audit_entries
from _torch_durable import engine as _engine
from _torch_durable import result as _result
from _torch_durable import same as _same
from _torch_durable import stream as _stream
from _torch_durable import update as _update
from repro_torch import core as T
from repro_torch.runtime import integrity as tint
from torch.utils import _pytree as pytree

SEG_DOMS = dict(A=97, B=89, C=5)


# ---------------------------------------------------------------------------
# pillar 3: audited Reevaluate
# ---------------------------------------------------------------------------
def _perturb_root(pkg, engine, delta):
    """Divergence in the live root view's first payload slot (the port:
    in place, as a drifted replay would leave it)."""
    root = engine.tree.name
    v = engine.views[root]
    if pkg is PORT:
        v.payload["v"][0] += delta
        return
    pay = dict(v.payload)
    lead = jnp.arange(pay["v"].shape[0]) == 0
    pay["v"] = pay["v"] + jnp.asarray(delta, pay["v"].dtype) * \
        lead.reshape((-1,) + (1,) * (pay["v"].ndim - 1))
    engine.views[root] = dataclasses.replace(v, payload=pay)


def _clean_audit(pkg):
    cfg = pkg.integ.IntegrityConfig(policy="quarantine", audit_interval=2,
                                    segment_updates=2)
    eng = _engine(pkg, store_base=True)
    ex = pkg.core.StreamExecutor(eng, integrity=cfg)
    ex.run(_stream(pkg))
    assert all(s["audit_s"] >= 0 for s in ex.last_segment_stats)
    return _audit_entries(cfg), _result(pkg, eng).tolist()


def test_audit_clean_run_is_exact_and_cheap():
    entries, _ = _same({p.name: _clean_audit(p) for p in BOTH})
    assert len(entries) == 2
    assert all(e["exact"] and not e["repaired"] for e in entries)


def _drift_repair(pkg):
    st = _stream(pkg)
    cfg = pkg.integ.IntegrityConfig(policy="quarantine", audit_interval=1,
                                    segment_updates=2)
    eng = _engine(pkg, store_base=True)
    ex = pkg.core.StreamExecutor(eng, integrity=cfg)
    ex.run(st[:4])
    _perturb_root(pkg, eng, 7.0)
    ex.run(st[4:])
    if pkg is PORT:
        ref = _engine(pkg)
        pkg.core.StreamExecutor(ref).run(_stream(pkg))
        np.testing.assert_array_equal(_result(pkg, eng), _result(pkg, ref))
    return _audit_entries(cfg), _result(pkg, eng).tolist()


def test_audit_detects_and_repairs_float_drift():
    """Drift injected between run halves is caught at the next audit and
    repaired from base: the same audit log as the reference, and the
    oracle result despite the corruption."""
    entries, _ = _same({p.name: _drift_repair(p) for p in BOTH})
    repaired = [e for e in entries if e["repaired"]]
    assert len(repaired) == 1 and repaired[0]["max_abs_err"] == pytest.approx(7.0)
    assert entries[-1]["exact"]


def _repair_capacity(pkg):
    eng = _engine(pkg, store_base=True)
    pkg.core.StreamExecutor(eng).run(_stream(pkg, n=4))
    root = eng.tree.name
    cap = eng.views[root].capacity
    _perturb_root(pkg, eng, 5.0)
    records = pkg.integ.audit_engine(eng, pkg.integ.IntegrityConfig(audit_interval=1),
                                     segment=0)
    view = eng.views[root]
    assert records[0].repaired
    assert isinstance(view, pkg.core.SparseRelation) and view.capacity == cap
    table = np.asarray(view.table) if pkg is REF else view.table.numpy()
    return cap, table.tolist(), _result(pkg, eng).tolist()


def test_audit_repair_preserves_sparse_capacity():
    """The repair keeps the live capacity, and the repaired table is the
    reference's slot for slot."""
    _same({p.name: _repair_capacity(p) for p in BOTH})


def test_audit_repair_in_place_keeps_the_live_tensors():
    """Where the repaired view keeps its layout — a dense view always, a
    sparse view at the live capacity — the repair writes into the live
    tensors (the executor's graphs are bound to them)."""
    for storage in ("dense", "sparse"):
        eng = _engine(PORT, store_base=True, storage=storage)
        T.StreamExecutor(eng).run(_stream(PORT, n=4))
        root = eng.tree.name
        view = eng.views[root]
        leaves = pytree.tree_leaves(view)
        ptrs = [x.data_ptr() for x in leaves]
        _perturb_root(PORT, eng, 5.0)
        cfg = tint.IntegrityConfig(audit_interval=1)
        (rec,) = tint.audit_engine(eng, cfg, segment=0)
        assert rec.repaired and cfg.audit_log[-1]["route"] == "in_place"
        assert eng.views[root] is view
        assert [x.data_ptr() for x in leaves] == ptrs
        assert tint.audit_engine(eng, cfg, segment=1)[0].exact


def test_sparse_repair_that_must_grow_replaces_the_table():
    """A sparse view whose recomputed keys exceed the live table's load
    factor gets a larger table (new tensors), the reference's capacity."""
    outcomes = {}
    for pkg in BOTH:
        eng = _engine(pkg, store_base=True)
        pkg.core.StreamExecutor(eng).run(_stream(pkg, n=4))
        root = eng.tree.name
        live = eng.views[root]
        small = pkg.storage.SparseRelation.zeros(
            live.schema, live.ring, live.domains, capacity=2,
            **({} if pkg is REF else {"device": "cpu"}))
        eng.views[root] = small
        rec = pkg.integ.audit_engine(eng, pkg.integ.IntegrityConfig(audit_interval=1),
                                     segment=0)[0]
        assert rec.repaired
        outcomes[pkg.name] = eng.views[root].capacity
        if pkg is PORT:
            assert eng.views[root] is not small
    assert _same(outcomes) > 2


def _integer_divergence(pkg):
    eng = _engine(pkg, kind="count", store_base=True)
    pkg.core.StreamExecutor(eng).run(_stream(pkg, kind="count", n=4))
    root = eng.tree.name
    v = eng.views[root]
    if pkg is PORT:
        v.payload["v"][0] += 1
    else:
        pay = dict(v.payload)
        pay["v"] = pay["v"].at[0].add(1)
        eng.views[root] = dataclasses.replace(v, payload=pay)
    cfg = pkg.integ.IntegrityConfig(audit_interval=1)
    with pytest.raises(pkg.integ.StreamIntegrityError, match="integer-ring"):
        pkg.integ.audit_engine(eng, cfg, segment=0)
    return _audit_entries(cfg)


def test_audit_integer_ring_divergence_raises():
    entries = _same({p.name: _integer_divergence(p) for p in BOTH})
    assert entries and not entries[-1]["exact"]


def test_audit_without_stored_base_raises():
    for pkg in BOTH:
        with pytest.raises(pkg.integ.StreamIntegrityError, match="store_base"):
            pkg.integ.audit_engine(_engine(pkg), pkg.integ.IntegrityConfig(
                audit_interval=1))


def _nan_divergence(pkg):
    eng = _engine(pkg, store_base=True)
    pkg.core.StreamExecutor(eng).run(_stream(pkg, n=2))
    _perturb_root(pkg, eng, np.nan)
    records = pkg.integ.audit_engine(eng, pkg.integ.IntegrityConfig(audit_interval=1),
                                     segment=0)
    assert not np.isnan(_result(pkg, eng)).any()
    return records[0].repaired, records[0].max_abs_err, _result(pkg, eng).tolist()


def test_nan_counts_as_infinite_divergence():
    repaired, err, _ = _same({p.name: _nan_divergence(p) for p in BOTH})
    assert repaired and err == np.inf


# ---------------------------------------------------------------------------
# pillar 4: graceful degradation
# ---------------------------------------------------------------------------
def _seg_upd(pkg, rel, B, seed):
    rng = np.random.default_rng(seed)
    sch = ("A", "B") if rel == "R" else ("B", "C")
    keys = np.stack([rng.integers(0, SEG_DOMS[v], size=B) for v in sch],
                    axis=1).astype(np.int32)
    return (rel, _update(pkg, sch, keys, np.ones(B, np.float32),
                         jnp.float32 if pkg is REF else torch.float32))


def _degrade_entries(cfg):
    return [{k: v for k, v in e.items() if k not in ("wall_s", "error")}
            for e in cfg.degrade_log]


def _emergency(pkg):
    flood = [_seg_upd(pkg, "R", 32, 300 + i) for i in range(12)]
    cfg = pkg.integ.IntegrityConfig(policy="quarantine")
    eng = _engine(pkg, doms=SEG_DOMS, seed=2)
    ex = pkg.core.StreamExecutor(eng, integrity=cfg)
    ex._run_segmented([(flood, {})])  # deliberately unbudgeted plan
    if pkg is PORT:
        seq = _engine(pkg, doms=SEG_DOMS, seed=2)
        for rel, upd in flood:
            seq.apply_update(rel, upd)
        np.testing.assert_array_equal(_result(pkg, eng), _result(pkg, seq))
    return (_degrade_entries(cfg), [s["segment"] for s in ex.last_segment_stats],
            _result(pkg, eng).tolist())


def test_emergency_resegmentation_on_admission_pressure():
    """An under-budgeted segment is split and rehashed at admission, its
    remainder spliced into the queue — the same decisions (kind, split,
    growth, occupancy) as the reference, the same result as the eager
    engine."""
    entries, segs, _ = _same({p.name: _emergency(p) for p in BOTH})
    assert "emergency_resegment" in [e["kind"] for e in entries]
    assert entries[0]["occupancy"] and len(segs) > 1


def _spill(pkg):
    cfg = pkg.integ.IntegrityConfig(policy="quarantine")
    eng = _engine(pkg, doms=SEG_DOMS, seed=6)
    ex = pkg.core.StreamExecutor(eng, integrity=cfg)
    fill = [_seg_upd(pkg, "R", 24, 600)]
    state = ex.run(fill, update_engine=False)
    top_up = [_seg_upd(pkg, "R", 16, 601)]
    out = ex.run(top_up, state=state)
    root = eng.tree.name
    seq = _engine(pkg, doms=SEG_DOMS, seed=6)
    for rel, upd in fill + top_up:
        seq.apply_update(rel, upd)
    got = np.asarray(pkg.storage.as_dense(out[0][root]).payload["v"])
    want = np.asarray(pkg.storage.as_dense(seq.views[root]).payload["v"])
    np.testing.assert_array_equal(got, want)
    return [e["kind"] for e in cfg.degrade_log], got.tolist()


def test_explicit_state_capacity_error_spills_to_eager():
    kinds, _ = _same({p.name: _spill(p) for p in BOTH})
    assert kinds == ["eager_spill"]


def test_capacity_degrade_off_still_raises():
    for pkg in BOTH:
        cfg = pkg.integ.IntegrityConfig(policy="quarantine", capacity_degrade=False)
        ex = pkg.core.StreamExecutor(_engine(pkg, doms=SEG_DOMS, seed=6),
                                     integrity=cfg)
        state = ex.run([_seg_upd(pkg, "R", 24, 600)], update_engine=False)
        with pytest.raises(pkg.stream.StreamCapacityError):
            ex.run([_seg_upd(pkg, "R", 16, 601)], state=state)
