"""The port's durable stream execution ≡ the reference's
(``tests/test_recovery.py``).

Every test of the reference's recovery suite that needs no sharding runs
here on the same numpy inputs through ``repro`` (JAX on the CPU) and
``repro_torch`` (on the CPU):

* ``Checkpointer`` hardening — async writer failures re-raise, stale
  ``*.tmp`` directories are swept, a torn or corrupt newest step falls
  back; the same committed steps and restored values as the reference;
* ``StreamCheckpointer`` — sparse capacities and zombie occupancy survive
  the round-trip, so capacity budgeting after a restore matches;
* ``StreamExecutor.resume`` — every in-process injection point recovers to
  the views of the reference's uninterrupted run, bitwise, across scan,
  rounds and switch dispatch × dense and sparse storage (the chaos sweep
  keeps the reference's hypothesis form and its 6 examples);
* a ``kill -9`` of a child process mid-segment (on the CPU), then a resume
  in the parent; the reference's mesh-elastic half (a 4-rank group killed,
  then resumed on another rank count) is ``test_torch_shard.py``'s;
* ``Supervisor`` / ``StreamSupervisor`` / ``ClusterState`` — restart
  budgets, backoff, the NaN guard, elastic mesh planning.

The reference integrity suite's escalation ladder is
``test_torch_ladder.py``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

from _torch_durable import (BOTH, PORT, REF, SCHEDULES, dense_views,  # noqa: F401
                            disarm_faults, engine, result, same, stream, torch)
from _torch_durable import array as _array
from _torch_durable import assert_views_equal
from repro_torch.core import StreamExecutor
from repro_torch.core import SparseRelation
from repro_torch.checkpoint import Checkpointer, StreamCheckpointer
from repro_torch.runtime import faults
from repro_torch.runtime import fault_tolerance as tft
from torch.utils import _pytree as pytree


def _tree(pkg, values, dtype):
    return {"a": _array(pkg, np.asarray(values), getattr(pkg, dtype))}


# ---------------------------------------------------------------------------
# Checkpointer hardening
# ---------------------------------------------------------------------------
def _writer_error(pkg, tmp):
    ck = pkg.ckpt.Checkpointer(str(tmp))
    tree = _tree(pkg, np.arange(4), "int32")
    with pkg.faults.inject("mid_checkpoint_write"):
        ck.save(tree, 1, blocking=False)
        with pytest.raises(pkg.faults.InjectedFault):
            ck.wait()
    out = [ck.all_steps()]
    # the error is consumed: the checkpointer is usable again
    ck.save(tree, 2, blocking=False)
    ck.wait()
    return out + [ck.all_steps(), ck.read_manifest(2)["leaves"]]


def test_async_writer_error_reraised_not_swallowed(tmp_path):
    """A writer-thread failure surfaces on the next wait() and nothing
    commits; then the checkpointer works again — as in the reference, down
    to the manifest's leaf fingerprints."""
    got = same({p.name: _writer_error(p, tmp_path / p.name) for p in BOTH})
    assert got[:2] == [[], [2]]


def test_async_writer_error_reraised_on_next_save(tmp_path):
    for pkg in BOTH:
        ck = pkg.ckpt.Checkpointer(str(tmp_path / pkg.name))
        tree = _tree(pkg, np.ones(3, np.float32), "float32")
        with pkg.faults.inject("mid_checkpoint_write"):
            ck.save(tree, 1, blocking=False)
            with pytest.raises(pkg.faults.InjectedFault):
                ck.save(tree, 2)  # surfaces the captured failure first


def test_stale_tmp_dirs_swept_on_init(tmp_path):
    for pkg in BOTH:
        torn = tmp_path / pkg.name / "step_00000007.tmp"
        torn.mkdir(parents=True)
        (torn / "leaf_0.npy").write_bytes(b"torn")
        pkg.ckpt.Checkpointer(str(tmp_path / pkg.name))
        assert not torn.exists()


def _corrupt_fallback(pkg, tmp):
    ck = pkg.ckpt.Checkpointer(str(tmp), keep=5)
    for step, add in ((1, 0), (2, 10), (3, 20)):
        ck.save(_tree(pkg, np.arange(3) + add, "int32"), step)
    (tmp / "step_00000003" / "manifest.json").write_text('{"step": 3,')
    os.remove(tmp / "step_00000002" / "leaf_0.npy")
    restored, step = ck.restore_latest(_tree(pkg, np.arange(3), "int32"))
    empty = pkg.ckpt.Checkpointer(str(tmp / "empty"))
    return (step, np.asarray(restored["a"]).tolist(), sorted(ck.quarantined),
            empty.restore_latest(_tree(pkg, np.arange(3), "int32")))


def test_restore_latest_falls_back_past_corrupt_steps(tmp_path):
    got = same({p.name: _corrupt_fallback(p, tmp_path / p.name) for p in BOTH})
    assert got[:2] == (1, [0, 1, 2]) and got[3] is None


def _kill_mid_write(pkg, tmp):
    ck = pkg.ckpt.Checkpointer(str(tmp))
    tree = _tree(pkg, np.arange(5, dtype=np.float32), "float32")
    ck.save(tree, 1)
    with pkg.faults.inject("mid_checkpoint_write"):
        with pytest.raises(pkg.faults.InjectedFault):
            ck.save(_tree(pkg, np.arange(5, dtype=np.float32) * 2, "float32"), 2)
    steps = ck.all_steps()
    restored, step = ck.restore_latest(tree)
    torn = (tmp / "step_00000002.tmp").exists()
    pkg.ckpt.Checkpointer(str(tmp))
    return (steps, step, np.asarray(restored["a"]).tolist(), torn,
            (tmp / "step_00000002.tmp").exists())


def test_kill_during_checkpoint_write_never_corrupts_latest(tmp_path):
    """A failure between the tmp write and the rename leaves the newest
    committed step intact; the next process sweeps the torn tmp dir."""
    got = same({p.name: _kill_mid_write(p, tmp_path / p.name) for p in BOTH})
    assert got == ([1], 1, list(range(5)), True, False)


def test_retention_deletes_a_step_by_renaming_it_first(tmp_path, monkeypatch):
    """A process killed while retention deletes an old step (here: the
    delete never happens) leaves a ``*.tmp`` directory, which is no
    committed step and which the next process sweeps — never a
    half-deleted ``step_*`` that still looks committed."""
    from repro_torch.checkpoint import checkpointer

    ck = Checkpointer(str(tmp_path), keep=2)
    monkeypatch.setattr(checkpointer.shutil, "rmtree", lambda *a, **k: None)
    for step in (1, 2, 3):
        ck.save({"a": torch.arange(3) + step}, step)
    assert ck.all_steps() == [2, 3]
    assert sorted(os.listdir(tmp_path)) == ["step_00000001.gc.tmp", "step_00000002",
                                            "step_00000003"]
    monkeypatch.undo()
    Checkpointer(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]


def test_restore_onto_shardings_is_not_ported(tmp_path):
    """Restoring onto placements (ported since): a replicated leaf comes
    back whole, a leaf split over a group as this rank's rows (rank 1 of 2
    here), from the same logical save."""
    from repro_torch.core.collectives import Placement, ShardGroup

    ck = Checkpointer(str(tmp_path))
    tree = {"a": torch.arange(4), "b": torch.arange(6).reshape(3, 2)}
    ck.save(tree, 1)
    grp = ShardGroup(None, 2, 1, "none")
    places = {"a": Placement.split("view", grp), "b": Placement.replicate()}
    got = ck.restore(tree, 1, shardings=places)
    assert torch.equal(got["a"], torch.arange(2, 4))
    assert torch.equal(got["b"], tree["b"])
    got, step = ck.restore_latest(tree, shardings=places)
    assert step == 1 and torch.equal(got["a"], torch.arange(2, 4))


def test_async_save_of_cpu_tensors_keeps_them_until_wait(tmp_path):
    """``sync_copy=False`` hands the writer the caller's tensors; the
    checkpointer holds them until the next wait(), and the committed bytes
    are theirs."""
    ck = Checkpointer(str(tmp_path))
    leaves = [torch.arange(6, dtype=torch.int32), torch.ones(2, 3)]
    ck.save_leaves(leaves, "two leaves", 4, blocking=False, sync_copy=False)
    assert ck._inflight is leaves or ck._thread is None
    ck.wait()
    assert ck._inflight is None and ck.all_steps() == [4]
    restored = ck.restore([torch.zeros(6, dtype=torch.int32), torch.zeros(2, 3)], 4)
    assert all(torch.equal(a, b) for a, b in zip(restored, leaves))
    assert ck.read_manifest(4)["treedef"] == "two leaves"


# ---------------------------------------------------------------------------
# chaos harness: deterministic engines and streams across dispatch × storage
# ---------------------------------------------------------------------------
_REF_CACHE: dict = {}


def chaos_reference(storage, sched_key):
    """Every view of the reference's uninterrupted run, densely
    (memoized per configuration)."""
    key = (storage, sched_key)
    if key not in _REF_CACHE:
        eng = engine(REF, storage=storage)
        REF.core.StreamExecutor(eng).run(stream(REF, schedule=SCHEDULES[sched_key]))
        _REF_CACHE[key] = dense_views(REF, eng)
    return _REF_CACHE[key]


def run_killed_then_resumed(pkg, tmp, storage, sched_key, point, at,
                            segment_updates=3):
    """Run checkpointed under an armed fault; simulate process death by
    dropping the engine and executor; resume on a fresh engine and
    executor sharing only the checkpoint directory.  Returns the recovered
    engine, whether the fault fired, and the committed steps with their
    meta."""
    st = stream(pkg, schedule=SCHEDULES[sched_key])
    ex = pkg.core.StreamExecutor(engine(pkg, storage=storage),
                                 checkpoint=pkg.state.StreamCheckpointer(
                                     str(tmp), segment_updates=segment_updates))
    fired = False
    try:
        with pkg.faults.inject(point, at=at):
            ex.resume(st)
    except pkg.faults.InjectedFault:
        fired = True
    # the "process" died: its writer thread ends with it, so no save of it
    # may still be running beside the restarted one
    ex.checkpoint.ckpt.discard_pending()
    del ex
    eng2 = engine(pkg, storage=storage)
    ck2 = pkg.state.StreamCheckpointer(str(tmp), segment_updates=segment_updates)
    pkg.core.StreamExecutor(eng2, checkpoint=ck2).resume(st)
    steps = [(s, ck2.ckpt.read_meta(s)) for s in ck2.ckpt.all_steps()]
    return eng2, fired, steps


#: the extended-chaos job raises this for deeper sweeps
_CHAOS_EXAMPLES = int(os.environ.get("REPRO_CHAOS_EXAMPLES", "6"))


@given(st.integers(0, 2), st.integers(0, 2), st.integers(0, 1),
       st.integers(0, 2))
@settings(max_examples=_CHAOS_EXAMPLES, deadline=None)
def test_chaos_random_injection_recovers_bit_identical(
        tmp_path_factory, point_i, at, storage_i, sched_i):
    """The chaos sweep: kill at a random injection point and occurrence,
    in a random dispatch mode × storage backend; every view of the
    recovered port engine equals the reference's uninterrupted run's,
    bitwise.  When the drawn occurrence is never reached the run simply
    completes and resume replays nothing."""
    point = ["mid_segment", "mid_admit", "post_rehash_pre_recompile"][point_i]
    storage = ["dense", "sparse"][storage_i]
    sched_key = list(SCHEDULES)[sched_i]
    tmp = tmp_path_factory.mktemp("chaos")
    eng, _, _ = run_killed_then_resumed(PORT, tmp, storage, sched_key, point, at)
    assert_views_equal(dense_views(PORT, eng), chaos_reference(storage, sched_key),
                       f"{point}@{at} {storage} {sched_key}")


def _anchor(tmp, storage, sched_key, point, at, **kw):
    """One injection in both packages: the recovered views, whether the
    fault fired, and the committed steps and their meta, each the
    reference's."""
    out = {}
    for pkg in BOTH:
        eng, fired, steps = run_killed_then_resumed(pkg, tmp / pkg.name, storage,
                                                    sched_key, point, at, **kw)
        out[pkg.name] = (fired, steps)
        if pkg is PORT:
            assert_views_equal(dense_views(PORT, eng),
                               chaos_reference(storage, sched_key), point)
    return same(out)


def test_mid_segment_kill_recovers(tmp_path):
    """Deterministic anchor for the sweep: the fault fires."""
    fired, steps = _anchor(tmp_path, "sparse", "rounds", "mid_segment", 1)
    assert fired and steps[-1][0] == 8


def test_post_rehash_pre_recompile_kill_recovers(tmp_path):
    """Death after sparse tables grew but before anything compiled or
    checkpointed against the new layout: the snapshot holds the old
    capacities, and resume re-derives the growth."""
    fired, steps = _anchor(tmp_path, "sparse", "scan", "post_rehash_pre_recompile",
                           0, segment_updates=None)
    assert fired, "stream must actually trigger a rehash"


def _boundary_write_kill(pkg, tmp):
    st = stream(pkg)
    ck = pkg.state.StreamCheckpointer(str(tmp), segment_updates=2)
    ex = pkg.core.StreamExecutor(engine(pkg, storage="dense"), checkpoint=ck)
    with pkg.faults.inject("mid_checkpoint_write", at=2) as inj:
        with pytest.raises(pkg.faults.InjectedFault):
            ex.resume(st)
    assert inj.fired
    committed = ck.ckpt.all_steps()
    eng2 = engine(pkg, storage="dense")
    pkg.core.StreamExecutor(eng2, checkpoint=pkg.state.StreamCheckpointer(
        str(tmp), segment_updates=2)).resume(st)
    return committed, dense_views(pkg, eng2)


def test_kill_during_boundary_checkpoint_write_recovers(tmp_path):
    """A kill inside the boundary save's writer surfaces through the
    executor's final wait, the latest committed snapshot is intact, and
    resume converges — the same committed steps and views as the
    reference."""
    out = {p.name: _boundary_write_kill(p, tmp_path / p.name) for p in BOTH}
    assert out["port"][0] == out["ref"][0] and out["port"][0]
    assert_views_equal(out["port"][1], out["ref"][1])


def test_resume_without_checkpointed_run_is_cold_start(tmp_path):
    """resume() on an empty directory runs from offset 0, the offset-0
    baseline snapshot first."""
    out = {}
    for pkg in BOTH:
        eng = engine(pkg, storage="dense")
        ck = pkg.state.StreamCheckpointer(str(tmp_path / pkg.name), segment_updates=4)
        pkg.core.StreamExecutor(eng, checkpoint=ck).resume(
            stream(pkg, schedule=SCHEDULES["scan"]))
        out[pkg.name] = (ck.ckpt.all_steps(), [ck.ckpt.read_meta(s)
                                               for s in ck.ckpt.all_steps()])
        if pkg is PORT:
            assert_views_equal(dense_views(PORT, eng), chaos_reference("dense", "scan"))
    steps, metas = same(out)
    assert steps == [0, 4, 8] and metas[0]["segment"] == -1


def test_resume_needs_a_checkpointer():
    ex = StreamExecutor(engine(PORT, storage="dense"))
    with pytest.raises(ValueError, match="StreamCheckpointer"):
        ex.resume(stream(PORT))


def test_checkpointed_run_requires_update_engine(tmp_path):
    ex = StreamExecutor(engine(PORT, storage="dense"),
                        checkpoint=StreamCheckpointer(str(tmp_path)))
    with pytest.raises(ValueError, match="checkpointed run"):
        ex.run(stream(PORT, schedule=SCHEDULES["scan"]), update_engine=False)
    rex = REF.core.StreamExecutor(engine(REF, storage="dense"),
                                  checkpoint=REF.state.StreamCheckpointer(
                                      str(tmp_path / "ref")))
    with pytest.raises(AssertionError, match="checkpointed run"):
        rex.run(stream(REF, schedule=SCHEDULES["scan"]), update_engine=False)


# ---------------------------------------------------------------------------
# snapshot fidelity: capacities, zombies, occupancy budgets
# ---------------------------------------------------------------------------
def _zombies(pkg, tmp):
    eng = engine(pkg, storage="sparse")
    grow = stream(pkg, seed=21, schedule=SCHEDULES["scan"])  # forces growth
    pkg.core.StreamExecutor(eng).run(grow)
    rel, upd = grow[0]
    neg = pkg.core.COOUpdate(upd.schema, upd.keys, {"v": -upd.payload["v"]})
    eng.apply_update(rel, neg)  # payloads to ring zero, slots kept
    sparse = sorted(n for n, v in eng.views.items()
                    if isinstance(v, pkg.core.SparseRelation))
    caps = {n: eng.views[n].capacity for n in sparse}
    slots = {n: eng.views[n].num_slots_used_sync() for n in sparse}
    assert any(s > 0 for s in slots.values())
    ck = pkg.state.StreamCheckpointer(str(tmp))
    ck.save_boundary(eng, offset=9, segment=0, blocking=True)
    eng2 = engine(pkg, storage="sparse")  # fresh planner-chosen capacities
    meta = ck.restore_into(eng2)
    for n in sparse:
        assert eng2.views[n].capacity == caps[n]
        assert eng2.views[n].num_slots_used_sync() == slots[n]
        np.testing.assert_array_equal(np.asarray(eng2.views[n].table),
                                      np.asarray(eng.views[n].table))
    np.testing.assert_array_equal(result(pkg, eng2), result(pkg, eng))
    rest = stream(pkg, seed=22, schedule=SCHEDULES["scan"])
    seg_a = [(len(s), g) for s, g in pkg.core.capacity_segments(eng, rest)]
    seg_b = [(len(s), g) for s, g in pkg.core.capacity_segments(eng2, rest)]
    assert seg_a == seg_b
    tables = {n: np.asarray(eng2.views[n].table).tolist() for n in sparse}
    return (meta, caps, slots, seg_b, tables, ck.ckpt.read_manifest(9)["leaves"],
            result(pkg, eng2).tolist())


def test_snapshot_preserves_sparse_layout_zombies_and_budgets(tmp_path):
    """A restore reproduces the sparse tables physically — capacity,
    zombie occupancy, the table slot for slot — so capacity segmentation
    budgets the remaining stream as the uninterrupted engine would; and
    every one of these is the reference's."""
    meta, *_ = same({p.name: _zombies(p, tmp_path / p.name) for p in BOTH})
    assert meta["offset"] == 9


def test_restored_state_is_new_tensors_in_the_owned_layout(tmp_path):
    """The port's restore installs new tensors (the executor's next run
    captures anew), a dense relation's components as slices of one plane
    and a sparse view's plane with its zero row."""
    eng = engine(PORT, storage="sparse")
    StreamExecutor(eng).run(stream(PORT))
    ck = StreamCheckpointer(str(tmp_path))
    ck.save_boundary(eng, offset=8, segment=0, blocking=True)
    before = {id(x) for x in pytree.tree_leaves(eng.state)}
    ck.restore_into(eng)
    after = pytree.tree_leaves(eng.state)
    assert not before & {id(x) for x in after}
    for v in eng.views.values():
        if isinstance(v, SparseRelation):
            assert v.plane.shape[0] == v.capacity + 1 and not v.plane[-1].any()


def _torn_fallback(pkg, tmp):
    eng = engine(pkg, storage="dense")
    ck = pkg.state.StreamCheckpointer(str(tmp))
    ck.save_boundary(eng, offset=2, segment=0, blocking=True)
    pkg.core.StreamExecutor(eng).run(stream(pkg, schedule=SCHEDULES["scan"])[:4])
    ck.save_boundary(eng, offset=4, segment=1, blocking=True)
    (tmp / "step_00000004" / "manifest.json").write_text("{")
    eng2 = engine(pkg, storage="dense")
    return ck.restore_into(eng2), result(pkg, eng2).tolist()


def test_restore_into_falls_back_past_torn_snapshot(tmp_path):
    meta, _ = same({p.name: _torn_fallback(p, tmp_path / p.name) for p in BOTH})
    assert meta["offset"] == 2


def test_split_segments_caps_boundary_spacing():
    for pkg in BOTH:
        eng = engine(pkg, storage="dense")
        segs = pkg.core.capacity_segments(eng, stream(pkg))
        assert len(segs) == 1, "dense engine never capacity-splits"
        split = pkg.core.split_segments(segs, 3)
        assert [len(s) for s, _ in split] == [3, 3, 2]
        assert pkg.core.split_segments(segs, None) is segs


# ---------------------------------------------------------------------------
# subprocess kill -9 chaos
# ---------------------------------------------------------------------------
_CHAOS_CHILD = r"""
import sys
sys.path.insert(0, sys.argv[2])
import numpy as np
import torch
from repro_torch.core import COOUpdate, DenseRelation, IVMEngine, Query, chain, sum_ring
from repro_torch.core import StreamExecutor
from repro_torch.checkpoint import StreamCheckpointer
from repro_torch.runtime import faults

torch.set_num_threads(1)
CH_DOMS = dict(A=64, B=64, C=3)
q = Query(relations={"R": ("A", "B"), "T": ("B", "C")}, free_vars=("A",),
          ring=sum_ring(), domains=CH_DOMS, lifts={"C": ("value",)})
rng = np.random.default_rng(3)
def rel(schema):
    shape = tuple(CH_DOMS[v] for v in schema)
    mult = np.zeros(shape, np.float32)
    idx = tuple(rng.integers(0, d, size=8) for d in shape)
    np.add.at(mult, idx, 1.0)
    return DenseRelation(tuple(schema), q.ring, {"v": torch.from_numpy(mult)})
db = {"R": rel("AB"), "T": rel("BC")}
srng = np.random.default_rng(11)
stream = []
for r in ["R", "T"] * 4:
    sch = q.relations[r]
    keys = np.stack([srng.integers(0, CH_DOMS[v], size=24) for v in sch],
                    axis=1).astype(np.int32)
    vals = srng.integers(-2, 3, size=24).astype(np.float32)
    stream.append((r, COOUpdate(sch, torch.from_numpy(keys),
                                {"v": torch.from_numpy(vals)})))
eng = IVMEngine.build(q, db, var_order=chain(["A", "B"], {"B": [["C"]]}),
                      storage="sparse", device="cpu")
ex = StreamExecutor(eng, checkpoint=StreamCheckpointer(sys.argv[1], segment_updates=2))
# kill -9 after the second segment boundary: no atexit, no finally — the
# torn state a preempted or OOM-killed worker leaves behind
faults.install(faults.FaultPlan("mid_segment", at=2, mode="kill9"))
ex.resume(stream)
print("UNREACHABLE: fault did not fire")
sys.exit(3)
"""


def test_subprocess_kill9_mid_segment_then_resume(tmp_path):
    """A child is SIGKILLed mid-stream; the parent resumes from the
    child's snapshots and converges to the reference's uninterrupted run,
    bitwise.  (The reference's child runs on 4 devices and the parent on
    another count: that mesh-elastic half, a 4-rank group killed and
    resumed on 1 and 2 ranks, is in ``test_torch_shard.py``.)"""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    ckdir = str(tmp_path / "ck")
    out = subprocess.run([sys.executable, "-c", _CHAOS_CHILD, ckdir, src],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == -9, (out.returncode, out.stdout[-500:],
                                  out.stderr[-2000:])
    ck = StreamCheckpointer(ckdir, segment_updates=2)
    # the baseline and the first boundary commit before the second
    # boundary's save starts; that one may have been cut by the kill
    steps = ck.ckpt.all_steps()
    assert steps[:2] == [0, 2] and set(steps) <= {0, 2, 4}, steps
    # no torn committed step: what the kill cut is a ``*.tmp`` directory
    assert not [n for n in os.listdir(ckdir) if n.startswith("step_")
                and not n.endswith(".tmp")
                and not os.path.exists(os.path.join(ckdir, n, "manifest.json"))]
    eng = engine(PORT, storage="sparse")
    StreamExecutor(eng, checkpoint=ck).resume(stream(PORT))
    assert_views_equal(dense_views(PORT, eng), chaos_reference("sparse", "rounds"))
    assert json.loads(json.dumps(ck.ckpt.read_meta(8)))["offset"] == 8


# ---------------------------------------------------------------------------
# supervision: Supervisor backoff/NaN guard, StreamSupervisor, ClusterState
# ---------------------------------------------------------------------------
def _backoff(pkg, monkeypatch):
    sleeps = []
    monkeypatch.setattr(pkg.ft.time, "sleep", sleeps.append)
    state = {"fail_at": {2, 5, 7}, "ckpt": 0}

    def step_fn(step):
        if step in state["fail_at"]:
            state["fail_at"].discard(step)
            raise RuntimeError("injected")
        return 0.5

    done, restarts, log = pkg.ft.Supervisor(max_restarts=5, backoff_s=0.1).run(
        n_steps=10, step_fn=step_fn,
        save_fn=lambda s: state.__setitem__("ckpt", s),
        restore_fn=lambda: state["ckpt"], checkpoint_every=2)
    return done, restarts, sleeps, log


def test_supervisor_backoff_sequencing(monkeypatch):
    done, restarts, sleeps, _ = same({p.name: _backoff(p, monkeypatch) for p in BOTH})
    assert done == 10 and restarts == 3
    np.testing.assert_allclose(sleeps, [0.1, 0.2, 0.4])  # exponential


def _nan_guard(pkg):
    calls = {"n": 0}

    def nan_once(step):
        calls["n"] += 1
        return float("nan") if calls["n"] == 1 else 0.1

    with pytest.raises(RuntimeError, match="restart budget"):
        pkg.ft.Supervisor(max_restarts=0, backoff_s=0.0).run(
            n_steps=3, step_fn=lambda s: float("nan"),
            save_fn=lambda s: None, restore_fn=lambda: 0)
    off = pkg.ft.Supervisor(max_restarts=0, backoff_s=0.0, nan_is_failure=False).run(
        n_steps=3, step_fn=lambda s: float("nan"), save_fn=lambda s: None,
        restore_fn=lambda: 0)[:2]
    once = pkg.ft.Supervisor(max_restarts=2, backoff_s=0.0).run(
        n_steps=3, step_fn=nan_once, save_fn=lambda s: None,
        restore_fn=lambda: 0)[:2]
    return off, once


def test_supervisor_nan_guard_toggle():
    assert same({p.name: _nan_guard(p) for p in BOTH}) == ((3, 0), (3, 1))


def _mesh(pkg):
    cs = pkg.ft.ClusterState(heartbeat_timeout_s=10.0)
    for i in range(16):
        cs.heartbeat(f"h{i}", n_chips=4, now=100.0)
    out = [cs.plan_mesh(model_parallel=4, now=101.0)]
    for i in range(10):
        cs.heartbeat(f"h{i}", n_chips=4, now=50.0)  # stale -> lost
    out.append(cs.plan_mesh(model_parallel=4, now=101.0))
    for i in range(10):
        cs.heartbeat(f"h{i}", n_chips=4, now=102.0)  # nodes return
    out.append(cs.plan_mesh(model_parallel=4, now=103.0))
    with pytest.raises(RuntimeError, match="healthy chips"):
        pkg.ft.ClusterState().plan_mesh(model_parallel=4, now=0.0)
    return out


def test_cluster_mesh_shrink_and_regrow():
    assert same({p.name: _mesh(p) for p in BOTH}) == [(16, 4), (4, 4), (16, 4)]


def test_stream_supervisor_restarts_through_injected_fault(tmp_path):
    """One injected mid-admit death, one restart, every view the
    reference's uninterrupted run's."""
    eng = engine(PORT, storage="dense")
    ex = StreamExecutor(eng, checkpoint=StreamCheckpointer(str(tmp_path),
                                                           segment_updates=2))
    faults.install(faults.FaultPlan("mid_admit", at=2))
    try:
        _, restarts, log = tft.StreamSupervisor(backoff_s=0.0).run(ex, stream(PORT))
    finally:
        faults.clear()
    assert restarts == 1 and any("failure" in e for e in log)
    assert log[0]["action"] == "restart"
    assert_views_equal(dense_views(PORT, eng), chaos_reference("dense", "rounds"))


def test_stream_supervisor_budget_exhaustion(tmp_path):
    eng = engine(PORT, storage="dense")

    class AlwaysDies:
        engine = eng

        def resume(self, stream):
            raise RuntimeError("permanently broken")

    with pytest.raises(RuntimeError, match="restart budget"):
        tft.StreamSupervisor(max_restarts=2, backoff_s=0.0).run(
            AlwaysDies(), stream(PORT))


def _nonfinite(pkg, tmp):
    st = stream(pkg, schedule=SCHEDULES["scan"])
    rel, upd = st[3]
    st[3] = (rel, pkg.core.COOUpdate(upd.schema, upd.keys, {"v": _array(
        pkg, np.full(upd.batch, np.inf, np.float32), pkg.float32)}))
    ex = pkg.core.StreamExecutor(engine(pkg, storage="dense"),
                                 checkpoint=pkg.state.StreamCheckpointer(
                                     str(tmp / "a"), segment_updates=4))
    with pytest.raises(RuntimeError, match="restart budget") as ei:
        pkg.ft.StreamSupervisor(max_restarts=1, backoff_s=0.0).run(ex, st)
    assert isinstance(ei.value.__cause__, FloatingPointError)
    ex2 = pkg.core.StreamExecutor(engine(pkg, storage="dense"),
                                  checkpoint=pkg.state.StreamCheckpointer(
                                      str(tmp / "b"), segment_updates=4))
    _, restarts, log = pkg.ft.StreamSupervisor(backoff_s=0.0,
                                               nan_is_failure=False).run(ex2, st)
    why = str(ei.value.__cause__)
    assert why.startswith("non-finite payload in view")
    return restarts, [e.get("action") for e in log if "action" in e]


def test_stream_supervisor_nonfinite_guard(tmp_path):
    """A float ring poisoned with inf fails the supervised run (every
    restart replays the same poison); with the guard off it completes.
    (The view the guard names first may differ: the packages keep their
    views in dicts of different order.)"""
    restarts, actions = same({p.name: _nonfinite(p, tmp_path / p.name) for p in BOTH})
    assert restarts == 0 and actions == []


def test_check_finite_reads_the_host_once_a_view(monkeypatch):
    """``_check_finite`` reduces each view's float leaves on its device
    and reads one flag a view."""
    eng = engine(PORT, storage="sparse")
    reads = []
    real = torch.Tensor.__bool__
    monkeypatch.setattr(torch.Tensor, "__bool__",
                        lambda self: reads.append(1) or real(self))
    tft.StreamSupervisor._check_finite(eng)
    assert len(reads) == len(eng.views)
