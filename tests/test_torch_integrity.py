"""The port's integrity layer ≡ the reference's (``tests/test_integrity.py``).

Every test of the reference's integrity suite runs here on the same numpy
inputs through ``repro`` (JAX on the CPU) and ``repro_torch`` (on the CPU),
and holds the port to what the reference produces wherever both produce an
outcome:

* reason bits and sanitized batches (bitwise);
* dead-letter records, ``audit_log`` and ``degrade_log`` entries (wall
  times aside) and the escalation log's actions;
* committed step lists, snapshot ``meta`` and manifest ``leaves`` (shapes,
  dtypes, CRC32s);
* final views, bitwise: payloads are integer-valued float32, so every
  accumulation order is exact.

This file holds validated admission, quarantine and checksummed
snapshots (the reference's pillars 1 and 2) and the straggler monitor;
``test_torch_integrity_audit.py`` the audited Reevaluate and graceful
degradation, ``test_torch_ladder.py`` the supervisor's escalation ladder.
Beside them, the port's own: validation builds no tensor from host data,
and every snapshot's manifest ``leaves`` are the reference's.
"""
import os

import numpy as np
import pytest

from _torch_durable import (BOTH, PORT, REF, disarm_faults,  # noqa: F401
                            jax, jnp, torch)
from _torch_durable import array as _array
from _torch_durable import engine as _engine
from _torch_durable import letters as _letters
from _torch_durable import result as _result
from _torch_durable import ring as _ring
from _torch_durable import same as _same
from _torch_durable import stream as _stream
from _torch_durable import update as _update
from _torch_durable import query as _query
from repro import core as R
from repro.runtime import integrity as rint
from repro_torch import core as T
from repro_torch.runtime import fault_tolerance as tft
from repro_torch.runtime import integrity as tint



#: (stream index, row, mutation) — NaN payload and out-of-domain key
POISONS = {(2, 5): "nan", (5, 7): "key"}
CLEAN = {k: "zero" for k in POISONS}


# ---------------------------------------------------------------------------
# pillar 1: validated admission
# ---------------------------------------------------------------------------
def _bits(pkg, keys, pay, doms):
    if pkg is REF:
        return np.asarray(rint.validate_rows(jnp.asarray(keys), (jnp.asarray(pay),),
                                             doms))
    return tint.validate_rows(torch.from_numpy(keys), (torch.from_numpy(pay),),
                              doms).numpy()


def test_validate_rows_reason_bits():
    keys = np.asarray([[1, 2], [70, 2], [1, 2], [-1, 80]], np.int32)
    pay = np.asarray([1.0, 2.0, np.nan, np.inf], np.float32)
    got = _same({p.name: _bits(p, keys, pay, (64, 64)) for p in BOTH})
    np.testing.assert_array_equal(got, [0, 2, 1, 3])
    assert got.dtype == np.int32


def test_validate_rows_builds_no_host_tensor(monkeypatch):
    """The reference's validator traces under an outer jit; the port's is
    plain torch that builds no tensor from host data (a graph-capturable
    admission), with the same bits."""
    pay = np.asarray([0.0, np.nan, 1.0, 2.0], np.float32)
    want = np.asarray(jax.jit(lambda k, p: rint.validate_rows(k, (p,), (64, 64)))(
        jnp.zeros((4, 2), jnp.int32), jnp.asarray(pay)))
    keys, payload = torch.zeros((4, 2), dtype=torch.int32), torch.from_numpy(pay)

    def refuse(*a, **k):
        raise AssertionError("validation built a tensor from host data")

    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", refuse)
    got = tint.validate_rows(keys, (payload,), (64, 64))
    bits, keys_s, pay_s = tint._validate_sanitize(keys, {"v": payload}, (64, 64))
    monkeypatch.undo()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(bits.numpy(), [0, 1, 0, 0])
    assert pay_s["v"].tolist() == [0.0, 0.0, 1.0, 2.0]


def test_validate_rows_integer_payloads_vacuously_finite():
    keys = np.zeros((3, 2), np.int32)
    pay = np.asarray([1, -2, 3], np.int32)
    got = _same({p.name: _bits(p, keys, pay, (8, 8)) for p in BOTH})
    assert not got.any()


def test_sanitized_rows_are_bit_transparent():
    """A masked row (key 0 + ring zero) is a no-op to the maintenance
    program; the port masks the same rows to the same bits."""
    outcomes = {}
    for pkg in BOTH:
        ring = _ring(pkg)
        upd = _stream(pkg)[0][1]
        bits = _array(pkg, np.asarray([0, 1] + [0] * (upd.batch - 2), np.int32),
                      jnp.int32 if pkg is REF else torch.int32)
        masked = pkg.integ.sanitize_batch(upd, bits, ring)
        keys = np.asarray(masked.keys) if pkg is REF else masked.keys.numpy()
        vals = (np.asarray(masked.payload["v"]) if pkg is REF
                else masked.payload["v"].numpy())
        if pkg is PORT:  # the reference's own suite runs its engines
            eng, ref = _engine(pkg), _engine(pkg)
            eng.apply_update("R", masked)
            ref.apply_update("R", _stream(pkg, rows={(0, 1): "zero"})[0][1])
            np.testing.assert_array_equal(_result(pkg, eng), _result(pkg, ref))
        outcomes[pkg.name] = np.concatenate([keys.ravel(), vals.ravel()])
    got = _same(outcomes)
    assert got[2:4].tolist() == [0, 0]


def _quarantine_run(pkg):
    cfg = pkg.integ.IntegrityConfig(policy="quarantine", segment_updates=2)
    eng = _engine(pkg)
    pkg.core.StreamExecutor(eng, integrity=cfg).run(_stream(pkg, rows=POISONS))
    if pkg is PORT:  # the reference's own suite holds it to its clean run
        ref = _engine(pkg)
        pkg.core.StreamExecutor(ref).run(_stream(pkg, rows=CLEAN))
        np.testing.assert_array_equal(_result(pkg, eng), _result(pkg, ref))
    return _letters(cfg.dead_letters), cfg.dead_letters.counts(), _result(pkg, eng)


def test_poison_update_chaos_quarantine_end_to_end():
    """NaN payloads + out-of-domain keys complete under quarantine with
    the final views bitwise the clean stream's, and the same dead letters
    (rel, stream index, row, key, reasons) as the reference."""
    out = {p.name: _quarantine_run(p) for p in BOTH}
    np.testing.assert_array_equal(out["port"][2], out["ref"][2])
    letters, counts = _same({k: v[:2] for k, v in out.items()})
    assert counts == {tint.REASON_NONFINITE: 1, tint.REASON_KEY_DOMAIN: 1}
    assert [(at, row) for _, at, row, _, _ in letters] == sorted(POISONS)
    assert all(len(key) == 2 for *_, key, _ in letters)


def _strict_run(pkg, tmp):
    cfg = pkg.integ.IntegrityConfig(policy="strict", segment_updates=2)
    ck = pkg.state.StreamCheckpointer(str(tmp), segment_updates=2)
    ex = pkg.core.StreamExecutor(_engine(pkg), checkpoint=ck, integrity=cfg)
    with pytest.raises(pkg.integ.StreamIntegrityError) as ei:
        ex.run(_stream(pkg, rows=POISONS), update_engine=True)
    ck.ckpt.discard_pending()  # a boundary save may still be in flight
    return _letters(ei.value.records), ck.ckpt.all_steps(), str(ei.value)


def test_poison_update_strict_fails_before_poisoned_snapshot(tmp_path):
    """Under strict the same stream fails at admission: every committed
    snapshot predates the first poisoned update, as in the reference."""
    letters, steps, msg = _same({p.name: _strict_run(p, tmp_path / p.name)
                                 for p in BOTH})
    assert letters[0][-1] == (tint.REASON_NONFINITE,)
    assert "update 2" in msg
    assert all(s <= min(at for at, _ in POISONS) for s in steps)


def _schema_run(pkg):
    st = _stream(pkg, n=4)
    zero_keys = np.zeros((4, 2), np.int32)
    bad = _update(pkg, ("A", "C"), zero_keys, np.ones(4, np.float32),
                  jnp.float32 if pkg is REF else torch.float32)
    cfg = pkg.integ.IntegrityConfig(policy="quarantine", segment_updates=2)
    eng = _engine(pkg)
    pkg.core.StreamExecutor(eng, integrity=cfg).run(st + [("R", bad)])
    if pkg is PORT:
        ref = _engine(pkg)
        pkg.core.StreamExecutor(ref).run(st)
        np.testing.assert_array_equal(_result(pkg, eng), _result(pkg, ref))
    bad_dtype = _update(pkg, ("A", "B"), zero_keys, np.ones(4, np.int32),
                        jnp.int32 if pkg is REF else torch.int32)
    with pytest.raises(pkg.integ.StreamIntegrityError,
                       match=pkg.integ.REASON_DTYPE) as ei:
        pkg.core.StreamExecutor(_engine(pkg), integrity=pkg.integ.IntegrityConfig(
            policy="strict")).run([("R", bad_dtype)])
    return _letters(cfg.dead_letters), _letters(ei.value.records), _result(pkg, eng)


def test_schema_mismatch_quarantines_whole_batch():
    """A wrong schema is replaced by an all-padding batch and
    dead-lettered with row == -1; a wrong payload dtype is REASON_DTYPE,
    and strict raises on it — the same records in both packages."""
    out = {p.name: _schema_run(p) for p in BOTH}
    np.testing.assert_array_equal(out["port"][2], out["ref"][2])
    quarantined, strict = _same({k: v[:2] for k, v in out.items()})
    (rec,) = quarantined
    assert rec[2] == -1 and tint.REASON_SCHEMA in rec[4]
    assert strict[0][4] == (tint.REASON_DTYPE,)


def test_wrong_key_dtype_is_a_whole_batch_dtype_error():
    """The port's own whole-batch case: float keys (the port's keys must
    be an integer dtype, as the reference's)."""
    q = _query(PORT, T.sum_ring())
    bad = T.COOUpdate(("A", "B"), torch.zeros((4, 2)), {"v": torch.ones(4)})
    assert tint.batch_schema_errors(q, "R", bad) == (tint.REASON_DTYPE,)
    ok = T.COOUpdate(("A", "B"), torch.zeros((4, 2), dtype=torch.int64),
                     {"v": torch.ones(4)})
    assert tint.batch_schema_errors(q, "R", ok) == ()
    refq = _query(REF, R.sum_ring())
    assert rint.batch_schema_errors(refq, "R", R.COOUpdate(
        ("A", "B"), jnp.zeros((4, 2)), {"v": jnp.ones(4)})) == (rint.REASON_DTYPE,)


def test_dead_letter_log_is_bounded():
    for pkg in BOTH:
        log = pkg.integ.DeadLetterLog(max_records=2)
        for i in range(5):
            log.append(pkg.integ.DeadLetter("R", i, 0, (0, 0),
                                            (pkg.integ.REASON_NONFINITE,)))
        assert len(log.records) == 2 and log.dropped == 3 and len(log) == 5


def _permissive(pkg):
    cfg = pkg.integ.IntegrityConfig(policy="permissive", segment_updates=2)
    eng = _engine(pkg)
    pkg.core.StreamExecutor(eng, integrity=cfg).run(
        _stream(pkg, rows={(2, 5): "nan", (5, 7): "inf"}))
    assert len(cfg.dead_letters) == 0
    return _result(pkg, eng)


def test_permissive_policy_bypasses_validation():
    """Unvalidated non-finite payloads go through to the views as in the
    reference.  (An out-of-domain key is no input of an unvalidated run in
    the port: its gathers index out of bounds and raise on the CPU, where
    JAX clamps — ROADMAP Queue 3, kept on purpose.)"""
    got = _same({p.name: _permissive(p) for p in BOTH})
    assert np.isnan(got).any()  # the poison went through


# ---------------------------------------------------------------------------
# pillar 2: checksummed snapshots
# ---------------------------------------------------------------------------
def _bitflip_run(pkg, tmp):
    ck = pkg.ckpt.Checkpointer(str(tmp))
    tree = {"a": _array(pkg, np.arange(8, dtype=np.float32),
                        jnp.float32 if pkg is REF else torch.float32)}
    with pkg.faults.inject("snapshot_committed", mode="bitflip") as inj:
        ck.save(tree, 1)
    assert inj.fired and inj.fired[0][2]["step"] == 1
    with pytest.raises(pkg.ckpt.ChecksumError):
        ck.restore(tree, 1)
    lax = pkg.ckpt.Checkpointer(str(tmp), verify_checksums=False)
    restored = np.asarray(lax.restore(tree, 1)["a"])
    assert not np.array_equal(restored, np.arange(8, dtype=np.float32))
    return restored, ck.read_manifest(1)["leaves"]


def test_bitflip_detected_by_checksum(tmp_path):
    """A flipped bit fails restore with ChecksumError; with verification
    off the corruption loads silently.  Both packages flip the same bit of
    the same bytes and fingerprint them alike."""
    out = {p.name: _bitflip_run(p, tmp_path / p.name) for p in BOTH}
    np.testing.assert_array_equal(out["port"][0], out["ref"][0])
    assert out["port"][1] == out["ref"][1]


def _resume_past_bitflip(pkg, tmp):
    eng = _engine(pkg)
    ck = pkg.state.StreamCheckpointer(str(tmp), segment_updates=2)
    with pkg.faults.inject("snapshot_committed", at=2, mode="bitflip"):
        pkg.core.StreamExecutor(eng, checkpoint=ck).run(_stream(pkg, n=6),
                                                        update_engine=True)
        ck.wait()
    steps = ck.ckpt.all_steps()
    metas = [ck.ckpt.read_meta(s) for s in steps]
    eng2 = _engine(pkg)
    ck2 = pkg.state.StreamCheckpointer(str(tmp), segment_updates=2)
    pkg.core.StreamExecutor(eng2, checkpoint=ck2).resume(_stream(pkg, n=6))
    assert (tmp / "corrupt_step_00000006").exists()
    if pkg is PORT:
        ref = _engine(pkg)
        pkg.core.StreamExecutor(ref).run(_stream(pkg, n=6))
        np.testing.assert_array_equal(_result(pkg, eng2), _result(pkg, ref))
    return steps, metas, ck2.ckpt.quarantined, _result(pkg, eng2).tolist()


def test_resume_falls_back_past_bitflipped_snapshot(tmp_path):
    steps, metas, quarantined, _ = _same({p.name: _resume_past_bitflip(
        p, tmp_path / p.name) for p in BOTH})
    assert steps == [2, 4, 6] and quarantined == [6]
    assert [m["offset"] for m in metas] == steps


def _retention_run(pkg, tmp):
    ck = pkg.ckpt.Checkpointer(str(tmp), keep=3)
    base = np.arange(4, dtype=np.float32)
    dtype = jnp.float32 if pkg is REF else torch.float32
    for s in range(1, 5):
        ck.save({"a": _array(pkg, base + s, dtype)}, s)
    assert ck.all_steps() == [2, 3, 4]
    (tmp / "step_00000004" / "manifest.json").write_text('{"step":')
    pkg.faults._flip_bit(str(tmp / "step_00000003" / "leaf_0.npy"))
    tree = {"a": _array(pkg, base, dtype)}
    restored, step = ck.restore_latest(tree)
    out = [step, sorted(ck.quarantined), ck.all_steps(),
           np.asarray(restored["a"]).tolist()]
    ck.save(tree, 5)
    ck.save(tree, 6)
    out.append(ck.all_steps())
    pkg.ckpt.Checkpointer(str(tmp))
    assert not any(n.startswith("corrupt_step_") for n in os.listdir(tmp))
    return out


def test_quarantined_steps_leave_retention_to_restorable(tmp_path):
    """keep=3 retains 3 *restorable* snapshots; a restarted process
    sweeps the corpses — step for step as the reference."""
    got = _same({p.name: _retention_run(p, tmp_path / p.name) for p in BOTH})
    assert got[:3] == [2, [3, 4], [2]] and got[4] == [2, 5, 6]


def _torn_manifest(pkg, tmp):
    eng = _engine(pkg)
    ck = pkg.state.StreamCheckpointer(str(tmp), segment_updates=2)
    pkg.core.StreamExecutor(eng, checkpoint=ck).run(_stream(pkg, n=4),
                                                    update_engine=True)
    ck.wait()
    steps = ck.ckpt.all_steps()
    (tmp / "step_00000004" / "manifest.json").write_text('{"step":')
    ck2 = pkg.state.StreamCheckpointer(str(tmp), segment_updates=2)
    meta = ck2.restore_into(_engine(pkg))
    return steps, meta, ck2.ckpt.quarantined


def test_torn_manifest_quarantined_by_stream_restore(tmp_path):
    steps, meta, quarantined = _same({p.name: _torn_manifest(p, tmp_path / p.name)
                                      for p in BOTH})
    assert steps == [2, 4] and int(meta["offset"]) == 2 and quarantined == [4]


def _manifest_leaves(pkg, tmp, storage):
    eng = _engine(pkg, storage=storage)
    ck = pkg.state.StreamCheckpointer(str(tmp), segment_updates=3)
    pkg.core.StreamExecutor(eng, checkpoint=ck).run(_stream(pkg), update_engine=True)
    ck.wait()
    return [(s, ck.ckpt.read_meta(s), ck.ckpt.read_manifest(s)["leaves"])
            for s in ck.ckpt.all_steps()]


@pytest.mark.parametrize("storage", ["dense", "sparse"])
def test_manifest_leaves_match_the_reference(tmp_path, storage):
    """One state, one manifest: every committed step's meta and every
    leaf's shape, dtype and CRC32 of its host bytes are the reference's
    (the views, the sparse tables slot for slot, the base relations)."""
    got = _same({p.name: _manifest_leaves(p, tmp_path / p.name, storage)
                 for p in BOTH})
    assert got[-1][0] == 8 and len(got) == 3
    assert {leaf["dtype"] for _, _, leaves in got for leaf in leaves} <= {
        "float32", "int32"}


# ---------------------------------------------------------------------------
# the straggler monitor fed from the segment loop
# ---------------------------------------------------------------------------
def test_straggler_monitor_fed_from_segment_stats():
    mon = tft.StragglerMonitor(factor=3.0)
    ex = T.StreamExecutor(_engine(PORT), integrity=tint.IntegrityConfig(
        segment_updates=2), stragglers=mon)
    ex.run(_stream(PORT))
    stats = ex.last_segment_stats
    assert len(stats) == 4
    assert all("straggler" in s and "straggler_baseline" in s for s in stats)
    assert {"save_s", "audit_s", "admit_s", "dispatch_s"} <= set(stats[0])
    assert mon.baseline is not None and mon.baseline > 0
    assert T.StreamExecutor(_engine(PORT)).stragglers.baseline is None


def test_straggler_verdict_matches_monitor_decision():
    """The stats column is exactly a twin monitor's verdict on the same
    walls (no resynthesis)."""
    ex = T.StreamExecutor(_engine(PORT), integrity=tint.IntegrityConfig(
        segment_updates=2))
    ex.run(_stream(PORT))
    twin = tft.StragglerMonitor(factor=3.0)
    for s in ex.last_segment_stats:
        assert s["straggler"] == twin.observe(s["segment"], s["admit_s"] + s["dispatch_s"])
