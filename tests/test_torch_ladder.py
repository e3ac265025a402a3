"""The port's ``StreamSupervisor`` escalation ladder ≡ the reference's
(the ladder tests of ``tests/test_integrity.py``).

restart → restore the previous snapshot → quarantine the batch →
reevaluate from base, each rung cleared by a failure only it can clear:
the same numpy inputs go through ``repro`` (JAX on the CPU) and
``repro_torch`` (on the CPU), and the port is held to the reference's
restarts, log actions, dead letters and final views (bitwise,
integer-valued float32 payloads).
"""
import shutil

import numpy as np

from _torch_durable import (BOTH, PORT, disarm_faults, engine, jnp,  # noqa: F401
                            letters, result, same, stream)


#: (stream index, row) -> mutation: a NaN payload and an out-of-domain key
POISONS = {(2, 5): "nan", (5, 7): "key"}


def _poison_root(pkg, eng):
    """NaN in the live root view's first payload slot."""
    import dataclasses

    root = eng.tree.name
    v = eng.views[root]
    if pkg is PORT:
        v.payload["v"][0] = float("nan")
        return
    pay = dict(v.payload)
    pay["v"] = pay["v"].at[0].set(jnp.nan)
    eng.views[root] = dataclasses.replace(v, payload=pay)


def _poisoned_snapshots(pkg, tmp, keep_older=True):
    st = stream(pkg, n=6)
    eng = engine(pkg, store_base=True)
    ck = pkg.state.StreamCheckpointer(str(tmp), segment_updates=2)
    pkg.core.StreamExecutor(eng, checkpoint=ck).run(st, update_engine=True)
    ck.wait()
    # the newest snapshot overwritten by a NaN-poisoned state: valid
    # bytes, valid checksums — only the NaN guard sees it
    _poison_root(pkg, eng)
    ck.save_boundary(eng, offset=len(st), segment=99, blocking=True)
    if not keep_older:
        for s in ck.ckpt.all_steps()[:-1]:
            shutil.rmtree(tmp / f"step_{s:08d}")
    eng2 = engine(pkg, store_base=True)
    ex2 = pkg.core.StreamExecutor(eng2, checkpoint=pkg.state.StreamCheckpointer(
        str(tmp), segment_updates=2))
    _, restarts, log = pkg.ft.StreamSupervisor(max_restarts=4, backoff_s=0.0).run(
        ex2, st)
    if pkg is PORT:
        ref = engine(pkg)
        pkg.core.StreamExecutor(ref).run(stream(pkg, n=6))
        np.testing.assert_array_equal(result(pkg, eng2), result(pkg, ref))
    return (restarts, [e.get("action") for e in log if "action" in e],
            result(pkg, eng2).tolist())


def test_ladder_restores_previous_snapshot_past_poison(tmp_path):
    _, actions, _ = same({p.name: _poisoned_snapshots(p, tmp_path / p.name)
                           for p in BOTH})
    assert actions == ["restart", "restore_previous_snapshot"]


def test_ladder_reevaluates_from_base_when_no_older_snapshot(tmp_path):
    _, actions, _ = same({p.name: _poisoned_snapshots(p, tmp_path / p.name, False)
                           for p in BOTH})
    assert actions[-1] == "reevaluate_from_base"


def _strict_ladder(pkg, tmp):
    cfg = pkg.integ.IntegrityConfig(policy="strict", segment_updates=2)
    ex = pkg.core.StreamExecutor(engine(pkg, store_base=True),
                                 checkpoint=pkg.state.StreamCheckpointer(
                                     str(tmp), segment_updates=2),
                                 integrity=cfg)
    _, restarts, log = pkg.ft.StreamSupervisor(max_restarts=3, backoff_s=0.0).run(
        ex, stream(pkg, n=6, rows=POISONS))
    return (restarts, [e.get("action") for e in log if "action" in e], cfg.policy,
            letters(cfg.dead_letters), result(pkg, ex.engine).tolist())


def test_ladder_downgrades_strict_to_quarantine(tmp_path):
    restarts, actions, policy, letters, _ = same(
        {p.name: _strict_ladder(p, tmp_path / p.name) for p in BOTH})
    assert restarts == 1 and actions == ["quarantine_batch"]
    assert policy == "quarantine" and letters


def _escalate_off(pkg, tmp):
    ex = pkg.core.StreamExecutor(engine(pkg), checkpoint=pkg.state.StreamCheckpointer(
        str(tmp), segment_updates=2))
    with pkg.faults.inject("mid_segment", at=0):
        _, restarts, log = pkg.ft.StreamSupervisor(
            max_restarts=2, backoff_s=0.0, escalate=False).run(ex, stream(pkg, n=4))
    return restarts, [e.get("action") for e in log if "action" in e]


def test_escalate_off_keeps_plain_restarts(tmp_path):
    assert same({p.name: _escalate_off(p, tmp_path / p.name)
                  for p in BOTH}) == (1, ["restart"])
