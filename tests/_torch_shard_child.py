"""Scenarios of the sharding parity tests (``test_torch_shard.py``).

The numpy sources of every scenario live here, so the JAX reference (in a
subprocess that forces 4 host devices) and the port (a group of ranks over
``torch.distributed``) build the same engines and streams.  Run as a
program, this file is one rank of the port's group::

    python tests/_torch_shard_child.py group RANK WORLD INIT_FILE OUT_DIR
    python tests/_torch_shard_child.py resume RANK WORLD INIT_FILE OUT_DIR

``group`` runs every scenario sharded (rank 0 writes ``port.npz`` and
``port.json`` to OUT_DIR), the serving check, then the chaos run, which
kills every rank with SIGKILL mid-segment (checkpoints under
``OUT_DIR/ck``).  ``resume`` resumes the chaos stream from those
checkpoints on WORLD ranks and writes ``resume<WORLD>.npz``.  The module
imports neither package at import time: the reference's child imports it
for the numpy sources alone.
"""
import json
import os
import sys

import numpy as np

DOMS = dict(A=4, B=8, C=4, D=8, E=4)
SCHEMAS = {"R": ("A", "B"), "S": ("A", "C", "E"), "T": ("C", "D")}
LIFTS = {"B": ("value",), "D": ("value",), "E": ("value",)}
VO = (["A", "C"], {"A": [["B"]], "C": [["D"], ["E"]]})

#: schedule scenarios of the reference's ``test_sharded_matches_single_device``
SCHEDULES = {
    "scan": ["S"] * 5,
    "rounds": ["R", "S", "T"] * 3,
    "switch": ["R", "S", "T", "S", "R", "R", "T"],
}
SCENARIOS = tuple(SCHEDULES) + ("float", "grow")

# the chaos query of the recovery and serving suites
CH_DOMS = dict(A=64, B=64, C=3)
CH_SCHEMAS = {"R": ("A", "B"), "T": ("B", "C")}


def np_db(rng, float_vals=False):
    def rel(schema):
        shape = tuple(DOMS[v] for v in schema)
        if float_vals:
            return (rng.random(size=shape)
                    * (rng.random(size=shape) < 0.4)).astype(np.float32)
        return rng.integers(0, 3, size=shape).astype(np.float32)

    return {"R": rel("AB"), "S": rel("ACE"), "T": rel("CD")}


def np_stream(rng, schedule, batches, float_vals=False):
    out = []
    for rel, B in zip(schedule, batches):
        sch = SCHEMAS[rel]
        keys = np.stack([rng.integers(0, DOMS[v], size=B) for v in sch],
                        axis=1).astype(np.int32)
        if float_vals:
            vals = (rng.random(size=B) * 4 - 2).astype(np.float32)
        else:
            vals = rng.integers(-2, 3, size=B).astype(np.float32)
        out.append((rel, keys, vals))
    return out


def scenario(name):
    """``(db, stream, engine kind)`` of a scenario, as numpy."""
    if name in SCHEDULES:
        rng = np.random.default_rng(7)
        db = np_db(rng)
        sched = SCHEDULES[name]
        return db, np_stream(rng, sched, [int(rng.integers(1, 8))
                                          for _ in sched]), "mixed"
    if name == "float":
        rng = np.random.default_rng(23)
        db = np_db(rng, float_vals=True)
        return db, np_stream(rng, ["R", "S", "T"] * 3, [6] * 9,
                             float_vals=True), "mixed"
    rng = np.random.default_rng(3)
    db = np_db(rng)
    return db, np_stream(rng, ["S"] * 12, [16] * 12), "grow"


def chaos_db():
    rng = np.random.default_rng(3)
    out = {}
    for name, sch in CH_SCHEMAS.items():
        shape = tuple(CH_DOMS[v] for v in sch)
        mult = np.zeros(shape, np.float32)
        idx = tuple(rng.integers(0, d, size=8) for d in shape)
        np.add.at(mult, idx, 1.0)
        out[name] = mult
    return out


def chaos_stream():
    rng = np.random.default_rng(11)
    out = []
    for rel in ["R", "T"] * 4:
        sch = CH_SCHEMAS[rel]
        keys = np.stack([rng.integers(0, CH_DOMS[v], size=24) for v in sch],
                        axis=1).astype(np.int32)
        out.append((rel, keys, rng.integers(-2, 3, size=24).astype(np.float32)))
    return out


class Port:
    """Engines and streams of the scenarios in the port, on ``device``."""

    def __init__(self, device="cpu"):
        import torch

        from repro_torch import core

        self.torch, self.core, self.device = torch, core, device
        c = core
        self.q = c.Query(relations=dict(SCHEMAS), free_vars=("A", "C"),
                         ring=c.sum_ring(), domains=DOMS, lifts=dict(LIFTS))
        self.cq = c.Query(relations=dict(CH_SCHEMAS), free_vars=("A",),
                          ring=c.sum_ring(), domains=CH_DOMS,
                          lifts={"C": ("value",)})

    def t(self, a):
        return self.torch.from_numpy(np.ascontiguousarray(a))

    def engine(self, db, kind):
        c = self.core
        rels = {n: c.DenseRelation(SCHEMAS[n], self.q.ring, {"v": self.t(a)})
                for n, a in db.items()}
        vo = c.chain(*VO)
        if kind == "sparse":
            return c.IVMEngine.build(self.q, rels, var_order=vo,
                                     storage="sparse", device=self.device)
        if kind == "grow":
            return c.IVMEngine.build(self.q, rels, var_order=vo,
                                     storage="sparse", device=self.device,
                                     storage_opts=dict(min_capacity=16))
        probe = c.IVMEngine.build(self.q, rels, var_order=vo, storage="sparse",
                                  device=self.device)
        sparse = [n for n, s in probe.storage_plan.items()
                  if s.kind == "sparse"]
        return c.IVMEngine.build(self.q, rels, var_order=vo, storage="sparse",
                                 storage_overrides={min(sparse): "dense"},
                                 device=self.device)

    def stream(self, items, schemas=SCHEMAS):
        return [(r, self.core.COOUpdate(schemas[r], self.t(k),
                                        {"v": self.t(v)}))
                for r, k, v in items]

    def chaos_engine(self, storage="sparse", **kw):
        c = self.core
        rels = {n: c.DenseRelation(CH_SCHEMAS[n], self.cq.ring,
                                   {"v": self.t(a)})
                for n, a in chaos_db().items()}
        return c.IVMEngine.build(self.cq, rels,
                                 var_order=c.chain(["A", "B"], {"B": [["C"]]}),
                                 storage=storage, device=self.device, **kw)

    def chaos_stream(self):
        return self.stream(chaos_stream(), CH_SCHEMAS)

    def result(self, eng, order=("A", "C")):
        return eng.result().transpose(order).payload["v"].cpu().numpy()


def _init(rank, world, init_file):
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    return dist


def _serve_check(port, out):
    """Every generation a 4-rank sharded executor publishes equals offline
    recomputation at its offset, view for view and lookup for lookup (the
    reference's ``test_four_device_pinned_reads_match_offline_recompute``)."""
    from repro_torch.serve import ViewServer

    from repro_torch.core import StreamExecutor, shard_executor

    stream = port.chaos_stream()
    report = {}
    for storage in ("dense", "sparse"):
        eng = port.chaos_engine(storage)
        ex = shard_executor(eng)
        server = ViewServer(ex, retain=64, segment_updates=2)
        ex.run(stream)
        reg = server.registry
        names = sorted(reg.latest().views)
        checked = 0
        for g in range(reg.generation + 1):
            with server.pin(g) as p:
                snap = reg.get(g)
                ref = port.chaos_engine(storage)
                if snap.offset:
                    StreamExecutor(ref).run(stream[:snap.offset])
                rsrv = ViewServer(StreamExecutor(ref))
                for n in names:
                    a = port.core.storage.as_dense(snap.views[n])
                    b = port.core.storage.as_dense(ref.views[n])
                    assert np.array_equal(a.payload["v"].numpy(),
                                          b.payload["v"].numpy()), (g, n)
                    view = ref.views[n]
                    if not view.schema:
                        continue
                    keys = np.stack([np.arange(6) % int(view.domain_of(v))
                                     for v in view.schema],
                                    axis=1).astype(np.int32)
                    got = p.point(n, keys).host()
                    want = rsrv.point(n, keys).host()
                    for c in got:
                        assert np.array_equal(got[c], want[c]), (g, n, c)
                    checked += 1
        assert reg.latest().offset == len(stream)
        report[storage] = dict(generations=reg.generation + 1,
                               reads=checked,
                               sharded=list(ex.shard.sharded_views()))
    out["serve"] = report


def _views(eng) -> dict:
    """Every view of ``eng`` whole, as host arrays (a collective for each
    sharded view)."""
    from repro_torch.core.storage import as_dense

    return {f"{n}.{c}": t.numpy().copy()
            for n in sorted(eng.views)
            for c, t in as_dense(eng.views[n]).payload.items()}


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def _port_only_checks(port, out):
    """Paths the reference's sharding tests do not take, held to the port's
    unsharded engine bitwise (integer-valued payloads): indicator
    projections (the triangle, ``fivm`` and ``dbt``), factorized updates
    (the matrix chain) through ``apply_update`` on a sharded state, and an
    audited stream whose sharded root is corrupted, then repaired in place
    at a boundary."""
    import torch

    from repro_torch.core import (IVMEngine, StreamExecutor, plan_shards,
                                  shard_executor)
    from repro_torch.core.apps import matrix_chain, regression
    from repro_torch.core.relations import is_sharded
    from repro_torch.data import synth
    from repro_torch.runtime.integrity import IntegrityConfig

    checks = {}
    n = 16
    doms = dict(A=n, B=n, C=n)
    rels = synth.TRIANGLE_RELATIONS
    q = regression.cofactor_query(rels, doms)
    db = synth.synth_db(rels, doms, q.ring, np.random.default_rng(0),
                        density=3.0 / n, device="cpu")
    stream = synth.distinct_key_stream(rels, doms, q.ring,
                                       np.random.default_rng(1), [8] * 6,
                                       device="cpu")
    for strategy in ("fivm", "dbt"):
        def build():
            return IVMEngine.build(q, db, var_order=synth.triangle_vo(),
                                   fuse_chains=False, device="cpu",
                                   strategy=strategy, use_indicators=True)

        plain = build()
        StreamExecutor(plain).run(stream)
        eng = build()
        ex = shard_executor(eng)
        ex.run(stream)
        checks[f"triangle_{strategy}_indicators"] = (
            _same(_views(eng), _views(plain)), len(ex.shard.sharded_views()))

    rng = np.random.default_rng(2)
    mats = [rng.integers(-2, 3, (8, 8)).astype(np.float32) for _ in range(3)]
    plain = matrix_chain.build_chain_engine(mats, updatable=("A2",), device="cpu")
    eng = matrix_chain.build_chain_engine(mats, updatable=("A2",), device="cpu")
    eng.shard_state(plan_shards(eng))
    for _ in range(3):
        u, v = (torch.from_numpy(rng.integers(-2, 3, 8).astype(np.float32))
                for _ in range(2))
        for e in (plain, eng):
            e.apply_update("A2", matrix_chain.rank1_update(2, u, v, e.query.ring))
    checks["chain_factorized"] = (
        _same(_views(eng), _views(plain)),
        sum(is_sharded(v) for v in eng.views.values()))

    stream = port.chaos_stream()
    plain = port.chaos_engine("dense", store_base=True)
    StreamExecutor(plain).run(stream)
    eng = port.chaos_engine("dense", store_base=True)
    ex = shard_executor(eng)
    ex.run(stream[:4])
    root = eng.views[eng.tree.name]
    if is_sharded(root):
        root.rows.add_(1.0)  # drift in every rank's slice
    cfg = IntegrityConfig(audit_interval=1, segment_updates=2)
    ex.integrity = cfg
    ex.run(stream[4:])
    repaired = [a["route"] for a in cfg.audit_log if a["repaired"]]
    checks["audit_repair"] = (_same(_views(eng), _views(plain)),
                              repaired == ["in_place"] and is_sharded(root))
    out["port_only"] = checks


def run_group(rank, world, init_file, out_dir):
    dist = _init(rank, world, init_file)
    from repro_torch.checkpoint.stream_state import StreamCheckpointer
    from repro_torch.core import collectives, plan_shards, shard_executor
    from repro_torch.core.relations import is_sharded
    from repro_torch.runtime import faults

    port = Port()
    out = {"world": world, "specs": {}, "sharded": {}, "local_rows": {}}
    arrays = {}
    for name in SCENARIOS:
        db, items, kind = scenario(name)
        eng = port.engine(db, kind)
        ex = shard_executor(eng)
        out["specs"][name] = ex.shard.pretty()
        out["sharded"][name] = list(ex.shard.sharded_views())
        # each rank holds 1/world of every sharded view's rows
        out["local_rows"][name] = {
            n: [int(v.rows.shape[0]), int(v.shard.total_rows)]
            for n, v in eng.views.items() if is_sharded(v)}
        ex.run(port.stream(items))
        out.setdefault("program", ex.last_run_stats.get("program"))
        arrays[name] = port.result(eng)
    out["plan_n4"] = plan_shards(port.engine(*scenario("rounds")[::2]),
                                 devices=world).pretty()
    _serve_check(port, out)
    _port_only_checks(port, out)
    out["collectives"] = {k: dict(v) for k, v in collectives.STATS.items()}
    if rank == 0:
        np.savez(os.path.join(out_dir, "port.npz"), **arrays)
        with open(os.path.join(out_dir, "port.json"), "w") as f:
            json.dump(out, f)
    dist.barrier()
    # the chaos run: every rank dies by SIGKILL after the second segment
    # boundary, the torn state a preempted group leaves behind
    eng = port.chaos_engine("sparse")
    ck = StreamCheckpointer(os.path.join(out_dir, "ck"), segment_updates=2)
    ex = shard_executor(eng, checkpoint=ck)
    faults.install(faults.FaultPlan("mid_segment", at=2, mode="kill9"))
    ex.resume(port.chaos_stream())
    print("UNREACHABLE: fault did not fire")
    sys.exit(3)


def run_resume(rank, world, init_file, out_dir):
    dist = _init(rank, world, init_file)
    from repro_torch.checkpoint.stream_state import StreamCheckpointer
    from repro_torch.core import shard_executor

    port = Port()
    eng = port.chaos_engine("sparse")
    ck = StreamCheckpointer(os.path.join(out_dir, "ck"), segment_updates=2)
    ex = shard_executor(eng, checkpoint=ck)
    ex.resume(port.chaos_stream())
    got = port.result(eng, order=("A",))
    if rank == 0:
        np.savez(os.path.join(out_dir, f"resume{world}.npz"), root=got,
                 sharded=np.array(list(ex.shard.sharded_views())))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    mode, rank, world, init_file, out_dir = sys.argv[1:6]
    fn = run_group if mode == "group" else run_resume
    fn(int(rank), int(world), init_file, out_dir)
