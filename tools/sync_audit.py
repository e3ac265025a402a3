#!/usr/bin/env python3
"""Count the synchronising calls of the eager trigger path on the card.

    python3 tools/sync_audit.py [ROOT ...]

For each ROOT (default: this checkout; another, such as a parent commit's
``git archive`` unpacked under ``build/``, is audited through its own
``src``), in a worker process of its own: the retailer streams of
``chip_smoke.py``'s stream phases (sum and degree-10 cofactor at
``RETAILER_DOMS_BIG``, plan fusion off and ``auto``, and the sum stream
under the ``scatter_dedup`` ⊎ backend), each on a fresh engine: one round
of five batches of 1000 to warm up (lift relations, kernel libraries,
cuBLAS), then one more round under ``torch.cuda.set_sync_debug_mode
("warn")``.  Where the tree has sparse view storage, also the housing star
at ``HOUSING_DOMS_BIG`` (pc = 65,536) with ``auto`` storage, which keeps six
of its seven views as hash tables: the sum ring (512 active postcodes,
batches of 64, fusion off and ``auto``) and the degree-8 cofactor ring
(3,072 active postcodes, batches of 1000, fusion ``auto``), two rounds of
six batches each.  Prints one JSON line a phase: the synchronising calls
counted and their sites (the innermost frame in ``repro_torch``, with its
source line), split into those of the trigger (``trigger_syncs``) and those
of the eager path's table growth check (``growth_syncs``: the occupancy
read of ``storage.grow_if_loaded``, one a touched sparse view a batch).
Where the tree has indicator projections, the triangle query of
``chip_smoke.py``'s triangle leg (the degree-3 cofactor ring, n = 1,024 a
variable, ``fivm`` with indicators, plan fusion ``auto``): one round R, S,
T of distinct-key batches of 1000 to warm up, then two more rounds
(phase ``triangle_indicators``; the R trigger of each bumps the
indicator).  Where the tree has the integrity and durability planes, the
housing stream of ``chip_smoke.py``'s integrity leg (I1: pc = 65,536, 512
active postcodes, batches of 512, ``segment_updates=4``; phase
``integrity_durable``): one segment's admission under ``strict`` and under
``quarantine`` (validation, and the capacity re-audit against live
occupancy that ``capacity_degrade`` adds), one audited Reevaluate pass, one
non-final boundary save, and one replay-only executor run, each after a
warm-up call.  Where the tree has the serving plane, its read paths over
the housing star at pc = 65,536 (512 active postcodes, served with ``auto``
storage, a hash table, and ``dense``; phase ``serve_reads``): ``point``
with device and with host keys, ``range_sum``, ``range_scan``, ``top_k``
and a registry publish, each after a warm-up call.  Last, the LM decode step (``lm_decode``, the reduced
llama3.2-1b config on 2 prompts of 33 tokens, its token already on the
card): one warm-up step, then one audited step (phase ``lm_decode_step``).
Card only.
"""
from __future__ import annotations

import json
import subprocess
import sys
import traceback
import warnings
from collections import Counter
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BATCH = 1000
PHASES = (("retailer_sum", "sum", "off", None),
          ("retailer_sum_fused", "sum", "auto", None),
          ("retailer_sum_scatter_dedup", "sum", "off", "scatter_dedup"),
          ("retailer_cofactor_m10", "cofactor", "off", None),
          ("retailer_cofactor_m10_fused", "cofactor", "auto", None))
#: (label, ring, fusion, active postcodes, batch) of the housing phases
SPARSE_PHASES = (("housing_sparse_sum", "sum", "off", 512, 64),
                 ("housing_sparse_sum_fused", "sum", "auto", 512, 64),
                 ("housing_sparse_cofactor_fused", "cofactor", "auto", 3072, BATCH))


def _site() -> tuple[str, bool]:
    """The innermost ``repro_torch`` frame of the current stack, and
    whether the call came from the eager path's table growth check."""
    stack = traceback.extract_stack()
    growth = any(f.name == "grow_if_loaded" for f in stack)
    for frame in reversed(stack):
        if "repro_torch" in frame.filename:
            path = frame.filename[frame.filename.index("repro_torch"):]
            return f"{path}:{frame.lineno} {frame.line}", growth
    return "outside repro_torch", growth


def _audit(eng, warm, audited) -> dict:
    """Apply ``warm``, then ``audited`` under sync debug mode "warn";
    returns the counts and sites of the audited updates."""
    for rel, upd in warm:
        eng.apply_update(rel, upd)

    def run():
        for rel, upd in audited:
            eng.apply_update(rel, upd)

    return dict(batches=len(audited), **_count_syncs(run))


def _count_syncs(run) -> dict:
    """The synchronising calls ``run()`` makes under sync debug mode
    "warn", by site, split into the trigger's and the growth check's."""
    import torch

    sites: Counter = Counter()
    growth: Counter = Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            site, in_growth = _site()
            (growth if in_growth else sites)[site] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return dict(syncs=sum(sites.values()) + sum(growth.values()),
                trigger_syncs=sum(sites.values()), sites=dict(sites),
                growth_syncs=sum(growth.values()), growth_sites=dict(growth))


def worker(tree: Path) -> None:
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.core import IVMEngine, Query, plan, sum_ring
    from repro_torch.core.apps import regression
    from repro_torch.data import synth
    from repro_torch.kernels import scatter_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    doms, rels = synth.RETAILER_DOMS_BIG, synth.RETAILER_RELATIONS
    for label, ring, fusion, backend in PHASES:
        q = (Query(relations=rels, free_vars=(), ring=sum_ring(), domains=doms,
                   lifts={"units": ("value",)}) if ring == "sum"
             else regression.cofactor_query(rels, doms))
        rng = np.random.default_rng(0)
        db = synth.synth_db(rels, doms, q.ring, rng, device="cuda")
        stream = synth.update_stream(rels, doms, q.ring, rng, BATCH, 2 * len(rels),
                                     device="cuda")
        with plan.use_fusion(fusion), scatter_ops.use_backend(backend):
            eng = IVMEngine.build(q, db, var_order=synth.retailer_vo(),
                                  strategy="fivm", storage="dense", device="cuda")
            eng.precompile(BATCH)
            out = _audit(eng, stream[:len(rels)], stream[len(rels):])
        print(json.dumps(dict(root=str(tree), phase=label, **out)), flush=True)
        del eng, db, stream
        torch.cuda.empty_cache()
    if not hasattr(synth, "synth_low_fill_db"):  # a tree before sparse storage
        return
    doms, rels = synth.HOUSING_DOMS_BIG, synth.HOUSING_RELATIONS
    for label, ring, fusion, n_active, batch in SPARSE_PHASES:
        q = (Query(relations=rels, free_vars=(), ring=sum_ring(), domains=doms,
                   lifts={"h2": ("value",)}) if ring == "sum"
             else regression.cofactor_query(rels, doms))
        db, active = synth.synth_low_fill_db(rels, doms, q.ring,
                                             np.random.default_rng(0), "pc",
                                             n_active, device="cuda")
        stream = synth.update_stream(rels, doms, q.ring, np.random.default_rng(1),
                                     batch, 2 * len(rels), key_pools={"pc": active},
                                     device="cuda")
        with plan.use_fusion(fusion):
            eng = IVMEngine.build(q, db, var_order=synth.housing_vo(),
                                  strategy="fivm", device="cuda")
            n_sparse = sum(s.kind == "sparse" for s in eng.storage_plan.values())
            eng.precompile(batch)
            out = _audit(eng, stream[:len(rels)], stream[len(rels):])
        print(json.dumps(dict(root=str(tree), phase=label, sparse_views=n_sparse,
                              **out)), flush=True)
        del eng, db, stream
        torch.cuda.empty_cache()
    if hasattr(synth, "distinct_key_stream"):  # a tree with indicators
        _triangle_phase(tree)
    if (tree / "src" / "repro_torch" / "runtime" / "integrity.py").exists():
        _integrity_durable_phase(tree)
    if (tree / "src" / "repro_torch" / "serve").exists():
        _serve_reads_phase(tree)
    _decode_phase(tree)


def _triangle_phase(tree: Path, n: int = 1024) -> None:
    """The synchronising calls of two triangle rounds with indicators."""
    import torch
    from repro_torch.core import IVMEngine
    from repro_torch.core.apps import regression
    from repro_torch.data import synth

    rels = synth.TRIANGLE_RELATIONS
    doms = dict(A=n, B=n, C=n)
    q = regression.cofactor_query(rels, doms)
    db = synth.synth_db(rels, doms, q.ring, np.random.default_rng(0),
                        density=3.0 / n, device="cuda")
    stream = synth.distinct_key_stream(rels, doms, q.ring, np.random.default_rng(1),
                                       [BATCH] * 9, device="cuda")
    eng = IVMEngine.build(q, db, var_order=synth.triangle_vo(), use_indicators=True,
                          fuse_chains=False, device="cuda")
    eng.precompile(BATCH)
    out = _audit(eng, stream[:3], stream[3:])
    print(json.dumps(dict(root=str(tree), phase="triangle_indicators", n=n,
                          indicator_rounds=2, **out)), flush=True)
    del eng, db, stream
    torch.cuda.empty_cache()


def _integrity_durable_phase(tree: Path) -> None:
    """The synchronising calls of the integrity and durability planes on
    the housing I1 stream: admission of one segment (strict, quarantine),
    one audit pass, one non-final boundary save, one replay-only run."""
    import shutil

    import torch
    from repro_torch.checkpoint import StreamCheckpointer
    from repro_torch.core import IVMEngine, Query, StreamExecutor, prepare_stream, sum_ring
    from repro_torch.data import synth
    from repro_torch.runtime.integrity import IntegrityConfig, audit_engine

    doms, rels = synth.HOUSING_DOMS_BIG, synth.HOUSING_RELATIONS
    q = Query(relations=rels, free_vars=(), ring=sum_ring(), domains=doms,
              lifts={"h2": ("value",)})
    db, active = synth.synth_low_fill_db(rels, doms, q.ring, np.random.default_rng(0),
                                         "pc", 512, device="cuda")
    stream = synth.update_stream(rels, doms, q.ring, np.random.default_rng(1), 512, 12,
                                 key_pools={"pc": active}, device="cuda")
    eng = IVMEngine.build(q, db, var_order=synth.housing_vo(), strategy="fivm",
                          store_base=True, device="cuda")
    eng.precompile(512)
    out = {}
    for policy in ("strict", "quarantine"):
        ex = StreamExecutor(eng, integrity=IntegrityConfig(policy=policy,
                                                           segment_updates=4))
        ex._admit_segment(stream[:4], {}, 0)
        out[f"admit_{policy}"] = _count_syncs(
            lambda ex=ex: ex._admit_segment(stream[4:8], {}, 4))
    cfg = IntegrityConfig(audit_interval=1)
    audit_engine(eng, cfg)
    out["audit"] = _count_syncs(lambda: audit_engine(eng, cfg))
    ckdir = ROOT / "build" / "sync_audit_snapshots"
    shutil.rmtree(ckdir, ignore_errors=True)
    ck = StreamCheckpointer(str(ckdir))
    ck.save_boundary(eng, offset=0, segment=0)
    ck.wait()
    out["boundary_save"] = _count_syncs(lambda: ck.save_boundary(eng, offset=4,
                                                                 segment=1))
    ck.wait()
    shutil.rmtree(ckdir, ignore_errors=True)
    ex = StreamExecutor(eng)
    prepared = prepare_stream(eng, stream[:4])
    ex.run(prepared)
    out["replay"] = _count_syncs(lambda: ex.run(prepared, donate_input=True))
    ex.release()
    print(json.dumps(dict(root=str(tree), phase="integrity_durable", batch=512,
                          segment_updates=4, **out)), flush=True)
    del eng, db, stream
    torch.cuda.empty_cache()


def _serve_reads_phase(tree: Path) -> None:
    """The synchronising calls of the serving plane's read paths and of a
    publish: the housing star at pc = 65,536 (512 active postcodes, S1's
    10 batches of 64 run through a registry-attached executor), served
    from its first ``pc``-keyed view by name, with ``auto`` storage (a hash
    table) and ``dense``; each path called once to warm, then audited."""
    import torch
    from repro_torch.core import IVMEngine, Query, StreamExecutor, sum_ring
    from repro_torch.data import synth
    from repro_torch.serve import ViewServer

    doms, rels = synth.HOUSING_DOMS_BIG, synth.HOUSING_RELATIONS
    q = Query(relations=rels, free_vars=(), ring=sum_ring(), domains=doms,
              lifts={"h2": ("value",)})
    db, active = synth.synth_low_fill_db(rels, doms, q.ring, np.random.default_rng(0),
                                         "pc", 512, device="cuda")
    stream = synth.update_stream(rels, doms, q.ring, np.random.default_rng(1), 64, 10,
                                 key_pools={"pc": active}, device="cuda")
    rng = np.random.default_rng(2)
    host_keys = rng.choice(active, size=(256, 1)).astype(np.int32)
    dev_keys = torch.from_numpy(host_keys).to("cuda")
    for storage in ("auto", "dense"):
        eng = IVMEngine.build(q, db, var_order=synth.housing_vo(), strategy="fivm",
                              storage=storage, device="cuda")
        ex = StreamExecutor(eng)
        server = ViewServer(ex)
        ex.run(stream)
        name = sorted(n for n, v in eng.views.items() if v.schema)[0]
        S = doms["pc"]
        paths = dict(point_device_keys=lambda: server.point(name, dev_keys),
                     point_host_keys=lambda: server.point(name, host_keys),
                     range_sum=lambda: server.range_sum(name, 0, S),
                     range_scan=lambda: server.range_scan(name, 0, S, 64),
                     top_k=lambda: server.top_k(name, 16),
                     publish=lambda: server.registry.publish(eng.views))
        out = {}
        for path, fn in paths.items():
            fn()
            out[path] = _count_syncs(fn)
        ex.release()
        print(json.dumps(dict(root=str(tree), phase="serve_reads", storage=storage,
                              view=name, view_kind=type(eng.views[name]).__name__,
                              keys=len(host_keys), **out)), flush=True)
        del eng, ex, server
    del db, stream
    torch.cuda.empty_cache()


def _decode_phase(tree: Path) -> None:
    """The synchronising calls of one LM decode step (the reduced llama3.2-1b
    config, 2 prompts of 33 tokens, the token already on the card)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import registry

    cfg = get_config("llama3_2_1b").reduced()
    api = registry.build(cfg)
    params = api.init(seed=0, device="cuda")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 33))
    logits, cache = api.prefill(params, {"tokens": toks}, 40)
    logits, cache = api.decode_step(params, logits.argmax(-1), 33, cache)
    token = logits.argmax(-1)
    out = _count_syncs(lambda: api.decode_step(params, token, 34, cache))
    print(json.dumps(dict(root=str(tree), phase="lm_decode_step", layers=cfg.n_layers,
                          steps=1, **out)), flush=True)


def main(argv) -> int:
    if argv[:1] == ["--worker"]:
        worker(Path(argv[1]).resolve())
        return 0
    for tree in argv or [str(ROOT)]:
        subprocess.run([sys.executable, __file__, "--worker", tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
