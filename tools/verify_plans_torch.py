#!/usr/bin/env python3
"""Standalone plan-verification gate of the PyTorch port.

    python3 tools/verify_plans_torch.py [--device cpu|cuda]

Builds every app configuration of ``repro_torch.core.apps`` (degree-m
regression cofactors, the factorized matrix chain, count-ring conjunctive
queries) under ``auto``, dense and sparse storage, plus the port's
main-path engines (the retailer sum, the housing star at pc = 4,096 with
hash tables, the triangle with indicator projections), compiles every
trigger plan the engines serve, and runs the full static rule set of
``repro_torch.analysis.verifier`` over each:

* per-plan rules (``verify_trigger_plan``): schema / dataflow typing, the
  state-machine replay, the fusion legality oracle (H100 shared memory),
  capacity soundness;
* the step-level CSE race rule (``verify_step_plans``) over each engine's
  all-triggers pattern.

The shard-placement rule waits for sharded execution (ROADMAP Queue 1 item
14).  Honors ``REPRO_TORCH_SCATTER_BACKEND``, ``REPRO_TORCH_PLAN_FUSION``
and ``REPRO_TORCH_VIEW_STORAGE``.  The engines are built on ``--device``
(default ``cpu``; plan fusion ``auto`` fuses on ``cuda`` only).  Prints each
plan's verify time; exit status 1 on any violation.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.analysis import verifier  # noqa: E402
from repro_torch.core import IVMEngine, Query, sum_ring  # noqa: E402
from repro_torch.core.apps import conjunctive, matrix_chain, regression  # noqa: E402
from repro_torch.core.variable_orders import chain  # noqa: E402
from repro_torch.data import synth  # noqa: E402


def _engines(device: str):
    """(label, engine) a configuration."""
    rng = np.random.default_rng(0)
    storages = [None, "dense", "sparse"]
    env_storage = os.environ.get("REPRO_TORCH_VIEW_STORAGE")
    if env_storage:
        storages = [None]  # the env override already picks the layout

    def label(app, storage):
        return f"{app}[{storage or env_storage or 'auto'}]"

    rels = {"R": ("A", "B"), "S": ("A", "C")}
    doms = dict(A=3, B=4, C=5)
    mult = {n: torch.from_numpy(rng.integers(0, 2, size=tuple(doms[v] for v in sch))
                                .astype(np.float32))
            for n, sch in rels.items()}
    for storage in storages:
        kw = {} if storage is None else {"storage": storage}
        yield label("regression", storage), regression.build_cofactor_engine(
            rels, doms, mult, var_order=chain(["A"], {"A": [["B"], ["C"]]}),
            device=device, **kw)

    mats = [rng.random((4, 3)).astype(np.float32),
            rng.random((3, 5)).astype(np.float32),
            rng.random((5, 2)).astype(np.float32)]
    for storage in storages:
        kw = {} if storage is None else {"storage": storage}
        yield label("matrix_chain", storage), matrix_chain.build_chain_engine(
            mats, device=device, **kw)

    crels = {"R": ("A", "B"), "S": ("B", "C")}
    cdoms = dict(A=3, B=3, C=3)
    cmult = {n: rng.integers(0, 2, size=tuple(cdoms[v] for v in sch)).astype(np.float32)
             for n, sch in crels.items()}
    for storage in storages:
        kw = {} if storage is None else {"storage": storage}
        eng, _ = conjunctive.make_factorized_engine(
            crels, cmult, chain(["A", "B", "C"]), cdoms, device=device, **kw)
        yield label("conjunctive", storage), eng

    q = Query(relations=synth.RETAILER_RELATIONS, free_vars=(), ring=sum_ring(),
              domains=synth.RETAILER_DOMS, lifts={"units": ("value",)})
    db = synth.synth_db(synth.RETAILER_RELATIONS, synth.RETAILER_DOMS, q.ring,
                        np.random.default_rng(0), device=device)
    yield label("retailer_sum", None), IVMEngine.build(
        q, db, var_order=synth.retailer_vo(), device=device)

    q = Query(relations=synth.HOUSING_RELATIONS, free_vars=(), ring=sum_ring(),
              domains=synth.HOUSING_DOMS, lifts={"h2": ("value",)})
    db, _ = synth.synth_low_fill_db(synth.HOUSING_RELATIONS, synth.HOUSING_DOMS,
                                    q.ring, np.random.default_rng(0), "pc",
                                    n_active=128, device=device)
    yield label("housing", None), IVMEngine.build(
        q, db, var_order=synth.housing_vo(), device=device)

    tdoms = dict(A=8, B=8, C=8)
    q = Query(relations=synth.TRIANGLE_RELATIONS, free_vars=(), ring=sum_ring(),
              domains=tdoms)
    db = synth.synth_db(synth.TRIANGLE_RELATIONS, tdoms, q.ring,
                        np.random.default_rng(0), device=device)
    yield label("triangle_indicators", None), IVMEngine.build(
        q, db, var_order=synth.triangle_vo(), use_indicators=True, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu", help="engine device (cpu or cuda)")
    args = ap.parse_args(argv)
    n_plans = n_violations = 0
    t_total = 0.0
    for label, eng in _engines(args.device):
        plans = []
        for rel in eng.updatable:
            for batch in (1, 4):
                sig = ("coo", tuple(eng.query.relations[rel]), batch)
                # compile outside the gate, so the timed part below is the
                # verification alone
                with verifier.use_verify("off"):
                    plans.append(eng.plans.lookup_sig(eng, rel, sig))
        step_plans = []
        for plan in plans:
            t0 = time.perf_counter()
            violations = verifier.verify_trigger_plan(eng, plan)
            dt = 1e3 * (time.perf_counter() - t0)
            t_total += dt
            n_plans += 1
            status = "ok" if not violations else f"{len(violations)} VIOLATION(S)"
            print(f"  {label:28s} δ{plan.rel} batch={plan.batch}: {status}"
                  f"  ({dt:.2f} ms)")
            for v in violations:
                n_violations += 1
                print(f"    {v.label()}")
            if plan.batch == 4:
                step_plans.append(plan)
        for v in verifier.verify_step_plans(step_plans):
            n_violations += 1
            print(f"    {v.label()}")
    print(f"verify-plans: {n_plans} plans, {n_violations} violations, "
          f"{t_total:.1f} ms verify time "
          f"({t_total / max(n_plans, 1):.2f} ms/plan)")
    return 1 if n_violations else 0


if __name__ == "__main__":
    raise SystemExit(main())
