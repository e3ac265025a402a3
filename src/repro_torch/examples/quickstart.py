"""Quickstart: F-IVM in 60 lines — Example 1.1 from the paper (the port's
counterpart of ``examples/quickstart.py``).

Maintains  Q[A,C] = SUM(R.B * T.D * S.E)  over R ⋈ S ⋈ T under a stream
of inserts/deletes, and shows the same view tree retargeted from the SUM
ring to the degree-m matrix ring (gradient statistics) by swapping the
payload ring — the paper's central trick.  Checks Q against a numpy
recomputation and prints OK.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (COOUpdate, DenseRelation, IVMEngine, Query,
                              StreamExecutor, chain, sum_ring)
from repro_torch.core.apps import regression
from repro_torch.device import resolve_device

DOMS = dict(A=8, B=8, C=8, D=8, E=8)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)

    # --- the SUM query of Example 1.1 ---------------------------------------
    ring = sum_ring()
    query = Query(
        relations={"R": ("A", "B"), "S": ("A", "C", "E"), "T": ("C", "D")},
        free_vars=("A", "C"),
        ring=ring,
        domains=DOMS,
        lifts={"B": ("value",), "D": ("value",), "E": ("value",)},
    )
    mults = {name: rng.integers(0, 3, size=tuple(DOMS[v] for v in sch)
                                ).astype(np.float32)
             for name, sch in query.relations.items()}
    db = {name: DenseRelation(sch, ring, {"v": torch.tensor(mults[name],
                                                            device=dev)})
          for name, sch in query.relations.items()}
    vo = chain(["A", "C"], {"A": [["B"]], "C": [["D"], ["E"]]})  # Fig. 1's tree

    engine = IVMEngine.build(query, db, var_order=vo, strategy="fivm",
                             device=dev)
    print("view tree:\n" + engine.tree.pretty())
    print(f"materialized views (μ): {sorted(engine.materialized_names)}")

    # --- stream updates -------------------------------------------------------
    # the whole stream up front, through the stream executor (on the card,
    # each step one CUDA graph); engine.apply_update(rel, upd) is the
    # per-call path for single steps
    stream = []
    for step in range(4):
        rel = ["S", "R", "T", "S"][step]
        sch = query.relations[rel]
        keys = np.stack([rng.integers(0, DOMS[v], size=16) for v in sch], 1)
        vals = rng.choice([-1.0, 1.0], size=16).astype(np.float32)  # incl. deletes
        np.add.at(mults[rel], tuple(keys.T), vals)
        stream.append((rel, COOUpdate(
            sch, torch.tensor(keys, dtype=torch.int32, device=dev),
            {"v": torch.tensor(vals, device=dev)})))
    StreamExecutor(engine).run(stream)
    res = engine.result().transpose(("A", "C")).payload["v"].cpu().numpy()
    print("Q[A,C] after 4 update batches:\n", res[:3, :3])
    vals = {v: np.arange(DOMS[v], dtype=np.float64) for v in "BDE"}
    expect = np.einsum("ab,ace,cd,b,d,e->ac", mults["R"], mults["S"],
                       mults["T"], vals["B"], vals["D"], vals["E"])
    if not np.array_equal(res, expect):  # integers far below 2**24: exact
        raise SystemExit("Q[A,C] differs from the numpy recomputation")

    # --- same tree, different ring: gradient statistics (Sec. 7.2) -----------
    q2 = regression.cofactor_query(query.relations, DOMS)
    db2 = {name: regression.relation_from_multiplicities(
        sch, q2.ring, torch.tensor(mults[name], device=dev))
        for name, sch in q2.relations.items()}
    eng2 = IVMEngine.build(q2, db2, var_order=vo, strategy="fivm", device=dev)
    stats = regression.stats_of_result(eng2.result())
    print(f"\ncofactor triple over the join: c={float(stats.c):.0f}, "
          f"|s|={float(torch.linalg.norm(stats.s)):.1f}, "
          f"Q is {tuple(stats.Q.shape)}")
    theta = regression.solve_linear_model(stats, label=3, features=[1, 4])
    print("ridge model (E ~ B, D) from maintained stats:",
          theta[:3].cpu().numpy())
    if not bool(torch.isfinite(theta).all()):
        raise SystemExit("the ridge solve is not finite")
    print("OK")


if __name__ == "__main__":
    main()
