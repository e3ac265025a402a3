"""Learning linear regression over a join, end to end (paper Sec. 7.2/8.4;
the port's counterpart of ``examples/learn_regression.py``).

A housing-style star schema streams inserts; F-IVM maintains the cofactor
matrix with the degree-m ring; batch gradient descent runs on the
maintained statistics — each convergence step is O(m²), independent of the
data size.  Compares against the closed-form solve and prints OK.

Run:  PYTHONPATH=src python -m repro_torch.examples.learn_regression [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import COOUpdate, IVMEngine, chain
from repro_torch.core.apps import regression
from repro_torch.device import resolve_device

RELS = {
    "House": ("pc", "beds", "price"),
    "Shop": ("pc", "footfall"),
    "Transport": ("pc", "links"),
}
DOMS = dict(pc=64, beds=6, price=16, footfall=8, links=5)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(7)

    q = regression.cofactor_query(RELS, DOMS)
    print("variables:", q.all_vars)  # pc, beds, price, footfall, links

    db = {}
    for name, sch in RELS.items():
        shape = tuple(DOMS[v] for v in sch)
        mult = (rng.random(size=shape) < 0.15).astype(np.float32)
        db[name] = regression.relation_from_multiplicities(
            sch, q.ring, torch.tensor(mult, device=dev))
    vo = chain(["pc"], {"pc": [["beds", "price"], ["footfall"], ["links"]]})
    engine = IVMEngine.build(q, db, var_order=vo, strategy="fivm", device=dev)

    # stream batches of inserts into House (the "fact" relation)
    trigger = engine.make_trigger("House")
    state = engine.state
    for _ in range(20):
        keys = np.stack([rng.integers(0, DOMS[v], size=64)
                         for v in RELS["House"]], 1)
        payload = q.ring.ones((64,), device=dev)
        state = trigger(state, COOUpdate(
            RELS["House"], torch.tensor(keys, dtype=torch.int32, device=dev),
            payload))
    engine.set_state(state)

    stats = regression.stats_of_result(engine.result())
    print(f"maintained: count={float(stats.c):.0f} examples in the join")

    # learn price (var idx 2) from beds, footfall, links (idx 1, 3, 4)
    label, features = 2, [1, 3, 4]
    theta_gd = regression.learn_linear_model(stats, label, features, lr=0.005,
                                             steps=20000)
    theta_ne = regression.solve_linear_model(stats, label, features)
    print("GD θ   :", theta_gd.cpu().numpy().round(3))
    print("solve θ:", theta_ne.cpu().numpy().round(3))
    err = float((theta_gd - theta_ne).abs().max())
    print(f"GD vs normal equations: max |Δθ| = {err:.4f}")
    if not err < 5e-2:
        raise SystemExit(f"GD is {err} from the normal equations")
    print("OK — gradient descent on maintained statistics converged.")


if __name__ == "__main__":
    main()
