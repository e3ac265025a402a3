"""Incremental matrix chain multiplication with factorized updates
(paper Sec. 7.1 / Fig. 9, generalizing LINVIEW; the port's counterpart of
``examples/matrix_chain.py``).

Maintains A = A1·A2·A3·A4 (n = 384) under a rank-1 row update and a rank-8
update to A2 (8 factorized deltas from an SVD) in O(n²) per rank instead
of O(n³) re-multiplication, then checks the result against a float64
numpy product and prints OK.  On the card each update's joins and ⊎s are
the ``matvec`` and ``outer_accumulate`` kernels.

Run:  PYTHONPATH=src python -m repro_torch.examples.matrix_chain [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.apps import matrix_chain
from repro_torch.device import resolve_device

N = 384
ROW_UPDATES = 6  # one warm-up, five timed
TIMED = 5


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    rng = np.random.default_rng(0)
    mats_np = [rng.standard_normal((N, N)).astype(np.float32) for _ in range(4)]
    mats = [torch.tensor(m, device=dev) for m in mats_np]
    engine = matrix_chain.build_chain_engine(mats, updatable=("A2",), device=dev)
    ring = engine.query.ring
    A = matrix_chain.result_matrix(engine).cpu().numpy()
    expect = np.linalg.multi_dot([m.astype(np.float64) for m in mats_np])
    print(f"static chain OK: max err = {np.abs(A - expect).max():.2e}")

    # --- rank-1 row update (Fig. 9 left) ------------------------------------
    trigger = engine.make_trigger("A2")
    state = engine.state
    row = 5
    delta = rng.standard_normal(N).astype(np.float32)
    upd = matrix_chain.row_update(2, row, torch.tensor(delta, device=dev), N, ring)
    state = trigger(state, upd)  # warm-up
    sync()
    t0 = time.perf_counter()
    for _ in range(TIMED):
        state = trigger(state, upd)
    sync()
    t_fivm = (time.perf_counter() - t0) / TIMED

    def reevaluate():
        return mats[0] @ mats[1] @ mats[2] @ mats[3]

    reevaluate()
    sync()
    t0 = time.perf_counter()
    for _ in range(TIMED):
        reevaluate()
    sync()
    t_re = (time.perf_counter() - t0) / TIMED
    print(f"rank-1 row update: F-IVM {t_fivm*1e3:.2f}ms vs reevaluation "
          f"{t_re*1e3:.2f}ms  ({t_re/t_fivm:.1f}x) on {dev.type}")

    # --- rank-r via SVD decomposition (Sec. 5 / Fig. 9 right) ----------------
    big = rng.standard_normal((N, N)).astype(np.float32)
    big_delta = (big[:, :8] @ big[:8, :]).astype(np.float32)  # rank 8
    sync()
    t0 = time.perf_counter()
    for u, v in matrix_chain.decompose_rank_r(torch.tensor(big_delta, device=dev), 8):
        state = trigger(state, matrix_chain.rank1_update(2, u, v, ring))
    sync()
    t_r8 = time.perf_counter() - t0
    engine.set_state(state)
    print(f"rank-8 update via 8 factorized deltas: {t_r8*1e3:.1f}ms "
          f"(reeval {t_re*1e3:.2f}ms)")

    # verify against float64
    m2 = mats_np[1].astype(np.float64)
    m2[row] += ROW_UPDATES * delta.astype(np.float64)
    m2 += big_delta
    expect = np.linalg.multi_dot([mats_np[0].astype(np.float64), m2,
                                  mats_np[2].astype(np.float64),
                                  mats_np[3].astype(np.float64)])
    got = matrix_chain.result_matrix(engine).cpu().numpy()
    rel_err = np.abs(got - expect).max() / np.abs(expect).max()
    print(f"incremental result relative err = {rel_err:.2e}")
    if not rel_err < 1e-4:  # fp32 accumulation over n=384 chains
        raise SystemExit(f"relative error {rel_err:.2e} above 1e-4")
    print("OK")


if __name__ == "__main__":
    main()
