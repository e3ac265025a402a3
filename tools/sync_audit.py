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
("warn")``.  Prints one JSON line a phase: the synchronising calls counted
and their sites (the innermost frame in ``repro_torch``, with its source
line).  Card only.
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


def _site() -> str:
    for frame in reversed(traceback.extract_stack()):
        if "repro_torch" in frame.filename:
            path = frame.filename[frame.filename.index("repro_torch"):]
            return f"{path}:{frame.lineno} {frame.line}"
    return "outside repro_torch"


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
        sites: Counter = Counter()

        def record(message, category, filename, lineno, file=None, line=None):
            if "called a synchronizing CUDA operation" in str(message):
                sites[_site()] += 1

        with plan.use_fusion(fusion), scatter_ops.use_backend(backend):
            eng = IVMEngine.build(q, db, var_order=synth.retailer_vo(),
                                  strategy="fivm", storage="dense", device="cuda")
            eng.precompile(BATCH)
            for rel, upd in stream[:len(rels)]:
                eng.apply_update(rel, upd)
            torch.cuda.synchronize()
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = record
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    for rel, upd in stream[len(rels):]:
                        eng.apply_update(rel, upd)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
        print(json.dumps(dict(root=str(tree), phase=label, batches=len(rels),
                              syncs=sum(sites.values()), sites=dict(sites))),
              flush=True)
        del eng, db, stream
        torch.cuda.empty_cache()


def main(argv) -> int:
    if argv[:1] == ["--worker"]:
        worker(Path(argv[1]).resolve())
        return 0
    for tree in argv or [str(ROOT)]:
        subprocess.run([sys.executable, __file__, "--worker", tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
