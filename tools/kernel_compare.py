#!/usr/bin/env python3
"""Time kernels and sparse-storage paths of this tree beside another
checkout's (a parent commit's), in turns on one card.

    python3 tools/kernel_compare.py OTHER_ROOT [SECTION ...]

SECTION is any of ``gms``, ``flash``, ``hash`` and ``housing`` (default:
all four).

OTHER_ROOT is the root of the other checkout (e.g. a ``git archive`` of the
parent unpacked under ``build/``).  Each tree runs in a worker process of
its own, through its own public wrappers and its own kernel build, in the
order other, this, this, other, so drift of the card or the host falls on
both alike.  A worker prints one JSON line a shape:

* ``gather_mul_scatter`` at chip_smoke.py's GMS_SHAPES (B = 1000,
  integer-valued data, duplicate out ids): device ms a call (the
  profiler's, the kernel alone), events ms and the wrapper's host µs a
  call;
* ``flash_attention`` (causal) at path D's reduced leg (2, 4, 2, 64, 16)
  and at (4, 32, 8, 1024, 32), bf16 and float32: the kernel the tree's
  dispatch takes (its ``variant``), device ms and events ms.
* ``hash``: ``hash_insert`` (distinct ids, the route the tree's wrapper
  takes) at chip_smoke.py's S3 shape (8,192 slots holding 3,072 keys, 1,000
  ids) and rehash (2^16 ids into 2^17 slots), ``hash_probe`` (2,000 ids) at
  the S3 shape: device ms and events ms; and on a sparse relation at the S3
  shape, a claim (``fused_slot_targets`` of a [1000, 1] key matrix) and a
  sibling gather (the tree's gather rows: ``gather_rows``, or ``lookup``
  and ``torch.where``): device events and device ms a call.
* ``housing``: chip_smoke.py's housing legs S1 (the sum ring, 512 active
  postcodes, 10 batches of 64, plan fusion off and ``auto``) and S3 (the
  degree-8 cofactor ring, 3,072 active postcodes, 20 batches of 1000,
  ``auto``), each eager (``apply_update``, profiled) and graphed (the stream
  executor: a capture run, then a profiled replay-only run): device events
  a batch, device busy and wall ms, idle share.

The last line gathers every number by shape, ``other`` and ``this`` lists
in run order.  Card only.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FLASH = ((2, 4, 2, 64, 16), (4, 32, 8, 1024, 32))


SECTIONS = ("gms", "flash", "hash", "housing")


def worker(tree: Path, sections) -> None:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))  # chip_smoke's timing helpers
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    for section in sections:
        globals()[f"_{section}"](np.random.default_rng(0))


def _t(a):
    import torch

    return torch.tensor(np.asarray(a), device="cuda")


def _gms(rng) -> None:
    from chip_smoke import GMS_SHAPES, host_us, kernel_device_ms, time_ms
    from repro_torch.kernels import ring_scatter

    B, t = 1000, _t
    for S, Sg, d in GMS_SHAPES:
        view = t(rng.integers(-4, 5, size=(S, d)).astype(np.float32))
        src = t(rng.integers(-4, 5, size=(Sg, d)).astype(np.float32))
        out_ids = t(rng.integers(0, S, size=B).astype(np.int32))
        in_ids = t(rng.integers(0, Sg, size=B).astype(np.int32))
        scale = t(rng.integers(-1, 2, size=B).astype(np.float32))

        def run():
            ring_scatter.gather_mul_scatter(view, out_ids, src, in_ids, scale)

        print(json.dumps({"kernel": "gather_mul_scatter", "shape": [S, Sg, d, B],
                          "device_ms": kernel_device_ms(run, "gather_mul_scatter_kernel"),
                          "events_ms": time_ms(run), "host_us": host_us(run)}), flush=True)


def _flash(rng) -> None:
    import torch
    from chip_smoke import FLASH_KERNEL_NAMES, kernel_device_ms, time_ms
    from repro_torch.kernels import flash_attention as tflash

    t = _t
    for B_, H, Hkv, T, D in FLASH:
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (t(rng.standard_normal(s).astype(np.float32)).to(dt)
                       for s in ((B_, H, T, D), (B_, Hkv, T, D), (B_, Hkv, T, D)))
            kind = tflash.variant(dt, D)

            def run():
                tflash.flash_attention(q, k, v)

            print(json.dumps({"kernel": "flash_attention", "variant": kind,
                              "shape": [B_, H, Hkv, T, D, str(dt).split(".")[1]],
                              "device_ms": kernel_device_ms(run, FLASH_KERNEL_NAMES[kind]),
                              "events_ms": time_ms(run)}), flush=True)


def _hash(rng) -> None:
    import torch
    from chip_smoke import (HASH_B, HASH_C, HASH_KEYS, HASH_REHASH_B, HASH_REHASH_C,
                            all_device_ms, device_events, kernel_device_ms, time_ms)
    from repro_torch.core import storage, sum_ring
    from repro_torch.kernels import hash_table

    for C, n_keys, B in ((HASH_C, HASH_KEYS, HASH_B), (HASH_REHASH_C, 0, HASH_REHASH_B)):
        keys = rng.choice(1 << 22, size=n_keys + B, replace=False).astype(np.int32)
        table = torch.full((C,), -1, dtype=torch.int32, device="cuda")
        hash_table.insert_ref(table, _t(keys[:n_keys]))
        ids = _t(keys[n_keys:])
        work = table.clone()

        def insert():
            work.copy_(table)
            hash_table.hash_insert(work, ids)

        print(json.dumps({"kernel": "hash_insert", "shape": [C, n_keys, B],
                          "device_ms": kernel_device_ms(insert, "insert_kernel"),
                          "events_ms_with_copy": time_ms(insert)}), flush=True)
        if n_keys:
            hash_table.insert_ref(table, ids)
            queries = torch.cat([ids, _t(rng.integers(0, 1 << 22, size=B).astype(np.int32))])

            def probe():
                hash_table.hash_probe(table, queries)

            print(json.dumps({"kernel": "hash_probe", "shape": [C, n_keys, 2 * B],
                              "device_ms": kernel_device_ms(probe, "hash_probe_kernel"),
                              "events_ms": time_ms(probe)}), flush=True)
    # the call sites on a sparse relation at the S3 shape
    rel = storage.SparseRelation.zeros(("pc",), sum_ring(), (1 << 22,), capacity=HASH_C,
                                       device="cuda")
    keys = rng.choice(1 << 22, size=2 * HASH_KEYS, replace=False).astype(np.int32)
    rel.scatter_add(_t(keys[:HASH_KEYS, None]), {"v": torch.ones(HASH_KEYS, device="cuda")})
    kmat = _t(rng.choice(keys, size=HASH_B)[:, None])
    gather_rows = getattr(rel, "gather_rows", None)

    def gather():
        if gather_rows is not None:
            return gather_rows(kmat)
        slot, found = rel.lookup(kmat)
        return torch.where(found, slot, rel.capacity)

    for name, fn in (("claim", lambda: rel.fused_slot_targets(kmat)), ("gather", gather)):
        fn()
        print(json.dumps({"kernel": f"sparse_{name}", "shape": [HASH_C, HASH_KEYS, HASH_B],
                          "device_events": len(device_events(fn, 1)[0]),
                          "device_ms": all_device_ms(fn), "events_ms": time_ms(fn)}),
              flush=True)


def _housing(rng) -> None:
    import torch
    from chip_smoke import (HOUSING_LEGS, SEED, _busy, device_events, housing_query,
                            housing_stream)
    from repro_torch.core import IVMEngine, StreamExecutor, plan, prepare_stream
    from repro_torch.data.synth import (HOUSING_DOMS_BIG, HOUSING_RELATIONS, housing_vo,
                                        synth_low_fill_db)

    for label, ring, n_active, pool_n, batch, n_batches, fusions in HOUSING_LEGS:
        if label.startswith("S2"):
            continue
        q = housing_query(ring, HOUSING_DOMS_BIG)
        db, active = synth_low_fill_db(HOUSING_RELATIONS, HOUSING_DOMS_BIG, q.ring,
                                       np.random.default_rng(SEED), "pc", n_active,
                                       device="cuda")
        stream = housing_stream(q, np.sort(active), batch, n_batches, SEED + 1)
        for fusion in fusions:
            with plan.use_fusion(fusion):
                out = {}
                eng = IVMEngine.build(q, db, var_order=housing_vo(), strategy="fivm",
                                      device="cuda")
                eng.precompile(batch)
                updates = iter(stream)
                events, wall = device_events(lambda: eng.apply_update(*next(updates)),
                                             len(stream))
                out["eager"] = _busy(events, wall)
                del eng
                eng = IVMEngine.build(q, db, var_order=housing_vo(), strategy="fivm",
                                      device="cuda")
                ex = StreamExecutor(eng)
                prepared = prepare_stream(eng, stream)
                ex.run(prepared)
                events, wall = device_events(lambda: ex.run(prepared, donate_input=True), 1)
                out["graphed"] = _busy(events, wall)
                ex.release()
                del eng, ex, prepared
                torch.cuda.empty_cache()
            for kind, prof in out.items():
                print(json.dumps({"kernel": f"housing_{kind}",
                                  "shape": [label, f"fusion_{fusion}", batch, n_batches],
                                  "device_events_per_batch": prof["device_events"] / n_batches,
                                  "device_busy_ms": prof["device_busy_ms"],
                                  "wall_ms": prof["wall_ms"],
                                  "idle_share": prof["idle_share"]}), flush=True)
        del db, stream
        torch.cuda.empty_cache()


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        worker(Path(sys.argv[2]).resolve(), sys.argv[3:] or SECTIONS)
        return 0
    if len(sys.argv) < 2 or any(a not in SECTIONS for a in sys.argv[2:]):
        raise SystemExit(__doc__)
    other = Path(sys.argv[1]).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    runs: dict = {}
    for label, tree in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
        out = subprocess.run([sys.executable, __file__, "--worker", str(tree),
                              *sys.argv[2:]], capture_output=True, text=True)
        if out.returncode:
            raise SystemExit(f"worker {label} ({tree}) failed:\n{out.stdout}\n{out.stderr}")
        for line in out.stdout.splitlines():
            if not line.startswith("{"):
                continue
            row = json.loads(line)
            print(json.dumps({"tree": label, **row}), flush=True)
            key = json.dumps([row["kernel"], row["shape"]])
            entry = runs.setdefault(key, {"other": [], "this": []})
            entry[label].append({k: v for k, v in row.items()
                                 if k not in ("kernel", "shape")})
    print(json.dumps({"compare": {k: v for k, v in runs.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
