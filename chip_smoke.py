#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the repository root with one card visible:

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):

1. Device: the card's name and power limit from nvidia-smi, then a build of
   all five CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together).
2. Kernels: each kernel against its plain PyTorch version on integer-valued
   float32 at the shapes the main path gives it (bitwise), timed with CUDA
   events and the profiler beside its plain version, a one-call PyTorch
   yardstick (``library_ms``, never used by the port) and its bound.
3. Paths, each through ``IVMEngine.apply_update`` (fivm, dense) at
   ``RETAILER_DOMS_BIG`` with batches of 1000 tuples, checked against a
   float64 re-evaluation, with every kernel's launch count reset before
   and read after it:
   - the retailer sum-aggregate and degree-m cofactor (m = 10) streams with
     plan fusion off (``scatter_add``, ``segment_ring_sum``,
     ``gather_mul_scatter``), 20 batches each;
   - the same two streams with fusion ``auto`` (on, on the card), where
     every fused chain is one ``fused_chain`` launch, 20 batches each;
   - a short sum stream under the ``scatter_dedup`` ⊎ backend.

The last line is ``{"ok": true, "device": {...}}``; the line before it lists
every kernel with its numbers.  Imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
BATCH = 1000
N_BATCHES = 20
SEED = 0
REPS = 50
#: the f32 engine is held to the f64 oracle bitwise where every oracle
#: value of a view is below 2**24 (each sum is then exact in float32);
#: otherwise within RTOL of the view's largest magnitude, because float32
#: sums of that size round at ~6e-8 per add and the engine adds in another
#: order than the oracle (einsum blocking, atomics).  One lost or doubled
#: batch of 1000 tuples moves these views by >= 3e-4 of their magnitude.
EXACT_LIMIT = 2.0 ** 24
RTOL = 1e-5


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def time_ms(fn, reps: int = REPS, warmup: int = 5) -> float:
    """Median device time of one ``fn()`` call over ``reps`` calls, each
    between its own pair of CUDA events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def device_events(fn, calls: int):
    """Device-side events (kernels, copies) of ``calls`` calls of ``fn``
    under torch.profiler, and the host wall seconds of those calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA], wall


def kernel_device_ms(fn, kernel: str, calls: int = 20):
    """Mean device time of the CUDA kernel named ``kernel`` per call of
    ``fn`` (the kernel alone, without launch gaps); None when the profiler
    saw no such kernel."""
    events, _ = device_events(fn, calls)
    mine = [e for e in events if kernel in e.name]
    if not mine:
        return None
    return sum(e.time_range.elapsed_us() for e in mine) / 1e3 / calls


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ints(rng, shape, lo=-4, hi=5):
    import torch

    return torch.tensor(rng.integers(lo, hi, size=shape).astype(np.float32),
                        device="cuda")


def ids_tensor(arr):
    import torch

    return torch.tensor(np.asarray(arr).astype(np.int32), device="cuda")


def check_equal(name: str, got, want) -> float:
    import torch

    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"(max abs err {err})")
    return err


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def kernel_phase(rng) -> dict:
    import torch
    from repro_torch.kernels import ref, scatter_ops
    from repro_torch.kernels.ring_scatter import gather_mul_scatter, scatter_add
    from repro_torch.kernels.segment_ring_sum import segment_ring_sum

    rows = {"scatter_add": [], "segment_ring_sum": [], "gather_mul_scatter": [],
            "scatter_dedup": [], "fused_chain": []}
    B = BATCH

    for S in (256, 6144, 1_179_648):
        for d in (1, 111):
            view = ints(rng, (S, d))
            vals = ints(rng, (B, d))
            ids_np = rng.integers(0, S, size=B)
            # correctness: padding (-1) and out-of-range rows must drop
            pad_np = ids_np.copy()
            pad_np[:8], pad_np[8:16] = -1, S + 3
            err = check_equal(
                f"scatter_add S={S} d={d}",
                scatter_add(view.clone(), ids_tensor(pad_np), vals),
                ref.scatter_add_ref(view.clone(), ids_tensor(pad_np), vals))
            ids = ids_tensor(ids_np)
            ids64 = ids.long()
            work = view.clone()
            u = len(np.unique(ids_np))
            bms, by = bound_ms(B * 4 + B * d * 4 + 2 * u * d * 4, B * d)
            row = dict(
                shape=dict(S=S, d=d, B=B), max_abs_err=err,
                kernel_ms=time_ms(lambda: scatter_add(work, ids, vals)),
                device_ms=kernel_device_ms(lambda: scatter_add(work, ids, vals),
                                           "scatter_add_kernel"),
                plain_ms=time_ms(lambda: ref.scatter_add_ref(work, ids, vals)),
                library_ms=time_ms(lambda: work.index_add_(0, ids64, vals)),
                bound_ms=bms, bound_by=by,
                # the two ⊎ paths the dispatch chooses between at this shape
                path_scatter_ms=time_ms(lambda: scatter_ops.scatter_add_flat(
                    work, ids, vals, backend="scatter")),
                path_compact_ms=time_ms(lambda: scatter_ops.scatter_add_flat(
                    work, ids, vals, backend="compact")))
            rows["scatter_add"].append(row)
            log({"kernel": "scatter_add", **row})
            del view, work

    for d in (1, 111):
        # local ranks of a batch's keys, as the compact path passes them
        keys = rng.integers(0, 6144, size=B)
        rank_np = np.unique(keys, return_inverse=True)[1]
        vals = ints(rng, (B, d))
        ids = ids_tensor(rank_np)
        pad = ids.clone()
        pad[:8] = -1
        err = check_equal(f"segment_ring_sum d={d}",
                          segment_ring_sum(vals, pad, B),
                          ref.segment_ring_sum_ref(vals, pad, B))
        ids64 = ids.long()
        bms, by = bound_ms(B * 4 + B * d * 4 + B * d * 4, B * d)
        row = dict(
            shape=dict(S=B, d=d, B=B), max_abs_err=err,
            kernel_ms=time_ms(lambda: segment_ring_sum(vals, ids, B)),
            device_ms=kernel_device_ms(lambda: segment_ring_sum(vals, ids, B),
                                       "segment_ring_sum_kernel"),
            plain_ms=time_ms(lambda: ref.segment_ring_sum_ref(vals, ids, B)),
            library_ms=time_ms(lambda: torch.zeros(
                (B, d), device="cuda").index_add_(0, ids64, vals)),
            bound_ms=bms, bound_by=by)
        rows["segment_ring_sum"].append(row)
        log({"kernel": "segment_ring_sum", **row})

    for S, Sg in ((96, 32), (96, 9216), (9216, 128)):
        d = 1
        view = ints(rng, (S, d))
        src = ints(rng, (Sg, d))
        out_np = rng.integers(0, S, size=B)
        in_np = rng.integers(0, Sg, size=B)
        scale = ints(rng, (B,), -1, 2)
        # padding: out_id -1 drops; in_id -1 clamps to row 0 under scale 0
        out_pad, in_pad, scale_pad = out_np.copy(), in_np.copy(), scale.clone()
        out_pad[:8] = -1
        in_pad[8:16] = -1
        scale_pad[8:16] = 0.0
        err = check_equal(
            f"gather_mul_scatter S={S} Sg={Sg}",
            gather_mul_scatter(view.clone(), ids_tensor(out_pad), src,
                               ids_tensor(in_pad), scale_pad),
            ref.gather_mul_scatter_ref(view.clone(), ids_tensor(out_pad), src,
                                       ids_tensor(in_pad), scale_pad))
        out_ids, in_ids = ids_tensor(out_np), ids_tensor(in_np)
        work = view.clone()
        u_in, u_out = len(np.unique(in_np)), len(np.unique(out_np))
        bms, by = bound_ms(3 * B * 4 + u_in * d * 4 + 2 * u_out * d * 4,
                           2 * B * d)
        row = dict(
            shape=dict(S=S, Sg=Sg, d=d, B=B), max_abs_err=err,
            kernel_ms=time_ms(lambda: gather_mul_scatter(
                work, out_ids, src, in_ids, scale)),
            device_ms=kernel_device_ms(lambda: gather_mul_scatter(
                work, out_ids, src, in_ids, scale), "gather_mul_scatter_kernel"),
            plain_ms=time_ms(lambda: ref.gather_mul_scatter_ref(
                work, out_ids, src, in_ids, scale)),
            # no single PyTorch call gathers, scales and scatters
            library_ms=None,
            bound_ms=bms, bound_by=by)
        rows["gather_mul_scatter"].append(row)
        log({"kernel": "gather_mul_scatter", **row})

    scatter_dedup_rows(rng, rows["scatter_dedup"])
    fused_chain_rows(rng, rows["fused_chain"])
    return rows


def scatter_dedup_rows(rng, out: list) -> None:
    """``scatter_dedup`` at the view sizes of the retailer triggers, S = 1
    (a collapsed-to-scalar view: every row one id) up to 1,179,648."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ring_scatter import scatter_add, scatter_dedup_ref

    B = BATCH
    for S in (1, 96, 9216, 1_179_648):
        for d in (1, 111):
            view = ints(rng, (S, d))
            vals = ints(rng, (B, d))
            ids_np = rng.integers(0, S, size=B)
            pad_np = ids_np.copy()
            pad_np[:8], pad_np[8:16] = -1, S + 3
            pad = ids_tensor(pad_np)
            got = scatter_add(view.clone(), pad, vals, dedup=True)
            err = check_equal(f"scatter_dedup S={S} d={d}", got,
                              scatter_dedup_ref(view.clone(), pad, vals))
            check_equal(f"scatter_dedup S={S} d={d} vs scatter_add", got,
                        ref.scatter_add_ref(view.clone(), pad, vals))
            ids = ids_tensor(ids_np)
            ids64 = ids.long()
            work = view.clone()
            u = len(np.unique(ids_np))
            bms, by = bound_ms(B * 4 + B * d * 4 + 2 * u * d * 4, B * d)

            def run():
                scatter_add(work, ids, vals, dedup=True)

            row = dict(
                shape=dict(S=S, d=d, B=B), max_abs_err=err,
                kernel_ms=time_ms(run),
                device_ms=kernel_device_ms(run, "scatter_dedup_kernel"),
                plain_ms=time_ms(lambda: scatter_dedup_ref(work, ids, vals)),
                library_ms=time_ms(lambda: work.index_add_(0, ids64, vals)),
                bound_ms=bms, bound_by=by)
            out.append(row)
            log({"kernel": "scatter_dedup", **row})
            del view, work


#: fused chains of the retailer Inventory trigger at RETAILER_DOMS_BIG:
#: (target rows S, gathered sibling-view rows or None, lift rows).  The
#: sum ring's chains have one source each (a gather, else the units lift);
#: the cofactor ring's lift every marginalized variable, so its gathering
#: chains have two.
MAIN_CHAINS = ((1_179_648, None, 8), (9216, 128, 128), (96, 9216, 96),
               (1, 96, 96))


def fused_chain_rows(rng, out: list) -> None:
    """``fused_chain`` at the main path's chains, scalar and degree-10 rings:
    duplicate out ids, padding rows (out id -1 with a ring-zero value, gather
    ids out of range), the 9216-row source and a collapsed-to-scalar target
    (S = 1), each checked with and without the per-row product output."""
    import torch
    from repro_torch.kernels.ring_fused import (fused_apply, fused_apply_ref,
                                                spec_width)

    B = BATCH
    for spec in (("scalar",), ("degree", 10)):
        d = spec_width(spec)
        m = 0 if spec[0] == "scalar" else spec[1]
        for S, gathered, lift in MAIN_CHAINS:
            if spec[0] == "scalar":
                src_rows = (gathered or lift,)
            else:
                src_rows = (lift,) if gathered is None else (gathered, lift)
            view = ints(rng, (S, d))
            vals = ints(rng, (B, d), -2, 3)
            out_np = rng.integers(0, S, size=B)
            sources, in_nps = [], []
            for Sg in src_rows:
                in_np = rng.integers(0, Sg, size=B)
                in_nps.append(in_np)
                sources.append((ints(rng, (Sg, d), -2, 3), ids_tensor(in_np)))
            # padding rows: out id -1, ring-zero value, gather ids -1 / >= Sg
            pad_out, pad_vals = out_np.copy(), vals.clone()
            pad_out[:8] = -1
            pad_vals[:8] = 0.0
            pad_sources = []
            for (plane, _), in_np in zip(sources, in_nps):
                pad_in = in_np.copy()
                pad_in[:4], pad_in[4:8] = -1, plane.shape[0] + 5
                pad_sources.append((plane, ids_tensor(pad_in)))
            prods = [torch.empty_like(vals) for _ in range(2)]
            label = f"fused_chain {spec} S={S} sources={src_rows}"
            got = fused_apply(view.clone(), ids_tensor(pad_out), pad_vals,
                              pad_sources, spec, product_out=prods[0])
            want = fused_apply_ref(view.clone(), ids_tensor(pad_out), pad_vals,
                                   pad_sources, spec, product_out=prods[1])
            err = check_equal(label, got, want)
            check_equal(label + " product", prods[0], prods[1])
            out_ids = ids_tensor(out_np)
            work = view.clone()
            # bound: values, out ids and every source's ids read once, each
            # distinct gathered row once, touched view rows read and written;
            # per source and row 1 + 3m + 7m² flops (d for the scalar ring)
            # and one add per element for the ⊎
            u_out = len(np.unique(out_np))
            u_src = sum(len(np.unique(x)) for x in in_nps)
            nbytes = (B * d * 4 + B * 4 * (1 + len(sources)) + u_src * d * 4
                      + 2 * u_out * d * 4)
            flops_row = d if m == 0 else 1 + 3 * m + 7 * m * m
            bms, by = bound_ms(nbytes, len(sources) * B * flops_row + B * d)

            def run():
                fused_apply(work, out_ids, vals, sources, spec)

            row = dict(
                shape=dict(S=S, Sg=list(src_rows), d=d, B=B), max_abs_err=err,
                kernel_ms=time_ms(run),
                device_ms=kernel_device_ms(run, "fused_chain_kernel"),
                plain_ms=time_ms(lambda: fused_apply_ref(
                    work, out_ids, vals, sources, spec)),
                # no single PyTorch call gathers, multiplies in the ring and
                # scatters
                library_ms=None,
                bound_ms=bms, bound_by=by)
            out.append(row)
            log({"kernel": "fused_chain", **row})
            del view, work


# ---------------------------------------------------------------------------
# Phase 3: the main path, checked against a float64 oracle
# ---------------------------------------------------------------------------
def compare_views(label: str, eng, store) -> dict:
    import torch

    worst = {"bitwise_views": 0, "tolerance_views": 0, "max_rel_err": 0.0}
    for name in sorted(eng.materialized_names):
        got_rel = eng.views[name]
        want_rel = store[name].transpose(got_rel.schema)
        for comp in got_rel.ring.components:
            got = got_rel.payload[comp].double()
            want = want_rel.payload[comp]
            if not torch.isfinite(got).all():
                raise AssertionError(f"{label} {name}.{comp}: non-finite values")
            scale = float(want.abs().max()) if want.numel() else 0.0
            if scale < EXACT_LIMIT:
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"{label} {name}.{comp}: differs from the oracle "
                        f"(max abs err {float((got - want).abs().max())})")
                worst["bitwise_views"] += 1
            else:
                rel = float((got - want).abs().max()) / scale
                if rel > RTOL:
                    raise AssertionError(f"{label} {name}.{comp}: relative "
                                         f"error {rel} > {RTOL}")
                worst["tolerance_views"] += 1
                worst["max_rel_err"] = max(worst["max_rel_err"], rel)
    return worst


def stream_phase(label, query, query64, db, doms, rng, kernels, expected,
                 fusion="off", backend=None, n_batches=N_BATCHES,
                 device="cuda", batch=BATCH):
    """Build a fivm engine under the given plan-fusion mode and ⊎ backend,
    time the update stream through it, read the kernels' launch counts,
    and hold the result to a float64 oracle."""
    from repro_torch.core import plan
    from repro_torch.kernels import scatter_ops

    with plan.use_fusion(fusion), scatter_ops.use_backend(backend):
        out = _stream_phase(label, query, query64, db, doms, rng, kernels,
                            expected, n_batches, device, batch)
    log(out)
    return out


def _chain_report(eng) -> dict:
    """Fused chains in the engine's plans, and those that gather a plane of
    more than 4096 rows (the reference's MAX_FUSED_PLANE, a TPU VMEM bound
    under which it keeps such a chain unfused)."""
    from repro_torch.core import plan

    chains = [op for p in eng.plans.plans.values() for op in p.ops
              if isinstance(op, plan.FusedChain)]
    big = sorted({f"{c.writes[0]}<-{v}" for c in chains for v in c.reads
                  if math.prod(eng.views[v].domains) > 4096})
    return dict(fused_chains=len(chains), beyond_tpu_plane_bound=big,
                smem_bytes=sorted({c.smem_bytes for c in chains}))


def _stream_phase(label, query, query64, db, doms, rng, kernels, expected,
                  n_batches, device, batch):
    import torch
    from repro_torch.core import DenseRelation, IVMEngine, evaluate_view, plan
    from repro_torch.data.synth import RETAILER_RELATIONS, retailer_vo, update_stream

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = IVMEngine.build(query, db, var_order=retailer_vo(), strategy="fivm",
                          storage="dense", device=device)
    eng.precompile(batch)
    sync()
    build_s = time.perf_counter() - t0
    stream = update_stream(RETAILER_RELATIONS, doms, query.ring, rng, batch,
                           n_batches, device=device)
    sync()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    for rel, upd in stream:
        eng.apply_update(rel, upd)
    sync()
    run_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    missing = [n for n in expected if launches[n] == 0]
    if missing:
        raise AssertionError(f"{label}: the main path never launched {missing}")
    fusion = plan.fusion_mode(eng.device)
    chains = _chain_report(eng)
    if (fusion == "on") != (chains["fused_chains"] > 0):
        raise AssertionError(f"{label}: fusion {fusion} but "
                             f"{chains['fused_chains']} fused chains")

    # oracle: the same updates into a float64 copy of the database with the
    # plain scatter, then one evaluation of the query
    db64 = {r: DenseRelation(rel.schema, query64.ring,
                             {c: v.double() for c, v in rel.payload.items()})
            for r, rel in db.items()}
    for rel, upd in stream:
        db64[rel] = db64[rel].scatter_add(
            upd.keys, {c: v.double() for c, v in upd.payload.items()},
            backend="torch")
    store: dict = {}
    evaluate_view(eng.tree, db64, query64, store=store)
    check = compare_views(label, eng, store)
    memory_bytes, plan_stats = eng.memory_bytes(), eng.plans.stats()
    del eng, db64, store
    profile = profile_stream(query, db, stream, batch, device) if on_card else None
    out = dict(
        stream=label, fusion=fusion, domains=doms, batch=batch,
        n_batches=n_batches, build_s=build_s, run_s=run_s,
        tuples_per_s=batch * n_batches / run_s,
        memory_bytes=memory_bytes,
        max_memory_allocated=torch.cuda.max_memory_allocated() if on_card else None,
        launches=launches,
        launches_per_batch={k: n / n_batches for k, n in launches.items()},
        plan_cache=plan_stats, chains=chains, oracle=check, profile=profile)
    del stream
    if on_card:
        torch.cuda.empty_cache()
    return out


def profile_stream(query, db, stream, batch, device) -> dict:
    """Where the stream's time goes: the same updates through a fresh engine
    under torch.profiler — device busy time against host wall time (the
    device's idle share) and the device time of the heaviest kernels."""
    from repro_torch.core import IVMEngine
    from repro_torch.data.synth import retailer_vo

    eng = IVMEngine.build(query, db, var_order=retailer_vo(), strategy="fivm",
                          storage="dense", device=device)
    eng.precompile(batch)
    updates = iter(stream)

    def step():
        eng.apply_update(*next(updates))

    events, wall = device_events(step, len(stream))
    by_name: dict = {}
    for e in events:
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    n_events = sum(n for _, n in by_name.values())
    return dict(wall_ms=1e3 * wall, device_busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / (1e3 * wall),
                device_events=n_events,
                device_events_per_batch=n_events / len(stream),
                top=[[name[:90], ms, n] for name, (ms, n) in top])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import Query, sum_ring
    from repro_torch.core.apps import regression
    from repro_torch.core.rings import DegreeMRing
    from repro_torch.data import synth
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.ring_fused import FUSED_CHAIN
    from repro_torch.kernels.ring_scatter import (GATHER_MUL_SCATTER, SCATTER_ADD,
                                                  SCATTER_DEDUP)
    from repro_torch.kernels.segment_ring_sum import SEGMENT_RING_SUM

    # float32 products in full precision (no TF32), as the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi.splitlines()[0])

    kernels = [SCATTER_ADD, SEGMENT_RING_SUM, GATHER_MUL_SCATTER, SCATTER_DEDUP,
               FUSED_CHAIN]
    build_s = _cuda.build_all(kernels)
    log({"build_s": build_s, "libraries": [k.library_path().name for k in kernels]})
    for k in kernels:
        text = k.library_path().with_suffix(".log")
        if text.exists():
            for line in text.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"{k.name}: {line.strip()}")

    rng = np.random.default_rng(SEED)
    rows = kernel_phase(rng)

    doms = synth.RETAILER_DOMS_BIG
    rels = synth.RETAILER_RELATIONS
    streams = []
    # sum aggregates: SUM(units) over the join; the unfused path, the fused
    # path (auto: on, on the card) and a short stream under scatter_dedup
    q = Query(relations=rels, free_vars=(), ring=sum_ring(), domains=doms,
              lifts={"units": ("value",)})
    q64 = Query(relations=rels, free_vars=(), ring=sum_ring(torch.float64),
                domains=doms, lifts={"units": ("value",)})
    rng = np.random.default_rng(SEED)
    db = synth.synth_db(rels, doms, q.ring, rng, device="cuda")
    streams.append(stream_phase("retailer_sum", q, q64, db, doms, rng, kernels,
                                ("scatter_add", "segment_ring_sum",
                                 "gather_mul_scatter")))
    streams.append(stream_phase("retailer_sum_fused", q, q64, db, doms,
                                np.random.default_rng(SEED + 1), kernels,
                                ("fused_chain",), fusion="auto"))
    streams.append(stream_phase("retailer_sum_scatter_dedup", q, q64, db, doms,
                                np.random.default_rng(SEED + 2), kernels,
                                ("scatter_dedup",), backend="scatter_dedup",
                                n_batches=5))
    del db
    torch.cuda.empty_cache()

    # degree-m cofactor ring, m = 10 (d = 111): unfused, the scalar
    # gather-⊗-⊎ is not on this path (wider rings gather, multiply, then
    # scatter); fused, every Gather→Lift→⊎ chain is one fused_chain launch
    cq = regression.cofactor_query(rels, doms)
    cq64 = regression.cofactor_query(rels, doms, dtype=torch.float64)
    if cq.ring != DegreeMRing(10):
        raise AssertionError(f"unexpected cofactor ring {cq.ring.name}")
    rng = np.random.default_rng(SEED)
    db = synth.synth_db(rels, doms, cq.ring, rng, device="cuda")
    streams.append(stream_phase("retailer_cofactor_m10", cq, cq64, db, doms,
                                rng, kernels,
                                ("scatter_add", "segment_ring_sum")))
    streams.append(stream_phase("retailer_cofactor_m10_fused", cq, cq64, db,
                                doms, np.random.default_rng(SEED + 1), kernels,
                                ("fused_chain",), fusion="auto"))
    del db
    launched = {k.name: sum(st["launches"][k.name] for st in streams)
                for k in kernels}
    if not all(launched.values()):
        raise AssertionError(f"a kernel launched on no path: {launched}")

    sources = {
        "scatter_add": ("src/repro_torch/kernels/csrc/scatter_add.cu",
                        "src/repro/kernels/ring_scatter.py:108",
                        dict(S=1_179_648, d=111, B=BATCH)),
        "segment_ring_sum": ("src/repro_torch/kernels/csrc/segment_ring_sum.cu",
                             "src/repro/kernels/segment_ring_sum.py:38",
                             dict(S=BATCH, d=111, B=BATCH)),
        "gather_mul_scatter": ("src/repro_torch/kernels/csrc/gather_mul_scatter.cu",
                               "src/repro/kernels/ring_scatter.py:170",
                               dict(S=96, Sg=9216, d=1, B=BATCH)),
        "scatter_dedup": ("src/repro_torch/kernels/csrc/scatter_dedup.cu",
                          "src/repro/kernels/ring_scatter.py:91",
                          dict(S=1_179_648, d=111, B=BATCH)),
        "fused_chain": ("src/repro_torch/kernels/csrc/fused_chain.cu",
                        "src/repro/kernels/ring_fused.py:191",
                        dict(S=96, Sg=[9216, 96], d=111, B=BATCH)),
    }
    summary = []
    for name, (source, replaces, shape) in sources.items():
        row = next(r for r in rows[name] if r["shape"] == shape)
        summary.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launched[name],
            max_abs_err=max(r["max_abs_err"] for r in rows[name]),
            ms=row["kernel_ms"], device_ms=row["device_ms"],
            plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], shape=shape))
    log({"kernels": summary})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
