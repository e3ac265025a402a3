#!/usr/bin/env python3
"""Where ``matvec``, ``flash_attention_tf32``, ``scatter_dedup``,
``fused_chain``, ``gather_mul_scatter`` and ``flash_attention``'s mma kernel
spend their time.

Builds each kernel's source as it is and in variants that cut out or
change one part of it, and times them in turns on the card (CUDA events,
the median of 20 calls, each in order and then in reverse order, averaged).
A variant is the shipped source compiled with ``-DREPRO_VARIANT=<n>``: the
kernels name their variants (``kVariant``) and are built with 0 in the
library.  Only the shipped kernel and the variants marked "checked" compute
the right result; the others show what a part costs.  Prints one JSON line
a shape:

``matvec`` at 8192 x 8192, rows layout (the TMA kernel), with the
wrapper's plan:

* ``shipped``;
* ``no_reads``: the stages' reads (the dot products) cut out: the ring,
  its bulk copies and barriers alone, the design's own ceiling.

``flash_attention_tf32`` at the LM path's prefill (4, 32, 8, 1024, 64),
causal, and at a non-causal (1, 8, 1, 1000, 64), float32, each with its
error against the float64 plain version (largest |err| over the largest
|output|):

* ``shipped``;
* ``no_split``: the producer does not split the tiles;
* ``no_compute``: the consumers release each tile unread (TMA and the
  split alone);
* ``no_pv``: S and the softmax, no PV products;
* ``ring_2_2`` (checked): two raw stages and two split slots at D = 64;
* ``o_in_tensor_cores`` (checked at D = 64): PV added into one tensor-core
  accumulator over every tile of a row, instead of a fresh one a tile.

``scatter_dedup`` at (S 1,179,648, d 111, B 1000) and ``fused_chain`` at
the degree-10 chain (S 96, sources of 9216 and 96 rows, d 111, B 1000),
integer-valued data with duplicate ids, each variant called through the
wrapper's C entry: device ms from the profiler (the kernel alone: at
B = 1000 the events ms of a call is host time), in turns:

* ``shipped`` (and ``scatter_add`` at the same shape, the same ⊎ without
  the dedup);
* ``dedup_no_dedup`` / ``chain_no_dedup``: every in-range row its own
  group (no in-tile dedup);
* ``dedup_no_reductions`` / ``chain_no_reductions``: no global atomics;
* ``chain_no_gathers``: no gather-id or source-row loads;
* ``chain_no_product``: the ring product of each source skipped.

``gather_mul_scatter`` at the summary shape (S 96, Sg 9216, d 1, B 1000),
at d = 111 with the same S and Sg, and at (S 9216, Sg 128, d 111), where
out ids rarely repeat within a tile; integer-valued data, device ms from
the profiler in turns:

* ``shipped``;
* ``gms_no_dedup``: every in-range row its own group;
* ``gms_no_reductions``: no global atomics;
* ``gms_no_gather``: no source loads (the scale alone);
* ``gms_match_any`` (checked): at d >= 2 the row's group found by
  ``__match_any_sync``, not by one vote.

``flash_attention``'s mma kernel at (4, 32, 8, 1024, 32), causal, in bf16
and float32, and at path D's reduced leg (2, 4, 2, 64, 16) in float32,
device ms from the profiler in turns, each with its error against the
float64 plain version:

* ``shipped``, and ``simt`` (the SIMT kernel of the same library);
* ``mma_no_pv``: S and the softmax, no PV;
* ``mma_no_softmax``: P = S, no max and no exponentials;
* ``mma_no_compute``: the K/V tiles staged, nothing computed;
* ``mma_one_term``: one term a product (TF32 hi·hi, bf16 P_1).

Run on a card from the repository root (all sections, or the ones
named: ``matvec``, ``flash``, ``dedup``, ``gms``, ``mma``):

    python3 tools/kernel_variants.py [section ...]
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))  # chip_smoke's profiler helpers

MATVEC_SRC = "matvec.cu"
FLASH_SRC = "flash_attention_tf32.cu"
DEDUP_SRC = "scatter_dedup.cu"
CHAIN_SRC = "fused_chain.cu"
GMS_SRC = "gather_mul_scatter.cu"
MMA_SRC = "flash_attention.cu"

#: name -> (source, REPRO_VARIANT, checked): the numbers are the kernels'
#: own kVariant constants
VARIANTS = {
    "no_reads": (MATVEC_SRC, 1, False),
    "no_split": (FLASH_SRC, 1, False),
    "no_compute": (FLASH_SRC, 2, False),
    "no_pv": (FLASH_SRC, 3, False),
    "ring_2_2": (FLASH_SRC, 4, True),
    "o_in_tensor_cores": (FLASH_SRC, 5, True),
    "dedup_no_dedup": (DEDUP_SRC, 1, False),
    "dedup_no_reductions": (DEDUP_SRC, 2, False),
    "chain_no_gathers": (CHAIN_SRC, 1, False),
    "chain_no_product": (CHAIN_SRC, 2, False),
    "chain_no_dedup": (CHAIN_SRC, 3, False),
    "chain_no_reductions": (CHAIN_SRC, 4, False),
    "gms_no_dedup": (GMS_SRC, 1, False),
    "gms_no_reductions": (GMS_SRC, 2, False),
    "gms_no_gather": (GMS_SRC, 3, False),
    "gms_match_any": (GMS_SRC, 4, True),
    "mma_no_pv": (MMA_SRC, 1, False),
    "mma_no_softmax": (MMA_SRC, 2, False),
    "mma_no_compute": (MMA_SRC, 3, False),
    "mma_one_term": (MMA_SRC, 4, False),
}
#: flash shapes (B, H, Hkv, T, D, causal)
FLASH_SHAPES = ((4, 32, 8, 1024, 64, True), (1, 8, 1, 1000, 64, False))


def build_all(names) -> dict:
    """Compile the variants (all nvcc processes at once) into
    build/kernels/variants/; returns name -> loaded library."""
    from repro_torch.kernels import _cuda

    out = _cuda.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        source, number, _ = VARIANTS[name]
        cmd = [_cuda.find_nvcc(), *_cuda.NVCC_FLAGS, f"-DREPRO_VARIANT={number}",
               "-I", str(_cuda.CSRC), "-o", str(out / f"{name}.so"), str(_cuda.CSRC / source)]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    libs = {}
    for name, proc in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{text}")
        spills = [line.strip() for line in text.splitlines() if "spill" in line]
        print(json.dumps({"variant": name, "ptxas": spills}), flush=True)
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs


def time_ms(fn, reps: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def in_turns(fns: dict) -> dict:
    times: dict = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            times[name].append(time_ms(fns[name]))
    return {name: statistics.mean(t) for name, t in times.items()}


def matvec_rows(libs) -> None:
    import torch
    from repro_torch.kernels import rank1_chain, ref

    P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    n = 8192
    rng = np.random.default_rng(0)
    A = torch.tensor(rng.standard_normal((n, n)).astype(np.float32), device="cuda")
    x = torch.tensor(rng.standard_normal(n).astype(np.float32), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sms = rank1_chain.sm_count(0)
    fn = libs["no_reads"].repro_matvec
    fn.argtypes = [P, P, I64, I64, I32, I32, I32, I64, P, P, P, P]
    y = torch.empty(n, device="cuda")
    t, rows, cols, aligned = rank1_chain.layout(A, x)
    plan = rank1_chain.matvec_plan(rows, cols, t, aligned, sms)
    assert plan.kernel == "tma", plan

    def cut():
        rc = fn(A.data_ptr(), x.data_ptr(), n, n, 0, 1, plan.blocks, 0, None, None,
                y.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"no_reads: CUDA error {rc}")

    bound = 1e3 * 4 * (n * n + 2 * n) / 3.35e12
    err = float((rank1_chain.matvec(A, x).double() - ref.matvec_ref(A, x).double())
                .abs().max())
    times = in_turns({"shipped": lambda: rank1_chain.matvec(A, x), "no_reads": cut,
                      "torch_mv": lambda: torch.mv(A, x)})
    print(json.dumps({"kernel": "matvec", "n": n, "layout": "rows", "ms": times,
                      "bound_ms": bound, "shipped_max_abs_err": err}), flush=True)


def flash_rows(libs) -> None:
    import torch
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.kernels import ref

    P, I32 = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for B, H, Hkv, T, D, causal in FLASH_SHAPES:
        rng = np.random.default_rng(T + D)
        q, k, v = (torch.tensor(rng.standard_normal(s).astype(np.float32), device="cuda")
                   for s in ((B, H, T, D), (B, Hkv, T, D), (B, Hkv, T, D)))
        want = ref.flash_attention_ref(q.double(), k.double(), v.double(), causal=causal)
        scale = float(want.abs().max())
        outs = {"shipped": lambda: tflash.flash_attention(q, k, v, causal=causal)}
        bufs = {}
        for name, lib in libs.items():
            if VARIANTS[name][0] != FLASH_SRC:
                continue
            fn = lib.repro_flash_attention_tf32
            fn.argtypes = [P, P, P, P, I32, I32, I32, I32, I32, I32, I32, I32, P]
            bufs[name] = torch.empty_like(q)

            def call(fn=fn, o=bufs[name], name=name):
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, Hkv,
                        T, T, D, D, int(causal), stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
                return o
            outs[name] = call
        errors = {}
        for name, fn in outs.items():
            got = fn()
            torch.cuda.synchronize()
            errors[name] = float((got.double() - want).abs().max()) / scale
        times = in_turns(outs)
        print(json.dumps({"kernel": "flash_attention_tf32", "shape": [B, H, Hkv, T, D],
                          "causal": causal, "ms": times, "rel_err": errors,
                          "checked": ["shipped"] + [n for n in bufs if VARIANTS[n][2]]}),
              flush=True)


def device_in_turns(fns: dict, kernel: str, others: dict | None = None) -> dict:
    """Device ms a call of the kernel named ``kernel`` (the profiler's,
    ``chip_smoke.kernel_device_ms``; ``others`` names another kernel for
    some of the functions) for each function, each in order and then in
    reverse order, averaged."""
    from chip_smoke import kernel_device_ms

    others = others or {}
    times: dict = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            times[name].append(kernel_device_ms(fns[name], others.get(name, kernel)))
    return {name: (None if None in t else statistics.mean(t)) for name, t in times.items()}


def _c_call(lib, kernel, args, name):
    """A call of ``kernel``'s C entry in the variant library ``lib`` with
    ``args`` (the wrapper's own, stream last)."""
    fn = getattr(lib, kernel.entry)
    fn.argtypes = kernel.argtypes

    def call():
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"{name}: CUDA error {rc}")
    return call


def dedup_rows(libs) -> None:
    """``scatter_dedup`` and ``fused_chain`` at the main path's summary
    shapes, shipped and cut, device ms in turns."""
    import torch
    from repro_torch.kernels import ring_fused, ring_scatter

    rng = np.random.default_rng(0)
    B = 1000

    def ints(shape, lo=-4, hi=5):
        return torch.tensor(rng.integers(lo, hi, size=shape).astype(np.float32),
                            device="cuda")

    def ids(n, hi):
        return torch.tensor(rng.integers(0, hi, size=n).astype(np.int32), device="cuda")

    stream = torch.cuda.current_stream().cuda_stream
    S, d = 1_179_648, 111
    view, vals, seg = ints((S, d)), ints((B, d)), ids(B, S)
    args = (view.data_ptr(), seg.data_ptr(), vals.data_ptr(), S, d, B,
            ring_scatter.tile_rows(d), stream)
    fns = {"shipped": lambda: ring_scatter.scatter_add(view, seg, vals, dedup=True),
           "scatter_add": lambda: ring_scatter.scatter_add(view, seg, vals)}
    for name, lib in libs.items():
        if VARIANTS[name][0] == DEDUP_SRC:
            fns[name] = _c_call(lib, ring_scatter.SCATTER_DEDUP, args, name)
    times = device_in_turns(fns, "scatter_dedup_kernel",
                            {"scatter_add": "scatter_add_kernel"})
    print(json.dumps({"kernel": "scatter_dedup", "shape": dict(S=S, d=d, B=B),
                      "device_ms": times}), flush=True)
    del view

    S, spec, rows = 96, ("degree", 10), (9216, 96)
    view, vals, out = ints((S, d)), ints((B, d), -2, 3), ids(B, S)
    sources = [(ints((r, d), -2, 3), ids(B, r)) for r in rows]
    pad = ring_fused.MAX_SOURCES - len(sources)
    args = (view.data_ptr(), out.data_ptr(), vals.data_ptr(), None, S, d, B, 10,
            len(sources), *[p.data_ptr() for p, _ in sources], *[None] * pad,
            *[i.data_ptr() for _, i in sources], *[None] * pad, *rows, *[0] * pad,
            ring_scatter.tile_rows(d), stream)
    fns = {"shipped": lambda: ring_fused.fused_apply(view, out, vals, sources, spec)}
    for name, lib in libs.items():
        if VARIANTS[name][0] == CHAIN_SRC:
            fns[name] = _c_call(lib, ring_fused.FUSED_CHAIN, args, name)
    print(json.dumps({"kernel": "fused_chain", "shape": dict(S=S, Sg=list(rows), d=d, B=B),
                      "device_ms": device_in_turns(fns, "fused_chain_kernel")}),
          flush=True)


def gms_rows(libs) -> None:
    """``gather_mul_scatter`` at the summary shape and at d = 111, shipped
    and cut or changed, device ms in turns."""
    import torch
    from repro_torch.kernels import ring_scatter

    rng = np.random.default_rng(0)
    B = 1000
    stream = torch.cuda.current_stream().cuda_stream

    def t(a):
        return torch.tensor(a, device="cuda")

    for S, Sg, d in ((96, 9216, 1), (96, 9216, 111), (9216, 128, 111)):
        view = t(rng.integers(-4, 5, size=(S, d)).astype(np.float32))
        src = t(rng.integers(-4, 5, size=(Sg, d)).astype(np.float32))
        out_ids = t(rng.integers(0, S, size=B).astype(np.int32))
        in_ids = t(rng.integers(0, Sg, size=B).astype(np.int32))
        scale = t(rng.integers(-1, 2, size=B).astype(np.float32))
        args = (view.data_ptr(), out_ids.data_ptr(), src.data_ptr(), in_ids.data_ptr(),
                scale.data_ptr(), S, Sg, d, B, ring_scatter.tile_rows(d), stream)
        fns = {"shipped": lambda: ring_scatter.gather_mul_scatter(view, out_ids, src,
                                                                  in_ids, scale)}
        for name, lib in libs.items():
            if VARIANTS[name][0] == GMS_SRC:
                fns[name] = _c_call(lib, ring_scatter.GATHER_MUL_SCATTER, args, name)
        print(json.dumps({"kernel": "gather_mul_scatter",
                          "shape": dict(S=S, Sg=Sg, d=d, B=B),
                          "device_ms": device_in_turns(fns, "gather_mul_scatter_kernel")}),
              flush=True)


def mma_rows(libs) -> None:
    """``flash_attention``'s mma kernel, shipped, cut and beside the SIMT
    kernel, device ms in turns and errors against float64."""
    import torch
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.kernels import ref

    stream = torch.cuda.current_stream().cuda_stream
    for B, H, Hkv, T, D, dt in ((4, 32, 8, 1024, 32, torch.bfloat16),
                                (4, 32, 8, 1024, 32, torch.float32),
                                (2, 4, 2, 64, 16, torch.float32)):
        rng = np.random.default_rng(T + D)
        q, k, v = (torch.tensor(rng.standard_normal(s).astype(np.float32),
                                device="cuda").to(dt)
                   for s in ((B, H, T, D), (B, Hkv, T, D), (B, Hkv, T, D)))
        want = ref.flash_attention_ref(q.double(), k.double(), v.double())
        scale = float(want.abs().max())
        outs = {"shipped": lambda: tflash.flash_attention(q, k, v),
                "simt": lambda: tflash.launch("simt", q, k, v)}
        for name, lib in libs.items():
            if VARIANTS[name][0] != MMA_SRC:
                continue
            o = torch.empty_like(q)
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, Hkv, T, T,
                    D, D, tflash.DTYPES[dt], 1, 0, stream)
            call = _c_call(lib, tflash.FLASH_ATTENTION, args, name)
            outs[name] = lambda call=call, o=o: (call(), o)[1]
        errors = {}
        for name, fn in outs.items():
            got = fn()
            torch.cuda.synchronize()
            errors[name] = float((got.double() - want).abs().max()) / scale
        del want
        times = device_in_turns(outs, "flash_attention_mma_kernel",
                                {"simt": "flash_attention_kernel"})
        print(json.dumps({"kernel": "flash_attention (mma)", "shape": [B, H, Hkv, T, D],
                          "dtype": str(dt).split(".")[1], "device_ms": times,
                          "rel_err": errors, "checked": ["shipped", "simt"]}), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    sections = {"matvec": (matvec_rows, (MATVEC_SRC,)),
                "flash": (flash_rows, (FLASH_SRC,)),
                "dedup": (dedup_rows, (DEDUP_SRC, CHAIN_SRC)),
                "gms": (gms_rows, (GMS_SRC,)),
                "mma": (mma_rows, (MMA_SRC,))}
    chosen = sys.argv[1:] or list(sections)
    unknown = set(chosen) - set(sections)
    if unknown:
        raise SystemExit(f"kernel_variants: unknown sections {sorted(unknown)}; "
                         f"one of {sorted(sections)}")
    sources = {src for name in chosen for src in sections[name][1]}
    libs = build_all([v for v, (src, _, _) in VARIANTS.items() if src in sources])
    for name in chosen:
        sections[name][0](libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
