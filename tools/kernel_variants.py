#!/usr/bin/env python3
"""Where ``matvec``, ``flash_attention_tf32``, ``scatter_dedup``,
``fused_chain``, ``gather_mul_scatter``, ``flash_attention``'s mma kernel and
the wgmma and TF32 flash kernels' MLA and (256, 256) instances spend their
time.

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

MLA's three kernels at (D, Dv) = (192, 128) (section ``mla``): the bf16
forward ``flash_attention_wgmma.cu`` at G2's prefill (4, 128, 128, 1024),
causal, the float32 backward ``flash_attention_bwd_tf32.cu`` at G1's
(1, 128, 128, 1024), causal, and the bf16 backward
``flash_attention_bwd_wgmma.cu`` at G3's (4, 128, 128, 1024), causal
(alone: section ``mla_bf16_bwd``), device ms from the profiler in turns
(the backwards' dq and dkdv kernels each), errors against float64 for the
shipped and checked builds, and two shipped calls bitwise equal; each
function's events ms in turns beside them (the profiler at times lists 19
of a window's 20 kernels, window after window, and then has no device ms):

* ``shipped``, and ``parent``: the same C entry built from another
  checkout's source (``--other ROOT``, e.g. a parent's ``git archive``
  under ``build/``; its entries' arguments read from its source), when
  given;
* forward ``shipped_lse``: the forward that also writes L (its o bitwise
  to ``shipped``'s); ``fwd_no_pv``: S, the softmax and the split, no PV;
  ``fwd_no_split``: P as one bf16 term; ``fwd_no_softmax``: P = S;
  ``fwd_no_compute``: the K/V tiles staged, nothing computed;
* float32 backward ``bwd_no_split``: the producer writes no hi/lo or
  transposed copies; ``bwd_no_compute``: the consumers release each tile
  unread; ``bwd_dq_pass1``: the dq kernel's first pass alone (its dkdv
  kernel as shipped); ``bwd_dk_only`` / ``bwd_dv_only``: the dkdv kernel's
  dK or dV work alone;
* bf16 backward, given the forward's L as autograd runs it (``shipped``;
  ``shipped_no_lse`` without it), beside SDPA's backward (``sdpa``, every
  kernel and copy of ``torch.autograd.grad``), each cut's registers and
  local memory (``tools/sass_report.py``): ``bf16_bwd_no_compute``: the
  consumers release each tile unread; ``bf16_bwd_dq_pass1`` (without L):
  the dq kernel's first pass alone; ``bf16_bwd_no_exchange``: Pᵀ not
  handed from the dkdv kernel's Sᵀ warpgroup to its dPᵀ one;
  ``bf16_bwd_no_softmax``: P = S; ``bf16_bwd_reg_probe`` (checked): one
  dkdv warpgroup does all the work, 208 registers of sums and fragments,
  to read what ptxas gives a consumer past ``setmaxnreg.inc 240``.

With ``--other ROOT`` the section also times against ROOT's builds in turns
(ROOT, this, this, ROOT), each pair's outputs compared bitwise: MLA's
instance of ``flash_attention_tf32.cu`` (float32 forward, (1, 128, 128,
1024)), and the D 64 and D 128 instances of the three sources: the bf16
forward and backward at (4, 32, 8, 1024, 64) and (1, 8, 2, 257, 128), the
float32 backward at the same shapes, causal; and it prints whether each
kernel instance of the four tensor-core sources has ROOT's
``sass_report`` line (``_sass_instances``).

Section ``bwd_d64_d128`` (``bwd_d64_d128_rows``): the attention backward
at head dims 64 and 128 in both routes, at llama3.2-1b's microbatch (4, 32,
8, 1024, 64) and moonshot-v1-16b-a3b's (4, 16, 16, 1024, 128), causal: the
shipped build given the forward's L (as autograd runs it) and without it,
the parent's build (``--other``), SDPA's backward and the cuts of
BWD_D64_D128_CUTS (``*_no_compute``, ``*_dq_pass1``, ``bf16_bwd_no_softmax``,
``bwd_no_split``, ``bf16_bwd_no_exchange`` at 128, and ``*_head_major``,
a head's tiles on ``blockIdx.x``, held bitwise to the shipped build), dq
and dkdv apart, with the bounds (``exp_bound_ms`` among them); then the
forwards with and without L beside the parent's, and with ``--other``
every kernel instance of the four tensor-core sources against the
parent's build (``sass_report`` lines; a (192, 128) instance that differs
leaves its SASS diff under ``build/sass_diff/``).

Section ``d256`` (``d256_rows``): the bf16 forward at (256, 256) with the
prefix-LM mask (paligemma-3b) at ``chip_smoke.py``'s two VLM_FWD_CASES,
(4, 8, 1, 384) and (1, 8, 1, 2048) with P 256: this tree's build without
and with L, the parent's build (``--other ROOT``) and the cuts of
D256_CUTS, device ms in turns beside SDPA's device ms with the mask as a
boolean ``attn_mask``, events ms in turns, errors against float64
(``check_flash``'s gate), L against the plain version's, two calls bitwise,
o bitwise with L and to the parent's, the bound and each build's grid
(from the profiler's trace, ``chip_smoke.trace_kernels``); before the shapes each build's (256, 256) ``sass_report`` lines (registers,
spills), after each shape block (0, 0)'s clock stamps (the ``d256_stamps``
build: the cycles of each part of a tile for each consumer), and after the
shapes the other bf16 instances (D256_OTHERS) in turns against the
parent's build and every instance's SASS against the parent's.  The cuts
are ``fwd_no_pv``, ``fwd_no_split``, ``fwd_no_softmax`` and
``fwd_no_compute``, as for MLA's instance (above).

Section ``d256_bwd`` (``d256_bwd_rows``): the attention backward at (256,
256) with the prefix-LM mask in both routes at D256_BWD_SHAPES (P 256):
given the forward's L and without, beside SDPA's backward with the mask as
a boolean ``attn_mask``, dq and dkdv apart, errors against float64, two
calls bitwise, the bounds and the (256, 256) instances' ``sass_report``
lines; with ``--other`` the other backward instances (D256_BWD_OTHERS:
E3's, moonshot's and MLA's shapes, no prefix) against the parent's build
in turns, outputs bitwise, and every instance's SASS against the parent's.

Run on a card from the repository root (all sections, or the ones
named: ``matvec``, ``flash``, ``dedup``, ``gms``, ``mma``, ``mla``,
``mla_bf16_bwd``, ``bwd_d64_d128``, ``d256``, ``d256_bwd``):

    python3 tools/kernel_variants.py [section ...] [--other ROOT]
"""
from __future__ import annotations

import ctypes
import json
import re
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
MLA_FWD_SRC = "flash_attention_wgmma.cu"
MLA_BWD_SRC = "flash_attention_bwd_tf32.cu"
#: the other sources of MLA's (192, 128) instances, timed beside a parent's
MLA_TF32_FWD_SRC = "flash_attention_tf32.cu"
MLA_BF16_BWD_SRC = "flash_attention_bwd_wgmma.cu"

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
    "fwd_no_pv": (MLA_FWD_SRC, 1, False),
    "fwd_no_split": (MLA_FWD_SRC, 2, False),
    "fwd_no_softmax": (MLA_FWD_SRC, 3, False),
    "fwd_no_compute": (MLA_FWD_SRC, 4, False),
    "d256_stamps": (MLA_FWD_SRC, 5, True),
    "bwd_no_split": (MLA_BWD_SRC, 1, False),
    "bwd_no_compute": (MLA_BWD_SRC, 2, False),
    "bwd_dq_pass1": (MLA_BWD_SRC, 3, False),
    "bwd_dk_only": (MLA_BWD_SRC, 4, False),
    "bwd_dv_only": (MLA_BWD_SRC, 5, False),
    "bf16_bwd_no_compute": (MLA_BF16_BWD_SRC, 1, False),
    "bf16_bwd_dq_pass1": (MLA_BF16_BWD_SRC, 2, False),
    "bf16_bwd_no_exchange": (MLA_BF16_BWD_SRC, 3, False),
    "bf16_bwd_no_softmax": (MLA_BF16_BWD_SRC, 4, False),
    "bf16_bwd_reg_probe": (MLA_BF16_BWD_SRC, 5, True),
    "bf16_bwd_head_major": (MLA_BF16_BWD_SRC, 6, True),
    "bwd_head_major": (MLA_BWD_SRC, 6, True),
}
#: section ``bwd_d64_d128``: its shapes (B, H, Hkv, T, D), causal, E3's
#: microbatch (llama3.2-1b) and moonshot-v1-16b-a3b's attention at T 1024,
#: and the cuts it times at D 64/128 by dtype (``bf16_bwd_no_exchange`` where
#: the dkdv warpgroups split by product: D 128)
BWD_D64_D128_SHAPES = ((4, 32, 8, 1024, 64), (4, 16, 16, 1024, 128))
BWD_D64_D128_CUTS = {
    "bfloat16": ("bf16_bwd_no_compute", "bf16_bwd_dq_pass1", "bf16_bwd_no_softmax",
                 "bf16_bwd_no_exchange", "bf16_bwd_head_major"),
    "float32": ("bwd_no_split", "bwd_no_compute", "bwd_dq_pass1", "bwd_head_major")}
#: the C entries' argument kinds in the ``--other`` tree's tensor-core
#: sources (``entry_argtypes``), by build: ``fwd``, ``bwd_wgmma``, ``tf32``,
#: ``bwd_tf32``
PARENT_ARGTYPES: dict = {}
#: flash shapes (B, H, Hkv, T, D, causal)
FLASH_SHAPES = ((4, 32, 8, 1024, 64, True), (1, 8, 1, 1000, 64, False))
#: section ``d256``: chip_smoke's two VLM_FWD_CASES at (256, 256), (B, H,
#: Hkv, T, prefix): paligemma-3b's L2 prefill and a long one; the cuts it
#: times (``fwd_*`` cut the (256, 256) instance too)
D256_SHAPES = ((4, 8, 1, 384, 256), (1, 8, 1, 2048, 256))
D256_CUTS = ("fwd_no_pv", "fwd_no_split", "fwd_no_softmax", "fwd_no_compute")
#: the build whose L instance stamps block (0, 0)'s tiles (``_d256_stamps``)
D256_STAMPS = "d256_stamps"
#: section ``d256``: the other bf16 instances of the source, (B, H, Hkv, T,
#: D, Dv), causal: E3's (64, 64), moonshot's (128, 128) and MLA's G2 prefill
D256_OTHERS = ((4, 32, 8, 1024, 64, 64), (4, 16, 16, 1024, 128, 128),
               (4, 128, 128, 1024, 192, 128))
#: section ``d256_bwd``: the (256, 256) backward at chip_smoke's
#: VLM_TC_BWD_CASES shape (paligemma-3b's L2 microbatch), (B, H, Hkv, T, P)
D256_BWD_SHAPES = ((4, 8, 1, 384, 256),)
#: section ``d256_bwd``: the other tensor-core backward instances, (B, H, Hkv,
#: T, D, Dv), causal, with no prefix against the parent's build: E3's (64,
#: 64), moonshot's (128, 128) and MLA's G3 (192, 128)
D256_BWD_OTHERS = ((4, 32, 8, 1024, 64, 64), (4, 16, 16, 1024, 128, 128),
                   (4, 128, 128, 1024, 192, 128))
#: the parent builds of each section that takes ``--other``
PARENT_BUILDS = {"mla": ("fwd", "bwd", "tf32", "bwd_wgmma"),
                 "mla_bf16_bwd": ("fwd", "bwd", "tf32", "bwd_wgmma"),
                 "bwd_d64_d128": ("fwd", "bwd", "tf32", "bwd_wgmma"),
                 "d256": ("fwd",),
                 "d256_bwd": ("fwd", "bwd", "tf32", "bwd_wgmma")}


def build_all(names, other: Path | None = None,
              parents=("fwd", "bwd", "tf32", "bwd_wgmma")) -> dict:
    """Compile the variants (all nvcc processes at once) into
    build/kernels/variants/, and with ``other`` (a checkout's root) that
    tree's tensor-core flash sources named in ``parents`` as ``parent_fwd``,
    ``parent_bwd`` and ``parent_bwd_wgmma`` (and, with this tree's build of
    the same, ``parent_tf32`` / ``this_tf32``); returns name -> loaded
    library."""
    from repro_torch.kernels import _cuda

    out = _cuda.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    csrc = {name: (_cuda.CSRC, *VARIANTS[name][:2]) for name in names}
    if other is not None:
        theirs = other / "src" / "repro_torch" / "kernels" / "csrc"
        builds = {"fwd": dict(parent_fwd=(theirs, MLA_FWD_SRC, 0)),
                  "bwd": dict(parent_bwd=(theirs, MLA_BWD_SRC, 0)),
                  "tf32": dict(parent_tf32=(theirs, MLA_TF32_FWD_SRC, 0),
                               this_tf32=(_cuda.CSRC, MLA_TF32_FWD_SRC, 0)),
                  "bwd_wgmma": dict(parent_bwd_wgmma=(theirs, MLA_BF16_BWD_SRC, 0))}
        for which in parents:
            csrc.update(builds[which])
    jobs = {}
    for name, (root, source, number) in csrc.items():
        cmd = [_cuda.find_nvcc(), *_cuda.NVCC_FLAGS, f"-DREPRO_VARIANT={number}",
               "-I", str(root), "-o", str(out / f"{name}.so"), str(root / source)]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    libs = {}
    if other is not None:
        from repro_torch.kernels import flash_attention as tflash

        PARENT_ARGTYPES["bwd_wgmma"] = entry_argtypes(
            theirs / MLA_BF16_BWD_SRC, tflash.FLASH_ATTENTION_BWD_WGMMA.entry)
        PARENT_ARGTYPES["bwd_tf32"] = entry_argtypes(
            theirs / MLA_BWD_SRC, tflash.FLASH_ATTENTION_BWD_TF32.entry)
        PARENT_ARGTYPES["fwd"] = entry_argtypes(theirs / MLA_FWD_SRC,
                                                tflash.FLASH_ATTENTION_WGMMA.entry)
        PARENT_ARGTYPES["tf32"] = entry_argtypes(theirs / MLA_TF32_FWD_SRC,
                                                 tflash.FLASH_ATTENTION_TF32.entry)
    for name, proc in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{text}")
        spills = [line.strip() for line in text.splitlines()
                  if "spill" in line or "wgmma" in line]
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
            fn.argtypes = tflash.FLASH_ATTENTION_TF32.argtypes
            bufs[name] = torch.empty_like(q)

            def call(fn=fn, o=bufs[name], name=name):
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, B, H,
                        Hkv, T, T, D, D, int(causal), 0, stream)
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


def _c_call(lib, kernel, args, name, argtypes=None):
    """A call of ``kernel``'s C entry in the variant library ``lib`` with
    ``args`` (the wrapper's own, stream last; ``argtypes`` where the
    library's entry takes others than this tree's)."""
    fn = getattr(lib, kernel.entry)
    fn.argtypes = argtypes or kernel.argtypes

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
                    D, D, tflash.DTYPES[dt], 1, 0, 0, stream)
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


def _bwd_split(fn, calls: int = 5) -> dict:
    """Device ms a call of a backward call ``fn``: each kernel's (``dq``,
    ``dkdv``), the mean over the calls a profiled window lists of it (the
    first of up to ``chip_smoke.WINDOWS`` windows of ``calls`` calls that
    lists each at least ``calls`` − 1 times: on the H100 windows of this
    backward often list 8 of their 10 kernels, window after window), and
    their sum."""
    from chip_smoke import WINDOWS, device_events

    for _ in range(WINDOWS):
        events, _ = device_events(fn, calls)
        by_part: dict = {}
        for e in events:
            if "flash_bwd" in e.name:
                by_part.setdefault("dq" if "dq" in e.name else "dkdv", []).append(
                    e.time_range.elapsed_us() / 1e3)
        if len(by_part) == 2 and all(len(t) >= calls - 1 for t in by_part.values()):
            split = {part: statistics.mean(t) for part, t in by_part.items()}
            return {"total": sum(split.values()), **split}
    return {"total": None}


def _bwd_in_turns(fns: dict) -> dict:
    """``_bwd_split`` of each function, each in order and then in reverse
    order, averaged by part."""
    runs: dict = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            runs[name].append(_bwd_split(fns[name]))
    out = {}
    for name, parts in runs.items():
        keys = set().union(*parts)
        out[name] = {k: (None if any(p.get(k) is None for p in parts)
                         else statistics.mean(p[k] for p in parts)) for k in sorted(keys)}
    return out


def entry_argtypes(source: Path, entry: str) -> list:
    """ctypes argument kinds of the C entry ``entry`` as ``source`` declares
    it (pointers and the stream ``c_void_p``, ints ``c_int``): another
    checkout's entry may take other arguments than this tree's."""
    text = source.read_text()
    m = re.search(r'extern "C" int ' + re.escape(entry) + r"\(([^)]*)\)", text)
    if m is None:
        raise RuntimeError(f"{source} declares no C entry {entry}")
    kinds = []
    for param in m.group(1).split(","):
        param = param.strip()
        kinds.append(ctypes.c_int if param.startswith("int ") else ctypes.c_void_p)
    return kinds


def _qkv(rng, B, H, Hkv, T, D, Dv, dt):
    import torch

    return [torch.tensor(rng.standard_normal(s).astype(np.float32), device="cuda").to(dt)
            for s in ((B, H, T, D), (B, Hkv, T, D), (B, Hkv, T, Dv), (B, H, T, Dv))]


def _fwd_calls(libs, names, q, k, v, stream, kernel=None, argtypes=None) -> dict:
    """C-entry calls of the forward (``kernel``, by default the wgmma one) in
    each library of ``names`` (whose entry takes ``argtypes``, by default the
    kernel's: an entry with a fifth pointer, L's, is passed null)."""
    from repro_torch.kernels import flash_attention as tflash

    kernel = kernel or tflash.FLASH_ATTENTION_WGMMA
    argtypes = argtypes or kernel.argtypes
    no_lse = (None,) if argtypes[4] is ctypes.c_void_p else ()
    no_prefix = (0,) if argtypes.count(ctypes.c_int) == 9 else ()
    B, H, T, D = q.shape
    Hkv, Dv = k.shape[1], v.shape[3]
    calls = {}
    for name in names:
        o = q.new_empty((B, H, T, Dv))
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *no_lse, B, H, Hkv,
                T, T, D, Dv, 1, *no_prefix, stream)
        call = _c_call(libs[name], kernel, args, name, argtypes)
        calls[name] = lambda call=call, o=o: (call(), o)[1]
    return calls


def _bwd_calls(libs, names, q, k, v, o, do, stream, kernel=None, argtypes=None,
               lse=None) -> dict:
    """C-entry calls of the backward (``kernel``, by default the float32 one)
    in each library of ``names`` (whose entry takes ``argtypes``, by default
    the kernel's), given the forward's L ``lse`` where the entry takes it (a
    ninth int, ``have_lse``), with no prefix where it takes one (a tenth int
    before ``have_lse``)."""
    import torch
    from repro_torch.kernels import flash_attention as tflash

    kernel = kernel or tflash.FLASH_ATTENTION_BWD_TF32
    argtypes = argtypes or kernel.argtypes
    n_int = argtypes.count(ctypes.c_int)
    have_lse = n_int >= 9
    B, H, T, D = q.shape
    Hkv, Dv = k.shape[1], v.shape[3]
    rows = -(-T // tflash.BWD_ROWS) * tflash.BWD_ROWS
    calls = {}
    for name in names:
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        delta = torch.empty((B * H, rows), dtype=torch.float32, device="cuda")
        lse2 = torch.empty_like(delta) if lse is None or not have_lse else lse
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse2.data_ptr(),
                delta.data_ptr(), B, H, Hkv, T, T, D, Dv, 1,
                *((0,) if n_int == 10 else ()),
                *((int(lse is not None),) if have_lse else ()), stream)
        call = _c_call(libs[name], kernel, args, name, argtypes)
        calls[name] = lambda call=call, g=(dq, dk, dv): (call(), g)[1]
    return calls


def mla_rows(libs) -> None:
    """MLA's bf16 forward and float32 backward at (192, 128): shipped,
    parent and cut, device ms in turns; with a parent, the D 64/128
    instances of both sources beside the parent's."""
    import torch
    from chip_smoke import check_flash, kernel_device_ms
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.kernels import ref

    stream = torch.cuda.current_stream().cuda_stream
    parent = "parent_fwd" in libs
    rng = np.random.default_rng(0)

    q, k, v, _ = _qkv(rng, 4, 128, 128, 1024, 192, 128, torch.bfloat16)
    want = ref.flash_attention_ref(q.double(), k.double(), v.double())
    fwd = {"shipped": lambda: tflash.flash_attention(q, k, v),
           "shipped_lse": lambda: tflash.flash_attention(q, k, v, return_lse=True)[0]}
    names = [n for n in libs if VARIANTS.get(n, ("",))[0] == MLA_FWD_SRC]
    fwd.update(_fwd_calls(libs, names, q, k, v, stream))
    if parent:
        fwd["parent"] = _fwd_calls(libs, ["parent_fwd"], q, k, v, stream,
                                   argtypes=PARENT_ARGTYPES["fwd"])["parent_fwd"]
    errors = {}
    for name in ["shipped", "parent"] + [n for n in names if VARIANTS[n][2]]:
        if name in fwd:
            got = fwd[name]()
            torch.cuda.synchronize()
            errors[name] = check_flash(f"mla forward {name}", got, want, torch.bfloat16)[1]
    bitwise = torch.equal(fwd["shipped"](), fwd["shipped"]())
    lse_same_o = torch.equal(fwd["shipped"](), fwd["shipped_lse"]())
    to_parent = torch.equal(fwd["shipped"](), fwd["parent"]()) if parent else None
    del want
    times = device_in_turns(fwd, "flash_attention_wgmma")
    print(json.dumps({"kernel": "flash_attention_wgmma (192, 128)",
                      "shape": [4, 128, 128, 1024, 192, 128], "dtype": "bfloat16",
                      "device_ms": times, "events_ms": in_turns(fwd), "rel_err": errors,
                      "bitwise_repeat": bitwise, "o_bitwise_with_lse": lse_same_o,
                      "bitwise_to_parent": to_parent}), flush=True)
    del q, k, v, fwd

    q, k, v, do = _qkv(rng, 1, 128, 128, 1024, 192, 128, torch.float32)
    o = tflash.flash_attention(q, k, v)
    want = ref.flash_attention_bwd_ref(*(t.double() for t in (q, k, v, o, do)))
    bwd = {"shipped": lambda: tflash.flash_attention_bwd(q, k, v, o, do)}
    names = [n for n in libs if VARIANTS.get(n, ("",))[0] == MLA_BWD_SRC]
    bwd.update(_bwd_calls(libs, names, q, k, v, o, do, stream))
    if parent:
        bwd["parent"] = _bwd_calls(libs, ["parent_bwd"], q, k, v, o, do, stream,
                                   argtypes=PARENT_ARGTYPES["bwd_tf32"])["parent_bwd"]
    errors = {}
    for name in ["shipped", "parent"] + [n for n in names if VARIANTS[n][2]]:
        if name in bwd:
            got = bwd[name]()
            torch.cuda.synchronize()
            errors[name] = {g: float((x.double() - w).abs().max() / w.abs().max())
                            for g, x, w in zip(("dq", "dk", "dv"), got, want)}
    bitwise = all(torch.equal(a, b) for a, b in zip(bwd["shipped"](), bwd["shipped"]()))
    del want
    print(json.dumps({"kernel": "flash_attention_bwd_tf32 (192, 128)",
                      "shape": [1, 128, 128, 1024, 192, 128], "dtype": "float32",
                      "device_ms": _bwd_in_turns(bwd), "events_ms": in_turns(bwd),
                      "rel_err": errors, "bitwise_repeat": bitwise}), flush=True)
    del q, k, v, o, do, bwd
    mla_bf16_bwd_rows(libs, rng, stream)
    if not parent:
        return
    # the MLA instances of the sources this section does not cut, each tree's
    # build through its C entry
    q, k, v, do = _qkv(rng, 1, 128, 128, 1024, 192, 128, torch.float32)
    fns = {name: _fwd_calls(libs, [f"{name}_tf32"], q, k, v, stream,
                            tflash.FLASH_ATTENTION_TF32,
                            PARENT_ARGTYPES["tf32"] if name == "parent" else None)[f"{name}_tf32"]
           for name in ("parent", "this")}
    print(json.dumps({"kernel": "flash_attention_tf32 (192, 128)",
                      "shape": [1, 128, 128, 1024, 192, 128], "dtype": "float32",
                      "device_ms": device_in_turns(fns, "flash_attention_tf32"),
                      "events_ms": in_turns(fns),
                      "bitwise_to_parent": torch.equal(fns["parent"](), fns["this"]())}),
          flush=True)
    for B, H, Hkv, T, D in ((4, 32, 8, 1024, 64), (1, 8, 2, 257, 128)):
        for dt in (torch.bfloat16, torch.float32):
            q, k, v, do = _qkv(rng, B, H, Hkv, T, D, D, dt)
            if dt == torch.bfloat16:
                theirs = _fwd_calls(libs, ["parent_fwd"], q, k, v, stream,
                                    argtypes=PARENT_ARGTYPES["fwd"])["parent_fwd"]
                fns = {"parent": theirs, "this": lambda: tflash.flash_attention(q, k, v)}
                same = torch.equal(fns["parent"](), fns["this"]())
                times = device_in_turns(fns, "flash_attention_wgmma")
                kernel = "flash_attention_wgmma"
                o = tflash.flash_attention(q, k, v)
                bwd = {"parent": _bwd_calls(libs, ["parent_bwd_wgmma"], q, k, v, o, do, stream,
                                            tflash.FLASH_ATTENTION_BWD_WGMMA,
                                            PARENT_ARGTYPES["bwd_wgmma"])["parent_bwd_wgmma"],
                       "this": lambda: tflash.flash_attention_bwd(q, k, v, o, do)}
                print(json.dumps({"kernel": "flash_attention_bwd_wgmma", "shape": [B, H, Hkv, T, D],
                                  "dtype": "bfloat16", "device_ms": _bwd_in_turns(bwd),
                                  "events_ms": in_turns(bwd),
                                  "bitwise_to_parent": all(torch.equal(a, b) for a, b in zip(
                                      bwd["parent"](), bwd["this"]()))}), flush=True)
                del o, bwd
            else:
                o = tflash.flash_attention(q, k, v)
                theirs = _bwd_calls(libs, ["parent_bwd"], q, k, v, o, do, stream,
                                    argtypes=PARENT_ARGTYPES["bwd_tf32"])["parent_bwd"]
                fns = {"parent": theirs,
                       "this": lambda: tflash.flash_attention_bwd(q, k, v, o, do)}
                same = all(torch.equal(a, b) for a, b in zip(fns["parent"](), fns["this"]()))
                times = _bwd_in_turns(fns)
                kernel = "flash_attention_bwd_tf32"
            print(json.dumps({"kernel": kernel, "shape": [B, H, Hkv, T, D],
                              "dtype": str(dt).split(".")[1], "device_ms": times,
                              "events_ms": in_turns(fns), "bitwise_to_parent": same}),
                  flush=True)
            del q, k, v, do, fns
    _sass_instances(libs)


def mla_bf16_bwd_rows(libs, rng, stream) -> None:
    """MLA's bf16 backward at G3's (4, 128, 128, 1024, 192 → 128), causal:
    shipped, cut and (with ``--other``) the parent's build, device ms in
    turns by kernel (dq, dkdv) beside SDPA's backward (its device ms of
    every kernel and copy, and events ms in turns with the rest), errors
    against float64 for the shipped, parent and checked builds, two shipped
    calls bitwise equal, and what ptxas made of each cut's build
    (``tools/sass_report.py``: registers, local memory)."""
    import torch
    import torch.nn.functional as F
    from chip_smoke import all_device_ms
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.kernels import ref
    from tools.sass_report import library_reports

    kernel = tflash.FLASH_ATTENTION_BWD_WGMMA
    q, k, v, do = _qkv(rng, 4, 128, 128, 1024, 192, 128, torch.bfloat16)
    o, lse = tflash.flash_attention(q, k, v, return_lse=True)
    want = ref.flash_attention_bwd_ref(*(t.double() for t in (q, k, v, o, do)))
    bwd = {"shipped": lambda: tflash.flash_attention_bwd(q, k, v, o, do, lse=lse),
           "shipped_no_lse": lambda: tflash.flash_attention_bwd(q, k, v, o, do)}
    names = [n for n in libs if VARIANTS.get(n, ("",))[0] == MLA_BF16_BWD_SRC]
    for name in names:  # as autograd runs them, given L, but the two-pass cut
        bwd.update(_bwd_calls(libs, [name], q, k, v, o, do, stream, kernel,
                              lse=None if name == "bf16_bwd_dq_pass1" else lse))
    if "parent_bwd_wgmma" in libs:
        bwd["parent"] = _bwd_calls(libs, ["parent_bwd_wgmma"], q, k, v, o, do, stream, kernel,
                                   PARENT_ARGTYPES["bwd_wgmma"])["parent_bwd_wgmma"]
    errors = {}
    for name in ["shipped", "shipped_no_lse", "parent"] + [n for n in names if VARIANTS[n][2]]:
        if name in bwd:
            got = bwd[name]()
            torch.cuda.synchronize()
            errors[name] = {g: float((x.double() - w).abs().max() / w.abs().max())
                            for g, x, w in zip(("dq", "dk", "dv"), got, want)}
    bitwise = {name: all(torch.equal(a, b) for a, b in zip(bwd[name](), bwd[name]()))
               for name in ("shipped", "shipped_no_lse")}
    same = (all(torch.equal(a, b) for a, b in zip(bwd["parent"](), bwd["shipped_no_lse"]()))
            if "parent" in bwd else None)
    del want
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)

    def sdpa():
        torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True)

    device = _bwd_in_turns(bwd)
    device["sdpa"] = statistics.mean(all_device_ms(sdpa) for _ in range(2))
    sass = {name: [r for r in library_reports(_cuda.BUILD_DIR / "variants" / f"{name}.so")
                   if "flash_bwd" in r["function"] and "192" in r["function"]]
            for name in names}
    print(json.dumps({"kernel": "flash_attention_bwd_wgmma (192, 128)",
                      "shape": [4, 128, 128, 1024, 192, 128], "dtype": "bfloat16",
                      "device_ms": device, "events_ms": in_turns({**bwd, "sdpa": sdpa}),
                      "rel_err": errors, "bitwise_repeat": bitwise,
                      "bitwise_to_parent": same, "sass": sass}), flush=True)
    del q, k, v, o, do, bwd, qs, ks, vs, out, lse


def bwd_d64_d128_rows(libs) -> None:
    """Section ``bwd_d64_d128``: the attention backward at D 64 and 128 in
    both routes (bf16 ``flash_attention_bwd_wgmma.cu``, float32
    ``flash_attention_bwd_tf32.cu``) at BWD_D64_D128_SHAPES, causal: the
    shipped build as autograd runs it (given the forward's L where
    ``lse_route`` holds; ``shipped_no_lse`` without it there), the parent's
    build (``--other``), the cuts of BWD_D64_D128_CUTS (given L where the
    shipped build takes it, but the two-pass cuts) and SDPA's backward,
    device ms by kernel (dq, dkdv) in turns and events ms in turns; errors
    against float64 for the shipped, parent and checked builds, two shipped
    calls bitwise equal, the head-major cut bitwise to the shipped build,
    the bounds (the five products of the causal half at the dtype's tensor
    rate, one TF32 term and three; ``exp_bound_ms``, the two exp2 passes
    given L at chip_smoke's rate) and each cut's ``sass_report`` lines.
    Then the forwards at the same shapes: the no-L launch beside the
    parent's and the launch that writes L, device ms in turns, outputs
    bitwise; and with ``--other`` every instance of the four sources
    against the parent's build (``_sass_instances``)."""
    import torch
    import torch.nn.functional as F
    from chip_smoke import (BF16_OPS_PER_S, EXP_PER_CLOCK_SM, TF32_OPS_PER_S, all_device_ms,
                            sm_clock_hz)
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.kernels import ref
    from tools.sass_report import library_reports

    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(0)
    parent = "parent_bwd" in libs
    exp_rate = (EXP_PER_CLOCK_SM * torch.cuda.get_device_properties(0).multi_processor_count
                * sm_clock_hz())
    for B, H, Hkv, T, D in BWD_D64_D128_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            dtype = str(dt).split(".")[1]
            bf16 = dt == torch.bfloat16
            kernel = tflash.FLASH_ATTENTION_BWD_WGMMA if bf16 else tflash.FLASH_ATTENTION_BWD_TF32
            q, k, v, do = _qkv(rng, B, H, Hkv, T, D, D, dt)
            lse = None
            if tflash.lse_route(dt, D, D):
                o, lse = tflash.flash_attention(q, k, v, return_lse=True)
            else:
                o = tflash.flash_attention(q, k, v)
            want = ref.flash_attention_bwd_ref(*(t.double() for t in (q, k, v, o, do)))
            bwd = {"shipped": lambda: tflash.flash_attention_bwd(q, k, v, o, do, lse=lse)}
            if lse is not None:
                bwd["shipped_no_lse"] = lambda: tflash.flash_attention_bwd(q, k, v, o, do)
            if parent:
                name = "parent_bwd_wgmma" if bf16 else "parent_bwd"
                bwd["parent"] = _bwd_calls(
                    libs, [name], q, k, v, o, do, stream, kernel,
                    PARENT_ARGTYPES["bwd_wgmma" if bf16 else "bwd_tf32"])[name]
            cuts = [n for n in BWD_D64_D128_CUTS[dtype]
                    if n in libs and (n != "bf16_bwd_no_exchange" or D == 128)]
            for name in cuts:
                bwd.update(_bwd_calls(libs, [name], q, k, v, o, do, stream, kernel,
                                      lse=None if name.endswith("dq_pass1") else lse))
            errors = {}
            for name in ("shipped", "shipped_no_lse", "parent",
                         *(n for n in cuts if VARIANTS[n][2])):
                if name in bwd:
                    got = bwd[name]()
                    torch.cuda.synchronize()
                    errors[name] = {g: float((x.double() - w).abs().max() / w.abs().max())
                                    for g, x, w in zip(("dq", "dk", "dv"), got, want)}
            del want

            def equal(a, b):
                return all(torch.equal(x, y) for x, y in zip(bwd[a](), bwd[b]()))

            bitwise = {"shipped_repeat": equal("shipped", "shipped")}
            for name in cuts:  # the cuts that only reorder the grid
                if name.endswith("head_major"):
                    bitwise[f"{name}_to_shipped"] = equal(name, "shipped")
            if parent:
                bitwise["parent_to_shipped_no_lse" if lse is not None
                        else "parent_to_shipped"] = equal(
                            "parent", "shipped_no_lse" if lse is not None else "shipped")
            qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
            out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)

            def sdpa(out=out, qs=qs, ks=ks, vs=vs):
                torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True)

            device = _bwd_in_turns(bwd)
            device["sdpa"] = statistics.mean(all_device_ms(sdpa) for _ in range(2))
            pairs = B * H * T * (T + 1) // 2
            flops = 2 * pairs * 5 * D
            peak = BF16_OPS_PER_S if bf16 else TF32_OPS_PER_S
            bounds = {"products_ms": 1e3 * flops / peak,
                      "exp_bound_ms": 1e3 * 2 * pairs / exp_rate}
            if not bf16:
                bounds["tc_bound_ms"] = 3 * bounds["products_ms"]
            sass = {name: [r for r in library_reports(_cuda.BUILD_DIR / "variants" / f"{name}.so")
                           if "flash_bwd" in r["function"] and f"Li{D}ELi{D}E" in r["function"]]
                    for name in cuts}
            print(json.dumps({"kernel": kernel.name, "shape": [B, H, Hkv, T, D],
                              "dtype": dtype, "lse_route": lse is not None,
                              "device_ms": device, "events_ms": in_turns({**bwd, "sdpa": sdpa}),
                              "rel_err": errors, "bitwise": bitwise, "bounds": bounds,
                              "sass": sass}), flush=True)
            del q, k, v, o, do, lse, bwd, qs, ks, vs, out
            torch.cuda.empty_cache()
    for B, H, Hkv, T, D in BWD_D64_D128_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            bf16 = dt == torch.bfloat16
            q, k, v, _ = _qkv(rng, B, H, Hkv, T, D, D, dt)
            fns = {"this": lambda: tflash.flash_attention(q, k, v)}
            if tflash.lse_route(dt, D, D):
                fns["this_lse"] = lambda: tflash.flash_attention(q, k, v, return_lse=True)[0]
            if parent:
                name = "parent_fwd" if bf16 else "parent_tf32"
                fns["parent"] = _fwd_calls(
                    libs, [name], q, k, v, stream,
                    None if bf16 else tflash.FLASH_ATTENTION_TF32,
                    PARENT_ARGTYPES["fwd" if bf16 else "tf32"])[name]
            outs = {name: fn() for name, fn in fns.items()}
            kernel = "flash_attention_wgmma" if bf16 else "flash_attention_tf32"
            print(json.dumps({"kernel": kernel, "shape": [B, H, Hkv, T, D],
                              "dtype": str(dt).split(".")[1],
                              "device_ms": device_in_turns(fns, kernel),
                              "events_ms": in_turns(fns),
                              "bitwise_to_this": {n: torch.equal(x, outs["this"])
                                                  for n, x in outs.items() if n != "this"}}),
                  flush=True)
            del q, k, v, fns, outs
    if parent:
        _sass_instances(libs)


def _sass_instances(libs) -> None:
    """Every kernel instance of the four wgmma and TF32 flash sources in the
    parent's build (``--other``) and this tree's, keyed by kernel and
    template arguments (an absent bool is false), each with whether its
    ``sass_report`` line (the SASS body's hash among it) is the parent's."""
    import difflib

    from repro_torch.kernels import _cuda
    from repro_torch.kernels import flash_attention as tflash
    from tools.sass_report import code_lines, library_sass, report

    out = _cuda.BUILD_DIR / "variants"
    diffs = _cuda.BUILD_DIR.parent / "sass_diff"

    def by_instance(path):
        found = {}
        for function, body in library_sass(path).items():
            # the kernel's name follows its length (after the namespace's)
            m = re.search(r"\d(flash_[a-z0-9_]+?_kernel)I((?:Li\d+E|Lb[01]E)+)E", function)
            if m:
                args = re.findall(r"L([ib])(\d+)E", m.group(2))
                ints = [a for kind, a in args if kind == "i"]
                flag = next((a for kind, a in args if kind == "b"), "0")
                kernel = m.group(1)
                r = report(function, body)
                found[f"{kernel}<{', '.join(ints)}, {flag}>"] = (
                    {key: r[key] for key in r if key != "function"}, code_lines(body))
        return found

    for name, kernel in (("parent_fwd", tflash.FLASH_ATTENTION_WGMMA),
                         ("parent_tf32", tflash.FLASH_ATTENTION_TF32),
                         ("parent_bwd_wgmma", tflash.FLASH_ATTENTION_BWD_WGMMA),
                         ("parent_bwd", tflash.FLASH_ATTENTION_BWD_TF32)):
        if name not in libs:  # a section that built fewer of the parent's
            continue
        kernel.library()
        theirs = by_instance(out / f"{name}.so")
        mine = by_instance(kernel.library_path())
        equal = {key: key in theirs and theirs[key][0] == line
                 for key, (line, _) in mine.items()}
        for key, same in equal.items():
            if not same and key in theirs and "192" in key:
                diffs.mkdir(parents=True, exist_ok=True)
                text = "\n".join(difflib.unified_diff(theirs[key][1], mine[key][1], "parent",
                                                      "this", lineterm="", n=2))
                (diffs / f"sass_diff_{kernel.name}_{re.sub(r'[^0-9a-z]+', '_', key)}.txt"
                 ).write_text(text[:400_000])
        print(json.dumps({"sass_instances": kernel.source, "equal": equal,
                          "parent_only": sorted(set(theirs) - set(mine)),
                          "this": {key: line for key, (line, _) in mine.items()}}),
              flush=True)


def _d256_call(lib, name, q, k, v, P, stream, argtypes=None, lse=None):
    """A call of a build's wgmma C entry at (256, 256) with the prefix P
    (``argtypes`` where the build's entry takes others than this tree's;
    with ``lse`` it also writes L there)."""
    from repro_torch.kernels import flash_attention as tflash

    B, H, T, D = q.shape
    o = q.new_empty((B, H, T, D))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), B, H, k.shape[1], T, T, D, D, 1, P,
            stream)
    call = _c_call(lib, tflash.FLASH_ATTENTION_WGMMA, args, name, argtypes)
    return lambda: (call(), o)[1]


def _d256_stamps(lib, q, k, v, P, stream) -> dict:
    """Block (0, 0)'s clock64 stamps from the ``d256_stamps`` build (its
    instance with L writes them past L's rows): the block's tile counts
    (the light unit's ``nl``, the heavy one's ``nh``) and for each consumer the cycles of each part of a tile (``wait``: for S(t)
    and PV(t − 1); ``head``: the mask, row max and O's rescale; ``v_wait``:
    for V(t); ``pv``: the k-steps' terms and PV wgmmas; ``s_issue``: S(t +
    1) issued; ``tile``: one tile to the next), medians over its tiles and
    each tile's ``tile``, and from its start the end of its loop and its
    end."""
    import torch

    B, H, T, D = q.shape
    Hkv = k.shape[1]
    rows = -(-T // 128) * 128
    points = 2 * 64 * 6  # consumers × kStampTiles × kStampPoints
    buf = torch.zeros(B * H * rows + 2 * points, dtype=torch.float32, device="cuda")
    call = _d256_call(lib, D256_STAMPS, q, k, v, P, stream, lse=buf)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    st = buf[B * H * rows:].view(torch.int64).view(2, 64, 6).cpu().numpy()
    n = 2 * (-(-T // 128))  # the L instance's q tiles

    def kv_tiles(i):
        return min(-(-T // 64), max(min((i + 1) * 64, T) - 1, P - 1) // 64 + 1)

    na, nb = kv_tiles(0), kv_tiles((H // Hkv * n - 1) % n)
    nl, nh = min(na, nb), max(na, nb)
    counts = (nh, nl)  # consumer h's tiles, l's
    out = {"nl": nl, "nh": nh}
    names = ("wait", "head", "v_wait", "pv", "s_issue")
    for w, nt in enumerate(counts):
        per = [{name: int(st[w, t, i + 1] - st[w, t, i]) for i, name in enumerate(names)}
               for t in range(min(nt, 62))]
        tiles = [int(st[w, t + 1, 0] - st[w, t, 0]) for t in range(min(nt, 62) - 1)]
        out[f"consumer{w}"] = {
            "tiles": nt,
            "median_cycles": {key: float(np.median([x[key] for x in per])) for key in names},
            "tile_cycles": tiles,
            "from_start": {"loop_end": int(st[w, 63, 1] - st[w, 63, 0]),
                           "end": int(st[w, 63, 2] - st[w, 63, 0])}}
    return out


def d256_rows(libs) -> None:
    """Section ``d256``: the bf16 forward at (256, 256) with the prefix-LM
    mask at D256_SHAPES (chip_smoke's VLM_FWD_CASES): this tree's build
    without and with L, the parent's build (``--other``) and the cuts of
    D256_CUTS, device ms in turns beside SDPA's device ms with the mask as a
    boolean ``attn_mask`` (every kernel and copy of the call), events ms in
    turns; errors against float64 (``check_flash``'s gate) for this tree's,
    the parent's and the checked builds, this build's L against the plain
    version's, two calls bitwise, o bitwise with L and to the parent's; the
    bound (q, k, v read and o written once; QKᵀ and PV over the pairs the
    mask keeps at the bf16 rate, and the kernel's own work, PV three times);
    each build's grid and the launches of 20 calls, from the profiler's
    trace (``chip_smoke.trace_kernels``); after each shape, block (0, 0)'s clock stamps from
    the ``d256_stamps`` build (``_d256_stamps``).  Before the shapes, each
    build's (256, 256) instances' ``sass_report`` lines (registers, local
    memory); after them
    the other bf16 instances (D256_OTHERS) in turns against the parent's
    build, outputs bitwise, and with ``--other`` every instance of the
    source against the parent's (``_sass_instances``)."""
    import torch
    import torch.nn.functional as F
    from chip_smoke import (BF16_OPS_PER_S, HBM_BYTES_PER_S, all_device_ms, check_flash,
                            prefix_pairs, trace_kernels)
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.kernels import ref
    from tools.sass_report import library_reports

    stream = torch.cuda.current_stream().cuda_stream
    parent = "parent_fwd" in libs
    cuts = [n for n in D256_CUTS if n in libs]
    kernel = tflash.FLASH_ATTENTION_WGMMA
    kernel.library()
    paths = {"this": kernel.library_path(),
             **{n: _cuda.BUILD_DIR / "variants" / f"{n}.so"
                for n in (["parent_fwd"] if parent else []) + cuts}}
    print(json.dumps({"d256_sass": {
        name: [r for r in library_reports(path) if "Li256ELi256E" in r["function"]]
        for name, path in paths.items()}}), flush=True)
    rng = np.random.default_rng(0)
    for B, H, Hkv, T, P in D256_SHAPES:
        q, k, v, _ = _qkv(rng, B, H, Hkv, T, 256, 256, torch.bfloat16)
        mask = ref.attention_mask(T, T, True, P, "cuda")
        fns = {"this": lambda: tflash.flash_attention(q, k, v, prefix_len=P),
               "this_lse": lambda: tflash.flash_attention(q, k, v, return_lse=True,
                                                          prefix_len=P)[0]}
        if parent:
            fns["parent"] = _d256_call(libs["parent_fwd"], "parent", q, k, v, P, stream,
                                       PARENT_ARGTYPES["fwd"])
        for name in cuts:
            fns[name] = _d256_call(libs[name], name, q, k, v, P, stream)

        def sdpa():
            F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)

        want = ref.flash_attention_ref(q.double(), k.double(), v.double(), prefix_len=P)
        errors = {}
        for name in ["this", "parent"] + [n for n in cuts if VARIANTS[n][2]]:
            if name in fns:
                got = fns[name]()
                torch.cuda.synchronize()
                errors[name] = check_flash(f"d256 {name} {(B, H, Hkv, T)} P {P}", got, want,
                                           torch.bfloat16)[0]
        del want
        o, lse = tflash.flash_attention(q, k, v, return_lse=True, prefix_len=P)
        want_lse = ref.flash_attention_lse_ref(q, k, v, prefix_len=P)
        lse_err = float((lse[..., :T] - want_lse).abs().max())
        if not lse_err <= 1e-6 * float(want_lse.abs().max()):
            raise AssertionError(f"d256 {(B, H, Hkv, T)}: L {lse_err} from the plain version's")
        first = fns["this"]()
        bitwise = {"repeat": torch.equal(first, fns["this"]()),
                   "with_lse": torch.equal(first, o)}
        if parent:
            bitwise["to_parent"] = torch.equal(first, fns["parent"]())
        for name in cuts:
            if VARIANTS[name][2]:
                bitwise[f"{name}_to_this"] = torch.equal(first, fns[name]())
        if not (bitwise["repeat"] and bitwise["with_lse"]):
            raise AssertionError(f"d256 {(B, H, Hkv, T)}: {bitwise}")
        del o, lse, want_lse, first
        device = device_in_turns(fns, "flash_attention_wgmma")
        device["sdpa"] = statistics.mean(all_device_ms(sdpa) for _ in range(2))
        pairs = B * H * prefix_pairs(T, P)
        nbytes = 2 * (2 * B * H * T * 256 + 2 * B * Hkv * T * 256)
        bound = max(nbytes / HBM_BYTES_PER_S, 4 * pairs * 256 / BF16_OPS_PER_S)
        grids = {}
        for name in ("this", "this_lse", "parent"):
            if name in fns:
                records = trace_kernels(fns[name], "flash_attention_wgmma")
                grids[name] = {"grids": sorted({tuple(r.get("args", {}).get("grid", ()))
                                                 for r in records}),
                               "launches": len(records)}
        print(json.dumps({"kernel": "flash_attention_wgmma (256, 256)",
                          "shape": [B, H, Hkv, T, 256, 256], "prefix_len": P,
                          "dtype": "bfloat16", "device_ms": device,
                          "events_ms": in_turns({**fns, "sdpa": sdpa}),
                          "max_abs_err": errors, "lse_max_abs_err": lse_err,
                          "bitwise": bitwise, "bound_ms": 1e3 * bound,
                          "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                                       >= 4 * pairs * 256 / BF16_OPS_PER_S else "operations"),
                          "kernel_work_ms": 1e3 * 8 * pairs * 256 / BF16_OPS_PER_S,
                          "grid": grids}), flush=True)
        if D256_STAMPS in libs:
            print(json.dumps({"d256_stamps": [B, H, Hkv, T, 256, 256], "prefix_len": P,
                              **_d256_stamps(libs[D256_STAMPS], q, k, v, P, stream)}),
                  flush=True)
        del q, k, v, mask, fns
        torch.cuda.empty_cache()
    for B, H, Hkv, T, D, Dv in D256_OTHERS:
        q, k, v, _ = _qkv(rng, B, H, Hkv, T, D, Dv, torch.bfloat16)
        fns = {"this": lambda: tflash.flash_attention(q, k, v)}
        if parent:
            fns["parent"] = _fwd_calls(libs, ["parent_fwd"], q, k, v, stream,
                                       argtypes=PARENT_ARGTYPES["fwd"])["parent_fwd"]
        same = torch.equal(fns["this"](), fns["parent"]()) if parent else None
        print(json.dumps({"kernel": "flash_attention_wgmma", "shape": [B, H, Hkv, T, D, Dv],
                          "dtype": "bfloat16",
                          "device_ms": device_in_turns(fns, "flash_attention_wgmma"),
                          "events_ms": in_turns(fns), "bitwise_to_parent": same}), flush=True)
        del q, k, v, fns
    if parent:
        _sass_instances(libs)


def d256_bwd_rows(libs) -> None:
    """Section ``d256_bwd``: the attention backward at (256, 256) with the
    prefix-LM mask (paligemma-3b) at D256_BWD_SHAPES in both routes (bf16
    ``flash_attention_bwd_wgmma.cu``, float32 ``flash_attention_bwd_tf32.cu``):
    this tree's build given the forward's L (as autograd runs it) and
    without it, and SDPA's backward with the mask as a boolean
    ``attn_mask``, device ms by kernel (dq, dkdv) in turns and events ms in
    turns, errors against float64, two calls bitwise, the bounds (the five
    products over the pairs the mask keeps at the dtype's tensor rate, one
    TF32 term and three; the bytes; ``exp_bound_ms``) and the (256, 256)
    instances' ``sass_report`` lines.  With ``--other`` then the other
    instances at D256_BWD_OTHERS in both dtypes, with no prefix, this
    tree's build (given L where ``lse_route`` holds) against the parent's
    (given the same L), in turns (parent, this, this, parent), outputs
    bitwise; and every instance of the four tensor-core sources against the
    parent's build (``_sass_instances``)."""
    import torch
    import torch.nn.functional as F
    from chip_smoke import (BF16_OPS_PER_S, EXP_PER_CLOCK_SM, TF32_OPS_PER_S, all_device_ms,
                            prefix_pairs, sm_clock_hz)
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.kernels import ref
    from tools.sass_report import library_reports

    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(0)
    exp_rate = (EXP_PER_CLOCK_SM * torch.cuda.get_device_properties(0).multi_processor_count
                * sm_clock_hz())
    for B, H, Hkv, T, P in D256_BWD_SHAPES:
        mask = ref.attention_mask(T, T, True, P, "cuda")
        pairs = B * H * prefix_pairs(T, P)
        for dt in (torch.bfloat16, torch.float32):
            dtype = str(dt).split(".")[1]
            bf16 = dt == torch.bfloat16
            kernel = tflash.FLASH_ATTENTION_BWD_WGMMA if bf16 else tflash.FLASH_ATTENTION_BWD_TF32
            q, k, v, do = _qkv(rng, B, H, Hkv, T, 256, 256, dt)
            o, lse = tflash.flash_attention(q, k, v, return_lse=True, prefix_len=P)
            want = ref.flash_attention_bwd_ref(*(t.double() for t in (q, k, v, o, do)),
                                               prefix_len=P)
            bwd = {"shipped": lambda: tflash.flash_attention_bwd(q, k, v, o, do, lse=lse,
                                                                 prefix_len=P),
                   "shipped_no_lse": lambda: tflash.flash_attention_bwd(q, k, v, o, do,
                                                                        prefix_len=P)}
            errors = {}
            for name, fn in bwd.items():
                got = fn()
                torch.cuda.synchronize()
                errors[name] = {g: float((x.double() - w).abs().max() / w.abs().max())
                                for g, x, w in zip(("dq", "dk", "dv"), got, want)}
            del want
            bitwise = {n: all(torch.equal(a, b) for a, b in zip(fn(), fn()))
                       for n, fn in bwd.items()}
            qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
            out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)

            def sdpa(out=out, qs=qs, ks=ks, vs=vs):
                torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True)

            device = _bwd_in_turns(bwd)
            device["sdpa"] = statistics.mean(all_device_ms(sdpa, 5) for _ in range(2))
            flops = 2 * pairs * 5 * 256
            peak = BF16_OPS_PER_S if bf16 else TF32_OPS_PER_S
            nbytes = q.element_size() * 2 * (B * H * T + B * Hkv * T) * 2 * 256
            bounds = {"products_ms": 1e3 * flops / peak, "bytes_ms": 1e3 * nbytes / 3.35e12,
                      "exp_bound_ms": 1e3 * 2 * pairs / exp_rate}
            if not bf16:
                bounds["tc_bound_ms"] = 3 * bounds["products_ms"]
            sass = [r for r in library_reports(kernel.library_path())
                    if "flash_bwd" in r["function"]
                    and ("256" in r["function"] or "d256" in r["function"])]
            print(json.dumps({"kernel": kernel.name, "shape": [B, H, Hkv, T, 256],
                              "prefix_len": P, "pairs_per_head": prefix_pairs(T, P),
                              "dtype": dtype, "device_ms": device,
                              "events_ms": in_turns({**bwd, "sdpa": sdpa}), "rel_err": errors,
                              "bitwise_repeat": bitwise, "bounds": bounds, "sass": sass}),
                  flush=True)
            del q, k, v, o, do, lse, bwd, qs, ks, vs, out
            torch.cuda.empty_cache()
        del mask
    if "parent_bwd_wgmma" not in libs:
        return
    for B, H, Hkv, T, D, Dv in D256_BWD_OTHERS:
        for dt in (torch.bfloat16, torch.float32):
            bf16 = dt == torch.bfloat16
            kernel = tflash.FLASH_ATTENTION_BWD_WGMMA if bf16 else tflash.FLASH_ATTENTION_BWD_TF32
            q, k, v, do = _qkv(rng, B, H, Hkv, T, D, Dv, dt)
            lse = None
            if tflash.lse_route(dt, D, Dv):
                o, lse = tflash.flash_attention(q, k, v, return_lse=True)
            else:
                o = tflash.flash_attention(q, k, v)
            name = "parent_bwd_wgmma" if bf16 else "parent_bwd"
            bwd = {"this": lambda: tflash.flash_attention_bwd(q, k, v, o, do, lse=lse),
                   "parent": _bwd_calls(libs, [name], q, k, v, o, do, stream, kernel,
                                        PARENT_ARGTYPES["bwd_wgmma" if bf16 else "bwd_tf32"],
                                        lse=lse)[name]}
            same = all(torch.equal(a, b) for a, b in zip(bwd["this"](), bwd["parent"]()))
            device = _bwd_in_turns({"parent": bwd["parent"], "this": bwd["this"]})
            ratio = (device["this"]["total"] / device["parent"]["total"]
                     if device["this"]["total"] and device["parent"]["total"] else None)
            print(json.dumps({"kernel": kernel.name, "shape": [B, H, Hkv, T, D, Dv],
                              "dtype": str(dt).split(".")[1], "lse_given": lse is not None,
                              "bitwise_to_parent": same, "device_ms": device,
                              "this_over_parent": ratio,
                              "events_ms": in_turns({"parent": bwd["parent"],
                                                     "this": bwd["this"]})}), flush=True)
            del q, k, v, o, do, lse, bwd
            torch.cuda.empty_cache()
    _sass_instances(libs)


def mla_bf16_bwd_only(libs) -> None:
    """Section ``mla_bf16_bwd``: ``mla_bf16_bwd_rows`` alone."""
    import torch

    mla_bf16_bwd_rows(libs, np.random.default_rng(0), torch.cuda.current_stream().cuda_stream)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    args = sys.argv[1:]
    other = None
    if "--other" in args:
        at = args.index("--other")
        other = Path(args[at + 1]).resolve()
        del args[at:at + 2]
    sections = {"matvec": (matvec_rows, (MATVEC_SRC,)),
                "flash": (flash_rows, (FLASH_SRC,)),
                "dedup": (dedup_rows, (DEDUP_SRC, CHAIN_SRC)),
                "gms": (gms_rows, (GMS_SRC,)),
                "mma": (mma_rows, (MMA_SRC,)),
                "mla": (mla_rows, (MLA_FWD_SRC, MLA_BWD_SRC, MLA_BF16_BWD_SRC)),
                "mla_bf16_bwd": (mla_bf16_bwd_only, (MLA_BF16_BWD_SRC,)),
                "bwd_d64_d128": (bwd_d64_d128_rows, (MLA_BWD_SRC, MLA_BF16_BWD_SRC)),
                "d256": (d256_rows, (MLA_FWD_SRC,)),
                "d256_bwd": (d256_bwd_rows, (MLA_BWD_SRC, MLA_BF16_BWD_SRC))}
    chosen = args or list(sections)
    unknown = set(chosen) - set(sections)
    if unknown:
        raise SystemExit(f"kernel_variants: unknown sections {sorted(unknown)}; "
                         f"one of {sorted(sections)}")
    sources = {src for name in chosen for src in sections[name][1]}
    names = [v for v, (src, _, _) in VARIANTS.items()
             if src in sources and ("d256" in chosen or not v.startswith("d256_"))]
    if chosen == ["bwd_d64_d128"]:  # its own cuts alone
        names = [v for cuts in BWD_D64_D128_CUTS.values() for v in cuts]
    if chosen == ["d256"]:
        names = [*D256_CUTS, D256_STAMPS]
    if chosen == ["d256_bwd"]:  # no cuts: the shipped builds and the parent's
        names = []
    parents = sorted({b for name in chosen for b in PARENT_BUILDS.get(name, ())})
    libs = build_all(names, other if parents else None, parents)
    for name in chosen:
        sections[name][0](libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
