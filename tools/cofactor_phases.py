#!/usr/bin/env python3
"""Where a ``cofactor_update`` launch spends its time, phase by phase.

Builds ``src/repro_torch/kernels/csrc/cofactor_update.cu`` as it is, with its
``REPRO_STAMP(k)`` hook defined so that thread 0 of every block stamps the
SM clock (``clock64``) and the global timer at each phase boundary, runs it
at the wrapper's own plan on integer data (checked against the plain
version), and prints one JSON line a shape:

* ``device_us``: device time a call of the stamped kernel (profiler);
* ``cycles``: per phase, the median and largest SM cycles over the blocks:
  ``init`` (barriers), ``rows`` (the TMA ring and the products),
  ``block_sum`` (the groups of a block), ``cluster_sum`` (DSMEM, written to
  the partials), and for the blocks that ran them ``set_and_result`` (the
  tickets and set sums up to the result) and ``result`` (the last cluster);
* ``ns``: global-timer spans from the first block's start: the spread of
  the blocks' starts, the last end of the rows, the last cluster partial
  written, the end of the result.

The stamps cost a few registers and stores, so the stamped kernel runs a
little slower than the real one.  Run on a card from the repository root:

    python3 tools/cofactor_phases.py [B,m ...]     # default 4096,32 65536,32 262144,130
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

#: the kernel's REPRO_STAMP(k) points, by k, and the phase each one ends
STAMPS = ["start", "init", "rows", "block_sum", "cluster_sum", "set_and_result", "result"]
SLOTS = len(STAMPS)
#: most blocks (batch blocks x passes) whose stamps are kept
MAX_STAMPED = 4096
KERNEL = ROOT / "src/repro_torch/kernels/csrc/cofactor_update.cu"


def stamped_source() -> str:
    """A source that defines REPRO_STAMP (the SM clock and the global timer
    of thread 0 of each block into a device array), then includes the
    kernel's own source unchanged, and adds a reader of the array."""
    return ("#include <cstdint>\n"
            "__device__ unsigned long long g_stamps[%d * %d * 2];\n"
            "#define REPRO_STAMP(k) if (threadIdx.x == 0) { unsigned long long t_;"
            " asm volatile(\"mov.u64 %%0, %%%%globaltimer;\" : \"=l\"(t_));"
            " const unsigned int b_ = blockIdx.y * gridDim.x + blockIdx.x;"
            " if (b_ < %d) { g_stamps[(b_ * %d + (k)) * 2] = t_;"
            " g_stamps[(b_ * %d + (k)) * 2 + 1] = clock64(); } }\n"
            "#include \"%s\"\n"
            'extern "C" int repro_read_stamps(void* host) {\n'
            "  return (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));\n}\n"
            % (MAX_STAMPED, SLOTS, MAX_STAMPED, SLOTS, SLOTS, KERNEL))


def build():
    from repro_torch.kernels import _cuda

    out = ROOT / "build" / "cofactor_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "cofactor_phases.cu").write_text(stamped_source())
    lib = out / "cofactor_phases.so"
    subprocess.run([_cuda.find_nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o",
                    str(lib), str(out / "cofactor_phases.cu")],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def device_us(fn, calls: int = 20) -> float:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in events) / calls


def phases(lib, B: int, m: int) -> dict:
    import torch
    from repro_torch.kernels import cofactor_update as tcof
    from repro_torch.kernels import ref

    fn = lib.repro_cofactor_update
    P = ctypes.c_void_p
    fn.argtypes = [P, P, ctypes.c_longlong] + [ctypes.c_int] * 6 + [P, P, P, P]
    rng = np.random.default_rng(B + m)
    x = torch.tensor(rng.integers(-4, 5, (B, m)).astype(np.float32), device="cuda")
    w = torch.tensor(rng.integers(-1, 2, B).astype(np.float32), device="cuda")
    plan = tcof.cofactor_plan(B, m, tcof.max_blocks(torch.cuda.current_device(), m))
    counters = torch.zeros(plan.counter_words, dtype=torch.int32, device="cuda")
    partials = torch.empty(plan.partial_floats, device="cuda")
    out = torch.empty(m * m + m + 1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = fn(x.data_ptr(), w.data_ptr(), B, m, plan.tile, plan.groups,
                plan.stage_rows, plan.blocks, plan.passes, counters.data_ptr(),
                partials.data_ptr(), out.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"stamped cofactor_update failed: CUDA error {rc}")

    call()
    c, s, Q = ref.cofactor_update_ref(x, w)
    if not (torch.equal(out[:m * m].view(m, m), Q) and torch.equal(out[m * m:-1], s)
            and torch.equal(out[-1:], c.reshape(1))):
        raise AssertionError(f"stamped kernel differs from the plain version at {B}x{m}")
    us = device_us(call)
    call()
    torch.cuda.synchronize()
    host = np.zeros(MAX_STAMPED * SLOTS * 2, dtype=np.uint64)
    if lib.repro_read_stamps(ctypes.c_void_p(host.ctypes.data)) != 0:
        raise RuntimeError("reading the stamps failed")
    st = host.reshape(MAX_STAMPED, SLOTS, 2)[:min(MAX_STAMPED, plan.blocks * plan.passes)]
    st = st.astype(np.int64)
    ns, cyc = st[:, :, 0], st[:, :, 1]
    t0 = ns[:, 0].min()
    names = STAMPS
    cycles = {}
    for k in range(1, SLOTS):
        # blocks that reached stamp k in this call (stamps of earlier calls
        # lie before this call's first start)
        ran = (ns[:, k] >= t0) & (ns[:, k - 1] >= t0)
        d = cyc[ran, k] - cyc[ran, k - 1]
        if len(d):
            cycles[names[k]] = [int(np.median(d)), int(d.max())]
    spans = {"start_spread": int(ns[:, 0].max() - t0),
             "rows_end": int(ns[:, 2].max() - t0),
             "cluster_sums_written": int(ns[:, 4][ns[:, 4] >= t0].max() - t0)}
    done = ns[:, SLOTS - 1][ns[:, SLOTS - 1] >= t0]
    if len(done):
        spans["result_end"] = int(done.max() - t0)
    return dict(B=B, m=m, plan=plan._asdict(), device_us=us, cycles=cycles, ns=spans)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("cofactor_phases: no CUDA device is available")
    shapes = [tuple(int(v) for v in a.split(",")) for a in argv] or \
        [(4096, 32), (65_536, 32), (262_144, 130)]
    lib = build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout else "nvidia-smi: n/a")
    for B, m in shapes:
        print(json.dumps(phases(lib, B, m)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
