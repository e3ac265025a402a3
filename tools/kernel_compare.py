#!/usr/bin/env python3
"""Time ``gather_mul_scatter`` and the small-head-dim flash kernel of this
tree beside another checkout's (a parent commit's), in turns on one card.

    python3 tools/kernel_compare.py OTHER_ROOT

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


def worker(tree: Path) -> None:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))  # chip_smoke's timing helpers
    import torch
    from chip_smoke import (FLASH_KERNEL_NAMES, GMS_SHAPES, host_us, kernel_device_ms,
                            time_ms)
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.kernels import ring_scatter

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    B = 1000

    def t(a):
        return torch.tensor(np.asarray(a), device="cuda")

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


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        worker(Path(sys.argv[2]).resolve())
        return 0
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    other = Path(sys.argv[1]).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    runs: dict = {}
    for label, tree in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
        out = subprocess.run([sys.executable, __file__, "--worker", str(tree)],
                             capture_output=True, text=True)
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
