#!/usr/bin/env python3
"""What ptxas made of the port's kernels: registers and spills, per kernel.

Builds the named sources of ``src/repro_torch/kernels/csrc/`` (default:
``flash_attention_bwd_wgmma.cu``) as the library builds them, disassembles
each library with the toolkit's ``cuobjdump -sass`` and prints one JSON line
a kernel function: the highest register index its code uses, its
local-memory stores and loads (spills: ``STL``, ``LDL``) and whether it
reallocates registers (``setmaxnreg``: ``USETMAXREG``), and a hash of its
code (blanks and branch labels made independent of the rest of the
library: two builds of one kernel compiled alike have the same).  ``-Xptxas -v``
reports a kernel's registers at launch; this shows what the code past a
``setmaxnreg.inc`` really holds.  Runs where ``nvcc`` is (the card's host):

    python3 tools/sass_report.py [flash_attention_bwd_wgmma.cu ...]
"""
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def functions(sass: str):
    """(name, body) of each kernel function in ``cuobjdump -sass`` output."""
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name, _, body = part.partition("\n")
        yield name.strip(), body


def code_lines(body: str) -> list:
    """The instruction lines of a function's SASS, each line's runs of
    blanks made one and branch labels renumbered from 0 in order of first
    use (cuobjdump pads every line to the widest instruction of the library
    and numbers the labels across it, so another function in the same
    library changes both)."""
    code = [" ".join(line.split()) for line in body.splitlines()
            if re.search(r"/\*[0-9a-f]{4,}\*/", line)]
    labels: dict = {}

    def label(m):
        return f".L_x_{labels.setdefault(m.group(1), len(labels))}"

    return [re.sub(r"\.L_x_(\d+)", label, line) for line in code]


def report(name: str, body: str) -> dict:
    code = code_lines(body)
    regs = [int(r) for line in code for r in re.findall(r"\bR(\d+)\b", line)]
    return dict(function=name, instructions=len(code), max_register=max(regs, default=-1),
                local_stores=sum("STL" in line for line in code),
                local_loads=sum("LDL" in line for line in code),
                setmaxnreg=sum("USETMAXREG" in line for line in code),
                sha=hashlib.sha256("\n".join(code).encode()).hexdigest()[:16])


def library_sass(path) -> dict:
    """Each kernel function's ``code_lines`` in the built library at
    ``path``, by name."""
    from repro_torch.kernels import _cuda

    cuobjdump = Path(_cuda.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    return {name: body for name, body in functions(sass)}


def library_reports(path) -> list:
    """``report`` of each kernel function in the built library at ``path``."""
    return [report(name, body) for name, body in library_sass(path).items()]


def main(argv) -> int:
    from repro_torch.kernels import _cuda
    # every kernel module, so that _cuda.KERNELS knows every source
    from repro_torch.kernels import (cofactor_update, flash_attention, hash_table,  # noqa: F401
                                     rank1_chain, ring_fused, ring_mul, ring_scatter,
                                     segment_ring_sum)

    wanted = argv or ["flash_attention_bwd_wgmma.cu"]
    kernels = [k for k in _cuda.KERNELS if getattr(k, "source", None) in wanted]
    missing = set(wanted) - {k.source for k in kernels}
    if missing:
        raise SystemExit(f"no kernel is built from {sorted(missing)}")
    _cuda.build_all(kernels)
    for k in kernels:
        for line in library_reports(k.library_path()):
            print(json.dumps({"source": k.source, **line}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
