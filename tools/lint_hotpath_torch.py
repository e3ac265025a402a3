#!/usr/bin/env python3
"""AST lint for the replay / serve hot path of the PyTorch port.

    python3 tools/lint_hotpath_torch.py [--root REPO] [--allowlist FILE] [--list]

The stream executor and the serving plane promise that steady-state work
is device work alone: a CUDA graph replay and a lookup never wait for the
device on the host, and a captured body reads no host state that varies
between replays.  One stray ``.item()`` in a step body synchronises every
step (and breaks its capture); one ``torch.tensor(list, device=...)`` is a
blocking host copy.  This lint checks the hot-path modules statically; it
is the static twin of ``tools/sync_audit.py``, which counts the same calls
at run time on the card.

``HP001`` synchronising calls — ``.item()``, ``.cpu()``, ``.tolist()``,
    ``.numpy()``, ``torch.tensor(...)``, ``torch.cuda.synchronize()``, and
    the port's own host readers (``host_payload()``, ``payload_sync()``,
    ``num_keys_sync()``, ``num_slots_used_sync()``).
``HP002`` host materialization of device values — ``np.asarray`` /
    ``np.array`` over any argument, ``float(...)`` of a non-literal.
``HP003`` host state that varies between runs — any ``time.*``,
    ``random.*`` or ``np.random.*`` call.
``HP004`` iteration over unordered containers — ``for _ in set(...)``, set
    literals, ``frozenset(...)``: their order depends on insertion history,
    so op order (and with it captured graphs and float reduction order)
    could vary from run to run.

Hot-path modules legitimately hold *host-side* admission, capacity,
growth and compile code.  Those sites are allowed either inline
(``# hotpath: allow``) or in ``tools/hotpath_allowlist_torch.txt``, one
``path::qualname[::CODE]`` entry a function scope with its reason: the
allowlist is the audited registry of every host touchpoint of the hot
path.  ``--list`` prints every finding's allowlist key (triage).  Exit
status 1 when a finding is not allowed.
"""
from __future__ import annotations

import argparse
import ast
import sys
from pathlib import Path

#: the port's replay / serve hot-path modules (repo-relative).  Modules
#: that also compile plans or plan storage are included on purpose: their
#: host calls must each be audited into the allowlist, so a refactor
#: cannot quietly move one into a step body.
HOT_MODULES = (
    "src/repro_torch/core/plan.py",
    "src/repro_torch/core/stream.py",
    "src/repro_torch/core/collectives.py",
    "src/repro_torch/core/contraction.py",
    "src/repro_torch/core/storage.py",
    "src/repro_torch/core/relations.py",
    "src/repro_torch/core/indicators.py",
    "src/repro_torch/kernels/cofactor_update.py",
    "src/repro_torch/kernels/flash_attention.py",
    "src/repro_torch/kernels/hash_table.py",
    "src/repro_torch/kernels/ops.py",
    "src/repro_torch/kernels/rank1_chain.py",
    "src/repro_torch/kernels/ref.py",
    "src/repro_torch/kernels/ring_fused.py",
    "src/repro_torch/kernels/ring_mul.py",
    "src/repro_torch/kernels/ring_scatter.py",
    "src/repro_torch/kernels/scatter_ops.py",
    "src/repro_torch/kernels/segment_ring_sum.py",
    "src/repro_torch/serve/lookup.py",
    "src/repro_torch/serve/registry.py",
    "src/repro_torch/serve/server.py",
)

SYNC_METHODS = frozenset({
    "item", "cpu", "tolist", "numpy", "host_payload", "payload_sync",
    "num_keys_sync", "num_slots_used_sync",
})

SYNC_CALLS = frozenset({"torch.tensor", "torch.cuda.synchronize"})

ALLOW_COMMENT = "# hotpath: allow"


def _dotted(node: ast.AST) -> str | None:
    """'np.random.default_rng' for nested Attribute / Name chains."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class Finding:
    def __init__(self, path: str, line: int, code: str, qualname: str,
                 message: str):
        self.path, self.line, self.code = path, line, code
        self.qualname, self.message = qualname, message

    def key(self) -> str:
        return f"{self.path}::{self.qualname}"

    def label(self) -> str:
        return (f"{self.path}:{self.line}: {self.code} "
                f"[{self.qualname}] {self.message}")


class HotPathVisitor(ast.NodeVisitor):
    def __init__(self, relpath: str, source_lines: list[str]):
        self.relpath = relpath
        self.lines = source_lines
        self.scope: list[str] = []
        self.findings: list[Finding] = []

    # ------------------------------------------------------------ scoping
    def _qual(self) -> str:
        return ".".join(self.scope) if self.scope else "<module>"

    def visit_FunctionDef(self, node):
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    # ----------------------------------------------------------- findings
    def _flag(self, node: ast.AST, code: str, message: str) -> None:
        line = getattr(node, "lineno", 0)
        if 0 < line <= len(self.lines) and ALLOW_COMMENT in self.lines[line - 1]:
            return
        self.findings.append(Finding(self.relpath, line, code, self._qual(),
                                     message))

    def visit_Call(self, node: ast.Call):
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in SYNC_METHODS:
            self._flag(node, "HP001", f".{func.attr}() synchronises the host")
        name = _dotted(func)
        if name:
            root = name.split(".", 1)[0]
            if name in SYNC_CALLS:
                self._flag(node, "HP001", f"{name}(...) synchronises the host")
            elif name in ("np.asarray", "np.array", "numpy.asarray",
                          "numpy.array"):
                self._flag(node, "HP002", f"{name}(...) materializes on the host")
            elif root in ("time", "random") or name.startswith(
                    ("np.random.", "numpy.random.")):
                self._flag(node, "HP003",
                           f"{name}(...) reads host state that varies between runs")
        if isinstance(func, ast.Name) and func.id == "float" and node.args \
                and not isinstance(node.args[0], ast.Constant):
            self._flag(node, "HP002", "float(x) forces a scalar device→host copy")
        self.generic_visit(node)

    def visit_For(self, node: ast.For):
        self._check_unordered_iter(node.iter)
        self.generic_visit(node)

    def visit_comprehension(self, node: ast.comprehension):
        self._check_unordered_iter(node.iter)
        for child in ast.iter_child_nodes(node):
            self.visit(child)

    def _check_unordered_iter(self, it: ast.AST) -> None:
        if isinstance(it, ast.Set):
            self._flag(it, "HP004", "iteration over a set literal has no "
                       "deterministic order")
        elif isinstance(it, ast.Call):
            name = _dotted(it.func)
            if name in ("set", "frozenset"):
                self._flag(it, "HP004", f"iteration over {name}(...) has no "
                           "deterministic order")


def load_allowlist(path: Path) -> set[str]:
    entries: set[str] = set()
    if not path.exists():
        return entries
    for raw in path.read_text().splitlines():
        line = raw.split("#", 1)[0].strip()
        if line:
            entries.add(line)
    return entries


def allowed(f: Finding, allowlist: set[str]) -> bool:
    return (f"{f.path}::{f.qualname}" in allowlist
            or f"{f.path}::{f.qualname}::{f.code}" in allowlist)


def lint(root: Path, allowlist: set[str]) -> tuple[list[Finding], int]:
    findings: list[Finding] = []
    checked = 0
    for rel in HOT_MODULES:
        path = root / rel
        if not path.exists():
            continue
        checked += 1
        src = path.read_text()
        v = HotPathVisitor(rel, src.splitlines())
        v.visit(ast.parse(src, filename=str(path)))
        findings.extend(f for f in v.findings if not allowed(f, allowlist))
    return findings, checked


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parent.parent,
                    help="repo root (default: this tool's repository)")
    ap.add_argument("--allowlist", type=Path, default=None,
                    help="allowlist file (default: "
                         "tools/hotpath_allowlist_torch.txt under --root)")
    ap.add_argument("--list", action="store_true",
                    help="print every finding's allowlist key and exit 0")
    args = ap.parse_args(argv)
    allow_path = args.allowlist or args.root / "tools/hotpath_allowlist_torch.txt"
    allowlist = load_allowlist(allow_path) if not args.list else set()
    findings, checked = lint(args.root, allowlist)
    for f in sorted(findings, key=lambda f: (f.path, f.line)):
        print(f.key() + f"::{f.code}" if args.list else f.label())
    if args.list:
        return 0
    if findings:
        print(f"\nhot-path lint: {len(findings)} finding(s) across {checked} "
              f"modules (allowlist: {allow_path})", file=sys.stderr)
        return 1
    print(f"hot-path lint: clean ({checked} modules, {len(allowlist)} "
          f"allowlisted scopes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
