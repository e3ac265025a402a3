"""The port's hot-path guards on the tree: ``tools/lint_hotpath_torch.py``
exits 0 with its allowlist, every allowlist entry still allows a finding,
each rule fires on a planted call, and ``tools/verify_plans_torch.py``
verifies every app and main-path plan clean.
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
LINT = ROOT / "tools" / "lint_hotpath_torch.py"


def _lint_module():
    spec = importlib.util.spec_from_file_location("lint_hotpath_torch", LINT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(*args, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *map(str, args)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_lint_is_clean_on_the_tree():
    out = _run(LINT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "hot-path lint: clean" in out.stdout


def test_every_allowlist_entry_allows_a_finding():
    """A stale entry (its scope moved or lost its host call) would quietly
    allow a future one: each entry must match a finding of the tree."""
    lint = _lint_module()
    allowlist = lint.load_allowlist(ROOT / "tools" / "hotpath_allowlist_torch.txt")
    findings, checked = lint.lint(ROOT, set())
    assert checked == len(lint.HOT_MODULES)
    used = {e for f in findings for e in allowlist if lint.allowed(f, {e})}
    assert used == allowlist, sorted(allowlist - used)


PLANTED = {
    "item": ("x.item()", "HP001"),
    "cpu": ("x.cpu()", "HP001"),
    "tolist": ("x.tolist()", "HP001"),
    "numpy": ("x.numpy()", "HP001"),
    "torch.tensor": ("torch.tensor([1, 2], device=x.device)", "HP001"),
    "synchronize": ("torch.cuda.synchronize()", "HP001"),
    "np.asarray": ("np.asarray(x)", "HP002"),
    "float": ("float(x)", "HP002"),
    "time": ("time.perf_counter()", "HP003"),
    "np.random": ("np.random.default_rng(0)", "HP003"),
    "set": ("[v for v in set(x)]", "HP004"),
}


@pytest.mark.parametrize("what", sorted(PLANTED))
def test_lint_flags_a_planted_call(tmp_path, what):
    """A step body gains one host call: the lint names the file, the scope
    and the rule, and exits 1; an inline ``# hotpath: allow`` silences it."""
    call, code = PLANTED[what]
    rel = "src/repro_torch/serve/lookup.py"
    for mod in _lint_module().HOT_MODULES:
        dst = tmp_path / mod
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text((ROOT / mod).read_text())
    allow = tmp_path / "tools" / "hotpath_allowlist_torch.txt"
    allow.parent.mkdir(parents=True, exist_ok=True)
    allow.write_text((ROOT / "tools" / "hotpath_allowlist_torch.txt").read_text())
    target = tmp_path / rel
    target.write_text(target.read_text()
                      + f"\n\ndef planted_step(x):\n    return {call}\n")
    out = _run(LINT, "--root", tmp_path)
    assert out.returncode == 1
    assert f"{rel}:" in out.stdout and f"{code} [planted_step]" in out.stdout
    target.write_text(target.read_text().replace(
        f"return {call}\n", f"return {call}  # hotpath: allow\n"))
    assert _run(LINT, "--root", tmp_path).returncode == 0


def test_verify_plans_tool_is_clean():
    out = _run(ROOT / "tools" / "verify_plans_torch.py")
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert ", 0 violations," in out.stdout
