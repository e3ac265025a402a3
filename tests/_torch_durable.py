"""Shared harness of the durability and integrity parity tests
(``test_torch_integrity.py``, ``test_torch_recovery.py``).

The reference suites' chaos query — R(A, B), T(B, C), free A, C lifted —
built in both packages from one numpy source: ``REF`` is the JAX package,
``PORT`` the port on the CPU, each a namespace of the modules a scenario
needs, so one scenario function runs on either and returns what the two
are compared on.  Payloads are small integers in float32: every
accumulation order is exact, so views compare bitwise.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as P  # noqa: E402

P.cap_torch_threads()
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import core as R  # noqa: E402
from repro.checkpoint import checkpointer as rckpt  # noqa: E402
from repro.checkpoint import stream_state as rstate  # noqa: E402
from repro.core import storage as rstorage  # noqa: E402
from repro.core import stream as rstream  # noqa: E402
from repro.runtime import fault_tolerance as rft  # noqa: E402
from repro.runtime import faults as rfaults  # noqa: E402
from repro.runtime import integrity as rint  # noqa: E402
from repro_torch import core as T  # noqa: E402
from repro_torch.checkpoint import checkpointer as tckpt  # noqa: E402
from repro_torch.checkpoint import stream_state as tstate  # noqa: E402
from repro_torch.core import storage as tstorage  # noqa: E402
from repro_torch.core import stream as tstream  # noqa: E402
from repro_torch.runtime import fault_tolerance as tft  # noqa: E402
from repro_torch.runtime import faults as tfaults  # noqa: E402
from repro_torch.runtime import integrity as tint  # noqa: E402

REF = SimpleNamespace(name="ref", core=R, ckpt=rckpt, state=rstate, storage=rstorage,
                      stream=rstream, ft=rft, faults=rfaults, integ=rint,
                      int32=jnp.int32, float32=jnp.float32)
PORT = SimpleNamespace(name="port", core=T, ckpt=tckpt, state=tstate, storage=tstorage,
                       stream=tstream, ft=tft, faults=tfaults, integ=tint,
                       int32=torch.int32, float32=torch.float32)
BOTH = (REF, PORT)

DOMS = dict(A=64, B=64, C=3)
SCHEMAS = {"R": ("A", "B"), "T": ("B", "C")}
SCHEDULES = {
    "scan": ["R"] * 8,
    "rounds": ["R", "T"] * 4,
    "switch": ["R", "R", "T", "R", "T", "T", "R", "R"],
}


@pytest.fixture(autouse=True)
def disarm_faults():
    """No fault plan armed in either package before or after a test."""
    for pkg in BOTH:
        pkg.faults.clear()
    yield
    for pkg in BOTH:
        pkg.faults.clear()


def np_db(seed=3, doms=DOMS):
    rng = np.random.default_rng(seed)

    def rel(schema):
        shape = tuple(doms[v] for v in schema)
        mult = np.zeros(shape, np.float32)
        idx = tuple(rng.integers(0, d, size=8) for d in shape)
        np.add.at(mult, idx, 1.0)
        return mult

    return {"R": (SCHEMAS["R"], rel("AB")), "T": (SCHEMAS["T"], rel("BC"))}


def np_stream(seed=11, B=24, schedule=None):
    """``[(rel, schema, keys, values)]``: ``schedule`` (default R, T
    alternating, 8 updates) of B rows each, values in -2..2."""
    rng = np.random.default_rng(seed)
    out = []
    for rel in schedule or SCHEDULES["rounds"]:
        sch = SCHEMAS[rel]
        keys = np.stack([rng.integers(0, DOMS[v], size=B) for v in sch],
                        axis=1).astype(np.int32)
        out.append((rel, sch, keys, rng.integers(-2, 3, size=B)))
    return out


def ring(pkg, kind="sum"):
    return pkg.core.count_ring() if kind == "count" else pkg.core.sum_ring()


def query(pkg, r, doms=DOMS):
    return pkg.core.Query(relations=dict(SCHEMAS), free_vars=("A",), ring=r,
                          domains=doms, lifts={"C": ("value",)})


def array(pkg, arr, dtype):
    if pkg is REF:
        return jnp.asarray(arr, dtype)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dtype)


def update(pkg, schema, keys, vals, dtype):
    return pkg.core.COOUpdate(tuple(schema),
                              array(pkg, np.asarray(keys, np.int32), pkg.int32),
                              {"v": array(pkg, vals, dtype)})


def engine(pkg, kind="sum", doms=DOMS, seed=3, **kw):
    """The chaos engine (sparse storage unless ``storage=`` says)."""
    r = ring(pkg, kind)
    db = {n: pkg.core.DenseRelation(sch, r, {"v": array(pkg, arr, r.dtype)})
          for n, (sch, arr) in np_db(seed, doms).items()}
    kw.setdefault("storage", "sparse")
    if pkg is PORT:
        kw["device"] = "cpu"
    return pkg.core.IVMEngine.build(query(pkg, r, doms), db,
                                    var_order=pkg.core.chain(["A", "B"], {"B": [["C"]]}),
                                    **kw)


def stream(pkg, kind="sum", seed=11, B=24, n=8, schedule=None, rows=None):
    """The update stream, each (stream index, row) of ``rows`` changed
    first: "nan", "inf", "key" (out of every domain) or "zero" (key 0 and
    payload 0: the clean counterpart of a masked row)."""
    dtype = ring(pkg, kind).dtype
    out = []
    for j, (rel, sch, keys, vals) in enumerate(
            np_stream(seed, B, schedule or SCHEDULES["rounds"][:n])):
        keys, vals = keys.copy(), vals.astype(np.float32)
        for (at, row), how in (rows or {}).items():
            if at != j:
                continue
            if how == "nan":
                vals[row] = np.nan
            elif how == "inf":
                vals[row] = np.inf
            elif how == "key":
                keys[row, 0] = 10_000
            else:
                keys[row] = 0
                vals[row] = 0
        out.append((rel, update(pkg, sch, keys, vals, dtype)))
    return out


def host(pkg, x) -> np.ndarray:
    return np.asarray(x) if pkg is REF else x.detach().cpu().numpy()


def result(pkg, eng) -> np.ndarray:
    """The root view, densely."""
    return host(pkg, eng.result().payload["v"])


def dense_views(pkg, eng) -> dict:
    """Every view of ``eng`` in dense form on the host."""
    return {name: host(pkg, pkg.storage.as_dense(v).payload["v"])
            for name, v in eng.views.items()}


def assert_views_equal(got: dict, want: dict, where=""):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=f"{where} {name}")


def letters(log):
    """Dead-letter records as comparable tuples."""
    return [(r.rel, r.stream_index, r.row, tuple(r.key), tuple(r.reasons))
            for r in log]


def audit_entries(cfg):
    """``audit_log`` without its wall times."""
    keys = ("segment", "view", "exact", "max_abs_err", "repaired")
    return [{k: e[k] for k in keys} for e in cfg.audit_log]


def actions(log):
    return [e.get("action") for e in log if "action" in e]


def same(outcomes: dict):
    """Hold the port's outcome of a scenario to the reference's; returns
    the port's."""
    ref, port = outcomes["ref"], outcomes["port"]
    if isinstance(ref, np.ndarray):
        np.testing.assert_array_equal(port, ref)
    else:
        assert port == ref
    return port
