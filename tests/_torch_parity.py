"""Shared harness of the port-vs-reference engine tests.

Builds a reference ``repro`` engine and a ``repro_torch`` engine (on the
CPU) from the same numpy arrays, replays the same update stream through
both, and compares every materialized view after every update.
"""
import os
import sys

import numpy as np

# benchmarks/common.py holds the reference's schemas and synthesizers
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

#: every oracle value below this is exact in float32, whatever the order
#: of the adds: the precondition of the bitwise comparisons
EXACT_LIMIT = 2 ** 24

#: torch's intra-op threads in the port's tests.  The suite runs under
#: several xdist workers; torch's default (a thread for every core) in one
#: worker would compete with all the others, the reference's timing guards
#: among them (tests/test_verifier.py).
TORCH_THREADS = 1


def cap_torch_threads() -> None:
    """Hold torch to TORCH_THREADS intra-op threads (every port test file
    calls this when it is imported)."""
    import torch

    if torch.get_num_threads() > TORCH_THREADS:
        torch.set_num_threads(TORCH_THREADS)


def tf32_rna(x):
    """``cvt.rna.tf32.f32`` on a float32 torch tensor: 10 mantissa bits,
    nearest, ties away from zero (the magnitude bits rounded half up), as a
    float32 (the emulations of the port's TF32 flash kernels)."""
    import torch

    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    """x as the kernels' two TF32 terms: hi = rna(x), lo = rna(x − hi)."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def db_to_numpy(db) -> dict:
    """Reference database -> ``{rel: (schema, {comp: array})}``."""
    return {n: (r.schema, {c: np.asarray(v) for c, v in r.payload.items()})
            for n, r in db.items()}


def port_update(upd, ring):
    """A reference update (COO or factorized) on the CPU in the port."""
    from repro_torch import convert

    if hasattr(upd, "factors"):
        return convert.factorized_update_from_numpy(upd.schema, upd.factors,
                                                    ring, device="cpu")
    return convert.update_from_numpy(
        upd.schema, np.asarray(upd.keys),
        {c: np.asarray(v) for c, v in upd.payload.items()}, ring, device="cpu")


def assert_views_equal(ref_eng, port_eng, where=""):
    from repro_torch import convert

    got_views = convert.state_to_numpy(port_eng)["views"]
    assert set(ref_eng.views) == set(got_views)
    for name, rv in ref_eng.views.items():
        assert tuple(port_eng.views[name].schema) == tuple(rv.schema), name
        for comp, arr in rv.payload.items():
            want = np.asarray(arr)
            got = got_views[name][comp]
            assert np.abs(want).max(initial=0) < EXACT_LIMIT, (name, comp)
            np.testing.assert_array_equal(got, want, err_msg=f"{where} {name}.{comp}")


def assert_views_close(ref_eng, port_eng, rtol, where=""):
    """Every materialized view of ``port_eng`` within ``rtol`` of the
    largest magnitude of the reference's (dense or sparse storage, compared
    densely): the bound for float32 sums the two packages add in another
    order."""
    from repro.core.storage import as_dense as ref_dense
    from repro_torch.core.storage import as_dense

    assert set(ref_eng.views) == set(port_eng.views)
    for name, rv in ref_eng.views.items():
        rv = ref_dense(rv)
        tv = as_dense(port_eng.views[name]).transpose(rv.schema)
        for comp, arr in rv.payload.items():
            want = np.asarray(arr).astype(np.float64)
            got = tv.payload[comp].numpy().astype(np.float64)
            scale = np.abs(want).max(initial=0.0)
            err = np.abs(got - want).max(initial=0.0)
            assert err <= rtol * scale, (where, name, comp, err, scale)


def sparse_views(ref_eng) -> dict:
    """The reference engine's views as numpy, ``{name: (capacity, table,
    payload)}``; capacity and table are None for a dense view."""
    from repro.core import storage as rstorage

    out = {}
    for name, rv in ref_eng.views.items():
        sparse = isinstance(rv, rstorage.SparseRelation)
        out[name] = (rv.capacity if sparse else None,
                     np.asarray(rv.table) if sparse else None,
                     {c: np.asarray(a) for c, a in rv.payload.items()})
    return out


def assert_sparse_views_equal(want, port_eng, where=""):
    """Every view of ``port_eng`` bitwise against a :func:`sparse_views`
    snapshot, a hash table's capacity and key table too."""
    from repro_torch.core.storage import SparseRelation

    assert set(want) == set(port_eng.views)
    for name, (capacity, table, payload) in want.items():
        tv = port_eng.views[name]
        assert isinstance(tv, SparseRelation) == (table is not None), name
        if table is not None:
            assert tv.capacity == capacity, (where, name)
            np.testing.assert_array_equal(tv.table.numpy(), table,
                                          err_msg=f"{where} {name} table")
        for c, arr in payload.items():
            np.testing.assert_array_equal(tv.payload[c].numpy(), arr,
                                          err_msg=f"{where} {name}.{c}")


def run_parity(ref_query, port_query, ref_db, stream, var_order_ref,
               var_order_port, strategy):
    """Build both engines, replay ``stream`` (reference updates), compare
    after every update; returns (reference engine, port engine)."""
    from repro.core import IVMEngine as RefEngine
    from repro_torch import convert
    from repro_torch.core import IVMEngine

    port_db = convert.database_from_numpy(db_to_numpy(ref_db), port_query.ring,
                                          device="cpu")
    ref_eng = RefEngine.build(ref_query, ref_db, var_order=var_order_ref,
                              strategy=strategy, storage="dense")
    port_eng = IVMEngine.build(port_query, port_db, var_order=var_order_port,
                               strategy=strategy, storage="dense", device="cpu")
    assert_views_equal(ref_eng, port_eng, "build")
    for i, (rel, upd) in enumerate(stream):
        ref_eng.apply_update(rel, upd)
        port_eng.apply_update(rel, port_update(upd, port_query.ring))
        assert_views_equal(ref_eng, port_eng, f"update {i} ({rel})")
    return ref_eng, port_eng
