"""The port's serving plane ≡ the reference's (``tests/test_serve.py``).

Every case of the reference's serving suite but the 4-device one (whose
4-rank form is ``test_torch_shard.py``'s) runs here on the same
numpy inputs through ``repro.serve`` (JAX on the CPU) and
``repro_torch.serve`` (on the CPU), and the port is held to the reference's
outcome bitwise (payloads are small integers in float32, or int32):

* lookups — ``point`` / ``range_sum`` / ``range_scan`` / ``top_k`` on dense
  and hashed-COO views (slot layouts equal), with padding rows and zombies,
  ties in ``top_k``, ``k`` past the position axis, an int32 count ring and a
  degree-m ring's components;
* ``SnapshotRegistry`` — retention, pins, bad arguments;
* ``ViewServer`` — padding and slicing, the stats schema, publish and
  checkpoint sharing their copies (each view cloned once a boundary);
* acceptance — every pinned generation equals an offline recompute at its
  offset, and a reader thread under a fault and an in-process ``resume``
  sees only whole generations.
"""
import threading
import time

import numpy as np
import pytest

from _torch_durable import (BOTH, PORT, REF, SCHEDULES, disarm_faults,  # noqa: F401
                            engine, host, jax, jnp, result, stream, torch)
from repro import serve as rserve
from repro.serve import lookup as rlookup
from repro_torch import serve as tserve
from repro_torch.core import StreamExecutor
from repro_torch.serve import lookup as tlookup
from torch.utils import _pytree as pytree

SERVE = {"ref": rserve, "port": tserve}
LOOKUP = {"ref": rlookup, "port": tlookup}

DOMS = (5, 4, 3)
SCHEMA = ("A", "B", "C")
#: a bound past every linearized id of the chaos views
ALL = 1 << 30


def _arr(pkg, x):
    x = np.ascontiguousarray(x)
    return jnp.asarray(x) if pkg is REF else torch.from_numpy(x)


def _host_tree(pkg, tree):
    if pkg is REF:
        return jax.tree.map(np.asarray, jax.device_get(tree))
    return pytree.tree_map(lambda x: x.detach().cpu().numpy(), tree)


def assert_trees_equal(got, want, where=""):
    """Two host pytrees (dicts, tuples, arrays) equal leaf for leaf, dtypes
    included."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            assert_trees_equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            assert_trees_equal(a, b, f"{where}/{i}")
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype, (where, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=where)


def _np_views(seed=0, n=40, doms=DOMS, vals=None):
    rng = np.random.default_rng(seed)
    keys = np.stack([rng.integers(0, d, size=n) for d in doms],
                    axis=1).astype(np.int32)
    if vals is None:
        vals = rng.integers(-3, 4, size=n)
    return keys, np.asarray(vals)


def _views(pkg, keys, vals, ring_kind="sum", doms=DOMS, schema=SCHEMA,
           capacity=128):
    """(dense, sparse, numpy multiplicities) over ``keys`` -> ``vals`` in
    one package: the dense view from numpy, the sparse from the COO rows
    (repeated keys add, some net to exactly ring zero: zombies)."""
    ring = pkg.core.count_ring() if ring_kind == "count" else pkg.core.sum_ring()
    np_dtype = np.int32 if ring_kind == "count" else np.float32
    vals = vals.astype(np_dtype)
    mult = np.zeros(doms, np_dtype)
    np.add.at(mult, tuple(keys.T), vals)
    dense = pkg.core.DenseRelation(schema, ring, {"v": _arr(pkg, mult)})
    sparse = pkg.core.SparseRelation.from_coo(
        schema, ring, doms, _arr(pkg, keys), {"v": _arr(pkg, vals)},
        capacity=capacity)
    return dense, sparse, mult


def _pick(views, backend):
    return views[0] if backend == "dense" else views[1]


def _both_views(backend, **kw):
    keys, vals = _np_views(**{k: kw.pop(k) for k in ("seed", "n", "vals")
                              if k in kw})
    out = {}
    for pkg in BOTH:
        views = _views(pkg, keys, vals, **kw)
        out[pkg.name] = (pkg, _pick(views, backend), views[2])
    if backend == "sparse":  # slot for slot
        np.testing.assert_array_equal(host(PORT, out["port"][1].table),
                                      host(REF, out["ref"][1].table))
    return out


def _point_keys(n=16, seed=1, doms=DOMS, pad=2):
    rng = np.random.default_rng(seed)
    q = np.stack([rng.integers(0, d, size=n) for d in doms],
                 axis=1).astype(np.int32)
    bad = np.full((pad, len(doms)), -1, np.int32)
    bad[0, 1:] = 0  # one negative column is padding too
    return np.concatenate([q, bad])


# ---------------------------------------------------------------------------
# lookups: the port ≡ the reference ≡ numpy (both backends, bitwise)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_point_matches_reference(backend):
    cases = _both_views(backend)
    q = _point_keys()
    got = {}
    for name, (pkg, view, mult) in cases.items():
        got[name] = _host_tree(pkg, LOOKUP[name].point(view, _arr(pkg, q)))
    assert_trees_equal(got["port"], got["ref"])
    ref = np.concatenate([mult[tuple(q[:16].T)], np.zeros(2, np.float32)])
    np.testing.assert_array_equal(got["port"]["v"], ref)


@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_range_sum_matches_reference(backend):
    cases = _both_views(backend)
    flat = cases["port"][2].reshape(-1)
    for lo, hi in [(0, flat.size), (7, 41), (13, 13), (50, 9), (0, ALL)]:
        got = {name: _host_tree(pkg, LOOKUP[name].range_sum(
                   view, *((jnp.int32(lo), jnp.int32(hi)) if pkg is REF
                           else (lo, hi))))
               for name, (pkg, view, _) in cases.items()}
        assert_trees_equal(got["port"], got["ref"], f"[{lo}, {hi})")
        np.testing.assert_array_equal(got["port"]["v"],
                                      flat[lo:max(lo, hi)].sum())


@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_range_scan_matches_reference(backend):
    cases = _both_views(backend)
    flat = cases["port"][2].reshape(-1)
    for lo, hi, k in [(5, 50, 6), (0, ALL, 40), (30, 31, 3), (9, 2, 4)]:
        got = {}
        for name, (pkg, view, _) in cases.items():
            bounds = (jnp.int32(lo), jnp.int32(hi)) if pkg is REF else (lo, hi)
            got[name] = _host_tree(pkg, LOOKUP[name].range_scan(view, *bounds, k))
        assert_trees_equal(got["port"], got["ref"], f"[{lo}, {hi}) k={k}")
        keys, payload, valid = got["port"]
        ids = np.flatnonzero(flat != 0)
        sel = ids[(ids >= lo) & (ids < hi)][:k]
        nv = int(valid.sum())
        assert nv == len(sel)
        np.testing.assert_array_equal(keys[:nv],
                                      np.stack(np.unravel_index(sel, DOMS), 1))
        np.testing.assert_array_equal(payload["v"][:nv], flat[sel])
        assert not payload["v"][nv:].any()  # ring zero past the end


@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_top_k_matches_reference(backend):
    """Distinct positive values on distinct keys: a unique descending
    order; then ``k`` past the live population (valid=False, ring zero)."""
    rng = np.random.default_rng(2)
    S = int(np.prod(DOMS))
    ids = rng.choice(S, size=12, replace=False)
    keys = np.stack(np.unravel_index(ids, DOMS), 1).astype(np.int32)
    vals = rng.permutation(np.arange(1, 13))
    got = {}
    for pkg in BOTH:
        view = _pick(_views(pkg, keys, vals, capacity=64), backend)
        got[pkg.name] = [_host_tree(pkg, LOOKUP[pkg.name].top_k(view, k))
                         for k in (5, 16)]
    assert_trees_equal(got["port"], got["ref"])
    (tkeys, tvals, valid), (_, v2, valid2) = got["port"]
    order = np.argsort(-vals)[:5]
    assert valid.all()
    np.testing.assert_array_equal(tvals, vals[order].astype(np.float32))
    np.testing.assert_array_equal(tkeys, keys[order])
    assert int(valid2.sum()) == 12 and not v2[12:].any()


@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_top_k_ties_match_reference(backend):
    """Integer data with many equal values: the port places equal values
    in ascending position, as ``lax.top_k`` does."""
    cases = _both_views(backend, n=60, vals=np.tile([2, 2, 1, 3, 3, -1], 10),
                        capacity=128)
    for k in (1, 7, 20, 60):
        got = {name: _host_tree(pkg, LOOKUP[name].top_k(view, k))
               for name, (pkg, view, _) in cases.items()}
        assert_trees_equal(got["port"], got["ref"], f"k={k}")


@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_k_beyond_the_position_axis_raises(backend):
    """Both packages refuse a ``k`` larger than the position axis (60
    dense keys, 64 sparse slots)."""
    cases = _both_views(backend, capacity=64)
    for name, (pkg, view, _) in cases.items():
        with pytest.raises(ValueError):
            LOOKUP[name].top_k(view, 61 if backend == "dense" else 65)
        with pytest.raises(ValueError):
            bounds = ((jnp.int32(0), jnp.int32(ALL)) if pkg is REF
                      else (0, ALL))
            LOOKUP[name].range_scan(view, *bounds,
                                    61 if backend == "dense" else 65)


@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_count_ring_lookups_keep_int32(backend):
    """An int32 count ring: ``torch.sum`` would return int64, the
    reference's ``jnp.sum`` int32 — the port casts back."""
    cases = _both_views(backend, ring_kind="count")
    q = _point_keys()
    got = {}
    for name, (pkg, view, _) in cases.items():
        lk = LOOKUP[name]
        bounds = (jnp.int32(3), jnp.int32(ALL)) if pkg is REF else (3, ALL)
        got[name] = _host_tree(pkg, (lk.point(view, _arr(pkg, q)),
                                     lk.range_sum(view, *bounds),
                                     lk.range_scan(view, *bounds, 5),
                                     lk.top_k(view, 5)))
    assert_trees_equal(got["port"], got["ref"])
    assert got["port"][1]["v"].dtype == np.int32


@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_degree_m_ring_lookups_match_reference(backend):
    """A degree-2 cofactor ring: (c, s, Q) components of several shapes,
    ``top_k`` by an entry of Q, and a view with no key columns (its point
    reads broadcast over the batch)."""
    rng = np.random.default_rng(4)
    n = 30
    keys = np.stack([rng.integers(0, d, size=n) for d in DOMS],
                    axis=1).astype(np.int32)
    comps = {"c": rng.integers(-2, 3, size=n), "s": rng.integers(-2, 3, size=(n, 2)),
             "Q": rng.integers(-2, 3, size=(n, 2, 2))}
    q = _point_keys(n=6)
    got = {}
    for pkg in BOTH:
        ring = pkg.core.DegreeMRing(2)
        mult = {c: np.zeros(DOMS + v.shape[1:], np.float32) for c, v in comps.items()}
        for c, v in comps.items():
            np.add.at(mult[c], tuple(keys.T), v.astype(np.float32))
        if backend == "dense":
            view = pkg.core.DenseRelation(SCHEMA, ring,
                                          {c: _arr(pkg, m) for c, m in mult.items()})
        else:
            view = pkg.core.SparseRelation.from_coo(
                SCHEMA, ring, DOMS, _arr(pkg, keys),
                {c: _arr(pkg, v.astype(np.float32)) for c, v in comps.items()},
                capacity=64)
        root = pkg.core.DenseRelation((), ring, {
            c: _arr(pkg, m.sum(axis=(0, 1, 2))) for c, m in mult.items()})
        lk = LOOKUP[pkg.name]
        bounds = (jnp.int32(4), jnp.int32(50)) if pkg is REF else (4, 50)
        got[pkg.name] = _host_tree(pkg, (
            lk.point(view, _arr(pkg, q)), lk.range_sum(view, *bounds),
            lk.range_scan(view, *bounds, 4), lk.top_k(view, 6, "Q", (1, 0)),
            lk.top_k(view, 3, "s", (1,)),
            lk.point(root, _arr(pkg, np.zeros((5, 0), np.int32)))))
    assert_trees_equal(got["port"], got["ref"])
    assert got["port"][-1]["Q"].shape == (5, 2, 2)


def _zombie_reads(pkg):
    lk = LOOKUP[pkg.name]
    kw = {"device": "cpu"} if pkg is PORT else {}
    sparse = pkg.core.SparseRelation.zeros(("A",), pkg.core.sum_ring(), (32,),
                                           capacity=16, **kw)
    keys = _arr(pkg, np.array([[3], [11], [20]], np.int32))
    sparse = sparse.scatter_add(keys, {"v": _arr(pkg, np.array([4., 6., 9.], np.float32))})
    sparse = sparse.scatter_add(keys[1:2], {"v": _arr(pkg, np.array([-6.], np.float32))})
    assert sparse.num_slots_used_sync() == 3  # the zombie holds its slot
    bounds = (jnp.int32(0), jnp.int32(32)) if pkg is REF else (0, 32)
    return _host_tree(pkg, (lk.point(sparse, keys), lk.range_sum(sparse, *bounds),
                            lk.range_scan(sparse, *bounds, 4), lk.top_k(sparse, 3),
                            sparse.table))


def test_lookups_are_zombie_transparent():
    """Keys deleted down to exact ring zero keep their slot but never
    surface through any lookup."""
    got = {pkg.name: _zombie_reads(pkg) for pkg in BOTH}
    assert_trees_equal(got["port"], got["ref"])
    pt, rs, (skeys, _, valid), (tkeys, tvals, tvalid), _ = got["port"]
    np.testing.assert_array_equal(pt["v"], [4.0, 0.0, 9.0])
    np.testing.assert_array_equal(rs["v"], 13.0)
    assert int(valid.sum()) == 2
    np.testing.assert_array_equal(skeys[:2], [[3], [20]])
    assert int(tvalid.sum()) == 2
    np.testing.assert_array_equal(tvals[:2], [9.0, 4.0])
    np.testing.assert_array_equal(tkeys[:2], [[20], [3]])


# ---------------------------------------------------------------------------
# SnapshotRegistry: retention, pinning, monotonicity
# ---------------------------------------------------------------------------
def _registry_run(pkg):
    reg = SERVE[pkg.name].SnapshotRegistry(retain=2)

    def full(g):
        return _arr(pkg, np.full((3,), g, np.int32))

    out = []
    for g in range(4):
        reg.publish({"x": full(g)})
    out.append((reg.generation, reg.publishes))
    with pytest.raises(LookupError):
        reg.get(0)  # evicted by double-buffered retention
    reg.pin()   # newest (3)
    reg.pin(2)
    for g in range(4, 8):
        reg.publish({"x": full(g)})
    # pinned generations survive any number of publishes, values intact
    out.append([host(pkg, reg.get(g).views["x"]).tolist() for g in (2, 3)])
    out.append(reg.stats()["pinned"])
    reg.release(2)
    reg.release(3)
    with pytest.raises(LookupError):
        reg.get(2)  # the release of an out-of-window pin evicts at once
    st = reg.stats()
    out.append({k: st[k] for k in ("generation", "publishes", "retained", "pinned",
                                   "publish_to_first_read_s")})
    return out


def test_registry_retention_and_pin_protects_eviction():
    got = {pkg.name: _registry_run(pkg) for pkg in BOTH}
    assert got["port"] == got["ref"]
    assert got["port"][1] == [[2] * 3, [3] * 3]
    assert got["port"][-1]["retained"] == 2


def test_registry_rejects_bad_args():
    for pkg in BOTH:
        srv = SERVE[pkg.name]
        with pytest.raises(ValueError):
            srv.SnapshotRegistry(retain=0)
        with pytest.raises(ValueError):
            srv.SnapshotRegistry(segment_updates=0)
        reg = srv.SnapshotRegistry()
        with pytest.raises(LookupError):
            reg.latest()  # nothing published yet
        reg.publish({"x": _arr(pkg, np.zeros(2, np.float32))})
        with pytest.raises(LookupError):
            reg.pin(7)


def test_publish_copies_and_never_aliases_the_state():
    """A published generation holds copies: writing the live views in place
    afterwards (as the next segment's graphs do) leaves it as it was."""
    eng = engine(PORT, storage="sparse")
    reg = tserve.SnapshotRegistry()
    snap = reg.publish(eng.views)
    before = {n: [t.clone() for t in pytree.tree_leaves(v)]
              for n, v in snap.views.items()}
    for n, v in eng.views.items():
        live = set(t.data_ptr() for t in pytree.tree_leaves(v))
        assert not live & set(t.data_ptr() for t in pytree.tree_leaves(snap.views[n]))
        for t in pytree.tree_leaves(v):
            t.add_(1)
    for n, v in snap.views.items():
        for a, b in zip(pytree.tree_leaves(v), before[n]):
            assert torch.equal(a, b), n


# ---------------------------------------------------------------------------
# ViewServer: padding, telemetry schema, copy sharing with the checkpointer
# ---------------------------------------------------------------------------
def same_outcome(fn, *args):
    outs = {pkg.name: fn(pkg, *args) for pkg in BOTH}
    assert outs["port"] == outs["ref"]
    return outs["port"]


def _padded_point(pkg, keys_as):
    eng = engine(pkg, storage="sparse")
    pkg.core.StreamExecutor(eng).run(stream(pkg))
    server = SERVE[pkg.name].ViewServer(pkg.core.StreamExecutor(eng))
    name = sorted(server.registry.latest().views)[0]
    view = eng.views[name]
    rng = np.random.default_rng(5)
    keys = np.stack([rng.integers(0, int(view.domain_of(v)), size=5)
                     for v in view.schema], axis=1).astype(np.int32)
    res = server.point(name, keys if pkg is REF or keys_as == "numpy"
                       else torch.from_numpy(keys))
    assert res.kind == "point" and res.generation == 0
    got = res.host()
    direct = _host_tree(pkg, LOOKUP[pkg.name].point(view, _arr(pkg, keys)))
    for c in direct:
        assert got[c].shape[0] == 5  # the pad rows (to MIN_BATCH=8) sliced off
        np.testing.assert_array_equal(got[c], direct[c])
    return got


@pytest.mark.parametrize("keys_as", ["numpy", "tensor"])
def test_viewserver_pads_and_slices_batches(keys_as):
    got = {pkg.name: _padded_point(pkg, keys_as) for pkg in BOTH}
    assert_trees_equal(got["port"], got["ref"])


def test_pad_keys_pads_to_a_power_of_two():
    for b, want in ((1, 8), (8, 8), (9, 16), (33, 64)):
        keys = np.arange(2 * b, dtype=np.int32).reshape(b, 2)
        for given in (keys, torch.from_numpy(keys)):
            padded, n = tserve.ViewServer._pad_keys(given, torch.device("cpu"))
            assert n == b and tuple(padded.shape) == (want, 2)
            assert padded.dtype == torch.int32
            np.testing.assert_array_equal(padded[:b].numpy(), keys)
            assert (padded[b:] == -1).all()
        padded, n = tserve.ViewServer._pad_keys(np.arange(b), torch.device("cpu"))
        assert tuple(padded.shape) == (want, 1) and n == b


REF_SEGMENT_KEYS = {"segment", "n_steps", "admit_s", "dispatch_s", "save_s",
                    "audit_s", "publish_s", "generation", "straggler",
                    "straggler_baseline"}
#: the port's segment stats carry these beyond the reference's
PORT_SEGMENT_EXTRAS = {"updates", "grow", "save_dispatch_s", "run"}
SERVER_KEYS = {"generation", "publishes", "retained", "pinned", "publish_s",
               "publish_to_first_read_s", "generation_lag",
               "last_segment_stats", "straggler_baseline"}


def _stats_run(pkg):
    eng = engine(pkg, storage="dense")
    ex = pkg.core.StreamExecutor(eng)
    server = SERVE[pkg.name].ViewServer(ex, segment_updates=3)
    ex.run(stream(pkg))
    st = server.stats()
    assert set(st) == SERVER_KEYS
    seg = st["last_segment_stats"]
    want = REF_SEGMENT_KEYS | (PORT_SEGMENT_EXTRAS if pkg is PORT else set())
    assert all(set(e) == want for e in seg)
    out = [st["generation"], st["publishes"], st["generation_lag"],
           [e["generation"] for e in seg], [e["n_steps"] for e in seg]]
    name = sorted(server.registry.latest().views)[0]
    server.point(name, np.zeros((2, len(eng.views[name].schema)), np.int32))
    st = server.stats()
    out += [st["generation_lag"], st["publish_to_first_read_s"] is not None]
    return out


def test_viewserver_stats_schema():
    """The stats surface other tooling keys off: the reference's nine keys
    exactly, its segment keys as a subset plus the port's named extras."""
    got = same_outcome(_stats_run)
    # bootstrap + one boundary per 3-update segment of the 8-update stream
    assert got == [3, 4, 3, [1, 2, 3], got[4], 0, True]


def test_publish_meta_stamps_the_audit():
    """With an auditing integrity config, each generation carries the
    boundary audit's outcome (``integrity.publish_meta``), as the
    reference's."""
    def run(pkg):
        eng = engine(pkg, storage="sparse", store_base=True)
        cfg = pkg.integ.IntegrityConfig(policy="quarantine", audit_interval=2,
                                        segment_updates=2)
        ex = pkg.core.StreamExecutor(eng, integrity=cfg)
        server = SERVE[pkg.name].ViewServer(ex, retain=16)
        ex.run(stream(pkg))
        reg = server.registry
        return [(reg.get(g).offset, reg.get(g).segment, reg.get(g).meta)
                for g in range(reg.generation + 1)]

    got = same_outcome(run)
    assert got[0][2] == {"bootstrap": True}
    assert any(m.get("audited") for _, _, m in got)


def test_registry_run_must_update_the_engine():
    eng = engine(PORT, storage="dense")
    ex = StreamExecutor(eng)
    tserve.ViewServer(ex)
    with pytest.raises(ValueError, match="registry-attached"):
        ex.run(stream(PORT), update_engine=False)


class _CloneCount(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the tensor copies a block makes (``clone`` and ``copy_`` into
    fresh tensors are what a snapshot costs)."""

    def __init__(self):
        super().__init__()
        self.clones = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.clone.default:
            self.clones += 1
        return func(*args, **(kwargs or {}))


def test_boundary_publish_and_checkpoint_share_copies(tmp_path):
    """A boundary that both publishes and checkpoints hands the registry's
    copies to the checkpointer: the saved leaves of every served view are
    the published tensors, each view is cloned once a boundary (counted),
    and the restored snapshot equals the live engine bitwise."""
    eng = engine(PORT, storage="sparse")
    ck = PORT.state.StreamCheckpointer(str(tmp_path / "port"), segment_updates=2)
    ex = StreamExecutor(eng, checkpoint=ck)
    server = tserve.ViewServer(ex, segment_updates=2)
    handed: list = []
    save_leaves = ck.ckpt.save_leaves

    def spy(leaves, *a, **kw):
        handed.append(list(leaves))
        return save_leaves(leaves, *a, **kw)

    ck.ckpt.save_leaves = spy
    publish = server.registry.publish
    published: list = []

    def spy_publish(*a, **kw):
        snap = publish(*a, **kw)
        published.append(snap)
        return snap

    server.registry.publish = spy_publish
    upds = stream(PORT, schedule=SCHEDULES["rounds"])
    ex.run(upds)
    assert server.registry.generation >= 4 and len(handed) == len(published) >= 4
    for leaves, snap in zip(handed, published):
        ptrs = {t.data_ptr() for t in leaves}
        for name, v in snap.views.items():
            assert all(t.data_ptr() in ptrs for t in pytree.tree_leaves(v)), name
    # clones of one boundary, publish then save: one table and one plane a
    # sparse view, one clone a leaf of every state part the publish left
    state = PORT.core.canonical_state(eng.state)
    n_sparse = sum(isinstance(v, PORT.core.SparseRelation) for v in eng.views.values())
    n_dense_leaves = sum(len(pytree.tree_leaves(v)) for v in eng.views.values()
                         if not isinstance(v, PORT.core.SparseRelation))
    rest = sum(len(pytree.tree_leaves(part)) for part in state[1:])
    counter = _CloneCount()
    with counter:
        snap = server.registry.publish(eng.views, offset=len(upds), segment=9)
        ck.save_boundary(eng, offset=len(upds), segment=9, view_copies=snap.views)
        ck.wait()
    assert counter.clones == 2 * n_sparse + n_dense_leaves + rest
    eng2 = engine(PORT, storage="sparse")
    meta = ck.restore_into(eng2)
    assert meta["offset"] == len(upds)
    np.testing.assert_array_equal(result(PORT, eng2), result(PORT, eng))
    for n in eng.views:
        for a, b in zip(pytree.tree_leaves(eng.views[n]),
                        pytree.tree_leaves(eng2.views[n])):
            assert torch.equal(a, b), n


def test_boundary_publish_and_checkpoint_match_reference(tmp_path):
    """The reference's copy-sharing case in both packages: the same
    generations and a restored state equal to the reference's."""
    def run(pkg):
        eng = engine(pkg, storage="sparse")
        ck = pkg.state.StreamCheckpointer(str(tmp_path / pkg.name), segment_updates=2)
        ex = pkg.core.StreamExecutor(eng, checkpoint=ck)
        server = SERVE[pkg.name].ViewServer(ex, segment_updates=2)
        upds = stream(pkg)
        ex.run(upds)
        eng2 = engine(pkg, storage="sparse")
        meta = ck.restore_into(eng2)
        return (server.registry.generation, meta["offset"],
                result(pkg, eng2).tolist(), ck.ckpt.all_steps())

    got = same_outcome(run)
    assert got[0] >= 4 and got[1] == 8


# ---------------------------------------------------------------------------
# acceptance: pinned generations == offline recomputation at that offset
# ---------------------------------------------------------------------------
def _probe_keys(view, n=6):
    if not view.schema:
        return np.zeros((n, 0), np.int32)
    return np.stack([np.arange(n) % int(view.domain_of(v))
                     for v in view.schema], axis=1).astype(np.int32)


def _offline_reads(pkg, storage, offset, probe):
    """Replay ``stream[:offset]`` on a fresh engine and read every view
    through the same lookups."""
    eng = engine(pkg, storage=storage)
    if offset:
        pkg.core.StreamExecutor(eng).run(stream(pkg)[:offset])
    srv = SERVE[pkg.name].ViewServer(pkg.core.StreamExecutor(eng))
    out = {}
    for n in sorted(srv.registry.latest().views):
        out[n] = (srv.point(n, probe[n]).host(),
                  srv.range_sum(n, 0, ALL).host())
    return eng, out


def _generations(pkg, storage):
    eng = engine(pkg, storage=storage)
    ex = pkg.core.StreamExecutor(eng)
    server = SERVE[pkg.name].ViewServer(ex, retain=32, segment_updates=2)
    upds = stream(pkg)
    ex.run(upds)
    reg = server.registry
    assert reg.generation >= 4  # bootstrap + a boundary per 2 updates
    names = sorted(reg.latest().views)
    probe = {n: _probe_keys(eng.views[n]) for n in names}
    out = []
    for g in range(reg.generation + 1):
        with server.pin(g) as p:
            snap = reg.get(g)
            assert p.offset == snap.offset
            ref_eng, ref_reads = _offline_reads(pkg, storage, snap.offset, probe)
            reads = {}
            for n in names:
                for a, b in zip(jax.tree.leaves(snap.views[n]) if pkg is REF
                                else pytree.tree_leaves(snap.views[n]),
                                jax.tree.leaves(ref_eng.views[n]) if pkg is REF
                                else pytree.tree_leaves(ref_eng.views[n])):
                    np.testing.assert_array_equal(host(pkg, a), host(pkg, b))
                reads[n] = (_host_tree(pkg, p.point(n, probe[n]).data),
                            _host_tree(pkg, p.range_sum(n, 0, ALL).data))
                assert_trees_equal(reads[n], ref_reads[n], f"{g}/{n}")
            out.append((g, snap.offset, snap.segment, reads))
    assert reg.latest().offset == len(upds)
    return out


@pytest.mark.parametrize("storage", ["dense", "sparse"])
def test_every_generation_matches_offline_recompute(storage):
    """Each published generation's views (all of them — the atomicity
    contract) equal a fresh engine that replayed exactly ``snap.offset``
    leading stream updates, and the port's generations equal the
    reference's, offsets and reads."""
    got = {pkg.name: _generations(pkg, storage) for pkg in BOTH}
    assert [g[:3] for g in got["port"]] == [g[:3] for g in got["ref"]]
    for a, b in zip(got["port"], got["ref"]):
        assert_trees_equal(a[3], b[3], f"generation {a[0]}")


def _chaos_reads(pkg, storage, tmp_path):
    eng = engine(pkg, storage=storage)
    upds = stream(pkg)
    ex = pkg.core.StreamExecutor(eng, checkpoint=pkg.state.StreamCheckpointer(
        str(tmp_path / pkg.name), segment_updates=2))
    server = SERVE[pkg.name].ViewServer(ex, segment_updates=2)
    names = sorted(server.registry.latest().views)
    probe = {n: _probe_keys(eng.views[n]) for n in names}
    for n in names:  # warm the lookups on the current layouts
        server.point(n, probe[n])
        server.range_sum(n, 0, ALL)
    seen: dict = {}
    errors: list = []
    stop = threading.Event()

    def reader():
        try:
            while not stop.is_set():
                with server.pin() as p:
                    if p.generation not in seen:
                        vals = {n: (_host_tree(pkg, p.point(n, probe[n]).data),
                                    _host_tree(pkg, p.range_sum(n, 0, ALL).data))
                                for n in names}
                        seen[p.generation] = (p.offset, vals)
                time.sleep(0.001)
        except Exception as e:  # noqa: BLE001 — surfaced by the assert below
            errors.append(e)

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        with pkg.faults.inject("mid_segment", at=1):
            with pytest.raises(pkg.faults.InjectedFault):
                ex.resume(upds)
        ex.resume(upds)  # in-process restart; the registry stays attached
        deadline = time.time() + 10
        while server.registry.generation not in seen and time.time() < deadline:
            time.sleep(0.005)
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive(), "the reader thread did not stop"
    assert not errors, errors
    assert len(seen) >= 2
    assert max(off for off, _ in seen.values()) == len(upds)
    offline: dict = {}
    for g, (offset, vals) in sorted(seen.items()):
        if offset not in offline:
            _, offline[offset] = _offline_reads(pkg, storage, offset, probe)
        assert_trees_equal(vals, offline[offset], f"generation {g}")
    return result(pkg, eng), server.registry


@pytest.mark.parametrize("storage", ["dense", "sparse"])
def test_reader_thread_never_sees_torn_generation(tmp_path, storage):
    """The chaos criterion: a reader thread issuing pinned multi-view
    lookups *while* segments execute under fault injection (a fault, then
    an in-process resume) sees only whole generations — every observed
    (generation, offset, values) triple equals an offline recompute at
    that offset — and the final views equal the reference's."""
    got, reg = _chaos_reads(PORT, storage, tmp_path)
    want, _ = _chaos_reads(REF, storage, tmp_path)
    np.testing.assert_array_equal(got, want)
    restored = [g for g in range(reg.generation + 1)
                if g in reg._snaps and reg._snaps[g].meta.get("restored")]
    assert all(reg._snaps[g].segment == -1 for g in restored)


def test_resume_republishes_the_restored_state(tmp_path):
    """``resume`` publishes the restored state as a generation of its own
    (``meta={"restored": True}``) before it replays the rest, in both
    packages at the same generation and offset."""
    def run(pkg):
        eng = engine(pkg, storage="sparse")
        upds = stream(pkg)
        ex = pkg.core.StreamExecutor(eng, checkpoint=pkg.state.StreamCheckpointer(
            str(tmp_path / pkg.name), segment_updates=2))
        server = SERVE[pkg.name].ViewServer(ex, retain=64, segment_updates=2)
        with pkg.faults.inject("mid_segment", at=2):
            with pytest.raises(pkg.faults.InjectedFault):
                ex.run(upds)
        ex.resume(upds)
        reg = server.registry
        return [(g, reg.get(g).offset, reg.get(g).segment, reg.get(g).meta)
                for g in range(reg.generation + 1)]

    got = same_outcome(run)
    restored = [e for e in got if e[3].get("restored")]
    assert len(restored) == 1 and restored[0][2] == -1


def test_registry_under_concurrent_pins_and_publishes():
    """Eight reader threads pin the newest generation twice, release once,
    read it and release again, while the stream thread publishes 200
    generations and the interpreter switches threads every 10 µs: a
    generation with a pin held is never evicted (a lost pin count would
    let it go), every one holds its own values, and at the end no pin is
    left and ``retain`` generations are."""
    import sys

    reg = tserve.SnapshotRegistry(retain=2)
    reg.publish({"x": torch.full((64,), 0, dtype=torch.int32)})
    errors: list = []
    stop = threading.Event()

    def reader():
        try:
            while not stop.is_set():
                g = reg.pin().generation
                reg.pin(g)  # a second pin, released first
                reg.release(g)
                try:
                    # one pin still held: g may not have been evicted
                    if not bool((reg.get(g).views["x"] == g).all()):
                        errors.append(f"generation {g} torn")
                finally:
                    reg.release(g)
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=reader, daemon=True) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        for g in range(1, 201):
            reg.publish({"x": torch.full((64,), g, dtype=torch.int32)})
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    st = reg.stats()
    assert st["generation"] == 200 and st["publishes"] == 201
    assert st["pinned"] == {} and st["retained"] == 2
