"""The port's ⊎ plain versions and dispatch ≡ the reference's ⊎, bit for bit.

Each flat entry point of ``repro_torch.kernels.scatter_ops`` — under the
``torch``, ``scatter`` and ``compact`` backends, which on CPU tensors run
the kernels' plain versions — is held against the reference's ``jnp``
backend and its Pallas kernels in interpret mode (``onehot_interpret``,
``compact_interpret``), across duplicate keys, padding rows (id -1 with a
ring-zero payload), ids >= S, widths d in {1, 7, 111} and shapes that are
not block multiples.  Payloads are integer-valued f32, so every
accumulation order is exact and equality is bitwise.  The CUDA kernels
themselves are held against these plain versions in
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402

_torch_parity.cap_torch_threads()
jnp = pytest.importorskip("jax.numpy")

from _hypothesis_compat import given, settings, strategies as st  # noqa: E402
from repro.core import DegreeMRing as RDegreeMRing  # noqa: E402
from repro.core import count_ring as rcount_ring  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import scatter_ops as rscatter  # noqa: E402
from repro_torch.core import DenseRelation, DegreeMRing, count_ring  # noqa: E402
from repro_torch.core import storage  # noqa: E402
from repro_torch.kernels import ring_scatter, scatter_ops  # noqa: E402
from repro_torch.kernels import segment_ring_sum as tsegsum  # noqa: E402

REF_BACKENDS = ("jnp", "onehot_interpret", "compact_interpret")
PORT_BACKENDS = ("torch", "scatter", "compact")


def _ints(rng, shape, lo=-4, hi=5):
    return rng.integers(lo, hi, size=shape).astype(np.float32)


def _ids(rng, S, B, n_pad=3, n_over=2):
    """Ids with duplicates, padding (-1) and out-of-range (>= S) rows."""
    ids = rng.integers(0, S, size=B).astype(np.int32)
    ids[:n_pad] = -1
    ids[n_pad:n_pad + n_over] = S + rng.integers(0, 3, size=n_over)
    return rng.permutation(ids)


def _ref_scatter(view, ids, vals):
    outs = [np.asarray(rscatter.scatter_add_flat(
        jnp.asarray(view), jnp.asarray(ids), jnp.asarray(vals), backend=b))
        for b in REF_BACKENDS]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    return outs[0]


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("d", [1, 7, 111])
@given(seed=st.integers(0, 2**31 - 1), S=st.integers(1, 40),
       B=st.integers(6, 45))
@settings(max_examples=3, deadline=None)
def test_scatter_add_flat_matches_reference(backend, d, seed, S, B):
    rng = np.random.default_rng(seed)
    view = _ints(rng, (S, d))
    ids = _ids(rng, S, B)
    vals = _ints(rng, (B, d))
    vals[ids < 0] = 0.0  # padding rows carry the ring zero
    want = _ref_scatter(view, ids, vals)
    got = scatter_ops.scatter_add_flat(torch.tensor(view), torch.tensor(ids),
                                       torch.tensor(vals), backend=backend)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d", [1, 7, 111])
@given(seed=st.integers(0, 2**31 - 1), S=st.integers(1, 40),
       B=st.integers(6, 45))
@settings(max_examples=3, deadline=None)
def test_segment_ring_sum_matches_reference(d, seed, S, B):
    rng = np.random.default_rng(seed)
    ids = _ids(rng, S, B)
    vals = _ints(rng, (B, d))
    want_ref = np.asarray(rops.segment_ring_sum(
        jnp.asarray(vals), jnp.asarray(ids), S, backend="jnp"))
    want_pallas = np.asarray(rops.segment_ring_sum(
        jnp.asarray(vals), jnp.asarray(ids), S, backend="interpret"))
    np.testing.assert_array_equal(want_pallas, want_ref)
    got = tsegsum.segment_ring_sum(torch.tensor(vals), torch.tensor(ids), S)
    np.testing.assert_array_equal(got.numpy(), want_ref)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("S,Sg", [(13, 9), (5, 40), (33, 1)])
@given(seed=st.integers(0, 2**31 - 1))
@settings(max_examples=3, deadline=None)
def test_gather_mul_scatter_flat_matches_reference(backend, S, Sg, seed):
    rng = np.random.default_rng(seed)
    B, d = 21, 1
    view = _ints(rng, (S, d))
    src = _ints(rng, (Sg, d))
    out_ids = _ids(rng, S, B, n_pad=2, n_over=1)
    in_ids = rng.integers(0, Sg, size=B).astype(np.int32)
    scale = _ints(rng, (B,), -2, 3)
    # a padding row that keeps a valid out_id clamps its gather and
    # carries scale 0
    in_ids[-2:] = -1
    scale[-2:] = 0.0
    args = (view, out_ids, src, in_ids, scale)
    outs = [np.asarray(rscatter.gather_mul_scatter_flat(
        *map(jnp.asarray, args), backend=b)) for b in REF_BACKENDS]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    got = scatter_ops.gather_mul_scatter_flat(*map(torch.tensor, args),
                                              backend=backend)
    np.testing.assert_array_equal(got.numpy(), outs[0])


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("m", [1, 3])
def test_scatter_add_payload_degree_m(backend, m):
    """(c, s, Q) payloads flatten to one [S, 1+m+m²] plane and back;
    duplicate keys and key-0 ring-zero padding rows."""
    rng = np.random.default_rng(m)
    ring_r, ring_t = RDegreeMRing(m), DegreeMRing(m)
    doms, B = (3, 4), 14
    view = {c: _ints(rng, (*doms, *shp)) for c, shp in ring_t.components.items()}
    keys = np.stack([rng.integers(0, dd, size=B) for dd in doms],
                    axis=1).astype(np.int32)
    keys[-3:] = 0
    vals = {c: _ints(rng, (B, *shp)) for c, shp in ring_t.components.items()}
    for v in vals.values():
        v[-3:] = 0.0
    want = rscatter.scatter_add_payload(
        {c: jnp.asarray(v) for c, v in view.items()}, doms, jnp.asarray(keys),
        {c: jnp.asarray(v) for c, v in vals.items()}, ring_r, backend="jnp")
    got = scatter_ops.scatter_add_payload(
        {c: torch.tensor(v) for c, v in view.items()}, doms, torch.tensor(keys),
        {c: torch.tensor(v) for c, v in vals.items()}, ring_t, backend=backend)
    for c in ring_t.components:
        np.testing.assert_array_equal(got[c].numpy(), np.asarray(want[c]))


def test_scatter_add_payload_count_ring_stays_int32():
    """Non-f32 payloads (count ring) take the exact index_put_ path."""
    rng = np.random.default_rng(3)
    view = rng.integers(0, 4, size=(5,)).astype(np.int32)
    keys = rng.integers(0, 5, size=(9, 1)).astype(np.int32)
    vals = rng.integers(-2, 3, size=(9,)).astype(np.int32)
    want = rscatter.scatter_add_payload(
        {"v": jnp.asarray(view)}, (5,), jnp.asarray(keys),
        {"v": jnp.asarray(vals)}, rcount_ring())
    got = scatter_ops.scatter_add_payload(
        {"v": torch.tensor(view)}, (5,), torch.tensor(keys),
        {"v": torch.tensor(vals)}, count_ring(), backend="compact")
    assert got["v"].dtype == torch.int32
    np.testing.assert_array_equal(got["v"].numpy(), np.asarray(want["v"]))


def test_owned_view_scatters_in_place():
    """A relation the engine owns keeps its components as slices of one
    plane, so the ⊎ updates that plane without concatenating a copy."""
    rng = np.random.default_rng(5)
    ring = DegreeMRing(2)
    rel = DenseRelation(("a",), ring, {
        c: torch.tensor(_ints(rng, (6, *shp)))
        for c, shp in ring.components.items()}).owned()
    plane = storage.flatten_payload(ring, rel.payload, rel.domains)
    assert plane.data_ptr() == rel.payload["c"].data_ptr()
    keys = torch.tensor([[1], [4], [1]], dtype=torch.int32)
    vals = {c: torch.ones((3, *shp)) for c, shp in ring.components.items()}
    before = plane.clone()
    new = rel.scatter_add(keys, vals, backend="scatter")
    assert new.payload["Q"].data_ptr() == rel.payload["Q"].data_ptr()
    assert torch.equal(plane[1], before[1] + 2) and torch.equal(plane[0], before[0])


def test_linear_ids_round_trip():
    keys = torch.tensor([[0, 0, 0], [1, 2, 3], [2, 4, 1]], dtype=torch.int32)
    doms = (3, 5, 4)
    ids = storage.linear_ids(keys, doms)
    assert ids.dtype == torch.int32
    assert ids.tolist() == [0, 1 * 20 + 2 * 4 + 3, 2 * 20 + 4 * 4 + 1]
    assert torch.equal(storage.unlinearize_ids(ids, doms), keys)


def test_backend_resolution(monkeypatch):
    monkeypatch.delenv(scatter_ops.ENV_VAR, raising=False)
    monkeypatch.setenv("REPRO_SCATTER_BACKEND", "compact_xla")  # not read
    res = scatter_ops.resolve_backend
    assert res(10**6, 1000, 1, device="cpu") == "torch"
    assert res(8000, 1000, 1, device="cuda") == "scatter"
    assert res(8001, 1000, 1, device="cuda") == "compact"
    assert res(4096, 10, 1, device="cuda") == "scatter"
    assert res(4097, 10, 1, device="cuda") == "compact"
    monkeypatch.setenv(scatter_ops.ENV_VAR, "compact")
    assert res(5, 1, 1, device="cpu") == "compact"
    with scatter_ops.use_backend("scatter"):
        assert res(5, 1, 1, device="cpu") == "scatter"
        assert res(5, 1, 1, "torch", device="cpu") == "torch"
    assert scatter_ops.active_override() == "compact"
    with pytest.raises(ValueError):
        res(5, 1, 1, "onehot", device="cpu")


def test_wrappers_check_their_inputs():
    view = torch.zeros((4, 2))
    ids = torch.zeros((3,), dtype=torch.int32)
    vals = torch.zeros((3, 2))
    with pytest.raises(TypeError):
        ring_scatter.scatter_add(view, ids.long(), vals)
    with pytest.raises(ValueError):
        ring_scatter.scatter_add(view, ids, torch.zeros((3, 3)))
    with pytest.raises(ValueError):
        ring_scatter.scatter_add(torch.zeros((2, 4)).t(), ids, vals)
    with pytest.raises(TypeError):
        tsegsum.segment_ring_sum(vals.double(), ids, 4)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_subnormal_payloads_reference_flushes_plain_versions_keep(backend):
    """Float32 payloads near 1e-40 (below 2^-126): the reference's XLA ⊎
    (the ``jnp`` backend) flushes them to 0, and so does every reduction of
    the reference on the CPU; the port's plain versions keep them (torch on
    the CPU does not flush).  On the card the kernels flush, as the
    reference does (``tests/test_torch_cuda.py::
    test_cuda_scatter_kernels_flush_subnormals``): the plain versions are
    the side that differs from the reference, and only in this range."""
    tiny = np.float32(1e-40)
    assert 0 < tiny < np.finfo(np.float32).tiny
    ids = np.array([0, 0, 2, -1, 5], np.int32)
    vals = np.full((5, 3), tiny, np.float32)
    want = np.asarray(rscatter.scatter_add_flat(
        jnp.zeros((4, 3), jnp.float32), jnp.asarray(ids), jnp.asarray(vals),
        backend="jnp"))
    assert not want.any()  # flushed
    assert float(jnp.sum(jnp.asarray(vals))) == 0.0
    got = scatter_ops.scatter_add_flat(torch.zeros((4, 3)), torch.tensor(ids),
                                       torch.tensor(vals), backend=backend)
    keep = np.zeros((4, 3), np.float32)
    keep[0] = np.float32(2 * tiny)  # two rows, exact in the subnormal range
    keep[2] = tiny
    np.testing.assert_array_equal(got.numpy(), keep)
