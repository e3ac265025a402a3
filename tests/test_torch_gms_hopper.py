"""The tile-dedup ``gather_mul_scatter`` kernel's arithmetic on the CPU, as
``tests/_dedup_order.py::gather_mul_scatter_order`` emulates it.

The emulation (each row's product ``src[clip(in_id)] · scale`` rounded
once, then per tile of ``tile_rows(d)`` rows the group of each in-range out
id summed at its lowest row in ascending row order, then one add into the
view) is held bitwise to the port's plain version
(``ref.gather_mul_scatter_ref``, which the wrapper runs on CPU tensors) and
to the JAX package's ``gather_mul_scatter`` on its XLA path and in
interpret mode, on integer-valued float32, where every order of the adds
is exact.  Cases: padding out ids (-1 and >= S), gather ids out of range
(clamped), S = 1 (every row one id), out ids repeating within a tile and
across tiles.  On normal data the emulation is within float32 rounding of
the plain version.  ``tests/test_torch_cuda.py`` holds the kernel bitwise
to the emulation on the card.  Also the wrapper layer: the backend is
resolved once a payload call, and int32 ids pass through unconverted.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _dedup_order as order  # noqa: E402
import _torch_parity  # noqa: E402

_torch_parity.cap_torch_threads()
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import scatter_ops as rscatter_ops  # noqa: E402
from repro_torch.core import sum_ring  # noqa: E402
from repro_torch.kernels import ref, ring_scatter, scatter_ops  # noqa: E402


def _ints(rng, shape, lo=-4, hi=5):
    return rng.integers(lo, hi, size=shape).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


def _case(rng, S, Sg, B, d):
    """view, out ids (duplicates, three -1, two >= S; one id twice in the
    first tile and again in the second), source plane, gather ids in
    [-2, Sg + 2) (clamped), integer scales."""
    view = _ints(rng, (S, d))
    out_ids = rng.integers(0, S, size=B).astype(np.int32)
    out_ids[:3] = -1
    out_ids[3:5] = S + rng.integers(0, 3, size=2)
    out_ids = rng.permutation(out_ids)
    T = ring_scatter.tile_rows(d)
    out_ids[[1, 2, T + 1]] = rng.integers(0, S)
    src = _ints(rng, (Sg, d), -3, 4)
    in_ids = rng.integers(-2, Sg + 2, size=B).astype(np.int32)
    scale = _ints(rng, (B,), -2, 3)
    return view, out_ids, src, in_ids, scale


def _repeats(ids, S, T):
    """(an in-range id repeats within a tile, one appears in two tiles)."""
    within, tiles_of = False, {}
    for r0 in range(0, len(ids), T):
        tile = [int(i) for i in ids[r0:r0 + T] if 0 <= i < S]
        within |= len(tile) != len(set(tile))
        for i in set(tile):
            tiles_of[i] = tiles_of.get(i, 0) + 1
    return within, any(n > 1 for n in tiles_of.values())


CASES = [(1, 9, 70), (9, 40, 300), (96, 7, 257), (1000, 3000, 333)]


@pytest.mark.parametrize("d", [1, 3, 43, 111])
@pytest.mark.parametrize("S,Sg,B", CASES)
def test_gms_order_matches_plain(d, S, Sg, B):
    rng = np.random.default_rng(S + Sg + B + d)
    view, out_ids, src, in_ids, scale = _case(rng, S, Sg, B, d)
    assert _repeats(out_ids, S, ring_scatter.tile_rows(d)) == (True, True)
    got = order.gather_mul_scatter_order(view, out_ids, src, in_ids, scale)
    want = ref.gather_mul_scatter_ref(_t(view), _t(out_ids), _t(src), _t(in_ids),
                                      _t(scale)).numpy()
    np.testing.assert_array_equal(got, want)
    # the wrapper's CPU branch is the plain version
    wrapped = ring_scatter.gather_mul_scatter(_t(view), _t(out_ids), _t(src),
                                              _t(in_ids), _t(scale)).numpy()
    np.testing.assert_array_equal(wrapped, want)


@pytest.mark.parametrize("d", [1, 111])
@pytest.mark.parametrize("S,Sg,B", CASES[:3] + [(300, 128, 1000)])
def test_gms_order_matches_reference(d, S, Sg, B):
    """Against the JAX package's XLA path (``jnp``: clamped gather, out ids
    out of range dropped) and its Pallas kernel in interpret mode, whose
    one-hot gather reads a zero row at an id out of range: that lowering
    gets the clamped gather ids."""
    rng = np.random.default_rng(7 * S + Sg + d)
    view, out_ids, src, in_ids, scale = _case(rng, S, Sg, B, d)
    got = order.gather_mul_scatter_order(view, out_ids, src, in_ids, scale)
    clamped = np.clip(in_ids, 0, Sg - 1).astype(np.int32)
    for backend, ids in (("jnp", in_ids), ("onehot_interpret", clamped)):
        want = rscatter_ops.gather_mul_scatter_flat(
            jnp.asarray(view), jnp.asarray(out_ids), jnp.asarray(src),
            jnp.asarray(ids), jnp.asarray(scale), backend=backend)
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("d", [1, 7, 111])
def test_gms_order_on_normal_data_is_within_rounding(d):
    """Normal data: the tile order is one order of the same float32 adds,
    so each view element is within float32 rounding of the plain version
    (one rounding a product, at most B adds)."""
    rng = np.random.default_rng(d + 1)
    S, Sg, B = 5, 64, 400  # heavy duplicates
    view = rng.standard_normal((S, d)).astype(np.float32)
    src = rng.standard_normal((Sg, d)).astype(np.float32)
    out_ids = rng.integers(-1, S + 1, size=B).astype(np.int32)
    in_ids = rng.integers(-1, Sg + 1, size=B).astype(np.int32)
    scale = rng.standard_normal(B).astype(np.float32)
    got = order.gather_mul_scatter_order(view, out_ids, src, in_ids, scale)
    want = ref.gather_mul_scatter_ref(_t(view).double(), _t(out_ids), _t(src).double(),
                                      _t(in_ids), _t(scale).double()).numpy()
    prods = np.abs(src[np.clip(in_ids, 0, Sg - 1)] * scale[:, None]).astype(np.float64)
    keep = (out_ids >= 0) & (out_ids < S)
    mags = np.abs(view).astype(np.float64)
    np.add.at(mags, out_ids[keep], prods[keep])
    assert np.all(np.abs(got - want) <= (B + 1) * 2.0 ** -24 * mags)


def test_gms_single_tile_sums_leader_first():
    """One tile at d = 1 with one id: the leader's product, then the others'
    in ascending row order, then the view: the emulation's sum is that
    chain of float32 adds, which differs from another order on this data."""
    vals = np.array([1.0, 2.0 ** -24, 2.0 ** -24, -1.0], np.float32)
    src = vals[:, None]
    ids = np.zeros(4, np.int32)
    got = order.gather_mul_scatter_order(np.zeros((1, 1), np.float32), ids, src,
                                         np.arange(4, dtype=np.int32),
                                         np.ones(4, np.float32))
    s = np.float32(0.0) + (((vals[0] + vals[1]) + vals[2]) + vals[3])
    assert got[0, 0] == s == np.float32(0.0)
    assert (vals[3] + vals[0]) + (vals[1] + vals[2]) != s


def test_gms_tiles_are_tile_rows():
    assert [ring_scatter.tile_rows(d) for d in (1, 3, 43, 111, 931)] == [32, 32, 16, 8, 8]
    assert ring_scatter.GATHER_MUL_SCATTER.argtypes[-2] is ring_scatter.I32


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_int32_ids_pass_through(dtype):
    ids = torch.arange(10, dtype=dtype)
    got = scatter_ops._int32(ids)
    assert got.dtype is torch.int32 and got.is_contiguous()
    assert (got is ids) == (dtype is torch.int32)
    strided = torch.arange(20, dtype=torch.int32)[::2]
    assert scatter_ops._int32(strided).is_contiguous()
    assert torch.equal(scatter_ops._int32(strided), strided)


@pytest.mark.parametrize("backend", [None, "torch", "scatter", "compact"])
def test_payload_resolves_the_backend_once(monkeypatch, backend):
    """``gather_mul_scatter_payload`` resolves its backend once and hands
    it on; the result is the plain gather-⊗-⊎ on every backend."""
    rng = np.random.default_rng(3)
    ring = sum_ring()
    doms, B, Sg = (4, 5), 40, 9
    view = {"v": _t(_ints(rng, doms))}
    keys = _t(np.stack([rng.integers(0, n, size=B) for n in doms], 1).astype(np.int32))
    src = _t(_ints(rng, (Sg, 1)))
    in_ids = _t(rng.integers(0, Sg, size=B).astype(np.int32))
    scale = _t(_ints(rng, (B,), -2, 3))
    calls = []
    real = scatter_ops.resolve_backend

    def counted(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(scatter_ops, "resolve_backend", counted)
    want = view["v"].clone().reshape(-1, 1)
    ids = keys[:, 0] * doms[1] + keys[:, 1]
    ref.gather_mul_scatter_ref(want, ids, src, in_ids, scale)
    out = scatter_ops.gather_mul_scatter_payload(
        {"v": view["v"].clone()}, doms, keys, src, in_ids, scale, ring, backend=backend)
    assert len(calls) == 1
    assert torch.equal(out["v"], want.reshape(doms))
