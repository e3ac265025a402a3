"""The port's rings ≡ ``repro.core.rings``, bit for bit.

``add``, ``mul`` (same key shape and broadcast key shapes), ``zeros``,
``ones`` and ``lift`` of the sum, count and degree-3 rings, on
integer-valued payloads made with numpy, against the JAX reference.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402

_torch_parity.cap_torch_threads()
jnp = pytest.importorskip("jax.numpy")

from repro.core import rings as R  # noqa: E402
from repro_torch.core import rings as T  # noqa: E402

RINGS = {
    "sum": (R.sum_ring, T.sum_ring),
    "count": (R.count_ring, T.count_ring),
    "degree3": (lambda: R.DegreeMRing(3), lambda: T.DegreeMRing(3)),
}


def _payload(rng, ring_t, key_shape):
    np_dtype = np.int32 if ring_t.dtype == torch.int32 else np.float32
    return {c: rng.integers(-3, 4, size=(*key_shape, *shp)).astype(np_dtype)
            for c, shp in ring_t.components.items()}


def _both(p):
    return ({c: jnp.asarray(v) for c, v in p.items()},
            {c: torch.tensor(v) for c, v in p.items()})


def _assert_same(ref, port, dtype=None):
    """Equal values; the port's dtype is ``dtype`` (default: the
    reference's)."""
    assert set(ref) == set(port)
    for c in ref:
        got = port[c].numpy()
        want = np.asarray(ref[c])
        assert got.dtype == (dtype or want.dtype), (c, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(RINGS))
@pytest.mark.parametrize("op", ["add", "mul", "mul_broadcast", "zeros",
                                "ones", "lift"])
def test_ring_op_matches_reference(name, op):
    make_ref, make_port = RINGS[name]
    ring_r, ring_t = make_ref(), make_port()
    rng = np.random.default_rng(len(name) * 7 + len(op))
    # the reference multiplies every product term by the float 1.0, which
    # promotes count-ring (int32) products to float32; the port keeps the
    # ring's dtype (ROADMAP Queue 3)
    mul_dtype = np.int32 if name == "count" else None
    if op in ("add", "mul"):
        a_r, a_t = _both(_payload(rng, ring_t, (2, 3)))
        b_r, b_t = _both(_payload(rng, ring_t, (2, 3)))
        _assert_same(getattr(ring_r, op)(a_r, b_r), getattr(ring_t, op)(a_t, b_t),
                     dtype=mul_dtype if op == "mul" else None)
    elif op == "mul_broadcast":
        a_r, a_t = _both(_payload(rng, ring_t, (2, 3)))
        b_r, b_t = _both(_payload(rng, ring_t, (3,)))
        _assert_same(ring_r.mul(a_r, b_r), ring_t.mul(a_t, b_t), dtype=mul_dtype)
    elif op in ("zeros", "ones"):
        _assert_same(getattr(ring_r, op)((4, 2)),
                     getattr(ring_t, op)((4, 2), device="cpu"))
    else:
        x = np.arange(-2, 5).astype(np.float32)
        kw = {"var_index": 1} if name == "degree3" else {}
        _assert_same(ring_r.lift(jnp.asarray(x), **kw),
                     ring_t.lift(torch.tensor(x), **kw))


def test_rings_compare_by_structure():
    assert T.sum_ring() == T.sum_ring()
    assert T.DegreeMRing(3) == T.DegreeMRing(3)
    assert T.sum_ring() != T.count_ring()
    assert T.sum_ring() != T.sum_ring(torch.float64)
