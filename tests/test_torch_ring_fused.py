"""The port's fused-chain runtime and tile dedup ≡ the reference's, bit for bit.

``repro_torch.kernels.ring_fused`` (``fused_ring_spec``, ``ring_mul_flat``,
the plain ``fused_apply``) and ``ring_scatter.tile_dedup`` /
``scatter_dedup`` against ``repro.kernels.ring_fused`` and
``repro.kernels.ring_scatter``: the reference's flat-XLA lowering
(``fused_xla``) and its Pallas kernels in interpret mode
(``fused_interpret``, ``onehot_dedup_interpret``).  Degree m in {1, 3, 10}
and scalar rings, padded columns, duplicate ids, padding rows (id -1 with a
ring-zero payload) and out-of-range gather ids.  Payloads are
integer-valued float32, so every accumulation order is exact and equality
is bitwise.  The CUDA kernels are held against these plain versions in
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402

_torch_parity.cap_torch_threads()
jnp = pytest.importorskip("jax.numpy")

from repro.core import DegreeMRing as RDegreeMRing  # noqa: E402
from repro.core import count_ring as rcount_ring  # noqa: E402
from repro.core import sum_ring as rsum_ring  # noqa: E402
from repro.kernels import ring_fused as rfused  # noqa: E402
from repro.kernels import ring_scatter as rring_scatter  # noqa: E402
from repro.kernels import scatter_ops as rscatter  # noqa: E402
from repro_torch.core import DegreeMRing, count_ring, sum_ring  # noqa: E402
from repro_torch.kernels import ring_fused, ring_scatter, scatter_ops  # noqa: E402

SPECS = [("scalar",), ("degree", 1), ("degree", 3), ("degree", 10)]


def _ints(rng, shape, lo=-3, hi=4):
    return rng.integers(lo, hi, size=shape).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: ".".join(map(str, s)))
@pytest.mark.parametrize("pad", [0, 5])
def test_ring_mul_flat_matches_reference(spec, pad):
    rng = np.random.default_rng(len(spec) * 11 + pad)
    d = ring_fused.spec_width(spec)
    assert d == rfused.spec_width(spec)
    a, b = _ints(rng, (2, 7, d)), _ints(rng, (2, 7, d))
    if pad:  # padded feature planes: zero columns stay zero
        a = np.pad(a, ((0, 0), (0, 0), (0, pad)))
        b = np.pad(b, ((0, 0), (0, 0), (0, pad)))
    got = ring_fused.ring_mul_flat(_t(a), _t(b), spec).numpy()
    want = np.asarray(rfused.ring_mul_flat(jnp.asarray(a), jnp.asarray(b), spec))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_fused_ring_spec_matches_reference():
    pairs = [(sum_ring(), rsum_ring()), (DegreeMRing(3), RDegreeMRing(3)),
             (DegreeMRing(10), RDegreeMRing(10)), (count_ring(), rcount_ring())]
    for port, ref in pairs:
        assert ring_fused.fused_ring_spec(port) == rfused.fused_ring_spec(ref)
    assert ring_fused.fused_ring_spec(count_ring()) is None  # int dtype
    assert ring_fused.fused_ring_spec(sum_ring(torch.float64)) is None


@pytest.mark.parametrize("n,d", [(1, 1), (16, 1), (40, 7), (32, 111)])
def test_tile_dedup_matches_reference(n, d):
    rng = np.random.default_rng(n + d)
    ids = rng.integers(-1, 4, size=n).astype(np.int32)  # heavy duplicates
    vals = _ints(rng, (n, d))
    mids, sums = ring_scatter.tile_dedup(_t(ids), _t(vals))
    rmids, rsums = rring_scatter.tile_dedup(jnp.asarray(ids), jnp.asarray(vals))
    np.testing.assert_array_equal(mids.numpy(), np.asarray(rmids))
    # only first occurrences are scattered; other rows are masked
    keep = np.asarray(rmids) >= 0
    np.testing.assert_array_equal(sums.numpy()[keep], np.asarray(rsums)[keep])


def _chain_case(rng, spec, S, B, n_src, pad_rows=0):
    """view, out_ids, vals and sources of one chain; the last ``pad_rows``
    rows are padding: out id -1, ring-zero value, gather ids -1 and past
    the plane's last row (clamp and one-hot must agree on them)."""
    d = ring_fused.spec_width(spec)
    view = _ints(rng, (S, d))
    out_ids = rng.integers(0, S, size=B).astype(np.int32)
    vals = _ints(rng, (B, d), -2, 3)
    sources = []
    for _ in range(n_src):
        Sg = int(rng.integers(1, 12))
        ids = rng.integers(0, Sg, size=B).astype(np.int32)
        if pad_rows:
            ids[B - pad_rows:] = np.where(np.arange(pad_rows) % 2, -1, Sg + 2)
        sources.append((_ints(rng, (Sg, d), -2, 3), ids))
    if pad_rows:
        out_ids[B - pad_rows:] = -1
        vals[B - pad_rows:] = 0.0
    return view, out_ids, vals, sources


def _ref_fused(view, out_ids, vals, sources, spec):
    outs = [np.asarray(rfused.fused_apply(
        jnp.asarray(view), jnp.asarray(out_ids), jnp.asarray(vals),
        [(jnp.asarray(p), jnp.asarray(i)) for p, i in sources], spec,
        backend=b)) for b in ("fused_xla", "fused_interpret")]
    np.testing.assert_array_equal(outs[0], outs[1])
    return outs[0]


def _port_fused(view, out_ids, vals, sources, spec, product=False):
    prod = torch.empty((len(out_ids), view.shape[1])) if product else None
    out = ring_fused.fused_apply(
        _t(view), _t(out_ids), _t(vals), [(_t(p), _t(i)) for p, i in sources],
        spec, product_out=prod)
    return out.numpy(), prod


@pytest.mark.parametrize("spec,n_src", [
    (("scalar",), 0), (("scalar",), 4), (("degree", 1), 2), (("degree", 3), 1),
    (("degree", 3), 4), (("degree", 10), 1), (("degree", 10), 2)],
    ids=lambda v: ".".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_fused_apply_matches_reference(spec, n_src):
    rng = np.random.default_rng(len(spec) * 31 + n_src)
    S, B = int(rng.integers(2, 20)), int(rng.integers(20, 40))
    case = _chain_case(rng, spec, S, B, n_src, pad_rows=4)
    got, prod = _port_fused(*case, spec, product=True)
    np.testing.assert_array_equal(got, _ref_fused(*case, spec))
    # the per-row product the kernel hands to a later chain
    view, out_ids, vals, sources = case
    cur = jnp.asarray(vals)
    for p, i in sources:
        cur = rfused.ring_mul_flat(cur, jnp.take(jnp.asarray(p), jnp.asarray(i),
                                                 axis=0, mode="clip"), spec)
    np.testing.assert_array_equal(prod.numpy(), np.asarray(cur))


@pytest.mark.parametrize("spec", [("scalar",), ("degree", 10)],
                         ids=lambda s: ".".join(map(str, s)))
def test_fused_apply_collapsed_scalar_target(spec):
    """A collapsed-to-scalar view: every row hits slot 0 (the tile dedup's
    best case), duplicates across several tiles."""
    rng = np.random.default_rng(5)
    view, _, vals, sources = _chain_case(rng, spec, 1, 70, 2)
    out_ids = np.zeros(70, np.int32)
    got, _ = _port_fused(view, out_ids, vals, sources, spec)
    np.testing.assert_array_equal(got, _ref_fused(view, out_ids, vals, sources,
                                                  spec))


def test_fused_apply_checks_its_operands():
    view = torch.zeros((4, 1))
    ids = torch.zeros((3,), dtype=torch.int32)
    vals = torch.zeros((3, 1))
    src = (torch.ones((2, 1)), ids)
    with pytest.raises(ValueError, match="at most 4"):
        ring_fused.fused_apply(view, ids, vals, [src] * 5, ("scalar",))
    with pytest.raises(TypeError):
        ring_fused.fused_apply(view, ids.long(), vals, [src], ("scalar",))
    with pytest.raises(ValueError, match="no rows"):
        ring_fused.fused_apply(view, ids, vals, [(torch.ones((0, 1)), ids)],
                               ("scalar",))


def test_chain_smem_model():
    """The H100 model: deterministic in the width, within a block's shared
    memory at the degree-10 width, tiles of 8 rows there; exactly the
    launch's request (no shared memory at width 1, a thread a row; else the
    tile of grouped rows and 8 warps' (c, s) slots for 4 sources)."""
    assert ring_fused.chain_smem_bytes(111) == ring_fused.chain_smem_bytes(111)
    assert ring_scatter.tile_rows(111) == 8
    assert ring_scatter.tile_rows(1) == 32
    assert ring_scatter.tile_rows(931) == 8
    assert ring_fused.chain_smem_bytes(111) == 4 * (8 * 111 + 8 * 2 * 4 * 11)
    assert ring_fused.chain_smem_bytes(1) == 0
    assert ring_fused.chain_smem_bytes(1) < ring_fused.chain_smem_bytes(111) \
        <= ring_fused.SMEM_PER_BLOCK
    # degree 30 (d = 931): 8-row tiles inside one block; degree 80
    # (d = 6481) is the widest that fits, degree 81 (d = 6643) is past it,
    # so such a chain stays unfused
    assert ring_fused.chain_smem_bytes(931) == 4 * (8 * 931 + 8 * 2 * 4 * 31)
    assert ring_fused.chain_smem_bytes(931) <= ring_fused.SMEM_PER_BLOCK
    assert ring_fused.chain_smem_bytes(1 + 80 + 6400) <= ring_fused.SMEM_PER_BLOCK
    assert ring_fused.chain_smem_bytes(1 + 81 + 6561) > ring_fused.SMEM_PER_BLOCK


def test_resolve_backend():
    assert ring_fused.resolve_backend(None, "cpu") == "fused_torch"
    assert ring_fused.resolve_backend("scatter", "cuda") == "fused_cuda"
    assert ring_fused.resolve_backend(None, "cuda") == "fused_cuda"
    assert ring_fused.resolve_backend("torch", "cuda") == "fused_torch"
    with scatter_ops.use_backend("torch"):
        assert ring_fused.resolve_backend(None, "cuda") == "fused_torch"


@pytest.mark.parametrize("d", [1, 7, 111])
@pytest.mark.parametrize("S,B", [(1, 50), (9, 300), (40, 33)])
def test_scatter_dedup_backend_matches_reference(d, S, B):
    rng = np.random.default_rng(S * 7 + B + d)
    view = _ints(rng, (S, d))
    ids = rng.integers(0, S, size=B).astype(np.int32)
    ids[:3] = -1
    ids[3:5] = S + 1
    vals = _ints(rng, (B, d))
    vals[:3] = 0.0
    want = np.asarray(rscatter.scatter_add_flat(
        jnp.asarray(view), jnp.asarray(ids), jnp.asarray(vals),
        backend="onehot_dedup_interpret"))
    got = scatter_ops.scatter_add_flat(_t(view), _t(ids), _t(vals),
                                       backend="scatter_dedup")
    np.testing.assert_array_equal(got.numpy(), want)
    with scatter_ops.use_backend("scatter_dedup"):
        got = scatter_ops.scatter_add_flat(_t(view), _t(ids), _t(vals))
    np.testing.assert_array_equal(got.numpy(), want)


def test_auto_never_picks_scatter_dedup():
    for S in (1, 100, 10_000, 10 ** 7):
        for dev in ("cpu", "cuda"):
            assert scatter_ops.resolve_backend(S, 1000, 111, device=dev) != \
                "scatter_dedup"
