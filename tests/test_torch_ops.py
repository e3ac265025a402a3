"""The port's kernel-ops layer ≡ the reference's ``repro.kernels.ops``.

The same numpy inputs, made from a seed, go through the reference's
functions (``backend="jnp"``, and one small ``backend="interpret"`` case
per kernel so that the Pallas body itself is compared) and through
``repro_torch.kernels.ops`` on the CPU (the kernels' plain versions), at
the shapes of ``tests/test_kernels.py``.  Tolerances:

* integer-valued float32 data: bitwise (every sum is exact in float32);
* normal data, elementwise results (``ring_mul``): within 1e-6 of the
  largest magnitude (ROADMAP's rule for general float rings);
* normal data, reductions over n terms (``cofactor_update``,
  ``segment_ring_sum``, ``matvec``, ``rank1_chain_update``): the two
  packages sum in different orders (XLA's blocking against PyTorch's), and
  float32 recursive summation of n terms errs by at most (n - 1)·2⁻²⁴·Σ|terms|
  in any order, with one rounding per product on top, so two orders differ
  by at most (n + 2)·2⁻²³·Σ|terms| per element (Σ|terms| in float64).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402

_torch_parity.cap_torch_threads()
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as rops  # noqa: E402
from repro_torch.core.rings import DegreeMRing  # noqa: E402
from repro_torch.kernels import _cuda, ops, ref  # noqa: E402
from repro_torch.kernels import ring_mul as tring_mul  # noqa: E402

EPS = 2.0 ** -23

COFACTOR_SHAPES = [(1, 1), (7, 3), (64, 8), (100, 7), (256, 43), (33, 130)]
RING_MUL_SHAPES = [(1, 1), (4, 5), (16, 16), (9, 33), (32, 130)]
SEGMENT_SHAPES = [(10, 4, 3), (100, 16, 7), (64, 130, 5), (513, 8, 11)]
MATVEC_SHAPES = [(8, 8), (32, 16), (130, 70)]


def _data(rng, shape, kind):
    if kind == "ints":
        return rng.integers(-4, 5, size=shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_same(got, want):
    """Bitwise, with the reference's shape and dtype."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def assert_within_sum_bound(got, want, n_terms, abs_sum):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    bound = (n_terms + 2) * EPS * np.asarray(abs_sum, np.float64)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (err <= bound).all(), float((err - bound).max())


def assert_within_rel(got, want, rtol=1e-6):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = np.abs(want).max(initial=0.0)
    assert np.abs(got - want).max(initial=0.0) <= rtol * scale


def _cpu(*arrays):
    return [torch.tensor(a) for a in arrays]


# ---------------------------------------------------------------------------
# cofactor_update
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["ints", "normal"])
@pytest.mark.parametrize("B,m", COFACTOR_SHAPES)
def test_cofactor_update_matches_reference(B, m, kind):
    rng = np.random.default_rng(B * 1000 + m)
    x, w = _data(rng, (B, m), kind), _data(rng, (B,), kind)
    got = ops.cofactor_update(*_cpu(x, w))
    want = rops.cofactor_update(x, w, backend="jnp")
    assert got[0].shape == (1,)
    if kind == "ints":
        for g, r in zip(got, want):
            assert_same(g, r)
        return
    ax, aw = np.abs(x).astype(np.float64), np.abs(w).astype(np.float64)
    sums = (aw.sum(keepdims=True), aw @ ax, (ax * aw[:, None]).T @ ax)
    for g, r, a in zip(got, want, sums):
        assert_within_sum_bound(g, r, B, a)


def test_cofactor_update_matches_pallas_interpret():
    rng = np.random.default_rng(11)
    x, w = _data(rng, (7, 3), "ints"), _data(rng, (7,), "ints")
    want = rops.cofactor_update(x, w, backend="interpret")
    for g, r in zip(ops.cofactor_update(*_cpu(x, w)), want):
        assert_same(g, r)


def test_cofactor_update_deletes_with_negative_weights():
    rng = np.random.default_rng(12)
    x = _data(rng, (50, 5), "ints")
    w = np.ones(50, np.float32)
    c, s, Q = ops.cofactor_update(*_cpu(x, w))
    c2, s2, Q2 = ops.cofactor_update(*_cpu(x, -w))
    assert_same(Q, x.T @ x)
    assert_same(Q2, -Q.numpy())
    assert_same(c2, -c.numpy())


# ---------------------------------------------------------------------------
# ring_mul
# ---------------------------------------------------------------------------
def _ring_operands(rng, K, m, kind):
    return [_data(rng, s, kind) for s in ((K,), (K, m), (K, m, m))]


@pytest.mark.parametrize("kind", ["ints", "normal"])
@pytest.mark.parametrize("K,m", RING_MUL_SHAPES)
def test_ring_mul_matches_reference(K, m, kind):
    rng = np.random.default_rng(K * 1000 + m)
    args = _ring_operands(rng, K, m, kind) + _ring_operands(rng, K, m, kind)
    got = ops.ring_mul(*_cpu(*args))
    want = rops.ring_mul(*args, backend="jnp")
    for g, r in zip(got, want):
        (assert_same if kind == "ints" else assert_within_rel)(g, r)


def test_ring_mul_matches_pallas_interpret():
    rng = np.random.default_rng(13)
    args = _ring_operands(rng, 4, 5, "ints") + _ring_operands(rng, 4, 5, "ints")
    want = rops.ring_mul(*args, backend="interpret")
    for g, r in zip(ops.ring_mul(*_cpu(*args)), want):
        assert_same(g, r)


@pytest.mark.parametrize("K,m", [(8, 6), (9, 33)])
def test_ring_mul_is_the_ports_ring_product_bitwise(K, m):
    """On normal data: ``ops.ring_mul`` ≡ ``DegreeMRing.mul``, also on the
    column slices of one [K, d] payload plane (the engine's layout)."""
    rng = np.random.default_rng(K + m)
    ring = DegreeMRing(m)
    d = 1 + m + m * m
    planes = [torch.tensor(_data(rng, (K, d), "normal")) for _ in range(2)]
    a, b = ({"c": p[:, 0], "s": p[:, 1:1 + m], "Q": p[:, 1 + m:].reshape(K, m, m)}
            for p in planes)
    assert not a["s"].is_contiguous()
    want = ring.mul(a, b)
    got = ops.ring_mul(a["c"], a["s"], a["Q"], b["c"], b["s"], b["Q"])
    for comp, g in zip(("c", "s", "Q"), got):
        assert torch.equal(g, want[comp]), comp
        assert g.is_contiguous()


def test_ring_mul_rejects_operands_not_dense_within_a_key():
    Q = torch.zeros((3, 4, 4)).transpose(1, 2)
    with pytest.raises(ValueError, match="dense within each key"):
        tring_mul.ring_mul(torch.zeros(3), torch.zeros((3, 4)), Q,
                           torch.zeros(3), torch.zeros((3, 4)), Q)


# ---------------------------------------------------------------------------
# segment_ring_sum
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["ints", "normal"])
@pytest.mark.parametrize("B,d,S", SEGMENT_SHAPES)
def test_segment_ring_sum_matches_reference(B, d, S, kind):
    rng = np.random.default_rng(B + d + S)
    v = _data(rng, (B, d), kind)
    ids = rng.integers(-1, S + 1, size=(B,)).astype(np.int32)  # padding too
    got = ops.segment_ring_sum(*_cpu(v, ids), S)
    want = rops.segment_ring_sum(v, ids, S, backend="jnp")
    if kind == "ints":
        assert_same(got, want)
        return
    keep = (ids >= 0) & (ids < S)
    abs_sum = np.zeros((S, d))
    np.add.at(abs_sum, ids[keep], np.abs(v[keep]).astype(np.float64))
    assert_within_sum_bound(got, want, B, abs_sum)


def test_segment_ring_sum_matches_pallas_interpret():
    rng = np.random.default_rng(14)
    v = _data(rng, (10, 4), "ints")
    ids = rng.integers(0, 3, size=(10,)).astype(np.int32)
    want = rops.segment_ring_sum(v, ids, 3, backend="interpret")
    assert_same(ops.segment_ring_sum(*_cpu(v, ids), 3), want)


def test_segment_ring_sum_casts_as_the_reference():
    """float64 values and int64 ids come back float32, as the reference
    casts them."""
    v = np.arange(12, dtype=np.float64).reshape(4, 3)
    ids = np.array([1, 0, 1, 5], np.int64)
    got = ops.segment_ring_sum(torch.tensor(v), torch.tensor(ids), 2)
    want = rops.segment_ring_sum(v.astype(np.float32), ids.astype(np.int32), 2,
                                 backend="jnp")
    assert_same(got, want)


@pytest.mark.parametrize("B,S,d", [(37, 13, 5), (9, 40, 1), (130, 7, 111)])
def test_segment_ring_sum_drops_out_of_range_like_pallas_interpret(B, S, d):
    """B ≠ S, with ids < 0 and >= S (which drop), against the Pallas kernel
    in interpret mode."""
    rng = np.random.default_rng(B * S + d)
    v = _data(rng, (B, d), "ints")
    ids = rng.integers(0, S, size=(B,)).astype(np.int32)
    ids[:3] = -1
    ids[3:5] = S + rng.integers(0, 4, size=2)
    ids = rng.permutation(ids)
    want = rops.segment_ring_sum(v, ids, S, backend="interpret")
    assert_same(ops.segment_ring_sum(*_cpu(v, ids), S), want)


# ---------------------------------------------------------------------------
# matvec and rank1_chain_update
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["ints", "normal"])
@pytest.mark.parametrize("n,k", MATVEC_SHAPES)
def test_matvec_matches_reference(n, k, kind):
    rng = np.random.default_rng(n * 100 + k)
    A, x = _data(rng, (n, k), kind), _data(rng, (k,), kind)
    want = rops.matvec(A, x, backend="jnp")
    # row-major A, and A as the transposed view of a row-major Aᵀ
    for At in (torch.tensor(A), torch.tensor(np.ascontiguousarray(A.T)).T):
        got = ops.matvec(At, torch.tensor(x))
        if kind == "ints":
            assert_same(got, want)
        else:
            assert_within_sum_bound(got, want, k, np.abs(A).astype(np.float64)
                                    @ np.abs(x).astype(np.float64))


@pytest.mark.parametrize("kind", ["ints", "normal"])
@pytest.mark.parametrize("n", [n for n, _ in MATVEC_SHAPES])
def test_rank1_chain_update_matches_reference(n, kind):
    rng = np.random.default_rng(n)
    A1, A3, V = (_data(rng, (n, n), kind) for _ in range(3))
    u, v = _data(rng, (n,), kind), _data(rng, (n,), kind)
    got = ops.rank1_chain_update(*_cpu(A1, u, v, A3, V))
    want = rops.rank1_chain_update(A1, u, v, A3, V, backend="jnp")
    if kind == "ints":
        assert_same(got, want)
        return
    # u2 and v2 are n-term sums; the outer product and the add round once
    # more each, relative to |V| + |u2||v2|
    a = lambda t: np.abs(t).astype(np.float64)  # noqa: E731
    abs_sum = np.outer(a(A1) @ a(u), a(v) @ a(A3))
    assert_within_sum_bound(got, want, n + 2, a(V) + 2 * abs_sum)


def test_matvec_and_rank1_chain_match_pallas_interpret():
    rng = np.random.default_rng(15)
    A1, A3, V = (_data(rng, (8, 8), "ints") for _ in range(3))
    u, v = _data(rng, (8,), "ints"), _data(rng, (8,), "ints")
    assert_same(ops.matvec(*_cpu(A1, u)), rops.matvec(A1, u, backend="interpret"))
    assert_same(ops.rank1_chain_update(*_cpu(A1, u, v, A3, V)),
                rops.rank1_chain_update(A1, u, v, A3, V, backend="interpret"))


def test_rank1_chain_update_is_the_chain_delta():
    """V' = V + (A1 u)(vᵀ A3) = V + A1 (u vᵀ) A3 (Example 7.1), exactly on
    integer-valued data."""
    rng = np.random.default_rng(16)
    A1, A3, V = (_data(rng, (16, 16), "ints") for _ in range(3))
    u, v = _data(rng, (16,), "ints"), _data(rng, (16,), "ints")
    got = ops.rank1_chain_update(*_cpu(A1, u, v, A3, V))
    assert_same(got, V + A1 @ np.outer(u, v) @ A3)
    assert_same(ref.rank1_chain_ref(*_cpu(A1, u, v, A3, V)), got.numpy())


# ---------------------------------------------------------------------------
# devices and the build
# ---------------------------------------------------------------------------
def test_ops_take_the_tensors_device_and_default_to_cuda():
    x = np.ones((4, 2), np.float32)
    c, s, Q = ops.cofactor_update(x, np.ones(4, np.float32), device="cpu")
    assert c.device.type == "cpu" and float(c[0]) == 4.0
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA, so the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.cofactor_update(x, np.ones(4, np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.matvec(x, np.ones(2, np.float32))


def test_every_kernel_has_its_own_source(monkeypatch):
    """build_all starts one ``nvcc`` per kernel into ``<library>.<pid>.tmp``,
    so two kernels of one source would write one file: it refuses them
    before building anything, and the port's nine kernels each have their
    own source."""
    from repro_torch.kernels.cofactor_update import COFACTOR_UPDATE
    from repro_torch.kernels.rank1_chain import MATVEC, OUTER_ACCUMULATE
    from repro_torch.kernels.ring_fused import FUSED_CHAIN
    from repro_torch.kernels.ring_mul import RING_MUL
    from repro_torch.kernels.ring_scatter import (GATHER_MUL_SCATTER, SCATTER_ADD,
                                                  SCATTER_DEDUP)
    from repro_torch.kernels.segment_ring_sum import SEGMENT_RING_SUM

    started = []
    monkeypatch.setattr(_cuda.CudaKernel, "start_build",
                        lambda self: started.append(self.source))
    twin = _cuda.CudaKernel("matvec.cu", "repro_other_entry", [])
    with pytest.raises(ValueError, match="share a source"):
        _cuda.build_all([MATVEC, twin])
    assert started == []
    kernels = [SCATTER_ADD, SEGMENT_RING_SUM, GATHER_MUL_SCATTER, SCATTER_DEDUP,
               FUSED_CHAIN, COFACTOR_UPDATE, RING_MUL, MATVEC, OUTER_ACCUMULATE]
    _cuda.build_all(kernels)
    assert started == [k.source for k in kernels]
    assert len({k.library_path() for k in kernels}) == len(kernels)


@pytest.mark.parametrize("rows,width", [(0, 3), (1, 1), (33, 130), (4096, 32),
                                        (262_144, 130), (8192, 8192), (100_001, 7)])
def test_kernel_splits_cover_every_row_within_one_wave(rows, width):
    """The partitions the wrappers hand the column-matvec and cofactor
    kernels: for matvec every row in exactly one chunk, no chunk empty; for
    cofactor_update every whole quad of rows in exactly one block, in order,
    the last rows (fewer than four) left to the last cluster, and the grid
    whole clusters within the cap it is given (here MAX_BLOCKS, two blocks
    an SM) over all its passes, unless a pass alone needs a cluster.  The
    card's own one-wave cap (``repro_cofactor_max_clusters``, through
    ``max_blocks``) is checked on the card only."""
    from repro_torch.kernels import cofactor_update as tcof
    from repro_torch.kernels import rank1_chain

    splits, chunk = rank1_chain.column_splits(rows, width)
    assert 1 <= splits <= 65535 and splits * chunk >= rows
    assert rows == 0 or (splits - 1) * chunk < rows
    plan = tcof.cofactor_plan(rows, width, tcof.MAX_BLOCKS)
    assert plan.blocks % tcof.CLUSTER == 0
    assert plan.blocks * plan.passes <= max(tcof.MAX_BLOCKS, tcof.CLUSTER * plan.passes)
    ranges = [tcof.block_rows(rows, plan.blocks, b) for b in range(plan.blocks)]
    assert ranges[0][0] == 0 and ranges[-1][1] == rows - rows % 4
    assert all(hi == lo for (_, hi), (lo, _) in zip(ranges, ranges[1:]))
    assert all(lo % 4 == 0 and lo <= hi for lo, hi in ranges)
