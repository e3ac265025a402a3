"""The matvec kernels' CPU-side pieces against the plain version and the
JAX package.

``csrc/matvec.cu`` runs only on the card; what surrounds it is checked
here:

* the plan (``rank1_chain.matvec_plan``): for ragged shapes, k % 4 != 0
  and n != k, in the rows layout the TMA kernel's stages
  (``block_stages``) read every row of every x chunk exactly once within
  their budgets, and in the cols layout the cols kernel's splits cover
  every row once, with partials and counters to match;
* the layout choice: a row-major, 16-byte aligned A with k % 4 == 0 and an
  aligned x takes the TMA kernel, any other rows layout the SIMT rows
  kernel, and every cols layout the cols kernel;
* an emulation of the kernels' fixed summation order in numpy float32
  (``tests/_matvec_order.py``), bitwise equal to the plain version and to
  the reference's ``ops.matvec`` (``"jnp"`` backend, and the Pallas kernel
  in interpret mode on a small case) on integer-valued data, and within the
  float32 sum bound of float64 on normal data;
* the scratch cache of the cols layout stays bounded under stream churn.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402

_torch_parity.cap_torch_threads()
jnp = pytest.importorskip("jax.numpy")

from _matvec_order import matvec_order  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro_torch.kernels import rank1_chain  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

SMS = 132
#: (rows, cols) of the row-major matrix: the path's 8192 x 8192 and 1024,
#: ragged rows, cols % 4 != 0, cols above one x chunk (8192 floats), one
#: row, one column, and cols of several 32-column strips with a ragged last
#: one
SHAPES = [(8192, 8192), (1024, 1024), (1001, 332), (1001, 333), (300, 20000),
          (20000, 300), (7, 4), (5, 8196), (1, 1), (4, 100_000), (3, 5), (130, 70),
          (64, 16_388), (2000, 2052)]


def _covered(plan, rows, cols):
    """{(chunk, row): block} over every block's stages of a TMA rows plan,
    asserting that no (chunk, row) is read twice and that each stage fits."""
    seen = {}
    for b in range(plan.blocks):
        for key, r, count, c0, w in rank1_chain.block_stages(plan, rows, cols, b):
            assert 0 < count and 0 < w and c0 + w <= cols
            assert count * w <= rank1_chain.STAGE_FLOATS and w % 4 == 0
            assert (c0, w) == rank1_chain.chunk_bounds(cols)[key]
            for row in range(r, r + count):
                assert (key, row) not in seen
                seen[(key, row)] = b
    return seen


@pytest.mark.parametrize("transposed", [False, True], ids=["rows", "cols"])
@pytest.mark.parametrize("rows,cols", SHAPES)
def test_plan_covers_every_row_once_within_budgets(rows, cols, transposed):
    plan = rank1_chain.matvec_plan(rows, cols, transposed, True, SMS)
    if transposed:
        # every cols layout: the cols kernel's splits of chunk rows
        assert plan.kernel == "simt"
        splits, chunk = plan.blocks, plan.chunk
        assert splits * chunk >= rows and (splits - 1) * chunk < rows
        assert 1 <= splits <= min(65535, -(-rows // rank1_chain.MIN_CHUNK))
        assert plan.partial_floats == splits * cols
        assert plan.counter_words == -(-cols // rank1_chain.SIMT_STRIP)
        return
    if cols % 4 or rows == 0:
        assert plan.kernel == "simt"
        return
    assert plan.kernel == "tma" and 1 <= plan.blocks <= SMS
    seen = _covered(plan, rows, cols)
    chunks = rank1_chain.chunk_bounds(cols)
    assert sum(w for _, w in chunks) == cols
    assert all(w <= rank1_chain.STAGE_FLOATS for _, w in chunks)
    assert len(seen) == rows * len(chunks)
    assert plan.counter_words == plan.partial_floats == 0


def test_shared_memory_of_the_tma_kernels_fits_a_block():
    """x, the ring, the segment sums and the barriers of the TMA kernel
    within the 227 KB a block may take."""
    R = rank1_chain
    rows_smem = 4 * (R.STAGE_FLOATS + R.STAGES * R.STAGE_FLOATS + 2 * R.WARPS) \
        + 8 * (R.STAGES + 1)
    assert rows_smem <= 232_448


def _cpu_view(base, offset, shape, transposed):
    """A float32 CPU tensor of ``shape`` at ``offset`` floats into ``base``,
    row-major, or the transpose of a row-major [shape[1], shape[0]]."""
    n, k = shape
    if transposed:
        return base[offset:offset + n * k].view(k, n).T
    return base[offset:offset + n * k].view(n, k)


@pytest.mark.parametrize("n,k,offset,transposed,want", [
    (64, 64, 0, False, "tma"), (64, 64, 0, True, "simt"),
    (64, 64, 1, False, "simt"), (64, 64, 2, True, "simt"), (64, 64, 4, False, "tma"),
    (64, 63, 0, False, "simt"), (63, 64, 0, True, "simt"), (63, 64, 0, False, "tma"),
    (64, 63, 0, True, "simt"), (0, 8, 0, False, "simt"), (8, 0, 0, False, "simt")])
def test_layout_takes_the_tma_kernel_only_where_it_can(n, k, offset, transposed, want):
    """The TMA kernel takes the rows layout only, and needs A and x 16-byte
    aligned and a multiple of 4 columns; every cols layout takes the cols
    kernel.  The wrapper chooses from shape and layout alone."""
    base = torch.zeros(n * k + 16)
    assert base.data_ptr() % 16 == 0
    A = _cpu_view(base, offset, (n, k), transposed)
    x = torch.zeros(k)
    t, rows, cols, aligned = rank1_chain.layout(A, x)
    assert t == (transposed and n > 1 and k > 1)
    assert rank1_chain.matvec_plan(rows, cols, t, aligned, SMS).kernel == want


def test_layout_needs_x_aligned_in_the_rows_layout_only():
    A = torch.zeros(8, 8)
    x = torch.zeros(9)[1:]
    assert rank1_chain.layout(A, x)[3] is False
    assert rank1_chain.layout(A.T.contiguous().T, x)[3] is True
    with pytest.raises(ValueError, match="row-major"):
        rank1_chain.layout(torch.zeros(8, 16)[:, ::2], torch.zeros(8))


def _data(rng, shape, kind):
    if kind == "ints":
        return rng.integers(-4, 5, size=shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


#: shapes small enough for the numpy emulation, each reaching a different
#: part of the order: rows layout, 8 rows a stage and more (a warp a row),
#: 1-4 rows a stage (2-8 warps a row), two and three x chunks; cols layout,
#: one split and many, splits with fewer rows than warps, a ragged last
#: strip
ORDER_SHAPES = [(1024, 1024), (1001, 332), (20, 20000), (3, 8196), (300, 2052),
                (37, 4), (129, 1000), (2, 16_404)]


@pytest.mark.parametrize("kind", ["ints", "normal"])
@pytest.mark.parametrize("transposed", [False, True], ids=["rows", "cols"])
@pytest.mark.parametrize("rows,cols", ORDER_SHAPES)
def test_emulated_order_matches_plain_and_reference(rows, cols, transposed, kind):
    rng = np.random.default_rng(rows * 7 + cols)
    A = _data(rng, (rows, cols), kind)
    x = _data(rng, (cols if not transposed else rows,), kind)
    got = matvec_order(A, x, transposed, SMS)
    mat = A.T if transposed else A
    plain = ref.matvec_ref(torch.tensor(mat), torch.tensor(x)).numpy()
    want = np.asarray(rops.matvec(jnp.asarray(mat), jnp.asarray(x), backend="jnp"))
    if kind == "ints":
        assert np.array_equal(got, plain) and np.array_equal(got, want)
        return
    exact = mat.astype(np.float64) @ x.astype(np.float64)
    bound = mat.shape[1] * 2.0 ** -24 * (np.abs(mat).astype(np.float64) @ np.abs(x))
    assert np.all(np.abs(got - exact) <= bound + 1e-30)


def test_emulated_order_matches_pallas_interpret():
    """One small case through the reference's Pallas kernel in interpret
    mode (its tiles padded to 256), both layouts, integer-valued."""
    rng = np.random.default_rng(17)
    A = _data(rng, (24, 40), "ints")
    x, v = _data(rng, (40,), "ints"), _data(rng, (24,), "ints")
    assert np.array_equal(matvec_order(A, x, False, SMS),
                          np.asarray(rops.matvec(A, x, backend="interpret")))
    assert np.array_equal(matvec_order(A, v, True, SMS),
                          np.asarray(rops.matvec(A.T, v, backend="interpret")))


def test_emulated_order_depends_on_the_grid_only_through_the_plan():
    """Different SM counts cut the work differently; on integer-valued data
    every cut gives the exact sums."""
    rng = np.random.default_rng(5)
    A = _data(rng, (300, 2052), "ints")
    x, v = _data(rng, (2052,), "ints"), _data(rng, (300,), "ints")
    for sms in (1, 7, 132, 264):
        assert np.array_equal(matvec_order(A, x, False, sms), A @ x)
        assert np.array_equal(matvec_order(A, v, True, sms), v @ A)


def test_scratch_cache_stays_bounded_under_stream_churn():
    """Each stream gets its own counters and partials, reused while large
    enough; at most SCRATCH_STREAMS streams a device stay cached."""
    cache = rank1_chain._scratch
    saved = dict(cache)
    cache.clear()
    dev = torch.device("cpu")
    plan = rank1_chain.matvec_plan(8192, 8192, True, True, SMS)
    try:
        first = cache.take(dev, 1, plan.counter_words, plan.partial_floats)
        assert first[0].numel() >= plan.counter_words and not first[0].any()
        assert first[1].numel() >= plan.partial_floats
        again = cache.take(dev, 1, plan.counter_words, plan.partial_floats)
        assert all(a is b for a, b in zip(again, first))
        for handle in range(2, 100):
            cache.take(dev, handle, plan.counter_words, plan.partial_floats)
            assert len(cache) <= rank1_chain.SCRATCH_STREAMS
        assert list(cache) == [(None, h) for h in range(96, 100)]
        big = rank1_chain.matvec_plan(300, 20000, True, True, SMS)
        counters, partials = cache.take(dev, 99, big.counter_words, big.partial_floats)
        assert counters.numel() >= big.counter_words and not counters.any()
        assert partials.numel() >= big.partial_floats
    finally:
        cache.clear()
        cache.update(saved)


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    rng = np.random.default_rng(3)
    A, x = (torch.tensor(_data(rng, s, "normal")) for s in ((33, 20), (20,)))
    assert torch.equal(rank1_chain.matvec(A, x), ref.matvec_ref(A, x))
    At = torch.tensor(_data(rng, (20, 33), "normal")).T
    assert torch.equal(rank1_chain.matvec(At, x), ref.matvec_ref(At, x))
