"""The Hopper designs of ``cofactor_update`` and ``scatter_add``, on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``).  What
surrounds them is Python the CPU reaches, and is checked here:

* the row partition of ``cofactor_plan`` / ``block_rows`` gives every row
  of the batch to exactly one block (or to the last cluster's tail), with
  every stage 16-byte aligned, and the plan takes any width;
* the thread-to-tile map, and the last cluster's walk over the partials,
  cover each entry (i <= j) of the (m+1)² triangle of x' = [x | 1] once,
  in one pass (narrow) or over the pairs of bands (banded, m >= 192);
* the scratch cache keeps at most SCRATCH_STREAMS streams a device;
* every phase stamp of ``tools/cofactor_phases.py`` is in the kernel;
* a numpy emulation of the kernel's summation order (each group over its
  rows with one rounding a product, groups in order, blocks of a cluster in
  rank order, clusters of a set in order, sets in order, then the tail
  rows; Q mirrored) equals the
  port's plain version and the JAX package's ``ops.cofactor_update``
  (backends ``jnp`` and ``interpret``) bitwise on integer-valued data, and
  is within float32 summation error of a float64 sum on normal data;
* ``scatter_add``'s head / vector / tail split of a view row covers every
  column once, with the vector part 16-byte aligned, for every id residue;
* the wrappers' input checks raise as before.

Tolerance on normal data: a float32 sum of N terms in any order is within
N·2⁻²⁴ of the sum of the terms' magnitudes (each add rounds once at 2⁻²⁴ of
a partial sum no larger than that), plus one rounding of each product.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402

_torch_parity.cap_torch_threads()

from repro_torch.kernels import cofactor_update as tcof  # noqa: E402
from repro_torch.kernels import ref, ring_scatter  # noqa: E402

BATCHES = [0, 1, 255, 4096, 65_536, 262_144]
WIDTHS = [1, 7, 32, 130, 300]


@pytest.mark.parametrize("m", WIDTHS)
@pytest.mark.parametrize("B", BATCHES)
def test_row_partition_gives_every_row_to_one_block(B, m):
    plan = tcof.cofactor_plan(B, m, tcof.MAX_BLOCKS)
    assert plan.blocks % tcof.CLUSTER == 0 and tcof.CLUSTER <= plan.blocks
    assert plan.blocks * plan.passes <= max(tcof.MAX_BLOCKS, tcof.CLUSTER * plan.passes)
    assert plan.passes == len(tcof.tiles(m))
    # a ticket counter for each set and one for the sets, in each pass;
    # a partial for each cluster and (of two sets or more) each set
    clusters = plan.blocks // tcof.CLUSTER
    sets = -(-clusters // tcof.SET)
    assert plan.counter_words == plan.passes * (1 + sets)
    slots = len(tcof.tiles(m)[0])
    parts = clusters + (sets if sets > 1 else 0)
    assert plan.partial_floats == plan.passes * parts * slots * (plan.tile ** 2 + 4)
    R = plan.stage_rows
    assert R % 4 == 0
    if not tcof.banded(m):
        assert R * 4 * (m + 1) <= tcof.STAGE_BYTES
    owner = np.full(B, -1)
    for b in range(plan.blocks):
        lo, hi = tcof.block_rows(B, plan.blocks, b)
        assert lo % 4 == 0 and hi % 4 == 0 and lo <= hi
        # every stage starts on a 16-byte boundary of x and of w
        for r0 in range(lo, hi, R):
            assert (r0 * m * 4) % 16 == 0 and (r0 * 4) % 16 == 0
            assert (min(R, hi - r0) * 4) % 16 == 0
        assert (owner[lo:hi] == -1).all()
        owner[lo:hi] = b
    tail = B % 4
    assert (owner[:B - tail] >= 0).all()
    # the last rows (fewer than four) are the last cluster's, once
    assert (owner[B - tail:] == -1).all()
    # no block has more than one stage above its fair share
    sizes = [np.subtract(*tcof.block_rows(B, plan.blocks, b)[::-1])
             for b in range(plan.blocks)]
    assert max(sizes) - min(sizes) <= 4


@pytest.mark.parametrize("m", [0, 1, 7, 32, 38, 39, 40, 41, 130, 191, 192, 256, 300])
def test_thread_map_covers_each_entry_once(m):
    """Each thread's tile, and the last cluster's walk over the partials in
    float4s (slot, row of the tile, four columns; the tile's 4 padding
    floats and the idle slots skipped), write each entry (i <= j) of the
    triangle once over all passes."""
    n = m + 1
    T = tcof.tile_edge(m)
    passes = tcof.tiles(m)
    plan = tcof.cofactor_plan(4096, m, tcof.MAX_BLOCKS)
    assert plan.tile == T and plan.passes == len(passes)
    assert tcof.banded(m) == (m >= 192)
    nt = -(-n // T)
    if tcof.banded(m):
        # a thread a slot of a pair of bands: the kBand² = 576-thread kernel
        assert plan.groups == 1
        assert all(len(slots) == tcof.BAND ** 2 for slots in passes)
    else:
        # the kernel's block: a thread a tile and group, in whole warps
        (slots,) = passes
        threads = -(-len(slots) * plan.groups // 32) * 32
        assert threads <= (256 if T == 4 else 320)
        # only the tiles of the last column reach column m (the ones) or
        # the padding past it, and they come last
        for slot, (ti, tj) in enumerate(slots):
            assert (tj == nt - 1) == (slot >= len(slots) - nt)
    seen = np.zeros((n, n), dtype=int)
    written = np.zeros((n, n), dtype=int)
    stride = T * T + 4
    for slots in passes:
        for tile in slots:
            if tile is None:
                continue
            ti, tj = tile
            assert 0 <= ti <= tj < nt
            assert (tj * T + T - 1 >= m) == (tj == nt - 1)
            for i in range(ti * T, ti * T + T):
                for j in range(tj * T, tj * T + T):
                    if i <= j < n:  # what the thread's tile holds of the triangle
                        seen[i, j] += 1
        for k in range(len(slots) * stride // 4):
            slot, off = divmod(4 * k, stride)
            if off >= T * T or slots[slot] is None:
                continue
            ti, tj = slots[slot]
            i = ti * T + off // T
            for u in range(4):
                j = tj * T + off % T + u
                if i <= j < n:
                    written[i, j] += 1
    assert (seen[np.triu_indices(n)] == 1).all()
    assert seen[np.tril_indices(n, -1)].sum() == 0
    assert (written == np.triu(np.ones((n, n), dtype=int))).all()


def _fma32(acc, a, b):
    """float32 acc + a·b with the product exact (float64) and the sum
    rounded to float32 (the kernel's one-rounding FMA, up to a double
    rounding that integer data never meets)."""
    return (acc.astype(np.float64) + a.astype(np.float64) * b.astype(np.float64)
            ).astype(np.float32)


def emulate(x: np.ndarray, w: np.ndarray):
    """The kernel's arithmetic, in its order, on x [B, m], w [B] float32:
    returns (c [1], s [m], Q [m, m])."""
    B, m = x.shape
    n = m + 1
    plan = tcof.cofactor_plan(B, m, tcof.MAX_BLOCKS)
    xa = np.concatenate([x, np.ones((B, 1), np.float32)], axis=1)  # x' = [x | 1]
    xwa = (xa * w[:, None]).astype(np.float32)  # x'·w, rounded once
    blocks = []
    for b in range(plan.blocks):
        lo, hi = tcof.block_rows(B, plan.blocks, b)
        block = None
        for g in range(plan.groups):
            acc = np.zeros((n, n), np.float32)
            for r0 in range(lo, hi, plan.stage_rows):
                for r in range(r0 + g, min(r0 + plan.stage_rows, hi), plan.groups):
                    acc = _fma32(acc, xwa[r][:, None], xa[r][None, :])
            block = acc if block is None else (block + acc).astype(np.float32)
        blocks.append(block)
    clusters = []
    for k in range(0, plan.blocks, tcof.CLUSTER):
        total = blocks[k]
        for r in range(1, tcof.CLUSTER):
            total = (total + blocks[k + r]).astype(np.float32)
        clusters.append(total)
    sets = []
    for k in range(0, len(clusters), tcof.SET):
        total = clusters[k]
        for part in clusters[k + 1:k + tcof.SET]:
            total = (total + part).astype(np.float32)
        sets.append(total)
    out = sets[0]
    for part in sets[1:]:
        out = (out + part).astype(np.float32)
    for r in range(B - B % 4, B):
        out = _fma32(out, xwa[r][:, None], xa[r][None, :])
    Q = np.triu(out[:m, :m])
    Q = Q + np.triu(Q, 1).T  # mirrored from the upper triangle
    return out[m, m].reshape(1), out[:m, m], Q


#: (B, m): only the tail rows; two clusters; 36 blocks (two sets of
#: clusters, the second of one); 32 blocks at the wide tile; the banded
#: kernel's three passes
CASES = [(3, 5), (3001, 7), (4607, 32), (1001, 130), (1001, 300)]


def _data(B, m, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "ints":
        return (rng.integers(-4, 5, size=(B, m)).astype(np.float32),
                rng.integers(-1, 2, size=B).astype(np.float32))
    return (rng.standard_normal((B, m)).astype(np.float32),
            rng.standard_normal(B).astype(np.float32))


@pytest.mark.parametrize("B,m", CASES)
def test_emulated_order_equals_plain_and_reference_on_integers(B, m):
    from repro.kernels import ops as rops

    x, w = _data(B, m, "ints", B + m)
    got = emulate(x, w)
    c, s, Q = ref.cofactor_update_ref(torch.tensor(x), torch.tensor(w))
    for g, want in zip(got, (c.reshape(1), s, Q)):
        np.testing.assert_array_equal(g, want.numpy())
    for backend in ("jnp", "interpret"):
        for g, want in zip(got, rops.cofactor_update(x, w, backend=backend)):
            np.testing.assert_array_equal(g, np.asarray(want), err_msg=backend)


@pytest.mark.parametrize("B,m", CASES)
def test_emulated_order_is_within_float32_rounding_on_normal_data(B, m):
    from repro.kernels import ops as rops

    x, w = _data(B, m, "normal", B * m + 1)
    got = emulate(x, w)
    x64, w64 = x.astype(np.float64), w.astype(np.float64)
    xw64 = x64 * w64[:, None]
    want = (w64.sum(keepdims=True), xw64.sum(0), xw64.T @ x64)
    mags = (np.abs(w64).sum(keepdims=True), np.abs(xw64).sum(0), np.abs(xw64).T @ np.abs(x64))
    bound = [(B + 2) * 2.0 ** -24 * mag for mag in mags]
    plain = ref.cofactor_update_ref(torch.tensor(x), torch.tensor(w))
    jax_ref = rops.cofactor_update(x, w, backend="jnp")
    for g, r, bd, p, j in zip(got, want, bound, plain, jax_ref):
        assert (np.abs(g - r) <= bd).all()
        assert (np.abs(p.numpy().reshape(g.shape) - r) <= bd).all()
        assert (np.abs(np.asarray(j).reshape(g.shape) - r) <= bd).all()
    # mirrored: Q is exactly symmetric, unlike a product that sums (j, i)
    # apart from (i, j)
    np.testing.assert_array_equal(got[2], got[2].T)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("d", [1, 3, 4, 111, 128])
def test_scatter_row_split_covers_every_column_once(d, offset):
    """The view row of id k starts (base + k·d) floats in; at each of the
    four residues of that offset mod 4 the kernel's split covers the row."""
    head, vectors, tail = ring_scatter.row_split(d, offset)
    assert 0 <= head < 4 and 0 <= tail < 4 and vectors >= 0
    cover = np.zeros(d, dtype=int)
    cover[:head] += 1
    for v in range(vectors):
        k = head + 4 * v
        assert (offset + k) % 4 == 0  # a 16-byte aligned float4
        cover[k:k + 4] += 1
    cover[head + 4 * vectors:] += 1
    assert (cover == 1).all()
    # one warp: at most 32 lanes take the head and the tail
    assert head <= 32 and tail <= 32


def test_scatter_add_checks_raise_as_before():
    view = torch.zeros((4, 3))
    ids = torch.zeros(2, dtype=torch.int32)
    vals = torch.zeros((2, 3))
    with pytest.raises(TypeError, match="seg_ids has dtype torch.int64"):
        ring_scatter.scatter_add(view, ids.long(), vals)
    with pytest.raises(ValueError, match=r"values has shape \(2, 4\), expected \(2, 3\)"):
        ring_scatter.scatter_add(view, ids, torch.zeros((2, 4)))
    with pytest.raises(ValueError, match="values must be contiguous"):
        ring_scatter.scatter_add(view, ids, torch.zeros((3, 2)).T)
    with pytest.raises(TypeError, match="view has dtype torch.float64"):
        ring_scatter.scatter_add(view.double(), ids, vals)
    with pytest.raises(ValueError, match="values is on meta, expected cpu"):
        ring_scatter.scatter_add(view, ids, vals.to("meta"))
    out = ring_scatter.scatter_add(view, torch.tensor([1, -1], dtype=torch.int32),
                                   torch.ones((2, 3)))
    assert out.sum() == 3 and out[1].tolist() == [1.0, 1.0, 1.0]


@pytest.mark.parametrize("m", [192, 300, 1001, 8192])
def test_cofactor_plan_takes_any_width(m):
    """Wide m takes the banded kernel: a pass a pair of bands, each pass's
    grid whole clusters, all passes within MAX_BLOCKS unless a pass alone
    needs a cluster; only a grid of more than 65535 passes is refused."""
    nt = -(-(m + 1) // 8)
    nb = -(-nt // tcof.BAND)
    plan = tcof.cofactor_plan(65_536, m, tcof.MAX_BLOCKS)
    assert plan.passes == nb * (nb + 1) // 2 == len(tcof.tiles(m))
    assert plan.groups == 1 and plan.tile == 8
    assert plan.blocks * plan.passes <= max(tcof.MAX_BLOCKS, tcof.CLUSTER * plan.passes)
    with pytest.raises(ValueError, match="more than a grid holds"):
        tcof.cofactor_plan(4096, 70_000, tcof.MAX_BLOCKS)
    # the plain version on the CPU takes any width
    c, s, Q = tcof.cofactor_update(torch.ones((2, m)), torch.ones(2))
    assert float(c[0]) == 2.0 and Q.shape == (m, m)


def test_scratch_cache_keeps_few_streams():
    """Many streams each get their own counters and partials, but at most
    SCRATCH_STREAMS a device stay cached, the least recently used dropped;
    a stream's buffers are reused while large enough and grow with the
    plan (new counters zeroed)."""
    dev = torch.device("cpu")
    small = tcof.cofactor_plan(4096, 32, tcof.MAX_BLOCKS)
    big = tcof.cofactor_plan(262_144, 300, tcof.MAX_BLOCKS)
    saved = dict(tcof._scratch)
    tcof._scratch.clear()
    try:
        first = tcof._scratch_for(dev, 1, small)
        assert first[0].numel() >= small.counter_words and not first[0].any()
        assert first[1].numel() >= small.partial_floats
        assert all(a is b for a, b in zip(tcof._scratch_for(dev, 1, small), first))
        for handle in range(2, 200):
            tcof._scratch_for(dev, handle, small)
            assert len(tcof._scratch) <= tcof.SCRATCH_STREAMS
        assert list(tcof._scratch) == [(None, h) for h in range(196, 200)]
        tcof._scratch_for(dev, 197, small)  # used again: the most recent
        tcof._scratch_for(dev, 500, small)
        assert list(tcof._scratch) == [(None, h) for h in (198, 199, 197, 500)]
        counters, partials = tcof._scratch_for(dev, 500, big)
        assert counters.numel() >= big.counter_words and not counters.any()
        assert partials.numel() >= big.partial_floats
    finally:
        tcof._scratch.clear()
        tcof._scratch.update(saved)


def test_every_phase_stamp_is_in_the_kernel():
    """``tools/cofactor_phases.py`` stamps the kernel through its
    REPRO_STAMP hook: each stamp it names is in the source once, and its
    source includes the kernel's own file unchanged."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "cofactor_phases", root / "tools" / "cofactor_phases.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    kernel = tool.KERNEL.read_text()
    for k in range(tool.SLOTS):
        assert kernel.count(f"REPRO_STAMP({k});") == 1, k
    assert f"REPRO_STAMP({tool.SLOTS});" not in kernel
    assert f'#include "{tool.KERNEL}"' in tool.stamped_source()
