"""The tile-dedup kernels' arithmetic on the CPU: ``scatter_dedup`` and
``fused_chain`` as ``tests/_dedup_order.py`` emulates them.

The emulation (leader = lowest row of each in-range id a tile, the other
rows added in ascending row order, then one add into the view) is held
bitwise to the port's plain versions (``scatter_dedup_ref``,
``fused_apply_ref``) and to the JAX package (``ring_scatter.tile_dedup``,
``ring_fused.fused_apply`` in its ``fused_xla`` and ``fused_interpret``
lowerings) on integer-valued float32, where every order of the adds is
exact; on normal data the per-row product is bitwise ``chain_product``'s
and the JAX package's within float32 rounding.  Also: the lanes' stepped
(i, j) of the degree-m ring's Q columns against ``divmod`` for every m up
to 48 and at the new widest fused degree (80), and the plan-time shared
memory model at its boundary widths, with a plan that fuses there.
``tests/test_torch_cuda.py`` holds the kernels bitwise to the emulation on
the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _dedup_order as order  # noqa: E402
import _torch_parity  # noqa: E402

_torch_parity.cap_torch_threads()
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ring_fused as rfused  # noqa: E402
from repro.kernels import ring_scatter as rring_scatter  # noqa: E402
from repro_torch.core import COOUpdate, IVMEngine, Query, chain  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core.apps import regression  # noqa: E402
from repro_torch.core.rings import DegreeMRing  # noqa: E402
from repro_torch.kernels import ref, ring_fused, ring_scatter  # noqa: E402


def _ints(rng, shape, lo=-3, hi=4):
    return rng.integers(lo, hi, size=shape).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


def _ids(rng, S, B):
    """Ids with duplicates, padding (-1) and out-of-range (>= S) rows."""
    ids = rng.integers(0, S, size=B).astype(np.int32)
    ids[:3] = -1
    ids[3:5] = S + rng.integers(0, 3, size=2)
    return rng.permutation(ids)


@pytest.mark.parametrize("d", [1, 3, 7, 43, 111])
@pytest.mark.parametrize("S,B", [(1, 70), (9, 300), (1000, 257)])
def test_scatter_dedup_order_matches_plain(d, S, B):
    rng = np.random.default_rng(S + B + d)
    view, ids, vals = _ints(rng, (S, d)), _ids(rng, S, B), _ints(rng, (B, d))
    got = order.scatter_dedup_order(view, ids, vals)
    want = ring_scatter.scatter_dedup_ref(_t(view), _t(ids), _t(vals)).numpy()
    np.testing.assert_array_equal(got, want)
    plain = ref.scatter_add_ref(_t(view), _t(ids), _t(vals)).numpy()
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("d", [1, 7, 111])
def test_tile_groups_match_reference_tile_dedup(d):
    """Each tile's leaders and group sums against the JAX package's
    ``tile_dedup`` (first occurrence, 0/1 matmul): bitwise on integer
    data, within float32 rounding on normal data."""
    rng = np.random.default_rng(d)
    T = ring_scatter.tile_rows(d)
    B = 5 * T
    ids = rng.integers(-1, 5, size=B).astype(np.int32)  # heavy duplicates
    for vals in (_ints(rng, (B, d)), rng.standard_normal((B, d)).astype(np.float32)):
        S = 5
        got = np.zeros((B, d), np.float32)
        leaders = np.full(B, -1)
        for leader, rows in order.tile_groups(ids, S, T):
            s = vals[leader].copy()
            for f in rows[1:]:
                s = s + vals[f]
            got[leader], leaders[leader] = s, ids[leader]
        for r0 in range(0, B, T):
            mids, sums = rring_scatter.tile_dedup(jnp.asarray(ids[r0:r0 + T]),
                                                  jnp.asarray(vals[r0:r0 + T]))
            mids, sums = np.asarray(mids), np.asarray(sums)
            np.testing.assert_array_equal(leaders[r0:r0 + T], mids)
            keep = mids >= 0
            if np.array_equal(vals, np.round(vals)):
                np.testing.assert_array_equal(got[r0:r0 + T][keep], sums[keep])
            else:
                np.testing.assert_allclose(got[r0:r0 + T][keep], sums[keep],
                                           rtol=1e-6, atol=1e-6)


def _chain_case(rng, spec, S, B, n_src, d=None, lo=-2, hi=3):
    d = d or ring_fused.spec_width(spec)
    view = _ints(rng, (S, d))
    out_ids = _ids(rng, S, B)
    vals = _ints(rng, (B, d), lo, hi)
    sources = []
    for i in range(n_src):
        Sg = (9, 128, 3, 1)[i]
        ids = rng.integers(-2, Sg + 2, size=B).astype(np.int32)  # clamped
        sources.append((_ints(rng, (Sg, d), lo, hi), ids))
    return view, out_ids, vals, sources


SPECS = [("scalar",), ("degree", 1), ("degree", 2), ("degree", 6), ("degree", 10)]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: ".".join(map(str, s)))
@pytest.mark.parametrize("n_src", [1, 2, 4])
def test_fused_apply_order_matches_plain(spec, n_src):
    rng = np.random.default_rng(len(spec) * 17 + n_src)
    S, B = (1, 9)[n_src % 2], 90
    view, out_ids, vals, sources = _chain_case(rng, spec, S, B, n_src)
    got, prod = order.fused_apply_order(view, out_ids, vals, sources, spec)
    tprod = torch.empty((B, view.shape[1]))
    want = ring_fused.fused_apply_ref(
        _t(view), _t(out_ids), _t(vals), [(_t(p), _t(i)) for p, i in sources],
        spec, product_out=tprod)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(prod, tprod.numpy())


@pytest.mark.parametrize("spec", SPECS[::2], ids=lambda s: ".".join(map(str, s)))
def test_fused_apply_order_matches_reference(spec):
    """Against the JAX package's flat-XLA and interpret-mode Pallas
    lowerings (out ids >= S map to -1 there: its kernel drops ids < 0; its
    one-hot gather reads a zero row at an id out of range, so the Pallas
    lowering gets the clamped gather ids)."""
    rng = np.random.default_rng(len(spec) * 5)
    view, out_ids, vals, sources = _chain_case(rng, spec, 9, 40, 2)
    got, _ = order.fused_apply_order(view, out_ids, vals, sources, spec)
    ids = np.where(out_ids < view.shape[0], out_ids, -1).astype(np.int32)
    for backend in ("fused_xla", "fused_interpret"):
        want = rfused.fused_apply(
            jnp.asarray(view), jnp.asarray(ids), jnp.asarray(vals),
            [(jnp.asarray(p), jnp.asarray(i if backend == "fused_xla"
                                          else np.clip(i, 0, len(p) - 1)))
             for p, i in sources], spec, backend=backend)
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("spec", [("scalar",), ("degree", 3), ("degree", 10)],
                         ids=lambda s: ".".join(map(str, s)))
def test_chain_product_order_on_normal_data(spec):
    """The kernel's per-column terms in ring_mul_flat's order: bitwise the
    port's ``chain_product`` on normal data, the JAX package's within
    float32 rounding."""
    rng = np.random.default_rng(3)
    d = ring_fused.spec_width(spec)
    vals = rng.standard_normal((64, d)).astype(np.float32)
    sources = [(rng.standard_normal((Sg, d)).astype(np.float32),
                rng.integers(-1, Sg + 1, size=64).astype(np.int32)) for Sg in (7, 5, 3)]
    got = order.chain_product_order(vals, sources, spec)
    want = ring_fused.chain_product(_t(vals), [(_t(p), _t(i)) for p, i in sources], spec)
    np.testing.assert_array_equal(got, want.numpy())
    cur = jnp.asarray(vals)
    for p, i in sources:
        cur = rfused.ring_mul_flat(cur, jnp.take(jnp.asarray(p), jnp.asarray(i),
                                                 axis=0, mode="clip"), spec)
    np.testing.assert_allclose(got, np.asarray(cur), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", list(range(1, 49)) + [64, 80])
def test_q_coords_step_like_divmod(m):
    """Every lane's stepped (i, j) is divmod(c - 1 - m, m) at each Q column
    (and the padding columns after it), for each of the four heads a view
    row can start with."""
    d = 1 + m + m * m
    for head in range(4):
        for width in (d, d + 5):
            got = order.q_coords(m, width, min(head, width))
            p = np.arange(width) - 1 - m
            want = np.stack([np.where(p >= 0, p // m, 0), np.where(p >= 0, p % m, p)], 1)
            np.testing.assert_array_equal(got, want)


#: the widest fused degree of the shared memory model (width 6481)
WIDEST_M = 80


def test_chain_smem_model_boundary():
    """Exactly the launch's request: none at width 1, else the tile of
    grouped rows and 8 warps' (c, s) slots for 4 sources.  Every chain that
    fused before (degree up to 48) still fuses; degree 80 is the widest."""
    assert ring_fused.chain_smem_bytes(1) == 0
    for m in range(1, 90):
        width = 1 + m + m * m
        assert ring_fused.ring_degree(width) == m
        assert ring_fused.ring_degree(width + 1) == 0
        want = 4 * (ring_scatter.tile_rows(width) * width + 8 * 2 * 4 * (m + 1))
        assert ring_fused.chain_smem_bytes(width) == want
        fits = want <= ring_fused.SMEM_PER_BLOCK
        assert fits == (m <= WIDEST_M), m
    assert ring_fused.chain_smem_bytes(1 + 48 + 48 * 48) == 4 * (8 * 2353 + 64 * 49)


def _wide_ring_engine(m):
    rng = np.random.default_rng(m)
    rels = {"R": ("A", "B"), "S": ("A", "C")}
    doms = dict(A=3, B=4, C=5)
    q = Query(relations=rels, free_vars=(), ring=DegreeMRing(m), domains=doms,
              lifts={v: ("degree", i) for i, v in enumerate("ABC")})
    db = {n: regression.relation_from_multiplicities(
        sch, q.ring, torch.tensor(rng.integers(0, 2, size=tuple(doms[v] for v in sch))
                                  .astype(np.float32)))
          for n, sch in rels.items()}
    return IVMEngine.build(q, db, var_order=chain(["A"], {"A": [["B"], ["C"]]}),
                           device="cpu")


@pytest.mark.parametrize("m", [48, WIDEST_M, WIDEST_M + 1])
def test_wide_ring_plans_fuse_to_the_boundary(m):
    """A degree-m cofactor trigger fuses up to the widest degree of the
    model, where its fused update equals the unfused one, and not past it."""
    upd = COOUpdate(("A", "B"), torch.tensor([[0, 1], [2, 3], [0, 1]], dtype=torch.int32),
                    {**DegreeMRing(m).zeros((3,), device="cpu"), "c": torch.ones(3)})
    engines = {}
    for mode in ("off", "on"):
        with tplan.use_fusion(mode):
            eng = _wide_ring_engine(m)
            eng.apply_update("R", upd)
            engines[mode] = eng
    with tplan.use_fusion("on"):
        plan = engines["on"].trigger_plan("R", upd)
    chains = [op for op in plan.ops if isinstance(op, tplan.FusedChain)]
    width = 1 + m + m * m
    if m <= WIDEST_M:
        assert chains
        assert all(c.smem_bytes == ring_fused.chain_smem_bytes(width) for c in chains)
    else:
        assert not chains
    for name, view in engines["off"].views.items():
        for c, t in view.payload.items():
            assert torch.equal(engines["on"].views[name].payload[c], t), (name, c)
