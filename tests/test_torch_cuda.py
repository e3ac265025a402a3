"""The CUDA kernels ≡ their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (marker
``cuda``).  The file imports no JAX, so it runs on a card host that has
only PyTorch: ``PYTHONPATH=src python -m pytest tests/test_torch_cuda.py``.
Integer-valued float32 data keeps the atomics' order irrelevant, so
equality is bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402

_torch_parity.cap_torch_threads()

from repro_torch.core import COOUpdate, IVMEngine, Query, sum_ring  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core.apps import regression  # noqa: E402
from repro_torch.data import synth  # noqa: E402
from repro_torch.kernels import ref, ring_fused, ring_scatter, scatter_ops  # noqa: E402
from repro_torch.kernels import segment_ring_sum as tsegsum  # noqa: E402

pytestmark = pytest.mark.cuda


def _listed_kernels(fn, calls: int, windows: int = 5):
    """The device kernels the profiler lists for ``calls`` calls of ``fn``,
    from the first of up to ``windows`` windows that lists ``calls`` of
    them (else the last), and the windows profiled.  A marker kernel, waited for, opens and closes
    each window and is not listed: the profiler was seen to leave out a
    kernel at a window's edge, and at times every kernel of a window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for window in range(1, windows + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name]
        if len(events) >= calls:
            break
    return events, window


def _ints(rng, shape, lo=-4, hi=5):
    return rng.integers(lo, hi, size=shape).astype(np.float32)


def _ids(rng, S, B, n_pad=3, n_over=2):
    """Ids with duplicates, padding (-1) and out-of-range (>= S) rows."""
    ids = rng.integers(0, S, size=B).astype(np.int32)
    ids[:n_pad] = -1
    ids[n_pad:n_pad + n_over] = S + rng.integers(0, 3, size=n_over)
    return rng.permutation(ids)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cuda_case(rng, S, B, d, dev):
    view = torch.tensor(_ints(rng, (S, d)), device=dev)
    ids = torch.tensor(_ids(rng, S, B), device=dev)
    vals = torch.tensor(_ints(rng, (B, d)), device=dev)
    return view, ids, vals


@pytest.mark.parametrize("S,d", [(1, 1), (37, 7), (6144, 111), (1 << 20, 1)])
def test_cuda_scatter_add_matches_plain(cuda_device, S, d):
    rng = np.random.default_rng(S + d)
    view, ids, vals = _cuda_case(rng, S, 333, d, cuda_device)
    n = ring_scatter.SCATTER_ADD.launches
    got = ring_scatter.scatter_add(view.clone(), ids, vals)
    assert ring_scatter.SCATTER_ADD.launches == n + 1
    assert torch.equal(got, ref.scatter_add_ref(view.clone(), ids, vals))


@pytest.mark.parametrize("S,d", [(1, 1), (50, 7), (1000, 111)])
def test_cuda_segment_ring_sum_matches_plain(cuda_device, S, d):
    rng = np.random.default_rng(S + d)
    _, ids, vals = _cuda_case(rng, S, 517, d, cuda_device)
    got = tsegsum.segment_ring_sum(vals, ids, S)
    assert torch.equal(got, ref.segment_ring_sum_ref(vals, ids, S))


@pytest.mark.parametrize("B,S,d", [(1000, 1000, 111), (1000, 1000, 1),
                                   (65536, 65536, 111), (4099, 300, 7)])
def test_cuda_segment_ring_sum_is_one_launch_and_deterministic(cuda_device, B, S, d):
    """One kernel launch a call, and the same bits on every run on normal
    data (each segment's rows are added in ascending row order, no
    atomics); within float32 summation error of the plain version."""
    rng = np.random.default_rng(B + S + d)
    vals = torch.tensor(rng.standard_normal((B, d)).astype(np.float32),
                        device=cuda_device)
    ids = torch.tensor(_ids(rng, S, B), device=cuda_device)
    n = tsegsum.SEGMENT_RING_SUM.launches
    first = tsegsum.segment_ring_sum(vals, ids, S)
    assert tsegsum.SEGMENT_RING_SUM.launches == n + 1
    for _ in range(3):
        assert torch.equal(tsegsum.segment_ring_sum(vals, ids, S), first)
    zeros = torch.zeros((S, d), dtype=torch.float64, device=cuda_device)
    want = ref.scatter_add_ref(zeros.clone(), ids, vals.double())
    abs_sum = ref.scatter_add_ref(zeros, ids, vals.double().abs())
    # each of at most B adds rounds at 2⁻²⁴ of the running magnitude
    assert bool(((first.double() - want).abs() <= B * 2.0 ** -24 * abs_sum).all())


@pytest.mark.parametrize("S,Sg", [(96, 32), (96, 9216), (9216, 128)])
def test_cuda_gather_mul_scatter_matches_plain(cuda_device, S, Sg):
    rng = np.random.default_rng(S + Sg)
    view, out_ids, _ = _cuda_case(rng, S, 1000, 1, cuda_device)
    src = torch.tensor(_ints(rng, (Sg, 1)), device=cuda_device)
    in_ids = torch.tensor(rng.integers(-1, Sg + 1, size=1000).astype(np.int32),
                          device=cuda_device)
    scale = torch.tensor(_ints(rng, (1000,), -2, 3), device=cuda_device)
    got = ring_scatter.gather_mul_scatter(view.clone(), out_ids, src, in_ids, scale)
    want = ref.gather_mul_scatter_ref(view.clone(), out_ids, src, in_ids, scale)
    assert torch.equal(got, want)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("S,d,B", [(1_179_648, 111, 65_536), (300, 111, 2000),
                                   (50, 3, 700)])
def test_cuda_scatter_add_row_split_matches_plain(cuda_device, S, d, B, offset):
    """The warp-per-row kernel with its scalar head, float4 reductions and
    scalar tail, on views that start 0-3 floats past a 16-byte boundary (so
    every id residue meets every split), at a kernel-phase batch too."""
    rng = np.random.default_rng(S + d + B + offset)
    base = torch.tensor(_ints(rng, (S * d + offset,)), device=cuda_device)
    want = base.clone()
    ids = torch.tensor(_ids(rng, S, B), device=cuda_device)
    vals = torch.tensor(_ints(rng, (B, d)), device=cuda_device)
    n = ring_scatter.SCATTER_ADD.launches
    ring_scatter.scatter_add(base[offset:].view(S, d), ids, vals)
    assert ring_scatter.SCATTER_ADD.launches == n + 1
    ref.scatter_add_ref(want[offset:].view(S, d), ids, vals)
    assert torch.equal(base, want)


def test_cuda_wrapper_rejects_cpu_operands(cuda_device):
    view = torch.zeros((4, 1), device=cuda_device)
    with pytest.raises(ValueError):
        ring_scatter.scatter_add(view, torch.zeros((2,), dtype=torch.int32),
                                 torch.zeros((2, 1), device=cuda_device))


def test_cuda_sum_ring_payload_dispatch(cuda_device):
    """auto on the card resolves per S and takes the kernels either way."""
    rng = np.random.default_rng(9)
    ring = sum_ring()
    for S in (100, 20000):
        view = {"v": torch.tensor(_ints(rng, (S,)), device=cuda_device)}
        keys = torch.tensor(rng.integers(0, S, size=(64, 1)).astype(np.int32),
                            device=cuda_device)
        vals = {"v": torch.tensor(_ints(rng, (64,)), device=cuda_device)}
        want = view["v"].clone().index_put_((keys[:, 0].long(),), vals["v"],
                                            accumulate=True)
        got = scatter_ops.scatter_add_payload(view, (S,), keys, vals, ring)
        assert torch.equal(got["v"], want)


def _engine_pair(cuda_device, ring, kernels):
    """The retailer stream through the engine on the card (kernels) and on
    the CPU (plain versions) under the current fusion and backend
    settings; returns the launches of ``kernels`` on the card."""
    doms, rels = synth.RETAILER_DOMS, synth.RETAILER_RELATIONS
    if ring == "sum":
        q = Query(relations=rels, free_vars=(), ring=sum_ring(), domains=doms,
                  lifts={"units": ("value",)})
    else:
        q = regression.cofactor_query(rels, doms)
    # sizes that keep every value below 2**24 (exact float32 sums); the
    # largest view (18432 keys) still takes the compact path
    density, batch = (0.05, 64) if ring == "sum" else (0.03, 32)
    engines = {}
    before = [k.launches for k in kernels]
    for dev in ("cpu", cuda_device):
        rng = np.random.default_rng(7)
        db = synth.synth_db(rels, doms, q.ring, rng, density=density, device=dev)
        eng = IVMEngine.build(q, db, var_order=synth.retailer_vo(),
                              storage="dense", device=dev)
        for rel, upd in synth.update_stream(rels, doms, q.ring, rng, batch, 10,
                                            device=dev):
            eng.apply_update(rel, upd)
        engines[str(dev)] = eng
    cpu, gpu = engines["cpu"], engines[str(cuda_device)]
    for name, view in cpu.views.items():
        for c, t in view.payload.items():
            assert t.abs().max() < 2 ** 24, (name, c)
            assert torch.equal(gpu.views[name].payload[c].cpu(), t), (name, c)
    return [k.launches - b for k, b in zip(kernels, before)]


@pytest.mark.parametrize("ring", ["sum", "cofactor"])
def test_cuda_engine_matches_cpu_engine(cuda_device, ring):
    """Unfused plans: the ⊎ kernels on the card ≡ the plain versions."""
    kernels = (ring_scatter.SCATTER_ADD, tsegsum.SEGMENT_RING_SUM,
               ring_scatter.GATHER_MUL_SCATTER)
    with tplan.use_fusion("off"):
        used = _engine_pair(cuda_device, ring, kernels)
    assert used[0] > 0 and used[1] > 0
    assert (used[2] > 0) == (ring == "sum")


@pytest.mark.parametrize("ring", ["sum", "cofactor"])
@pytest.mark.parametrize("backend", [None, "scatter_dedup"])
def test_cuda_fused_engine_matches_cpu_engine(cuda_device, ring, backend):
    """Fused plans on both devices: every chain is one ``fused_chain``
    launch on the card; under ``scatter_dedup`` the unfused ⊎ sites take
    the tile-dedup kernel."""
    kernels = (ring_fused.FUSED_CHAIN, ring_scatter.SCATTER_DEDUP)
    with tplan.use_fusion("on"), scatter_ops.use_backend(backend):
        used = _engine_pair(cuda_device, ring, kernels)
    assert used[0] > 0
    assert (used[1] > 0) == (backend == "scatter_dedup")


@pytest.mark.parametrize("d", [1, 111])
@pytest.mark.parametrize("S", [1, 96, 9216])
def test_cuda_scatter_dedup_matches_plain(cuda_device, S, d):
    rng = np.random.default_rng(S + d)
    view, ids, vals = _cuda_case(rng, S, 1000, d, cuda_device)
    n = ring_scatter.SCATTER_DEDUP.launches
    got = ring_scatter.scatter_add(view.clone(), ids, vals, dedup=True)
    assert ring_scatter.SCATTER_DEDUP.launches == n + 1
    assert torch.equal(got, ring_scatter.scatter_dedup_ref(view.clone(), ids, vals))
    assert torch.equal(got, ref.scatter_add_ref(view.clone(), ids, vals))


@pytest.mark.parametrize("spec", [("scalar",), ("degree", 10)],
                         ids=lambda s: ".".join(map(str, s)))
@pytest.mark.parametrize("n_src", [1, 2, 4])
@pytest.mark.parametrize("S", [1, 96])
def test_cuda_fused_chain_matches_plain(cuda_device, spec, n_src, S):
    """Duplicate and padding out ids, out-of-range gather ids (clamped), a
    9216-row source and, at S = 1, a collapsed-to-scalar target."""
    rng = np.random.default_rng(S * 10 + n_src)
    d = ring_fused.spec_width(spec)
    B = 1000
    view, out_ids, vals = _cuda_case(rng, S, B, d, cuda_device)
    sources = []
    for Sg in (9216, 128, 32, 1)[:n_src]:
        plane = torch.tensor(_ints(rng, (Sg, d), -2, 3), device=cuda_device)
        ids = torch.tensor(rng.integers(-2, Sg + 2, size=B).astype(np.int32),
                           device=cuda_device)
        sources.append((plane, ids))
    prods = [torch.empty((B, d), device=cuda_device) for _ in range(2)]
    n = ring_fused.FUSED_CHAIN.launches
    got = ring_fused.fused_apply(view.clone(), out_ids, vals, sources, spec,
                                 product_out=prods[0])
    assert ring_fused.FUSED_CHAIN.launches == n + 1
    want = ring_fused.fused_apply_ref(view.clone(), out_ids, vals, sources,
                                      spec, product_out=prods[1])
    assert torch.equal(prods[0], prods[1])
    assert torch.equal(got, want)
    with scatter_ops.use_backend("torch"):  # the documented switch
        plain = ring_fused.fused_apply(view.clone(), out_ids, vals, sources,
                                       spec)
    assert ring_fused.FUSED_CHAIN.launches == n + 1
    assert torch.equal(plain, want)


def _tile_local_ids(rng, B, T, single):
    """Out ids (and S) whose duplicates fall within one tile of T rows:
    tile t draws from ids 4t .. 4t + 3 (or, ``single``, every row id 0 of
    S = 1, one tile), with padding (-1) and out-of-range (>= S) rows."""
    if single:
        S = 1
        ids = np.zeros(B, np.int32)
    else:
        S = 4 * (-(-B // T)) + 3
        ids = (4 * (np.arange(B) // T) + rng.integers(0, 4, size=B)).astype(np.int32)
    ids[rng.permutation(B)[:3]] = -1
    ids[rng.permutation(B)[:2]] = S + 1
    return S, ids


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("single", [False, True], ids=["tiles", "S1"])
@pytest.mark.parametrize("d", [1, 3, 7, 43, 111, 931])
def test_cuda_scatter_dedup_matches_its_order(cuda_device, d, single):
    """Normal data, ids repeating only within a tile: the kernel's sums are
    bitwise tests/_dedup_order.py's (leader first, then ascending rows)."""
    import _dedup_order

    rng = np.random.default_rng(d + single)
    T = ring_scatter.tile_rows(d)
    B = T if single else 997
    S, ids = _tile_local_ids(rng, B, T, single)
    view, vals = _normal(rng, (S, d)), _normal(rng, (B, d))
    want = _dedup_order.scatter_dedup_order(view, ids, vals)
    got = ring_scatter.scatter_add(*_on(cuda_device, view, ids, vals), dedup=True)
    assert torch.equal(got.cpu(), torch.tensor(want))


@pytest.mark.parametrize("single", [False, True], ids=["tiles", "S1"])
@pytest.mark.parametrize("n_src", [1, 2, 4])
@pytest.mark.parametrize("m", [0, 1, 2, 6, 10, 30, 80])
def test_cuda_fused_chain_matches_its_order(cuda_device, m, n_src, single):
    """Normal data, out ids repeating only within a tile, gather ids out of
    range (clamped): the view and ``product_out`` are bitwise
    tests/_dedup_order.py's, scalar ring and degrees 1 to 80 (d = 6481, the
    widest the plan fuses)."""
    import _dedup_order

    rng = np.random.default_rng(100 * m + 10 * n_src + single)
    spec = ("scalar",) if m == 0 else ("degree", m)
    d = ring_fused.spec_width(spec)
    T = ring_scatter.tile_rows(d)
    B = T if single else 1000
    S, out_ids = _tile_local_ids(rng, B, T, single)
    view, vals = _normal(rng, (S, d)), _normal(rng, (B, d))
    sources = [(_normal(rng, (Sg, d)), rng.integers(-2, Sg + 2, size=B).astype(np.int32))
               for Sg in (9216 if d <= 111 else 300, 128, 32, 1)[:n_src]]
    want, want_prod = _dedup_order.fused_apply_order(view, out_ids, vals, sources, spec)
    prod = torch.empty((B, d), device=cuda_device)
    got = ring_fused.fused_apply(
        *_on(cuda_device, view, out_ids, vals),
        [tuple(_on(cuda_device, p, i)) for p, i in sources], spec, product_out=prod)
    assert torch.equal(prod.cpu(), torch.tensor(want_prod))
    assert torch.equal(got.cpu(), torch.tensor(want))


@pytest.mark.parametrize("d", [3, 43, 111, 931])
@pytest.mark.parametrize("S,Sg", [(1, 96), (96, 9216), (9216, 128)])
def test_cuda_gather_mul_scatter_wide_matches_plain(cuda_device, S, Sg, d):
    """The warp-a-row kernel (d >= 2) on integer data: duplicate and padding
    out ids, gather ids out of range (clamped), S = 1; bitwise equal to the
    plain version, one launch."""
    rng = np.random.default_rng(S + Sg + d)
    view, out_ids, _ = _cuda_case(rng, S, 1000, d, cuda_device)
    src = torch.tensor(_ints(rng, (Sg, d)), device=cuda_device)
    in_ids = torch.tensor(rng.integers(-2, Sg + 2, size=1000).astype(np.int32),
                          device=cuda_device)
    scale = torch.tensor(_ints(rng, (1000,), -2, 3), device=cuda_device)
    n = ring_scatter.GATHER_MUL_SCATTER.launches
    got = ring_scatter.gather_mul_scatter(view.clone(), out_ids, src, in_ids, scale)
    assert ring_scatter.GATHER_MUL_SCATTER.launches == n + 1
    want = ref.gather_mul_scatter_ref(view.clone(), out_ids, src, in_ids, scale)
    assert torch.equal(got, want)


@pytest.mark.parametrize("single", [False, True], ids=["tiles", "S1"])
@pytest.mark.parametrize("d", [1, 3, 7, 43, 111, 931])
def test_cuda_gather_mul_scatter_matches_its_order(cuda_device, d, single):
    """Normal data, out ids repeating only within a tile, gather ids out of
    range (clamped): the view is bitwise tests/_dedup_order.py's
    ``gather_mul_scatter_order`` (each product rounded once, the leader
    first, then ascending rows), the same bits on every run, and one device
    event a call."""
    import _dedup_order

    rng = np.random.default_rng(10 * d + single)
    T = ring_scatter.tile_rows(d)
    B = T if single else 1000
    S, out_ids = _tile_local_ids(rng, B, T, single)
    Sg = 300
    view, src = _normal(rng, (S, d)), _normal(rng, (Sg, d))
    in_ids = rng.integers(-2, Sg + 2, size=B).astype(np.int32)
    scale = _normal(rng, (B,))
    want = _dedup_order.gather_mul_scatter_order(view, out_ids, src, in_ids, scale)
    dview, douts, dsrc, dins, dscale = _on(cuda_device, view, out_ids, src, in_ids, scale)
    first = ring_scatter.gather_mul_scatter(dview.clone(), douts, dsrc, dins, dscale)
    assert torch.equal(first.cpu(), torch.tensor(want))
    for _ in range(3):
        again = ring_scatter.gather_mul_scatter(dview.clone(), douts, dsrc, dins, dscale)
        assert torch.equal(again, first)
    work = dview.clone()
    n = ring_scatter.GATHER_MUL_SCATTER.launches
    events, windows = _listed_kernels(
        lambda: ring_scatter.gather_mul_scatter(work, douts, dsrc, dins, dscale), 10)
    assert ring_scatter.GATHER_MUL_SCATTER.launches == n + 10 * windows
    assert len(events) == 10
    assert all("gather_mul_scatter_kernel" in e.name for e in events)


# ---------------------------------------------------------------------------
# The kernel-ops layer: cofactor_update, ring_mul, matvec, outer_accumulate
# ---------------------------------------------------------------------------
def _on(dev, *arrays):
    return [torch.tensor(a, device=dev) for a in arrays]


@pytest.mark.parametrize("B,m", [(1, 1), (33, 130), (4096, 32), (70001, 7), (0, 5),
                                 (65_536, 32), (262_144, 130), (300, 300), (1001, 300),
                                 (2049, 1001)])
def test_cuda_cofactor_update_matches_plain(cuda_device, B, m):
    from repro_torch.kernels import cofactor_update as tcof

    rng = np.random.default_rng(B + m)
    x, w = _on(cuda_device, _ints(rng, (B, m)), _ints(rng, (B,), -1, 2))
    n = tcof.COFACTOR_UPDATE.launches
    got = tcof.cofactor_update(x, w)
    assert tcof.COFACTOR_UPDATE.launches == n + 1
    c, s, Q = ref.cofactor_update_ref(x, w)
    for g, want in zip(got, (c.reshape(1), s, Q)):
        assert torch.equal(g, want)


@pytest.mark.parametrize("B,m", [(65_536, 32), (4099, 130), (4099, 300)])
def test_cuda_cofactor_update_is_full_float32(cuda_device, B, m):
    """One entry of each column is an odd integer of 12 significant bits,
    which TF32 or bf16 would round; every sum stays below 2**24, so the
    float32 statistics are exact and equal the float64 ones."""
    from repro_torch.kernels import cofactor_update as tcof

    rng = np.random.default_rng(B * m)
    x, w = _ints(rng, (B, m)), _ints(rng, (B,), -1, 2)
    rows = np.arange(m) * (B // m)
    x[rows, np.arange(m)] = (rng.integers(1024, 1501, size=m) * 2 + 1) * \
        rng.choice([-1, 1], size=m)
    w[rows] = 1.0
    x64, w64 = x.astype(np.float64), w.astype(np.float64)
    got = tcof.cofactor_update(*_on(cuda_device, x, w))
    want = (w64.sum(keepdims=True), w64 @ x64, (x64 * w64[:, None]).T @ x64)
    for g, r in zip(got, want):
        assert np.array_equal(g.cpu().numpy().astype(np.float64), r)


@pytest.mark.parametrize("B,m", [(4096, 32), (65_536, 32), (4099, 130), (262_144, 130),
                                 (1001, 256), (1001, 300), (65_536, 300)])
def test_cuda_cofactor_update_is_one_launch_and_deterministic(cuda_device, B, m):
    """One device event a call, the same bits on every call on normal data
    (fixed summation order), within float32 summation error of a float64
    sum, and Q exactly symmetric (mirrored)."""
    from repro_torch.kernels import cofactor_update as tcof

    rng = np.random.default_rng(B + m)
    x, w = _on(cuda_device, rng.standard_normal((B, m)).astype(np.float32),
               rng.standard_normal(B).astype(np.float32))
    first = [t.clone() for t in tcof.cofactor_update(x, w)]
    agains = []
    events, _ = _listed_kernels(lambda: agains.append(tcof.cofactor_update(x, w)), 3)
    assert len(events) == 3 and all("cofactor_" in e.name for e in events)
    for again in agains:
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert torch.equal(first[2], first[2].T)
    x64, w64 = x.double(), w.double()
    xw64 = x64 * w64[:, None]
    want = (w64.sum().reshape(1), xw64.sum(0), xw64.T @ x64)
    mags = (w64.abs().sum().reshape(1), xw64.abs().sum(0), xw64.abs().T @ x64.abs())
    for g, r, mag in zip(first, want, mags):
        assert bool(((g.double() - r).abs() <= (B + 2) * 2.0 ** -24 * mag).all())


def test_cuda_cofactor_update_on_two_streams(cuda_device):
    """Calls on two streams at once each equal the same call alone: each
    stream has its own scratch and ticket counters."""
    from repro_torch.kernels import cofactor_update as tcof

    rng = np.random.default_rng(2)
    xs = _on(cuda_device, *(rng.standard_normal((65_536, 32)).astype(np.float32)
                            for _ in range(2)))
    w = torch.ones(65_536, device=cuda_device)
    alone = [tcof.cofactor_update(x, w)[2].clone() for x in xs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for _ in range(10):
        for x, st in zip(xs, streams):
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                outs.append(tcof.cofactor_update(x, w)[2])
    torch.cuda.synchronize()
    assert all(torch.equal(got, alone[k % 2]) for k, got in enumerate(outs))


def test_cuda_cofactor_update_scratch_stays_bounded_under_stream_churn(cuda_device):
    """A call on each of many streams, one after another, each equal to the
    call alone, keeps the scratch of at most SCRATCH_STREAMS streams."""
    from repro_torch.kernels import cofactor_update as tcof

    rng = np.random.default_rng(3)
    x, w = _on(cuda_device, _ints(rng, (4096, 32)), _ints(rng, (4096,), -1, 2))
    want = [t.clone() for t in tcof.cofactor_update(x, w)]
    outs = []
    for _ in range(40):
        st = torch.cuda.Stream()
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            outs.append(tcof.cofactor_update(x, w))
        keys = [k for k in tcof._scratch if k[0] == x.device.index]
        assert len(keys) <= tcof.SCRATCH_STREAMS
    torch.cuda.synchronize()
    for got in outs:
        assert all(torch.equal(g, r) for g, r in zip(got, want))


@pytest.mark.parametrize("kind", ["ints", "normal"])
@pytest.mark.parametrize("K,m", [(1, 1), (9, 33), (1000, 10)])
def test_cuda_ring_mul_matches_plain_and_ring_mul(cuda_device, K, m, kind):
    """Bitwise on any data, also on the column slices of payload planes."""
    from repro_torch.core.rings import DegreeMRing
    from repro_torch.kernels import ring_mul as tring_mul

    rng = np.random.default_rng(K + m)
    d = 1 + m + m * m
    mk = (lambda s: _ints(rng, s)) if kind == "ints" else (
        lambda s: rng.standard_normal(s).astype(np.float32))
    planes = _on(cuda_device, mk((K, d)), mk((K, d)))
    ops_ = [(p[:, 0], p[:, 1:1 + m], p[:, 1 + m:].reshape(K, m, m)) for p in planes]
    n = tring_mul.RING_MUL.launches
    got = tring_mul.ring_mul(*ops_[0], *ops_[1])
    assert tring_mul.RING_MUL.launches == n + 1
    contiguous = [t.contiguous() for o in ops_ for t in o]
    for g, want in zip(got, ref.ring_mul_ref(*contiguous)):
        assert torch.equal(g, want)
    a, b = ({"c": o[0], "s": o[1], "Q": o[2]} for o in ops_)
    prod = DegreeMRing(m).mul(a, b)
    for g, comp in zip(got, ("c", "s", "Q")):
        assert torch.equal(g, prod[comp])


@pytest.mark.parametrize("n,k", [(1, 1), (130, 70), (1001, 333), (1024, 1024), (8192, 8192),
                                 (1001, 332), (300, 20000), (20000, 300), (5, 8196),
                                 (4, 100_000)])
def test_cuda_matvec_matches_plain_both_layouts(cuda_device, n, k):
    from repro_torch.kernels import rank1_chain

    rng = np.random.default_rng(n + k)
    A, x = _on(cuda_device, _ints(rng, (n, k)), _ints(rng, (k,)))
    want = ref.matvec_ref(A, x)
    At = A.T.contiguous().T  # the same matrix, column-major
    before = rank1_chain.MATVEC.launches
    for layout in (A, At):
        assert torch.equal(rank1_chain.matvec(layout, x), want)
    assert rank1_chain.MATVEC.launches == before + 2


@pytest.mark.parametrize("transposed", [False, True], ids=["rows", "cols"])
@pytest.mark.parametrize("rows,cols", [(1024, 1024), (1001, 332), (300, 2052), (3, 8196),
                                       (2, 16_404), (37, 4)])
def test_cuda_matvec_is_its_emulated_order_and_repeatable(cuda_device, rows, cols,
                                                          transposed):
    """On normal data the kernel of each layout (TMA rows, cols) equals, bit
    for bit, the numpy emulation of its summation order
    (tests/_matvec_order.py) and itself from call to call."""
    from _matvec_order import matvec_order
    from repro_torch.kernels import rank1_chain

    rng = np.random.default_rng(rows + cols)
    A = rng.standard_normal((rows, cols)).astype(np.float32)
    x = rng.standard_normal(rows if transposed else cols).astype(np.float32)
    At, xt = _on(cuda_device, A, x)
    mat = At.T if transposed else At
    sms = rank1_chain.sm_count(At.device.index)
    assert rank1_chain.matvec_plan(rows, cols, transposed, True, sms).kernel == \
        ("simt" if transposed else "tma")
    first = rank1_chain.matvec(mat, xt)
    assert all(torch.equal(rank1_chain.matvec(mat, xt), first) for _ in range(3))
    assert np.array_equal(first.cpu().numpy(), matvec_order(A, x, transposed, sms))


@pytest.mark.parametrize("n", [1024, 8192])
def test_cuda_matvec_is_one_launch_in_both_layouts(cuda_device, n):
    """One kernel a call in each layout, no second pass and nothing
    allocated on the device but the output."""
    from repro_torch.kernels import rank1_chain

    rng = np.random.default_rng(n)
    A, x = _on(cuda_device, rng.standard_normal((n, n)).astype(np.float32),
               rng.standard_normal(n).astype(np.float32))
    for mat, name in ((A, "matvec_rows_tma"), (A.T, "matvec_cols")):
        rank1_chain.matvec(mat, x)
        before = rank1_chain.MATVEC.launches
        events, windows = _listed_kernels(lambda: rank1_chain.matvec(mat, x), 10)
        assert rank1_chain.MATVEC.launches == before + 10 * windows
        assert len(events) == 10 and all(name in e.name for e in events)


def test_cuda_matvec_on_two_streams(cuda_device):
    """Cols-layout calls on two streams at once each equal the call alone:
    each stream has its own ticket counters and partials."""
    from repro_torch.kernels import rank1_chain

    rng = np.random.default_rng(6)
    mats = _on(cuda_device, *(rng.standard_normal((4096, 4096)).astype(np.float32)
                              for _ in range(2)))
    x = torch.tensor(rng.standard_normal(4096).astype(np.float32), device=cuda_device)
    alone = [rank1_chain.matvec(M.T, x).clone() for M in mats]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for _ in range(10):
        for M, st in zip(mats, streams):
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                outs.append(rank1_chain.matvec(M.T, x))
    torch.cuda.synchronize()
    assert all(torch.equal(got, alone[i % 2]) for i, got in enumerate(outs))


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_cuda_matvec_unaligned_layouts_take_the_simt_kernels(cuda_device, offset):
    """A view at an offset that is not 16-byte aligned takes the SIMT
    kernels, in both layouts, and is still exact on integer data."""
    from repro_torch.kernels import rank1_chain

    rng = np.random.default_rng(offset)
    n, k = 300, 512
    base = torch.tensor(_ints(rng, (n * k + offset,)), device=cuda_device)
    A = base[offset:].view(n, k)
    x = torch.tensor(_ints(rng, (k,)), device=cuda_device)
    v = torch.tensor(_ints(rng, (n,)), device=cuda_device)
    for mat, vec in ((A, x), (A.T, v)):
        t, rows, cols, aligned = rank1_chain.layout(mat, vec)
        assert not aligned
        assert rank1_chain.matvec_plan(rows, cols, t, aligned, 132).kernel == "simt"
        assert torch.equal(rank1_chain.matvec(mat, vec), ref.matvec_ref(mat, vec))


@pytest.mark.parametrize("kind", ["ints", "normal"])
@pytest.mark.parametrize("n,m", [(1, 1), (7, 130), (1024, 1024), (333, 1001)])
def test_cuda_outer_accumulate_matches_plain(cuda_device, n, m, kind):
    from repro_torch.kernels import rank1_chain

    rng = np.random.default_rng(n * m)
    mk = (lambda s: _ints(rng, s)) if kind == "ints" else (
        lambda s: rng.standard_normal(s).astype(np.float32))
    V, u, v = _on(cuda_device, mk((n, m)), mk((n,)), mk((m,)))
    got = rank1_chain.outer_accumulate(V, u, v)
    assert torch.equal(got, ref.outer_accumulate_ref(V, u, v))
    assert torch.equal(got, V + torch.outer(u, v))


def test_cuda_rank1_chain_update_and_running_cofactor(cuda_device):
    """The ops layer and RunningCofactor on the card ≡ on the CPU."""
    from repro_torch.data.stats import RunningCofactor
    from repro_torch.kernels import ops

    rng = np.random.default_rng(21)
    arrays = [_ints(rng, s) for s in ((300, 300), (300,), (300,), (300, 300),
                                      (300, 300))]
    on_card = _on(cuda_device, *arrays)
    got = ops.rank1_chain_update(*on_card)
    assert torch.equal(got, ref.rank1_chain_ref(*on_card))
    assert torch.equal(got.cpu(), ops.rank1_chain_update(*map(torch.tensor, arrays)))
    batches = [_ints(np.random.default_rng(i), (500, 9)) for i in range(3)]
    states = []
    for dev in ("cpu", cuda_device):
        st = RunningCofactor.init(9, device=dev)
        for x in batches:
            st = st.update(torch.tensor(x, device=dev))
        st = st.update(torch.tensor(batches[-1], device=dev),
                       weights=-torch.ones(500, device=dev))
        states.append(st)
    cpu, gpu = states
    for a, b in ((cpu.c, gpu.c), (cpu.s, gpu.s), (cpu.Q, gpu.Q)):
        assert torch.equal(a, b.cpu())


#: the bf16 tensor-core kernel's head dims at T = 77, 257 and 1000, causal
#: and not, with GQA groups 1, 4 and 8 (H = 8 over Hkv = 8, 2, 1)
WGMMA_FLASH_SHAPES = [
    (1, 8, 8, 77, 64, True), (1, 8, 2, 77, 64, False), (1, 8, 1, 257, 64, True),
    (1, 8, 8, 257, 64, False), (1, 8, 2, 1000, 64, True), (1, 8, 1, 1000, 64, False),
    (1, 8, 8, 77, 128, True), (1, 8, 2, 77, 128, False), (1, 8, 1, 257, 128, True),
    (1, 8, 8, 257, 128, False), (1, 8, 2, 1000, 128, True),
    (1, 8, 1, 1000, 128, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,T,D,causal", [
    (1, 4, 1, 1000, 128, True), (2, 4, 2, 77, 16, True), (1, 2, 1, 5, 8, True),
    (2, 8, 8, 130, 32, False), (1, 32, 8, 257, 64, True)] + WGMMA_FLASH_SHAPES)
def test_cuda_flash_attention_matches_plain(cuda_device, B, H, Hkv, T, D, causal,
                                            dtype):
    """The flash kernel that ``variant`` names against the plain version in
    float64 on the same inputs, at unaligned T: float32 within 1e-5 of the
    largest output; bf16 within one bf16 rounding of the float64 result
    (the kernels compute in float32, or with P in three bf16 terms, from
    exact bf16 inputs and round their output once).  That kernel launches
    once, the other not at all."""
    from repro_torch.kernels import flash_attention as tflash

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(T + D)
    q, k, v = (torch.tensor(rng.standard_normal(s).astype(np.float32),
                            device=cuda_device).to(dt)
               for s in ((B, H, T, D), (B, Hkv, T, D), (B, Hkv, T, D)))
    before = {name: kern.launches for name, kern in tflash.KERNELS.items()}
    got = tflash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    named = tflash.variant(dt, D)
    assert {name: kern.launches - before[name]
            for name, kern in tflash.KERNELS.items()} == {
                name: int(name == named) for name in tflash.KERNELS}
    assert got.dtype == dt and got.shape == q.shape
    want = ref.flash_attention_ref(q.double(), k.double(), v.double(), causal=causal)
    err = (got.double() - want).abs()
    scale = float(want.abs().max())
    if dt == torch.float32:
        assert float(err.max()) <= 1e-5 * scale
    else:
        assert bool((err <= 2.0 ** -8 * want.abs() + 1e-6 * scale).all())


@pytest.mark.parametrize("B,H,Hkv,T,D", [(4, 32, 8, 1024, 64), (1, 4, 1, 1000, 128),
                                          (1, 8, 2, 257, 128), (3, 6, 3, 100, 64)])
def test_cuda_flash_tf32_at_path_shapes(cuda_device, B, H, Hkv, T, D):
    """The TF32 kernel at chip_smoke.py's float32 shapes and an unaligned
    GQA one, k and v also at an offset that is not 16-byte aligned (copied
    once for the tensor maps): within 1e-5 of the largest output of the
    float64 plain version, one launch each."""
    from repro_torch.kernels import flash_attention as tflash

    rng = np.random.default_rng(B * T + D)
    q = torch.tensor(rng.standard_normal((B, H, T, D)).astype(np.float32), device=cuda_device)
    kv = torch.tensor(rng.standard_normal(2 * B * Hkv * T * D + 1).astype(np.float32),
                      device=cuda_device)
    want = None
    for off in (0, 1):
        k = kv[off:off + B * Hkv * T * D].view(B, Hkv, T, D)
        v = kv[off + B * Hkv * T * D:off + 2 * B * Hkv * T * D].view(B, Hkv, T, D)
        n = tflash.FLASH_ATTENTION_TF32.launches
        got = tflash.flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert tflash.FLASH_ATTENTION_TF32.launches == n + 1
        want = ref.flash_attention_ref(q.double(), k.double(), v.double())
        scale = float(want.abs().max())
        assert float((got.double() - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [8, 16, 32])
@pytest.mark.parametrize("B,H,Hkv,T,Tk,causal", [
    (2, 4, 2, 64, 64, True), (1, 8, 2, 257, 257, True), (1, 4, 1, 1000, 1000, True),
    (2, 6, 3, 100, 333, False), (1, 8, 8, 257, 64, False)])
def test_cuda_flash_mma_matches_float64(cuda_device, B, H, Hkv, T, Tk, causal, D, dtype):
    """The mma kernel (the dispatch at D 8/16/32) and the SIMT kernel of the
    same library on the same inputs, causal at T = 64, 257 and 1000 and
    non-causal with T != Tk, GQA groups 1 to 4, against the plain version
    in float64: float32 within 1e-5 of the largest output; bf16 within one
    bf16 rounding of the float64 result.  One launch each."""
    from repro_torch.kernels import flash_attention as tflash

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(T + Tk + D)
    q, k, v = (torch.tensor(rng.standard_normal(s).astype(np.float32),
                            device=cuda_device).to(dt)
               for s in ((B, H, T, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D)))
    assert tflash.variant(dt, D) == "mma"
    want = ref.flash_attention_ref(q.double(), k.double(), v.double(), causal=causal)
    scale = float(want.abs().max())
    for kind in ("mma", "simt"):
        n = tflash.FLASH_ATTENTION.launches
        got = (tflash.flash_attention(q, k, v, causal=causal) if kind == "mma"
               else tflash.launch("simt", q, k, v, causal=causal))
        torch.cuda.synchronize()
        assert tflash.FLASH_ATTENTION.launches == n + 1
        assert got.dtype == dt and got.shape == q.shape
        err = (got.double() - want).abs()
        if dt == torch.float32:
            assert float(err.max()) <= 1e-5 * scale, (kind, float(err.max()), scale)
        else:
            assert bool((err <= 2.0 ** -8 * want.abs() + 1e-6 * scale).all()), kind


#: MLA's head-dim pairs on the card: (dtype, D, Dv, route)
MLA_ROUTES = [("bfloat16", 192, 128, "wgmma"), ("float32", 192, 128, "tf32"),
              ("float32", 16, 8, "mma"), ("bfloat16", 16, 8, "mma")]


@pytest.mark.parametrize("dtype,D,Dv,route", MLA_ROUTES)
@pytest.mark.parametrize("B,H,Hkv,T,causal", [
    (1, 4, 4, 77, True), (1, 2, 2, 257, False), (2, 4, 2, 1000, True),
    (1, 2, 2, 300, False), (2, 4, 4, 64, True)])
def test_cuda_flash_mla_pairs_match_float64(cuda_device, B, H, Hkv, T, causal, dtype, D,
                                            Dv, route):
    """Each forward route at MLA's (D, Dv) pairs, causal and not, at T that
    are not multiples of a tile, against the plain version in float64 on
    the same inputs: float32 within 1e-5 of the largest output, bf16 within
    one bf16 rounding of the float64 result.  One launch of the route's
    kernel a call, none of another; two calls bitwise equal."""
    from repro_torch.kernels import flash_attention as tflash

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(T + D + Dv)
    q, k, v = (torch.tensor(rng.standard_normal(s).astype(np.float32),
                            device=cuda_device).to(dt)
               for s in ((B, H, T, D), (B, Hkv, T, D), (B, Hkv, T, Dv)))
    assert tflash.variant(dt, D, Dv) == route
    before = {name: kern.launches for name, kern in tflash.KERNELS.items()}
    got = tflash.flash_attention(q, k, v, causal=causal)
    again = tflash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert {name: kern.launches - before[name] for name, kern in tflash.KERNELS.items()} == {
        name: 2 * int(name == route) for name in tflash.KERNELS}
    assert got.dtype == dt and got.shape == (B, H, T, Dv)
    assert torch.equal(got, again)
    want = ref.flash_attention_ref(q.double(), k.double(), v.double(), causal=causal)
    err = (got.double() - want).abs()
    scale = float(want.abs().max())
    if dt == torch.float32:
        assert float(err.max()) <= 1e-5 * scale, (float(err.max()), scale)
    else:
        assert bool((err <= 2.0 ** -8 * want.abs() + 1e-6 * scale).all())


def test_cuda_flash_wgmma_mla_instance_spills_nothing(cuda_device):
    """``tools/sass_report.py`` on ``flash_attention_wgmma.cu``: the kernel's
    two (192, 128) instances, without L and with it (``return_lse``), store
    and load nothing in local memory."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, str(root / "tools" / "sass_report.py"),
                          "flash_attention_wgmma.cu"], capture_output=True, text=True,
                         check=True).stdout
    rows = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    mine = [r for r in rows if "flash_attention_wgmma_kernelILi192ELi128E" in r["function"]]
    assert len(mine) == 2, rows
    for r in mine:
        assert (r["local_stores"], r["local_loads"]) == (0, 0), r


def test_cuda_flash_d256_instances_spill_nothing(cuda_device):
    """``tools/sass_report.py`` on ``flash_attention_wgmma.cu``: the bf16
    (256, 256) kernel, without L and with it, stores and loads nothing in
    local memory (its consumers hold O's 128 registers a thread past
    setmaxnreg)."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, str(root / "tools" / "sass_report.py"),
                          "flash_attention_wgmma.cu"], capture_output=True, text=True,
                         check=True).stdout
    rows = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    for flag in ("Lb0E", "Lb1E"):
        mine = [r for r in rows
                if f"flash_attention_wgmma_kernelILi256ELi256E{flag}" in r["function"]]
        assert len(mine) == 1, (flag, rows)
        assert (mine[0]["local_stores"], mine[0]["local_loads"]) == (0, 0), mine[0]


def _flash_gate(got, want, dt, what=""):
    """float32 within 1e-5 of the largest output of the float64 plain
    version; bf16 within one bf16 rounding of it."""
    err = (got.double() - want).abs()
    scale = float(want.abs().max())
    if dt == torch.float32:
        assert float(err.max()) <= 1e-5 * scale, (what, float(err.max()), scale)
    else:
        assert bool((err <= 2.0 ** -8 * want.abs() + 1e-6 * scale).all()), what


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,T,causal,prefix", [
    (1, 8, 1, 77, True, None), (1, 4, 1, 300, False, None), (2, 8, 1, 384, True, 256),
    (1, 8, 1, 1000, True, 256), (1, 4, 2, 257, True, 100), (1, 2, 1, 130, True, 130),
    (2, 8, 1, 65, True, None), (1, 4, 1, 129, True, 100), (4, 8, 1, 2048, True, 256),
    (1, 8, 2, 300, True, 100), (1, 3, 1, 150, False, None)])
def test_cuda_flash_d256_matches_float64(cuda_device, B, H, Hkv, T, causal, prefix, dtype):
    """paligemma-3b's head dim 256 on the wgmma (bf16) and tf32 (float32)
    forward, causal, non-causal and under prefix-LM masks (P 256 at L2's
    shape, an unaligned P 100, P = T), against the plain version in
    float64: one launch of the route's kernel a call, two calls bitwise
    equal; bf16 also with L (``return_lse``), o bitwise the call without.
    The bf16 kernel's schedule at its edges: a one-row last 64-row q tile
    (T 65) and 128-row one (T 129, L's rows), several waves of blocks at
    (4, 8, 1, 2048), q heads of two KV heads paired (Hkv 2 under H 8), and
    units of 64 rows wholly past T (T 150 is 4 units a head, L's rows: the
    last one writes L and stores nothing) over an odd count of heads."""
    from repro_torch.kernels import flash_attention as tflash

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(T + (prefix or 0))
    q, k, v = (torch.tensor(rng.standard_normal(s).astype(np.float32),
                            device=cuda_device).to(dt)
               for s in ((B, H, T, 256), (B, Hkv, T, 256), (B, Hkv, T, 256)))
    route = tflash.variant(dt, 256)
    assert route == ("wgmma" if dt == torch.bfloat16 else "tf32")
    before = {name: kern.launches for name, kern in tflash.KERNELS.items()}
    got = tflash.flash_attention(q, k, v, causal=causal, prefix_len=prefix)
    again = tflash.flash_attention(q, k, v, causal=causal, prefix_len=prefix)
    torch.cuda.synchronize()
    assert {name: kern.launches - before[name] for name, kern in tflash.KERNELS.items()} == {
        name: 2 * int(name == route) for name in tflash.KERNELS}
    assert torch.equal(got, again)
    want = ref.flash_attention_ref(q.double(), k.double(), v.double(), causal=causal,
                                   prefix_len=prefix)
    _flash_gate(got, want, dt)
    if tflash.lse_route(dt, 256):
        o, lse = tflash.flash_attention(q, k, v, causal=causal, return_lse=True,
                                        prefix_len=prefix)
        assert torch.equal(o, got)
        want_lse = ref.flash_attention_lse_ref(q, k, v, causal=causal, prefix_len=prefix)
        assert float((lse[..., :T] - want_lse).abs().max()) <= 1e-6 * float(
            want_lse.abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,T,D,prefix", [
    (2, 4, 1, 40, 16, 16), (2, 4, 2, 80, 16, 16), (1, 8, 2, 300, 16, 100),
    (1, 8, 2, 300, 64, 100), (1, 4, 1, 257, 128, 200), (1, 4, 4, 77, 32, 77),
    (2, 4, 4, 200, 192, 70)])
def test_cuda_flash_prefix_matches_float64(cuda_device, B, H, Hkv, T, D, prefix, dtype):
    """The prefix-LM mask on every forward route but D 256's (above): the
    mma kernel at the reduced paligemma's (16, 16) and D 32, the SIMT kernel
    by name beside it, the wgmma and tf32 kernels at D 64 and 128 and MLA's
    (192, 128), against the plain version in float64."""
    from repro_torch.kernels import flash_attention as tflash

    dt = getattr(torch, dtype)
    Dv = 128 if D == 192 else D
    rng = np.random.default_rng(T + D + prefix)
    q, k, v = (torch.tensor(rng.standard_normal(s).astype(np.float32),
                            device=cuda_device).to(dt)
               for s in ((B, H, T, D), (B, Hkv, T, D), (B, Hkv, T, Dv)))
    want = ref.flash_attention_ref(q.double(), k.double(), v.double(), prefix_len=prefix)
    route = tflash.variant(dt, D, Dv)
    kinds = (route, "simt") if D == Dv and D in tflash.HEAD_DIMS else (route,)
    for kind in kinds:
        kern = tflash.KERNELS.get(kind, tflash.FLASH_ATTENTION)
        n = kern.launches
        got = (tflash.flash_attention(q, k, v, prefix_len=prefix) if kind == route
               else tflash.launch("simt", q, k, v, prefix_len=prefix))
        torch.cuda.synchronize()
        assert kern.launches == n + 1
        _flash_gate(got, want, dt, kind)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,T,D,prefix", [(2, 4, 1, 40, 16, 16),
                                                 (1, 4, 2, 200, 32, 100),
                                                 (2, 2, 1, 130, 16, 64)])
def test_cuda_flash_bwd_simt_with_prefix_matches_float64(cuda_device, B, H, Hkv, T, D,
                                                         prefix, dtype):
    """The SIMT backward (the reduced paligemma's training path) with the
    prefix-LM mask against ``ref.flash_attention_bwd_ref`` in float64 on the
    same inputs (o from the mma forward with the prefix): each gradient
    within 1e-5 (float32) or 1e-2 (bf16) of its largest magnitude, two
    calls bitwise equal, one launch a call; and through ``FlashAttentionFn``
    as autograd runs it."""
    from repro_torch.kernels import flash_attention as tflash

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(T + D + prefix)
    q, k, v = (torch.tensor(rng.standard_normal(s).astype(np.float32),
                            device=cuda_device).to(dt)
               for s in ((B, H, T, D), (B, Hkv, T, D), (B, Hkv, T, D)))
    do = torch.tensor(rng.standard_normal((B, H, T, D)).astype(np.float32),
                      device=cuda_device).to(dt)
    o = tflash.flash_attention(q, k, v, prefix_len=prefix)
    assert tflash.bwd_variant(dt, D) == "simt"
    n = tflash.FLASH_ATTENTION_BWD.launches
    got = tflash.flash_attention_bwd(q, k, v, o, do, prefix_len=prefix)
    again = tflash.flash_attention_bwd(q, k, v, o, do, prefix_len=prefix)
    torch.cuda.synchronize()
    assert tflash.FLASH_ATTENTION_BWD.launches == n + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ref.flash_attention_bwd_ref(*(t.double() for t in (q, k, v, o, do)),
                                       prefix_len=prefix)
    tol = 1e-5 if dt == torch.float32 else 1e-2
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert float((g.double() - w).abs().max()) <= tol * float(w.abs().max()), name
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    out = tflash.FlashAttentionFn.apply(qs, ks, vs, True, prefix)
    for g, w in zip(torch.autograd.grad(out, (qs, ks, vs), do), got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,T,D,causal,prefix", [
    (2, 8, 1, 384, 256, True, 256), (1, 4, 1, 77, 256, True, None),
    (1, 4, 2, 257, 256, True, 100), (1, 2, 1, 130, 256, True, 130),
    (1, 3, 1, 150, 256, False, None), (1, 8, 2, 300, 64, True, 100),
    (1, 4, 1, 257, 128, True, 200), (2, 4, 4, 200, 192, True, 70)])
def test_cuda_flash_bwd_d256_and_prefix_match_float64(cuda_device, B, H, Hkv, T, D, causal,
                                                      prefix, dtype):
    """The tensor-core backwards at paligemma-3b's (256, 256) (causal,
    non-causal, the prefix-LM mask at L2's P 256, an unaligned P 100, P = T)
    and with a prefix at D 64, 128 and MLA's (192, 128), given the
    forward's L where ``lse_route`` holds and without it, against
    ``ref.flash_attention_bwd_ref`` in float64: each gradient within 1e-5
    (float32) or 1e-2 (bf16) of its largest magnitude, one launch of the
    route's kernel a call, two calls bitwise equal; and through
    ``FlashAttentionFn`` as autograd runs it, bitwise the call given L."""
    from repro_torch.kernels import flash_attention as tflash

    dt = getattr(torch, dtype)
    Dv = 128 if D == 192 else D
    rng = np.random.default_rng(T + D + (prefix or 0))
    q, k, v, do = (torch.tensor(rng.standard_normal(s).astype(np.float32),
                                device=cuda_device).to(dt)
                   for s in ((B, H, T, D), (B, Hkv, T, D), (B, Hkv, T, Dv), (B, H, T, Dv)))
    route = tflash.bwd_variant(dt, D, Dv)
    assert route == ("wgmma" if dt == torch.bfloat16 else "tf32")
    lse = None
    if tflash.lse_route(dt, D, Dv):
        o, lse = tflash.flash_attention(q, k, v, causal, return_lse=True, prefix_len=prefix)
    else:
        o = tflash.flash_attention(q, k, v, causal, prefix_len=prefix)
    want = ref.flash_attention_bwd_ref(*(t.double() for t in (q, k, v, o, do)), causal=causal,
                                       prefix_len=prefix)
    tol = 1e-5 if dt == torch.float32 else 1e-2
    for given in ((lse, None) if lse is not None else (None,)):
        before = {name: kern.launches for name, kern in tflash.BWD_KERNELS.items()}
        got = tflash.flash_attention_bwd(q, k, v, o, do, causal, lse=given, prefix_len=prefix)
        again = tflash.flash_attention_bwd(q, k, v, o, do, causal, lse=given,
                                           prefix_len=prefix)
        torch.cuda.synchronize()
        assert {n: kern.launches - before[n] for n, kern in tflash.BWD_KERNELS.items()} == {
            n: 2 * int(n == route) for n in tflash.BWD_KERNELS}
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err = float((g.double() - w).abs().max())
            assert err <= tol * float(w.abs().max()), (name, given is not None, err)
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    out = tflash.FlashAttentionFn.apply(qs, ks, vs, causal, prefix)
    for g, w in zip(torch.autograd.grad(out, (qs, ks, vs), do), got if lse is None else
                    tflash.flash_attention_bwd(q, k, v, o, do, causal, lse=lse,
                                               prefix_len=prefix)):
        assert torch.equal(g, w)


def test_cuda_flash_bwd_d256_instances_spill_nothing(cuda_device):
    """``tools/sass_report.py`` on the two backward sources and the TF32
    forward: the (256, 256) kernels (the bf16 dq kernel with and without
    L and its dkdv kernel by part, the float32 ones, the TF32 forward that
    writes L) store and load nothing in local memory."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, str(root / "tools" / "sass_report.py"),
                          "flash_attention_bwd_wgmma.cu", "flash_attention_bwd_tf32.cu",
                          "flash_attention_tf32.cu"], capture_output=True, text=True,
                         check=True).stdout
    rows = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    for marker, n in (("flash_bwd_dq_wgmma_kernelILi256ELi256E", 2),
                      ("flash_bwd_dkdv_d256_kernel", 1),
                      ("flash_bwd_dq_tf32_d256_kernel", 2),
                      ("flash_bwd_dkdv_tf32_d256_kernel", 1),
                      ("flash_attention_tf32_kernelILi256ELi256ELb1E", 1)):
        mine = [r for r in rows if marker in r["function"]]
        assert len(mine) == n, (marker, rows)
        for r in mine:
            assert (r["local_stores"], r["local_loads"]) == (0, 0), r


def test_cuda_flash_refuses_what_no_route_takes(cuda_device):
    """A pair no kernel takes, and the SIMT kernel by name at Dv ≠ D, raise
    before any launch."""
    from repro_torch.kernels import flash_attention as tflash

    q = torch.zeros((1, 2, 8, 64), device=cuda_device)
    with pytest.raises(ValueError, match="q/k 64, v 32"):
        tflash.flash_attention(q, q, q[..., :32].contiguous())
    q = torch.zeros((1, 2, 8, 16), device=cuda_device)
    with pytest.raises(ValueError, match="simt kernel takes D = Dv"):
        tflash.launch("simt", q, q, q[..., :8].contiguous())


def test_cuda_reduced_deepseek_float32_matches_cpu(cuda_device):
    """The reduced deepseek-v3-671b in float32 on the card (MLA at (16, 8):
    the mma kernel once a layer in the prefill, no flash kernel in a decode
    step) against the same weights on the CPU: logits of the prefill and
    two decode steps within 1e-5 of their largest magnitude."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.models import layers, registry

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("deepseek_v3_671b").reduced()
    api = registry.build(cfg)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 66))
    outs = []
    for dev in ("cpu", cuda_device):
        params = layers.map_tree(lambda t: t.to(dev), api.init(seed=0, device="cpu"))
        with torch.inference_mode():
            before = {name: kern.launches for name, kern in tflash.KERNELS.items()}
            logits, cache = api.prefill(params, {"tokens": toks[:, :64]}, 66)
            launches = {name: kern.launches - before[name]
                        for name, kern in tflash.KERNELS.items()}
            steps = [logits]
            for i in range(2):
                logits, cache = api.decode_step(params, toks[:, 64 + i], 64 + i, cache)
                steps.append(logits)
        outs.append(steps)
    assert launches == {"wgmma": 0, "tf32": 0, "mma": cfg.n_layers}
    for a, b in zip(*outs):
        scale = float(a.abs().max())
        assert float((b.cpu() - a).abs().max()) <= 1e-5 * scale


def test_cuda_model_attention_launches_the_tf32_kernel(cuda_device):
    """``models.attention.flash_attention`` on float32 CUDA tensors at head
    dim 64 is the TF32 kernel: one launch, the wrapper's output bit for bit."""
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.models import attention

    rng = np.random.default_rng(7)
    q, k, v = (torch.tensor(rng.standard_normal(s).astype(np.float32), device=cuda_device)
               for s in ((2, 4, 70, 64), (2, 2, 70, 64), (2, 2, 70, 64)))
    before = {name: kern.launches for name, kern in tflash.KERNELS.items()}
    got = attention.flash_attention(q, k, v)
    assert {name: kern.launches - before[name] for name, kern in tflash.KERNELS.items()} == {
        "wgmma": 0, "tf32": 1, "mma": 0}
    assert torch.equal(got, tflash.flash_attention(q, k, v))


def test_cuda_reduced_lm_float32_takes_the_simt_kernel(cuda_device):
    """The reduced llama3.2-1b in float32 on the card (head dim 16: the
    mma kernel of ``flash_attention.cu``, the library that also holds the
    SIMT kernel, once a layer in the prefill, the TF32 kernel never) against
    the same weights on the CPU: logits of the prefill and two decode steps
    within 1e-5 of their largest magnitude."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.models import layers, registry

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama3_2_1b").reduced()
    api = registry.build(cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 66))
    outs = []
    for dev in ("cpu", cuda_device):
        params = layers.map_tree(lambda t: t.to(dev), api.init(seed=0, device="cpu"))
        before = {name: kern.launches for name, kern in tflash.KERNELS.items()}
        logits, cache = api.prefill(params, {"tokens": toks[:, :64]}, 66)
        steps = [logits]
        for i in range(2):
            logits, cache = api.decode_step(params, toks[:, 64 + i], 64 + i, cache)
            steps.append(logits)
        launches = {name: kern.launches - before[name] for name, kern in tflash.KERNELS.items()}
        outs.append(steps)
    assert launches == {"wgmma": 0, "tf32": 0, "mma": cfg.n_layers}
    for a, b in zip(*outs):
        scale = float(a.abs().max())
        assert float((b.cpu() - a).abs().max()) <= 1e-5 * scale


def test_cuda_model_attention_launches_the_kernel(cuda_device):
    """``models.attention.flash_attention`` on CUDA tensors is the kernel:
    one launch, the wrapper's output bit for bit."""
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.models import attention

    rng = np.random.default_rng(5)
    q, k, v = (torch.tensor(rng.standard_normal(s).astype(np.float32),
                            device=cuda_device)
               for s in ((2, 4, 40, 16), (2, 2, 40, 16), (2, 2, 40, 16)))
    n = tflash.FLASH_ATTENTION.launches
    got = attention.flash_attention(q, k, v)
    assert tflash.FLASH_ATTENTION.launches == n + 1
    assert torch.equal(got, tflash.flash_attention(q, k, v))


@pytest.mark.parametrize("arch", ["llama3_2_1b", "qwen2_1_5b"])
def test_cuda_lm_prefill_and_decode_match_cpu(cuda_device, arch):
    """The reduced model on the card (flash kernel in each prefill layer)
    against the same weights on the CPU (the plain branches): float32 logits
    and caches within 1e-5 of their largest magnitude."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import layers, registry

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    api = registry.build(cfg)
    params = api.init(seed=0, device="cpu")
    on_card = layers.map_tree(lambda t: t.to(cuda_device), params)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 34))
    outs = []
    for p in (params, on_card):
        logits, cache = api.prefill(p, {"tokens": toks[:, :33]}, 40)
        logits2, cache = api.decode_step(p, toks[:, 33], 33, cache)
        outs.append([logits, logits2, cache["sub0"]["k"], cache["sub0"]["v"]])
    for a, b in zip(*outs):
        scale = float(a.abs().max())
        assert float((b.cpu() - a).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("arch", ["xlstm_1_3b", "jamba_v0_1_52b"])
def test_cuda_ssm_and_hybrid_prefill_and_decode_match_cpu(cuda_device, arch):
    """The reduced xlstm (mLSTM and sLSTM blocks) and jamba (Mamba blocks,
    a GQA layer a period through the mma flash kernel, its decode cache a
    ring buffer of 32 slots) on the card against the same weights on the
    CPU: a prompt of 24, then 12 decode steps fed the same tokens across
    the ring's wrap at 32; float32 logits and every cache leaf within 1e-4
    of their largest magnitude (behind seven Mamba layers two float32
    runs drift apart by up to ~3e-5: ``tests/test_torch_hybrid.py``)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import layers, registry

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    api = registry.build(cfg)
    params = api.init(seed=0, device="cpu")
    on_card = layers.map_tree(lambda t: t.to(cuda_device), params)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 36))
    outs = []
    for p in (params, on_card):
        logits, cache = api.prefill(p, {"tokens": toks[:, :24]}, 64)
        got = [logits]
        for pos in range(24, 36):
            logits, cache = api.decode_step(p, toks[:, pos], pos, cache)
            got.append(logits)
        outs.append(got + [t for st in cache.values() for t in st.values()])
    for a, b in zip(*outs):
        scale = float(a.abs().max())
        assert float((b.cpu() - a).abs().max()) <= 1e-4 * scale


def test_cuda_decode_step_does_not_synchronise(cuda_device):
    """One decode step of the reduced llama config, its token already on the
    card, makes no synchronising call: ``gqa_decode`` builds the step's
    position on the device (it was a tensor of host data, a blocking copy
    in every layer; ROADMAP Queue 3)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import registry

    cfg = get_config("llama3_2_1b").reduced()
    api = registry.build(cfg)
    params = api.init(seed=0, device=cuda_device)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 33))
    logits, cache = api.prefill(params, {"tokens": toks}, 40)
    token = logits.argmax(-1)
    logits, cache = api.decode_step(params, token, 33, cache)  # warm-up
    token = logits.argmax(-1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, cache = api.decode_step(params, token, 34, cache)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# CUDA graphs: the stream path's kernels captured and replayed, and the
# stream executor (core/stream.py) against the eager engine
# ---------------------------------------------------------------------------
def _graph_case(kernel, rng, dev):
    """(call, state): ``call(state)`` runs the kernel's wrapper once at a
    main-path shape on integer data, in place into ``state`` (the view) or
    into a new output it returns."""
    B = 1000

    def t(a):
        return torch.tensor(a, device=dev)

    if kernel == "segment_ring_sum":
        S, d = 1000, 111
        ids, vals = t(_ids(rng, S, B)), t(_ints(rng, (B, d)))
        return (lambda _: tsegsum.segment_ring_sum(vals, ids, S)), None
    if kernel in ("scatter_add", "scatter_dedup"):
        view, ids, vals = _cuda_case(rng, 4096, B, 111, dev)
        dedup = kernel == "scatter_dedup"
        return (lambda v: ring_scatter.scatter_add(v, ids, vals, dedup=dedup)), view
    if kernel == "gather_mul_scatter":
        view, out_ids, _ = _cuda_case(rng, 96, B, 1, dev)
        src = t(_ints(rng, (9216, 1)))
        in_ids = t(rng.integers(0, 9216, size=B).astype(np.int32))
        scale = t(_ints(rng, (B,), -2, 3))
        return (lambda v: ring_scatter.gather_mul_scatter(v, out_ids, src, in_ids,
                                                          scale)), view
    spec, d = ("degree", 10), 111
    view, out_ids, vals = _cuda_case(rng, 96, B, d, dev)
    vals = t(_ints(rng, (B, d), -1, 2))
    sources = [(t(_ints(rng, (rows, d), -1, 2)),
                t(rng.integers(0, rows, size=B).astype(np.int32))) for rows in (9216, 96)]
    return (lambda v: ring_fused.fused_apply(v, out_ids, vals, sources, spec)), view


@pytest.mark.parametrize("kernel", ["scatter_add", "scatter_dedup", "segment_ring_sum",
                                    "gather_mul_scatter", "fused_chain"])
def test_cuda_stream_kernels_replay_in_a_graph(cuda_device, kernel):
    """Each kernel of the stream path, its wrapper captured in a CUDA graph,
    runs at replay (not at capture) and equals its eager call; its launch
    count sees each replay once (``_cuda.CapturedLaunches``)."""
    from repro_torch.kernels import _cuda

    call, view = _graph_case(kernel, np.random.default_rng(len(kernel)), cuda_device)
    wrapper = next(k for k in _cuda.KERNELS if k.name == kernel)
    eager = call(None if view is None else view.clone())  # also loads the library
    twice = None if view is None else call(call(view.clone()))
    work = None if view is None else view.clone()
    graph = torch.cuda.CUDAGraph()
    launches = _cuda.CapturedLaunches()
    with torch.cuda.graph(graph):
        out = call(work)
    launches.close()
    assert launches.counts == {wrapper: 1}
    if view is not None:
        assert torch.equal(work, view)  # the capture ran nothing
    n = wrapper.launches
    graph.replay()
    launches.replayed()
    assert torch.equal(out, eager)
    graph.replay()
    launches.replayed()
    assert torch.equal(out, eager if view is None else twice)
    assert wrapper.launches == n + 2


_GRAPH_SCHEDULES = {
    "scan": ["Inventory"] * 4,
    "rounds": list(synth.RETAILER_RELATIONS) * 3,
    "rounds_tail": list(synth.RETAILER_RELATIONS) * 3 + ["Inventory", "Item"],
    "switch": ["Inventory", "Item", "Weather", "Item", "Census", "Location",
               "Inventory", "Inventory", "Census"],
}


def _retailer_stream(ring, schedule, batch, rng, dev):
    out = []
    for rel in schedule:
        sch = synth.RETAILER_RELATIONS[rel]
        keys = np.stack([rng.integers(0, synth.RETAILER_DOMS[v], size=batch)
                         for v in sch], axis=1).astype(np.int32)
        vals = rng.choice([-1.0, 1.0], size=batch).astype(np.float32)
        payload = ({"v": torch.tensor(vals, device=dev)} if set(ring.components) == {"v"}
                   else {**ring.zeros((batch,), device=dev),
                         "c": torch.tensor(vals, device=dev)})
        out.append((rel, COOUpdate(sch, torch.tensor(keys, device=dev), payload)))
    return out


def _counts():
    from repro_torch.kernels import _cuda

    return {k.name: k.launches for k in _cuda.KERNELS}


def _since(before):
    return {n: c - before[n] for n, c in _counts().items() if c != before[n]}


@pytest.mark.parametrize("fusion", ["off", "on"])
@pytest.mark.parametrize("mode", list(_GRAPH_SCHEDULES))
def test_cuda_executor_matches_eager_engine(cuda_device, mode, fusion):
    """The executor on the card (each step body a CUDA graph) ≡ the eager
    engine, bitwise on integer data: a capture run (warm-up step, capture,
    replays), then a replay-only run on the same state under
    ``set_sync_debug_mode("error")`` that keeps every state leaf at its
    address.  Launch counts, replays included, equal the eager engine's."""
    from repro_torch.core import StreamExecutor, prepare_stream

    rng = np.random.default_rng(3)
    q = Query(relations=synth.RETAILER_RELATIONS, free_vars=(), ring=sum_ring(),
              domains=synth.RETAILER_DOMS, lifts={"units": ("value",)})
    # sparse enough that every view stays below 2**24: float32 sums are then
    # exact whatever order the atomics add in
    db = synth.synth_db(synth.RETAILER_RELATIONS, synth.RETAILER_DOMS, q.ring, rng,
                        density=0.05, device=cuda_device)
    stream = _retailer_stream(q.ring, _GRAPH_SCHEDULES[mode], 64, rng, cuda_device)
    with tplan.use_fusion(fusion):
        eager, graphed = (IVMEngine.build(q, db, var_order=synth.retailer_vo(),
                                          device=cuda_device) for _ in range(2))
        prepared = prepare_stream(graphed, stream)
        ex = StreamExecutor(graphed)
        before = _counts()
        for rel, upd in stream:
            eager.apply_update(rel, upd)
        want_launches = _since(before)
        before = _counts()
        ex.run(prepared)
        assert _since(before) == want_launches
        st = ex.last_run_stats
        assert st["replays"] > 0 and st["replays"] + st["eager_steps"] == prepared.n_steps
        ptrs = [t.data_ptr() for t in tplan.state_leaves(graphed.state)]
        for name, v in eager.views.items():
            assert torch.equal(graphed.views[name].payload["v"], v.payload["v"]), name
        for rel, upd in stream:
            eager.apply_update(rel, upd)
        before = _counts()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ex.run(prepared, donate_input=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert _since(before) == want_launches
        assert ex.last_run_stats["eager_steps"] == 0
    assert [t.data_ptr() for t in tplan.state_leaves(graphed.state)] == ptrs
    for name, v in eager.views.items():
        assert float(v.payload["v"].abs().max()) < _torch_parity.EXACT_LIMIT, name
        assert torch.equal(graphed.views[name].payload["v"], v.payload["v"]), name
    ex.release()


#: a second schedule of the first one's signature: in switch mode the same
#: relations, first seen in the same order, in another aperiodic order
_SECOND_GRAPH_SCHEDULES = {
    **_GRAPH_SCHEDULES,
    "switch": ["Inventory", "Item", "Weather", "Census", "Location", "Item",
               "Inventory", "Census", "Inventory"],
}


@pytest.mark.parametrize("mode", list(_GRAPH_SCHEDULES))
def test_cuda_executor_runs_two_streams_of_one_signature(cuda_device, mode):
    """A second stream of the first one's signature (in switch mode, in
    another order) through the same executor replays the first one's
    graphs on its own inputs, under ``set_sync_debug_mode("error")``; a
    raw stream on a copied state then captures anew.  ≡ the eager engine
    bitwise on integer data."""
    from repro_torch.core import StreamExecutor, prepare_stream

    rng = np.random.default_rng(5)
    q = Query(relations=synth.RETAILER_RELATIONS, free_vars=(), ring=sum_ring(),
              domains=synth.RETAILER_DOMS, lifts={"units": ("value",)})
    db = synth.synth_db(synth.RETAILER_RELATIONS, synth.RETAILER_DOMS, q.ring, rng,
                        density=0.05, device=cuda_device)
    first = _retailer_stream(q.ring, _GRAPH_SCHEDULES[mode], 64, rng, cuda_device)
    second = _retailer_stream(q.ring, _SECOND_GRAPH_SCHEDULES[mode], 64, rng,
                              cuda_device)
    eager, graphed = (IVMEngine.build(q, db, var_order=synth.retailer_vo(),
                                      device=cuda_device) for _ in range(2))
    p1, p2 = prepare_stream(graphed, first), prepare_stream(graphed, second)
    assert p1.signature == p2.signature
    ex = StreamExecutor(graphed)
    ex.run(p1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ex.run(p2, donate_input=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    st = ex.last_run_stats
    assert st["eager_steps"] == 0 and st["replays"] == p2.n_steps
    ex.run(first)
    assert ex.last_run_stats["eager_steps"] > 0 and len(ex._compiled) == 1
    for rel, upd in first + second + first:
        eager.apply_update(rel, upd)
    for name, v in eager.views.items():
        assert float(v.payload["v"].abs().max()) < _torch_parity.EXACT_LIMIT, name
        assert torch.equal(graphed.views[name].payload["v"], v.payload["v"]), name
    ex.release()


@pytest.mark.parametrize("fusion", ["off", "on"])
@pytest.mark.parametrize("ring", ["sum", "cofactor"])
def test_cuda_eager_trigger_path_does_not_synchronise(cuda_device, ring, fusion):
    """After one warm-up round (lift relations, kernel libraries, cuBLAS),
    a round of eager triggers makes no synchronising call."""
    rng = np.random.default_rng(4)
    q = (Query(relations=synth.RETAILER_RELATIONS, free_vars=(), ring=sum_ring(),
               domains=synth.RETAILER_DOMS, lifts={"units": ("value",)})
         if ring == "sum" else
         regression.cofactor_query(synth.RETAILER_RELATIONS, synth.RETAILER_DOMS))
    db = synth.synth_db(synth.RETAILER_RELATIONS, synth.RETAILER_DOMS, q.ring, rng,
                        device=cuda_device)
    stream = _retailer_stream(q.ring, list(synth.RETAILER_RELATIONS) * 2, 64, rng,
                              cuda_device)
    with tplan.use_fusion(fusion):
        eng = IVMEngine.build(q, db, var_order=synth.retailer_vo(), device=cuda_device)
        for rel, upd in stream[:5]:
            eng.apply_update(rel, upd)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for rel, upd in stream[5:]:
                eng.apply_update(rel, upd)
        finally:
            torch.cuda.set_sync_debug_mode(0)


# ---------------------------------------------------------------------------
# sparse view storage: the hash kernels, and triggers and graphs over hash
# tables
# ---------------------------------------------------------------------------
def _hash_case(rng, C, B, prefill, id_max=1 << 20):
    """A table holding ``prefill`` distinct ids (inserted by the plain
    version) and ``B`` distinct new ids with two sentinels (-1)."""
    from repro_torch.kernels import hash_table

    table = torch.full((C,), -1, dtype=torch.int32)
    pre = np.unique(rng.integers(0, id_max, size=prefill)).astype(np.int32)
    hash_table.insert_ref(table, torch.tensor(pre))
    ids = np.setdiff1d(np.unique(rng.integers(0, id_max, size=B)), pre)
    ids = rng.permutation(np.concatenate([ids, [-1, -1]])).astype(np.int32)
    return table, torch.tensor(ids)


#: (capacity, new ids, prefilled ids): small tables, contention at a 0.7 load,
#: a table that fills up (rows that never place), and the rehash sizes of
#: the housing legs
_HASH_CASES = [(8, 6, 0), (64, 40, 5), (16, 30, 6), (2048, 1000, 512),
               (8192, 4000, 3072), (1 << 17, 1 << 16, 0)]


@pytest.mark.parametrize("C,B,prefill", _HASH_CASES)
def test_cuda_hash_insert_matches_plain(cuda_device, C, B, prefill):
    """``hash_insert`` builds the plain version's table slot for slot (the
    reference's lockstep rounds), with its slots and placed flags, in one
    launch."""
    from repro_torch.kernels import hash_table

    rng = np.random.default_rng(C + B)
    table, ids = _hash_case(rng, C, B, prefill)
    want_table = table.clone()
    want_slot, want_placed = hash_table.insert_ref(want_table, ids)
    got_table = table.to(cuda_device)
    before = hash_table.HASH_INSERT.launches
    got_slot, got_placed = hash_table.hash_insert(got_table, ids.to(cuda_device))
    torch.cuda.synchronize()
    assert hash_table.HASH_INSERT.launches == before + 1
    assert torch.equal(got_table.cpu(), want_table)
    assert torch.equal(got_slot.cpu(), want_slot)
    assert torch.equal(got_placed.cpu(), want_placed)
    if C == 16:
        assert not want_placed.all()


@pytest.mark.parametrize("C,B,prefill", _HASH_CASES)
def test_cuda_hash_probe_matches_plain(cuda_device, C, B, prefill):
    """``hash_probe`` gives the plain version's slots and found flags for
    present, absent and sentinel ids, in one launch."""
    from repro_torch.kernels import hash_table

    rng = np.random.default_rng(C + 2 * B)
    table, ids = _hash_case(rng, C, B, prefill)
    hash_table.insert_ref(table, ids)
    queries = torch.cat([ids, torch.tensor(rng.integers(-1, 1 << 20, size=B)
                                           .astype(np.int32))])
    want = hash_table.probe_ref(table, queries)
    before = hash_table.HASH_PROBE.launches
    got = hash_table.hash_probe(table.to(cuda_device), queries.to(cuda_device))
    torch.cuda.synchronize()
    assert hash_table.HASH_PROBE.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


#: (route, capacity, new ids, prefilled ids): each insert route at sizes
#: that take it (the wrapper picks the route by size), rows above a
#: block's threads (cta: 5,000 rows on 1,024 threads; global: 9,000 and
#: 2^16 rows on 1,024), and full tables (rows that never place)
_ROUTE_CASES = [("cta", 8, 6, 0), ("cta", 16, 30, 6), ("cta", 8192, 4000, 3072),
                ("cta", 16384, 5000, 2000), ("global", 32768, 1000, 512),
                ("global", 1 << 17, 1 << 16, 0), ("global", 1 << 18, 3000, 1000),
                ("global", 16384, 9000, 0), ("global", 64, 9000, 5)]


def _route_id(case):
    return "-".join(map(str, case[:3]))


@pytest.mark.parametrize("route,C,B,prefill", _ROUTE_CASES, ids=map(_route_id, _ROUTE_CASES))
def test_cuda_hash_insert_routes_match_plain(cuda_device, route, C, B, prefill):
    """Each insert route, at sizes that take it, builds the plain
    version's table slot for slot, with its slots, placed flags and rounds,
    in one launch of that route."""
    from repro_torch.kernels import hash_table

    rng = np.random.default_rng(C + B)
    table, ids = _hash_case(rng, C, B, prefill)
    want_table, want_rounds = table.clone(), torch.zeros(1, dtype=torch.int32)
    want = hash_table.insert_ref(want_table, ids, rounds=want_rounds)
    got_table = table.to(cuda_device)
    rounds = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    assert hash_table.insert_route(C, B) == route
    counter = hash_table.ROUTE_LAUNCHES[f"hash_insert:{route}"]
    before = counter.launches
    got = hash_table.hash_insert(got_table, ids.to(cuda_device), rounds=rounds)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert torch.equal(got_table.cpu(), want_table)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int(rounds) == int(want_rounds)


def _dup_ids(rng, B, id_max):
    """B ids with duplicates (a third of the draws repeat earlier ones) and
    sentinels (-1, -3)."""
    ids = rng.integers(0, id_max, size=B)
    rep = rng.random(B) < 0.34
    ids[rep] = rng.choice(ids[~rep], size=int(rep.sum()))
    ids[rng.random(B) < 0.03] = -1
    ids[:2] = -3
    return torch.tensor(rng.permutation(ids).astype(np.int32))


@pytest.mark.parametrize("route,C,B,prefill", _ROUTE_CASES, ids=map(_route_id, _ROUTE_CASES))
def test_cuda_hash_insert_targets_matches_plain(cuda_device, route, C, B, prefill):
    """``hash_insert_targets`` on duplicated ids and sentinels, by each
    route: the plain version's table and every row's target, and the same
    from the keyed entry on a two-column key matrix."""
    from repro_torch.kernels import hash_table

    rng = np.random.default_rng(C + 3 * B)
    table, _ = _hash_case(rng, C, 0, prefill)
    ids = _dup_ids(rng, B, 3 * C)
    want_table = table.clone()
    want = hash_table.insert_targets_ref(want_table, ids)
    got_table = table.to(cuda_device)
    assert hash_table.insert_route(C, B) == route
    got = hash_table.hash_insert_targets(got_table, ids.to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(got_table.cpu(), want_table)
    assert torch.equal(got.cpu(), want)
    # keyed: id = 7 · col 2 + col 0 of a [B, 3] matrix (ids >= 0 only)
    keyed = ids.clamp(min=0)
    keys = torch.stack([keyed % 7, torch.zeros_like(keyed), keyed // 7], dim=1)
    want_table = table.clone()
    want = hash_table.insert_targets_ref(want_table, keyed)
    got_table = table.to(cuda_device)
    got = hash_table.hash_insert_targets_keys(got_table, keys.to(cuda_device), (2, 0),
                                              (7, 1))
    torch.cuda.synchronize()
    assert torch.equal(got_table.cpu(), want_table)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("C,n_keys", [(8, 8), (64, 64), (64, 45), (2048, 1400),
                                      (8192, 3072)])
def test_cuda_keyed_probe_matches_plain(cuda_device, C, n_keys):
    """The keyed probe (and the id probe) give the plain version's slots,
    found flags and gather rows, on full tables (misses end where they
    began) and on chains that wrap past slot C - 1."""
    from repro_torch.kernels import hash_table

    rng = np.random.default_rng(C + n_keys)
    table = torch.full((C,), -1, dtype=torch.int32)
    # up to four ids that hash to slot C - 1 first: their chains wrap
    ids = torch.arange(1 << 16, dtype=torch.int32)
    last = ids[hash_table.hash_ids(ids, C) == C - 1][:4].numpy()
    rest = np.setdiff1d(rng.choice(1 << 16, size=2 * n_keys, replace=False), last)
    present = np.concatenate([last, rng.permutation(rest)[:n_keys - len(last)]])
    hash_table.insert_ref(table, torch.tensor(present.astype(np.int32)))
    queries = np.concatenate([present, rng.integers(0, 1 << 16, size=3 * C)])
    keys = torch.tensor(np.stack([queries >> 8, rng.integers(0, 5, size=len(queries)),
                                  queries & 255], axis=1).astype(np.int32))
    want = hash_table.probe_keys_ref(table, keys, (0, 2), (256, 1))
    t_dev, k_dev = table.to(cuda_device), keys.to(cuda_device)
    got = hash_table.hash_probe_keys(t_dev, k_dev, (0, 2), (256, 1))
    ids = hash_table.linearize_ref(keys, (0, 2), (256, 1))
    got_ids = hash_table.hash_probe(t_dev, ids.to(cuda_device))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    for g, w in zip(got_ids, want[:2]):
        assert torch.equal(g.cpu(), w)
    assert bool((want[0] < hash_table.hash_ids(ids, C)).any())  # wrapped chains


def test_cuda_sparse_claim_and_gather_are_one_launch(cuda_device):
    """On the card a sparse ``fused_slot_targets`` is one insert kernel (no
    argsort, no rank prepass) and a sibling gather (``gather_rows``, and a
    delta's deferred gather plan) one probe kernel, with nothing else on
    the device; both equal the CPU relation's."""
    from repro_torch.core.contraction import BatchedDelta
    from repro_torch.core.storage import SparseRelation
    from repro_torch.kernels import hash_table

    rng = np.random.default_rng(9)
    doms, schema = (64, 16), ("A", "B")
    keys = np.stack([rng.integers(0, d, size=300) for d in doms], axis=1).astype(np.int32)
    vals = rng.integers(-3, 4, size=300).astype(np.float32)
    rels = {}
    for dev in ("cpu", cuda_device):
        rel = SparseRelation.zeros(schema, sum_ring(), doms, capacity=512, device=dev)
        rel.scatter_add(torch.tensor(keys, device=dev), {"v": torch.tensor(vals, device=dev)})
        rels[str(dev)] = rel
    delta = np.stack([rng.integers(0, 5, size=1000)] + [rng.integers(0, d, size=1000)
                                                        for d in doms[::-1]],
                     axis=1).astype(np.int32)  # (X, B, A)
    cols = (2, 1)
    out = {}
    for dev, rel in rels.items():
        k = torch.tensor(delta, device=rel.device)
        out[dev] = (rel.gather_rows(k, cols), rel.fused_slot_targets(k, cols)[1],
                    rel.table.clone())
    for g, w in zip(out[str(cuda_device)], out["cpu"]):
        assert torch.equal(g.cpu(), w)
    rel, k = rels[str(cuda_device)], torch.tensor(delta, device=cuda_device)
    for fn, kernel, counter in (
            (lambda: rel.fused_slot_targets(k, cols), "smem_insert_kernel",
             hash_table.HASH_INSERT),
            (lambda: rel.gather_rows(k, cols), "hash_probe_kernel", hash_table.HASH_PROBE)):
        before = counter.launches
        events, windows = _listed_kernels(fn, 5)
        # the message says what the profiler lost (ROADMAP Queue 3): the
        # listed names, the windows profiled and the wrapper's launches
        assert len(events) == 5 and all(kernel in e.name for e in events), \
            ([e.name[:60] for e in events], windows, counter.launches - before)
        assert counter.launches == before + 5 * windows
    ring = sum_ring()
    d = BatchedDelta(coo_schema=("X", "B", "A"), dense_schema=(), keys=k, ring=ring,
                     payload={"v": torch.ones(1000, device=cuda_device)})
    events, _ = _listed_kernels(lambda: d._gather_plan(rel), 5)
    assert len(events) == 5 and all("hash_probe_kernel" in e.name for e in events)


def _housing_sparse(dev, n_active=128, pool_extra=0, batch=32, n_batches=12):
    """The housing star at pc = 4,096 (auto: six hash tables, fill 3.1 %),
    its low-fill database and a stream on ``dev``."""
    doms = synth.HOUSING_DOMS
    q = Query(relations=synth.HOUSING_RELATIONS, free_vars=(), ring=sum_ring(),
              domains=doms, lifts={"h2": ("value",)})
    db, active = synth.synth_low_fill_db(synth.HOUSING_RELATIONS, doms, q.ring,
                                         np.random.default_rng(0), "pc", n_active,
                                         device=dev)
    pool = np.sort(np.concatenate([
        active, np.setdiff1d(np.arange(doms["pc"]), active)[:pool_extra]]))
    stream = synth.update_stream(synth.HOUSING_RELATIONS, doms, q.ring,
                                 np.random.default_rng(1), batch, n_batches,
                                 key_pools={"pc": pool}, device=dev)
    return q, db, stream


def _sparse_views_equal(a, b):
    from repro_torch.core.storage import SparseRelation

    for name, v in a.views.items():
        w = b.views[name]
        assert isinstance(v, SparseRelation) == isinstance(w, SparseRelation), name
        if isinstance(v, SparseRelation):
            assert torch.equal(v.table.cpu(), w.table.cpu()), name
        assert torch.equal(v.payload["v"].cpu(), w.payload["v"].cpu()), name


@pytest.mark.parametrize("fusion", ["off", "on"])
def test_cuda_sparse_trigger_does_not_synchronise(cuda_device, fusion):
    """After a warm-up round, a round of eager triggers that ⊎ into hash
    tables (``functional_update``: the trigger without the eager path's
    growth check, whose occupancy read is its one synchronise) makes no
    synchronising call, launches both hash kernels and leaves the CPU
    engine's views and tables."""
    from repro_torch.kernels import hash_table

    with tplan.use_fusion(fusion):
        engines = {}
        for dev in ("cpu", cuda_device):
            q, db, stream = _housing_sparse(dev)
            eng = IVMEngine.build(q, db, var_order=synth.housing_vo(), device=dev)
            assert sum(s.kind == "sparse" for s in eng.storage_plan.values()) == 6
            for i, (rel, upd) in enumerate(stream):
                if str(dev) == "cpu" or i < 6:
                    eng.apply_update(rel, upd)
                    continue
                if i == 6:
                    before = (hash_table.HASH_PROBE.launches,
                              hash_table.HASH_INSERT.launches)
                    torch.cuda.synchronize()
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    eng.set_state(eng.functional_update(*eng.state, rel, upd))
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            engines[str(dev)] = eng
    assert hash_table.HASH_PROBE.launches > before[0]
    assert hash_table.HASH_INSERT.launches > before[1]
    _sparse_views_equal(engines["cpu"], engines[str(cuda_device)])


@pytest.mark.parametrize("fusion", ["off", "on"])
def test_cuda_graphed_executor_over_sparse_views_matches_eager(cuda_device, fusion):
    """The executor on the card over hash tables: a capture run, then a
    replay-only run under ``set_sync_debug_mode("error")`` that keeps every
    state leaf (key tables and planes included) at its address; both equal
    the eager engine bitwise, with the eager engine's launch counts."""
    from repro_torch.core import StreamExecutor, prepare_stream

    q, db, stream = _housing_sparse(cuda_device)
    with tplan.use_fusion(fusion):
        eager, graphed = (IVMEngine.build(q, db, var_order=synth.housing_vo(),
                                          device=cuda_device) for _ in range(2))
        prepared = prepare_stream(graphed, stream)
        assert prepared.mode == "rounds"
        ex = StreamExecutor(graphed)
        for rel, upd in stream:
            eager.set_state(eager.functional_update(*eager.state, rel, upd))
        ex.run(prepared)
        assert ex.last_run_stats["replays"] > 0
        _sparse_views_equal(eager, graphed)
        ptrs = [t.data_ptr() for t in tplan.state_leaves(graphed.state)]
        before = _counts()
        for rel, upd in stream:
            eager.set_state(eager.functional_update(*eager.state, rel, upd))
        want_launches = _since(before)
        assert want_launches.get("hash_insert", 0) > 0
        before = _counts()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ex.run(prepared, donate_input=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert _since(before) == want_launches
        assert ex.last_run_stats["eager_steps"] == 0
    assert [t.data_ptr() for t in tplan.state_leaves(graphed.state)] == ptrs
    _sparse_views_equal(eager, graphed)
    ex.release()


@pytest.mark.parametrize("cols", [(0, 1, 2, 3), (4, 0, 3, 1, 2)])
def test_cuda_wide_keys_match_plain(cuda_device, cols):
    """Keys of 4 and 5 columns, wider than the kernels linearize: the
    wrappers linearize them before the launch and the claim and the probe
    are one launch each of the same kernels, equal to the plain versions
    (which the CPU tests hold to the reference)."""
    from repro_torch.core import storage
    from repro_torch.kernels import hash_table

    rng = np.random.default_rng(len(cols))
    doms = (50, 30, 40, 60, 20)
    strides = storage.row_major_strides([doms[c] for c in cols])
    keys = torch.tensor(np.stack([rng.integers(0, d, size=3000) for d in doms], axis=1)
                        .astype(np.int32))
    C = 4096
    want_t = torch.full((C,), -1, dtype=torch.int32)
    want = hash_table.insert_targets_ref(want_t, hash_table.linearize_ref(keys, cols,
                                                                          strides))
    got_t, k_dev = want_t.new_full((C,), -1).to(cuda_device), keys.to(cuda_device)
    before = _counts()
    got = hash_table.hash_insert_targets_keys(got_t, k_dev, cols, strides)
    queries = torch.cat([k_dev, k_dev.flip(0) % 3])
    rows = hash_table.hash_probe_keys(got_t, queries, cols, strides)
    torch.cuda.synchronize()
    assert _since(before) == {"hash_insert": 1, "hash_insert_targets:cta": 1,
                              "hash_probe": 1, "hash_probe:keys": 1}
    assert torch.equal(got_t.cpu(), want_t) and torch.equal(got.cpu(), want)
    want_rows = hash_table.probe_keys_ref(want_t, queries.cpu(), cols, strides)
    for g, w in zip(rows, want_rows):
        assert torch.equal(g.cpu(), w)


def test_cuda_four_column_sparse_view_matches_cpu(cuda_device):
    """A group-by over four key columns, every view forced sparse (tables
    sized for the stream), through the executor twice: on the card the
    second run is graph replays alone (the root view claimed by
    four-column keys) under ``set_sync_debug_mode("error")``; views and
    tables equal the CPU executor's, bitwise."""
    from repro_torch import convert
    from repro_torch.core import StreamExecutor, chain, prepare_stream
    from repro_torch.kernels import hash_table

    rng = np.random.default_rng(5)
    doms = dict(A=12, B=9, C=10, D=16, E=5)
    q = Query(relations={"R": ("A", "B", "C", "D"), "S": ("D", "E")},
              free_vars=("A", "B", "C", "D"), domains=doms, ring=sum_ring(),
              lifts={"E": ("value",)})
    arrays = {n: (sch, {"v": (rng.random(tuple(doms[v] for v in sch)) < 0.05)
                        .astype(np.float32)}) for n, sch in q.relations.items()}
    raw = []
    for rel in ("R",) * 4:
        sch = q.relations[rel]
        raw.append((rel, sch, np.stack([rng.integers(0, doms[v], size=64) for v in sch],
                                       axis=1).astype(np.int32),
                    rng.integers(-2, 3, size=64).astype(np.float32)))
    vo = chain(["A", "B", "C", "D"], {"D": [["E"]]})
    engines = {}
    for dev in ("cpu", cuda_device):
        db = convert.database_from_numpy(arrays, q.ring, device=dev)
        stream = [(rel, convert.update_from_numpy(sch, k, {"v": v}, q.ring, device=dev))
                  for rel, sch, k, v in raw]
        eng = IVMEngine.build(q, db, var_order=vo, storage="sparse",
                              storage_opts=dict(headroom=4), device=dev)
        assert any(len(v.schema) == 4 for n, v in eng.views.items()
                   if eng.storage_plan[n].kind == "sparse")
        ex = StreamExecutor(eng)
        prepared = prepare_stream(eng, stream)
        ex.run(prepared)
        if str(dev) == "cpu":
            ex.run(prepared)
        else:
            before = hash_table.ROUTE_LAUNCHES["hash_insert_targets:cta"].launches
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                ex.run(prepared, donate_input=True)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert ex.last_run_stats["eager_steps"] == 0
            assert ex.last_run_stats["replays"] > 0
            assert hash_table.ROUTE_LAUNCHES["hash_insert_targets:cta"].launches > before
            ex.release()
        engines[str(dev)] = eng
    _sparse_views_equal(engines["cpu"], engines[str(cuda_device)])


def test_cuda_executor_grows_tables_between_segments(cuda_device):
    """A raw stream that outgrows the tables runs as capacity segments on
    the card (rehash, recompile, capture): views and tables equal the CPU
    executor's."""
    from repro_torch.core import StreamExecutor

    out = {}
    for dev in ("cpu", cuda_device):
        q, db, stream = _housing_sparse(dev, pool_extra=1024 - 128, batch=200)
        eng = IVMEngine.build(q, db, var_order=synth.housing_vo(), device=dev)
        ex = StreamExecutor(eng)
        ex.run(stream)
        assert any(s["grow"] for s in ex.last_segment_stats)
        out[str(dev)] = eng
    _sparse_views_equal(out["cpu"], out[str(cuda_device)])


@pytest.mark.parametrize("kernel", ["scatter_add", "scatter_dedup", "fused_chain",
                                    "gather_mul_scatter"])
@pytest.mark.parametrize("d", [1, 111])
def test_cuda_scatter_kernels_flush_subnormals(cuda_device, kernel, d):
    """Payloads and products near 1e-40 (below 2^-126), through each ⊎
    kernel at d = 1 (scalar reductions only) and d = 111 (the float4
    reductions of a row's aligned interior, ``common.cuh``'s ``reduce_group``,
    and the scalar ones of its head and tail): every kernel leaves 0, as
    the reference's XLA ⊎ does (the float32 reductions flush subnormal
    inputs and results).  The plain versions keep such values
    (``tests/test_torch_scatter.py::
    test_subnormal_payloads_reference_flushes_plain_versions_keep``)."""
    S, B = 64, 256
    rng = np.random.default_rng(d)
    ids = torch.tensor(rng.permutation(np.arange(B) % S).astype(np.int32),
                       device=cuda_device)
    view = torch.zeros((S, d), device=cuda_device)
    tiny = torch.full((B, d), 1e-40, device=cuda_device)
    if kernel in ("scatter_add", "scatter_dedup"):
        ring_scatter.scatter_add(view, ids, tiny, dedup=kernel == "scatter_dedup")
    elif kernel == "fused_chain":  # 1e-20 · 1e-20: a subnormal product
        vals = torch.full((B, d), 1e-20, device=cuda_device)
        plane = torch.full((S, d), 1e-20, device=cuda_device)
        ring_fused.fused_apply(view, ids, vals, [(plane, ids)], ("scalar",)
                               if d == 1 else ("degree", 10))
    else:
        src = torch.full((S, d), 1e-20, device=cuda_device)
        ring_scatter.gather_mul_scatter(view, ids, src, ids,
                                        torch.full((B,), 1e-20, device=cuda_device))
    torch.cuda.synchronize()
    assert not view.any(), f"{kernel} kept {int(view.count_nonzero())} subnormal values"


def _chain_mats(rng, n, count=3):
    """Integer-valued float32 matrices: every chain product and update sum
    stays an integer below 2**24, exact in any summation order."""
    return [rng.integers(-1, 2, size=(n, n)).astype(np.float32) for _ in range(count)]


def _chain_updates(rng, n):
    """Integer rank-1 and row updates (u, v), as numpy pairs."""
    out = []
    for i in range(4):
        if i % 2:
            u = np.zeros(n, np.float32)
            u[rng.integers(0, n)] = 1.0
        else:
            u = rng.integers(-1, 2, size=n).astype(np.float32)
        out.append((u, rng.integers(-1, 2, size=n).astype(np.float32)))
    return out


def _chain_kernel_ops(plan, views) -> tuple[int, int]:
    """(Join-Lift-Marg triples, ⊎ ops into a dense 2-D view) of a rank-1
    chain plan: the matvec and outer_accumulate launches of one update."""
    ops = plan.ops
    joins = sum(isinstance(op, tplan.JoinContract)
                and isinstance(ops[i + 1], tplan.Lift)
                and isinstance(ops[i + 2], tplan.Marginalize)
                for i, op in enumerate(ops))
    outers = sum(isinstance(op, tplan.ScatterAccum) and op.storage == "dense"
                 and len(views[op.view].schema) == 2 for op in ops)
    return joins, outers


@pytest.mark.parametrize("updatable", [("A2",), None])
def test_cuda_chain_engine_bitwise_to_cpu(cuda_device, updatable):
    """The chain engine on the card (rank-1 joins and ⊎s on the matvec and
    outer_accumulate kernels) ≡ the same engine on the CPU (the kernels'
    plain versions), every view, on integer-valued data."""
    from repro_torch.core.apps import matrix_chain

    rng = np.random.default_rng(0)
    n = 192
    mats = _chain_mats(rng, n)
    engines = {dev: matrix_chain.build_chain_engine(mats, updatable=updatable,
                                                    device=dev)
               for dev in ("cpu", cuda_device)}
    updates = _chain_updates(rng, n)
    for u, v in updates:
        for dev, eng in engines.items():
            eng.apply_update("A2", matrix_chain.rank1_update(
                2, torch.tensor(u, device=dev), torch.tensor(v, device=dev),
                eng.query.ring))
    cpu, card = engines["cpu"], engines[cuda_device]
    for name, view in cpu.views.items():
        np.testing.assert_array_equal(card.views[name].payload["v"].cpu().numpy(),
                                      view.payload["v"].numpy(), err_msg=name)
    a2 = mats[1].astype(np.float64) + sum(np.outer(u, v) for u, v in updates)
    want = mats[0].astype(np.float64) @ a2 @ mats[2].astype(np.float64)
    np.testing.assert_array_equal(matrix_chain.result_matrix(card).cpu().numpy(), want)


@pytest.mark.parametrize("updatable", [("A2",), None])
def test_cuda_chain_update_launches_equal_the_plan(cuda_device, updatable):
    """One rank-1 update launches matvec once a (Join, Lift, Marg) triple
    of its plan and outer_accumulate once a ⊎ into a dense 2-D view."""
    from repro_torch.core.apps import matrix_chain
    from repro_torch.kernels import rank1_chain

    rng = np.random.default_rng(1)
    n = 256
    eng = matrix_chain.build_chain_engine(_chain_mats(rng, n), updatable=updatable,
                                          device=cuda_device)
    (u, v), = _chain_updates(rng, n)[:1]
    upd = matrix_chain.rank1_update(2, torch.tensor(u, device=cuda_device),
                                    torch.tensor(v, device=cuda_device), eng.query.ring)
    joins, outers = _chain_kernel_ops(eng.trigger_plan("A2", upd), eng.views)
    assert joins == 2 and outers == (1 if updatable else 3)
    before = rank1_chain.MATVEC.launches, rank1_chain.OUTER_ACCUMULATE.launches
    eng.apply_update("A2", upd)
    torch.cuda.synchronize()
    assert (rank1_chain.MATVEC.launches - before[0],
            rank1_chain.OUTER_ACCUMULATE.launches - before[1]) == (joins, outers)


def test_cuda_sparse_chain_engine_equals_dense(cuda_device):
    """A storage="sparse" chain engine on the card (joins densify sparse
    siblings, each ⊎ the per-factor active-key lowering through the hash
    kernels) ≡ dense storage, under integer row updates."""
    from repro_torch.core.apps import matrix_chain
    from repro_torch.core.storage import SparseRelation

    rng = np.random.default_rng(2)
    n = 64
    mats = _chain_mats(rng, n, count=2)
    eng_d = matrix_chain.build_chain_engine(mats, storage="dense", device=cuda_device)
    eng_s = matrix_chain.build_chain_engine(mats, storage="sparse", device=cuda_device)
    assert any(isinstance(v, SparseRelation) for v in eng_s.views.values())
    for k, row in ((1, 3), (2, 0), (1, 63)):
        delta = torch.tensor(rng.integers(-2, 3, size=n).astype(np.float32),
                             device=cuda_device)
        for eng in (eng_d, eng_s):
            eng.apply_update(f"A{k}", matrix_chain.row_update(k, row, delta, n,
                                                              eng.query.ring))
    np.testing.assert_array_equal(matrix_chain.result_matrix(eng_s).cpu().numpy(),
                                  matrix_chain.result_matrix(eng_d).cpu().numpy())


# ---------------------------------------------------------------------------
# Indicator projections (the triangle query) and the conjunctive app
# ---------------------------------------------------------------------------
def _triangle(dev, n=48, seed=0, batches=(40,) * 9):
    """The triangle query in the degree-3 cofactor ring at n a variable
    (0/1 multiplicities at ``synth_db``'s density 0.3, so that triangles
    exist at this n) and a round-robin stream of distinct-key batches."""
    doms = dict(A=n, B=n, C=n)
    q = regression.cofactor_query(synth.TRIANGLE_RELATIONS, doms)
    db = synth.synth_db(synth.TRIANGLE_RELATIONS, doms, q.ring,
                        np.random.default_rng(seed), device=dev)
    stream = synth.distinct_key_stream(synth.TRIANGLE_RELATIONS, doms, q.ring,
                                       np.random.default_rng(seed + 1),
                                       list(batches), device=dev)
    return q, db, stream


def _tri_engine(q, db, dev, **kw):
    return IVMEngine.build(q, db, var_order=synth.triangle_vo(),
                           use_indicators=True, fuse_chains=False, device=dev,
                           **kw)


def _states_equal(a, b):
    la = tplan.state_leaves(a.state)
    lb = tplan.state_leaves(b.state)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x.cpu(), y.cpu())


@pytest.mark.parametrize("strategy", ["fivm", "dbt"])
@pytest.mark.parametrize("fusion", ["off", "on"])
def test_cuda_triangle_engine_bitwise_to_cpu(cuda_device, strategy, fusion):
    """Views, base relations, indicator counts and planes on the card equal
    the CPU engine's after the stream (integer data below 2**24)."""
    engines = {}
    with tplan.use_fusion(fusion):
        for dev in ("cpu", cuda_device):
            q, db, stream = _triangle(dev)
            eng = _tri_engine(q, db, dev, strategy=strategy)
            for rel, upd in stream:
                eng.apply_update(rel, upd)
            engines[str(dev)] = eng
    _states_equal(engines["cpu"], engines[str(cuda_device)])
    assert engines["cpu"].indicators["V0@C"].counts.sum() > 0


def test_cuda_triangle_launches_equal_the_plan(cuda_device):
    """Each update launches the ⊎ kernels its plan's ScatterAccum ops,
    IndicatorBump and stored base relation name under their backends
    (``compact``: a ``segment_ring_sum`` and a ``scatter_add``;
    ``scatter``: a ``scatter_add``), and fused chains one ``fused_chain``
    each."""
    from repro_torch.core.storage import payload_width

    q, db, stream = _triangle(cuda_device)
    eng = _tri_engine(q, db, cuda_device, strategy="fivm")
    kernels = {"scatter_add": ring_scatter.SCATTER_ADD,
               "segment_ring_sum": tsegsum.SEGMENT_RING_SUM,
               "gather_mul_scatter": ring_scatter.GATHER_MUL_SCATTER,
               "fused_chain": ring_fused.FUSED_CHAIN}
    for rel, upd in stream:
        p = eng.trigger_plan(rel, upd)
        want = dict.fromkeys(kernels, 0)

        def resolved(domains):
            return scatter_ops.resolve_backend(int(np.prod(domains)), upd.batch,
                                               payload_width(q.ring),
                                               device=cuda_device)

        def scatter(backend):
            if backend == "compact":
                want["segment_ring_sum"] += 1
            if backend in ("compact", "scatter"):
                want["scatter_add"] += 1

        for op in p.ops + p.ind_ops:
            if isinstance(op, tplan.FusedChain):
                want["fused_chain"] += 1
            elif isinstance(op, tplan.ScatterAccum):
                scatter(op.backend)
            elif isinstance(op, tplan.IndicatorBump):
                scatter(resolved(eng.indicators[op.node].counts.shape))
        for name in p.write_base:  # the stored base relation's ⊎
            scatter(resolved(eng.base[name].domains))
        before = {k: w.launches for k, w in kernels.items()}
        eng.apply_update(rel, upd)
        assert {k: w.launches - before[k] for k, w in kernels.items()} == want, rel
    assert any(p.ind_ops for p in eng.plans.plans.values())


def test_cuda_indicator_round_makes_no_synchronising_call(cuda_device):
    """A round R, S, T whose R trigger bumps the indicator: the trigger
    path (``functional_update``) under ``set_sync_debug_mode("error")``."""
    q, db, stream = _triangle(cuda_device, batches=(40,) * 6)
    eng = _tri_engine(q, db, cuda_device, strategy="fivm")
    for rel, upd in stream[:3]:  # warm-up: lift relations, kernel libraries
        eng.apply_update(rel, upd)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for rel, upd in stream[3:]:
            eng.set_state(eng.functional_update(*eng.state, rel, upd))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert eng.trigger_plan("R", stream[3][1]).ind_ops


def test_cuda_graphed_triangle_executor_with_padded_rows(cuda_device):
    """The executor on the card over the indicator round, batches of 39
    and 40 rows (padded rows through the IndicatorBump): a capture run,
    then a replay-only run of the same stream on the captured state; the
    state equals an eager engine's that took the same padded batches."""
    from repro_torch.core import StreamExecutor, prepare_stream

    q, db, stream = _triangle(cuda_device,
                              batches=[40 - (i // 3) % 2 for i in range(9)])
    eager = _tri_engine(q, db, cuda_device, strategy="fivm")
    graphed = _tri_engine(q, db, cuda_device, strategy="fivm")
    prepared = prepare_stream(graphed, stream)
    ex = StreamExecutor(graphed)
    ex.run(prepared)
    torch.cuda.set_sync_debug_mode("error")
    try:
        ex.run(prepared, donate_input=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ex.last_run_stats["eager_steps"] == 0 and ex.last_run_stats["replays"]
    for _ in range(2):
        for rel, upd in stream:
            eager.apply_update(rel, upd.pad_to(q.ring, 40))
    _states_equal(eager, graphed)
    ex.release()


def test_cuda_conjunctive_W_views_bitwise_to_cpu(cuda_device):
    from repro_torch.core.apps import conjunctive

    rels = {"House": ("pc", "h1"), "Shop": ("pc", "s1"), "Rest": ("pc", "r1")}
    doms = dict(pc=256, h1=6, s1=6, r1=6)
    vo = (["pc"], {"pc": [["h1"], ["s1"], ["r1"]]})
    rng = np.random.default_rng(0)
    data = {n: (rng.random(tuple(doms[v] for v in sch)) < 0.5).astype(np.int64)
            for n, sch in rels.items()}
    engines = {}
    for dev in ("cpu", cuda_device):
        from repro_torch.core import chain

        eng, _ = conjunctive.make_factorized_engine(rels, data, chain(*vo), doms,
                                                    device=dev)
        upds = np.random.default_rng(1)
        for i in range(6):
            rel = list(rels)[i % 3]
            shape = data[rel].shape
            flat = upds.choice(int(np.prod(shape)), size=64, replace=False)
            keys = np.stack(np.unravel_index(flat, shape), axis=1).astype(np.int32)
            vals = upds.choice([-1.0, 1.0], size=64).astype(np.float32)
            eng.apply_update(rel, COOUpdate(rels[rel], torch.tensor(keys, device=dev),
                                            {"v": torch.tensor(vals, device=dev)}))
        engines[str(dev)] = eng
    cpu, card = engines["cpu"], engines[str(cuda_device)]
    assert sorted(cpu.views) == sorted(card.views)
    assert sum(n.startswith("W:") for n in card.views) == 4
    for name, v in cpu.views.items():
        assert torch.equal(v.payload["v"], card.views[name].payload["v"].cpu()), name


# ---------------------------------------------------------------------------
# the durability and integrity planes on the card
# ---------------------------------------------------------------------------
def _housing_engine(q, db, dev, **kw):
    return IVMEngine.build(q, db, var_order=synth.housing_vo(), device=dev, **kw)


def _dense_views_equal(a, b):
    from repro_torch.core.storage import as_dense

    for name, v in a.views.items():
        assert torch.equal(as_dense(v).payload["v"], as_dense(b.views[name]).payload["v"]), name


def test_cuda_checkpointed_graphed_run_matches_eager(cuda_device, tmp_path):
    """A checkpointed run on the card (two segments of six updates, the
    second only replays) equals the eager engine bitwise, and a run with
    the same segments but no checkpoint leaf for leaf (key tables too); its
    snapshots restore to the same state."""
    from repro_torch.checkpoint import StreamCheckpointer
    from repro_torch.core import StreamExecutor
    from repro_torch.runtime.integrity import IntegrityConfig

    q, db, stream = _housing_sparse(cuda_device)
    eager, graphed, plain = (_housing_engine(q, db, cuda_device) for _ in range(3))
    for rel, upd in stream:
        eager.apply_update(rel, upd)
    ck = StreamCheckpointer(str(tmp_path), segment_updates=6)
    ex = StreamExecutor(graphed, checkpoint=ck)
    ex.run(stream)
    StreamExecutor(plain, integrity=IntegrityConfig(policy="permissive",
                                                    segment_updates=6)).run(stream)
    stats = ex.last_segment_stats
    assert [s["updates"] for s in stats] == [6, 6]
    assert stats[1]["run"]["eager_steps"] == 0 and stats[1]["run"]["replays"] == 6
    _dense_views_equal(eager, graphed)
    _sparse_views_equal(plain, graphed)
    assert ck.ckpt.all_steps() == [6, 12]
    restored = _housing_engine(q, db, cuda_device)
    assert ck.restore_into(restored)["offset"] == 12
    _sparse_views_equal(graphed, restored)
    ex.release()


def test_cuda_boundary_save_makes_no_synchronising_call(cuda_device, tmp_path):
    """A non-final boundary save (clones on the current stream, an event,
    the writer thread) makes no synchronising call, and the next segment's
    in-place writes, queued right behind it, do not reach the snapshot:
    the restored state is the state at the save."""
    from repro_torch.checkpoint import StreamCheckpointer
    from repro_torch.core import StreamExecutor

    q, db, stream = _housing_sparse(cuda_device)
    eng = _housing_engine(q, db, cuda_device)
    StreamExecutor(eng).run(stream[:6])
    ck = StreamCheckpointer(str(tmp_path))
    ck.save_boundary(eng, offset=0, segment=0)  # warm: the pinned buffers
    ck.wait()
    want = [t.clone() for t in tplan.state_leaves(eng.state)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ck.save_boundary(eng, offset=6, segment=1)
        for rel, upd in stream[6:]:
            eng.set_state(eng.functional_update(*eng.state, rel, upd))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ck.wait()
    restored = _housing_engine(q, db, cuda_device)
    assert ck.restore_into(restored)["offset"] == 6
    got = tplan.state_leaves(restored.state)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in zip(tplan.state_leaves(eng.state), want))


def test_cuda_supervisor_restarts_the_same_executor_without_a_stale_graph(
        cuda_device, tmp_path):
    """``StreamSupervisor`` resumes the executor that failed: the restore
    installs new tensors, the next segment captures on them, and no graph
    replays onto the tensors it was bound to before the restore (they
    keep their values); the result is the uninterrupted run's."""
    from repro_torch.checkpoint import StreamCheckpointer
    from repro_torch.core import StreamExecutor
    from repro_torch.runtime import faults
    from repro_torch.runtime.fault_tolerance import StreamSupervisor

    q, db, stream = _housing_sparse(cuda_device, n_batches=18)
    ref = _housing_engine(q, db, cuda_device)
    for rel, upd in stream:
        ref.apply_update(rel, upd)
    eng = _housing_engine(q, db, cuda_device)
    ck = StreamCheckpointer(str(tmp_path), segment_updates=6)
    ex = StreamExecutor(eng, checkpoint=ck)
    before_restore = []
    restore = ck.restore_into

    def spy(engine):
        leaves = tplan.state_leaves(engine.state)
        before_restore.append((leaves, [t.clone() for t in leaves]))
        return restore(engine)

    ck.restore_into = spy
    faults.install(faults.FaultPlan("mid_segment", at=1))
    try:
        _, restarts, log = StreamSupervisor(backoff_s=0.0).run(ex, stream)
    finally:
        faults.clear()
    assert restarts == 1 and log[0]["action"] == "restart"
    stale, values = before_restore[-1]
    now = tplan.state_leaves(eng.state)
    assert not {id(t) for t in stale} & {id(t) for t in now}
    for t, v in zip(stale, values):
        assert torch.equal(t, v)  # nothing replayed onto the old tensors
    _dense_views_equal(ref, eng)
    ex.release()


def test_cuda_in_place_audit_repair_keeps_the_leaves_and_the_graphs(cuda_device,
                                                                    monkeypatch):
    """Drift put into a dense and a sparse view after the first segment is
    repaired in place at its audit: every state leaf keeps its address, the
    next segment replays its graphs (no eager step, no capture), and the
    result is the eager engine's."""
    from repro_torch.core import StreamExecutor
    from repro_torch.core.storage import SparseRelation
    from repro_torch.runtime import faults
    from repro_torch.runtime.integrity import IntegrityConfig

    q, db, stream = _housing_sparse(cuda_device, n_batches=18)
    eager = _housing_engine(q, db, cuda_device)
    for rel, upd in stream:
        eager.apply_update(rel, upd)
    eng = _housing_engine(q, db, cuda_device, store_base=True)
    root = eng.tree.name
    sparse = next(n for n, v in sorted(eng.views.items()) if isinstance(v, SparseRelation))
    cfg = IntegrityConfig(policy="quarantine", audit_interval=1, segment_updates=6,
                          audit_views=(root, sparse))
    ex = StreamExecutor(eng, integrity=cfg)
    seen = {}
    crossing = faults.crossing

    def drift(point, **ctx):
        if point == "mid_segment" and ctx["segment"] == 0:
            root_v = eng.views[root].payload["v"].view(-1)
            root_v[0] += 0.01 * root_v[0].abs() + 7  # past audit_tol, relative
            v = eng.views[sparse]
            slot = int(torch.nonzero(v.table >= 0)[0])
            v.plane[slot] += 7
            seen["ptrs"] = [t.data_ptr() for t in tplan.state_leaves(eng.state)]
        crossing(point, **ctx)

    monkeypatch.setattr(faults, "crossing", drift)
    ex.run(stream)
    repaired = [e for e in cfg.audit_log if e["repaired"]]
    assert [(e["segment"], e["view"], e["route"]) for e in repaired] == [
        (0, root, "in_place"), (0, sparse, "in_place")]
    stats = ex.last_segment_stats
    assert [s["run"]["eager_steps"] for s in stats[1:]] == [0, 0]
    assert [t.data_ptr() for t in tplan.state_leaves(eng.state)] == seen["ptrs"]
    _dense_views_equal(eager, eng)
    ex.release()


def test_cuda_strict_admission_reads_the_host_once_a_segment(cuda_device):
    """Validated admission of a segment: ``strict`` reads one stacked flag
    vector on the host, ``quarantine`` nothing (its flags wait for the
    run's end)."""
    import warnings

    from repro_torch.runtime.integrity import IntegrityConfig, admit_stream

    q, db, stream = _housing_sparse(cuda_device)
    eng = _housing_engine(q, db, cuda_device)
    for policy, want in (("strict", 1), ("quarantine", 0)):
        cfg = IntegrityConfig(policy=policy)
        admit_stream(eng, stream[:6], cfg)  # warm
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                admit_stream(eng, stream[:6], cfg, base_offset=6)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = [w for w in caught if "synchronizing" in str(w.message)]
        assert len(syncs) == want, (policy, [str(w.message) for w in syncs])


# ---------------------------------------------------------------------------
# the serving plane on the card
# ---------------------------------------------------------------------------
def _served_housing(dev, storage="auto", retain=2, **kw):
    """The housing star at pc = 4,096 (``auto``: six hash tables) after its
    stream ran through a registry-attached executor: (engine, executor,
    server, the first ``pc``-keyed view by name)."""
    from repro_torch.core import StreamExecutor
    from repro_torch.serve import ViewServer

    q, db, stream = _housing_sparse(dev, **kw)
    eng = _housing_engine(q, db, dev, storage=storage)
    ex = StreamExecutor(eng)
    server = ViewServer(ex, retain=retain)
    ex.run(stream)
    name = sorted(n for n, v in eng.views.items() if v.schema)[0]
    return eng, ex, server, name


def _host(tree):
    from torch.utils import _pytree as pytree

    return pytree.tree_map(lambda x: x.detach().cpu().numpy(), tree)


def _assert_host_equal(a, b, where=""):
    from torch.utils import _pytree as pytree

    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    assert sa == sb, where
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype, where
        np.testing.assert_array_equal(x, y, err_msg=where)


@pytest.mark.parametrize("storage", ["auto", "dense"])
def test_cuda_serve_reads_make_no_synchronising_call(cuda_device, storage):
    """``point`` (device and host keys), ``range_sum``, ``range_scan``,
    ``top_k`` and a publish make no synchronising call on the card
    (``set_sync_debug_mode("error")``), and every read equals the CPU
    engine's, top-k ties in the same order (the tables are equal slot for
    slot)."""
    out = {}
    for dev in ("cpu", cuda_device):
        eng, ex, server, name = _served_housing(dev, storage)
        keys = np.concatenate([np.arange(0, 4096, 37), [-1, -1]])[:, None].astype(np.int32)
        dkeys = torch.from_numpy(keys).to(dev)
        paths = (lambda: server.point(name, dkeys), lambda: server.point(name, keys),
                 lambda: server.range_sum(name, 0, 4096),
                 lambda: server.range_scan(name, 100, 3000, 32),
                 lambda: server.top_k(name, 8))
        for fn in paths:  # warm: pinned buffers, first-use allocations
            fn()
        if dev == "cpu":
            reads = [fn().data for fn in paths]
        else:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                reads = [fn().data for fn in paths]
                server.registry.publish(eng.views)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        out[str(dev)] = _host(reads)
        ex.release()
    _assert_host_equal(out[str(cuda_device)], out["cpu"])


def test_cuda_sparse_point_read_is_one_keyed_probe(cuda_device):
    """A point read of a hash-table view launches one keyed ``hash_probe``
    and no other hand kernel: the wrappers' counts, and the profiler lists
    one ``hash_probe_kernel`` a read."""
    from repro_torch.kernels import hash_table

    eng, ex, server, name = _served_housing(cuda_device)
    from repro_torch.core.storage import SparseRelation

    assert isinstance(eng.views[name], SparseRelation)
    keys = torch.arange(0, 4096, 16, dtype=torch.int32, device=cuda_device)[:, None]
    server.point(name, keys)
    others = [ring_scatter.SCATTER_ADD, ring_scatter.SCATTER_DEDUP,
              ring_scatter.GATHER_MUL_SCATTER, tsegsum.SEGMENT_RING_SUM,
              ring_fused.FUSED_CHAIN, hash_table.HASH_INSERT]
    before = ([k.launches for k in others], hash_table.HASH_PROBE.launches,
              hash_table.ROUTE_LAUNCHES["hash_probe:keys"].launches)
    events, windows = _listed_kernels(lambda: server.point(name, keys), 10)
    assert sum("hash_probe_kernel" in e.name for e in events) == 10
    assert [k.launches for k in others] == before[0]
    assert hash_table.HASH_PROBE.launches - before[1] == 10 * windows
    assert hash_table.ROUTE_LAUNCHES["hash_probe:keys"].launches - before[2] == 10 * windows
    ex.release()


def test_cuda_evicted_generation_read_in_flight_stays_correct(cuda_device):
    """A read of generation g queued on a side stream behind a long kernel,
    while the producer's stream evicts g (``retain=1``) and allocates and
    fills memory of g's size: the read still sees g, because it marked g's
    tensors as used on its stream (``record_stream``), so the caching
    allocator does not hand g's block to the producer's stream before the
    read has run.  (The view has a size of its own, 12,000,068 bytes, so
    the allocator's best fit for the fill is g's block.)"""
    from types import SimpleNamespace

    from repro_torch.core import DenseRelation
    from repro_torch.serve import ViewServer

    n = 3_000_017
    ring = sum_ring()
    views = {"X": DenseRelation(("A",), ring, {"v": torch.ones(n, device=cuda_device)})}
    ex = SimpleNamespace(engine=SimpleNamespace(views=views), last_segment_stats=[],
                         stragglers=SimpleNamespace(baseline=None))
    server = ViewServer(ex, retain=1)
    keys = torch.arange(0, n, n // 512, dtype=torch.int32, device=cuda_device)[:, None]
    snap = server.registry.latest()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):  # warm the read's own allocations
        server.point("X", keys, snapshot=snap)
    # six cached blocks of the view's size: from here on no allocation of
    # that size calls cudaMalloc, which would wait for the whole device and
    # so order the read before the fills below
    warm = [torch.empty((n,), device=cuda_device) for _ in range(6)]
    del warm
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)  # the read waits behind this on its stream
        res = server.point("X", keys, snapshot=snap)
    g = snap.generation
    del snap
    server.registry.publish(views)  # evicts g on the producer's stream
    with pytest.raises(LookupError):
        server.registry.get(g)
    junk = [torch.full((n,), 7.0, device=cuda_device) for _ in range(6)]
    side.synchronize()
    assert torch.equal(res.data["v"].cpu(), torch.ones(keys.shape[0]))
    del junk


def test_cuda_reader_stays_live_across_a_recapture(cuda_device):
    """A reader thread on its own CUDA stream reads every view of each new
    generation under a pin while a growing stream runs as capacity segments
    (each rehash recompiles and captures its graphs anew, in thread-local
    capture mode): no error, and every generation it saw equals the CPU
    executor's state at that generation's offset, read the same way."""
    import threading
    import time

    from repro_torch.core import StreamExecutor
    from repro_torch.serve import ViewServer

    def served(dev):
        q, db, stream = _housing_sparse(dev, pool_extra=1024 - 128, batch=200)
        eng = IVMEngine.build(q, db, var_order=synth.housing_vo(), device=dev)
        return eng, stream

    eng, stream = served(cuda_device)
    ex = StreamExecutor(eng)
    server = ViewServer(ex, retain=64, segment_updates=3)
    keys = {n: (np.arange(0, 4096, 13)[:, None] if v.schema else np.zeros((8, 0)))
            .astype(np.int32) for n, v in eng.views.items()}

    def reads(src):
        return {n: _host((src.point(n, k).data, src.range_sum(n, 0, 1 << 30).data))
                for n, k in sorted(keys.items())}

    reads(server)
    seen, errors, stop = {}, [], threading.Event()

    def reader():
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                while not stop.is_set():
                    with server.pin() as p:
                        if p.generation not in seen:
                            seen[p.generation] = (p.offset, reads(p))
                    time.sleep(0.001)
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        ex.run(stream)
        torch.cuda.synchronize()
        deadline = time.time() + 30
        while server.registry.generation not in seen and time.time() < deadline:
            time.sleep(0.005)
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and not errors, errors
    stats = ex.last_segment_stats
    assert any(s["grow"] for s in stats)
    assert any(s["run"]["eager_steps"] for s in stats[1:])  # a recapture
    assert len(seen) >= 2 and max(off for off, _ in seen.values()) == len(stream)
    ex.release()
    for g, (offset, got) in sorted(seen.items()):
        ref, ref_stream = served("cpu")
        if offset:
            StreamExecutor(ref).run(ref_stream[:offset])
        _assert_host_equal(got, reads(ViewServer(StreamExecutor(ref))), f"generation {g}")


# ---------------------------------------------------------------------------
# The attention backward kernel and the training step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,T,D,causal", [
    (2, 4, 2, 100, 16, True), (2, 4, 4, 100, 16, False), (1, 4, 1, 65, 8, True),
    (1, 8, 2, 130, 32, False), (2, 8, 2, 257, 64, True), (1, 8, 8, 64, 64, False),
    (1, 8, 2, 257, 128, True), (1, 4, 1, 77, 128, False), (4, 8, 2, 1024, 64, True),
    (4, 8, 2, 1024, 64, False)])
def test_cuda_flash_bwd_matches_plain(cuda_device, B, H, Hkv, T, D, causal, dtype):
    """``flash_attention_bwd`` against its plain version in float64 on the
    same inputs (o from the forward kernel): dQ, dK and dV within 1e-5
    (float32) or 1e-2 (bf16: outputs rounded to bf16) of each one's largest
    magnitude; one launch a call of the route ``bwd_variant`` names (the
    tf32 route for float32 at D 64/128, the wgmma route for bf16 there, the
    SIMT route at D ≤ 32; two kernels each); a second call bitwise equal (no
    atomics).  The wgmma route is also held to its own plain version,
    ``flash_attention_bwd_bf16_ref``, within 1e-2."""
    from repro_torch.kernels import flash_attention as tflash

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(T + D + H)
    q, k, v, do = (torch.tensor(rng.standard_normal(s).astype(np.float32),
                                device=cuda_device).to(dt)
                   for s in ((B, H, T, D), (B, Hkv, T, D), (B, Hkv, T, D), (B, H, T, D)))
    o = tflash.flash_attention(q, k, v, causal=causal)
    kind = tflash.bwd_variant(dt, D)
    counts = {name: kern.launches for name, kern in tflash.BWD_KERNELS.items()}
    got = tflash.flash_attention_bwd(q, k, v, o, do, causal=causal)
    again = tflash.flash_attention_bwd(q, k, v, o, do, causal=causal)
    torch.cuda.synchronize()
    assert {name: kern.launches - counts[name] for name, kern in
            tflash.BWD_KERNELS.items()} == {name: 2 * (name == kind) for name in counts}
    wants = [ref.flash_attention_bwd_ref(*(t.double() for t in (q, k, v, o, do)),
                                         causal=causal)]
    if kind == "wgmma":
        wants.append(ref.flash_attention_bwd_bf16_ref(q, k, v, o, do, causal=causal))
    rtol = 1e-5 if dt == torch.float32 else 1e-2
    for want in wants:
        for g, a, w, inp in zip(got, again, want, (q, k, v)):
            assert g.dtype == dt and g.shape == inp.shape
            assert torch.equal(g, a)
            assert float((g.double() - w.double()).abs().max()) <= rtol * float(
                w.abs().max())


def test_cuda_flash_bwd_rejects_what_it_does_not_take(cuda_device):
    """The wrapper raises on shapes, dtypes and devices the kernel does not
    take, and a launch the C entry refuses (causal with T != Tk) raises."""
    from repro_torch.kernels import flash_attention as tflash

    def t(*shape, dtype=torch.float32, device=cuda_device):
        return torch.zeros(shape, dtype=dtype, device=device)

    q, k = t(1, 2, 8, 16), t(1, 1, 8, 16)
    with pytest.raises(ValueError, match="head dim"):
        tflash.flash_attention_bwd(t(1, 2, 8, 48), t(1, 1, 8, 48), t(1, 1, 8, 48),
                                   t(1, 2, 8, 48), t(1, 2, 8, 48))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        h = torch.float16
        tflash.flash_attention_bwd(t(1, 2, 8, 16, dtype=h), t(1, 1, 8, 16, dtype=h),
                                   t(1, 1, 8, 16, dtype=h), t(1, 2, 8, 16, dtype=h),
                                   t(1, 2, 8, 16, dtype=h))
    with pytest.raises(ValueError, match="do is"):
        tflash.flash_attention_bwd(q, k, k, q, t(1, 2, 8, 16, device="cpu"))
    with pytest.raises(ValueError, match="T == Tk"):
        tflash.flash_attention_bwd(t(1, 2, 4, 16), k, k, t(1, 2, 4, 16), t(1, 2, 4, 16))
    lse = t(1, 2, 4)
    with pytest.raises(RuntimeError, match="repro_flash_attention_bwd failed"):
        q4 = t(1, 2, 4, 16)
        tflash.FLASH_ATTENTION_BWD.launch(
            q4.data_ptr(), k.data_ptr(), k.data_ptr(), q4.data_ptr(), q4.data_ptr(),
            q4.data_ptr(), k.data_ptr(), k.data_ptr(), lse.data_ptr(), lse.data_ptr(),
            1, 2, 1, 4, 8, 16, 16, 0, 1, 0, 0)
    lse = t(2, tflash.BWD_ROWS)
    with pytest.raises(RuntimeError, match="repro_flash_attention_bwd_wgmma failed"):
        q4, k8 = t(1, 2, 4, 64, dtype=torch.bfloat16), t(1, 1, 8, 64, dtype=torch.bfloat16)
        tflash.FLASH_ATTENTION_BWD_WGMMA.launch(
            q4.data_ptr(), k8.data_ptr(), k8.data_ptr(), q4.data_ptr(), q4.data_ptr(),
            q4.data_ptr(), k8.data_ptr(), k8.data_ptr(), lse.data_ptr(), lse.data_ptr(),
            1, 2, 1, 4, 8, 64, 64, 1, 0, 0)
    with pytest.raises(RuntimeError, match="repro_flash_attention_bwd_tf32 failed"):
        q4, k8 = t(1, 2, 4, 64), t(1, 1, 8, 64)
        tflash.FLASH_ATTENTION_BWD_TF32.launch(
            q4.data_ptr(), k8.data_ptr(), k8.data_ptr(), q4.data_ptr(), q4.data_ptr(),
            q4.data_ptr(), k8.data_ptr(), k8.data_ptr(), lse.data_ptr(), lse.data_ptr(),
            1, 2, 1, 4, 8, 64, 64, 1, 0, 0)


@pytest.mark.parametrize("D", [16, 64])
def test_cuda_model_attention_gradient_takes_the_backward_kernel(cuda_device, D):
    """With a gradient asked for, ``models.attention.flash_attention`` on
    CUDA tensors is ``FlashAttentionFn``: the forward kernel once, the
    backward route ``bwd_variant`` names once (float32: SIMT at D 16, tf32
    at D 64), the gradients those of ``flash_attention_bwd`` (given the
    forward's L where ``lse_route`` holds: tf32 at D 64); without one
    (serving) it is the plain launch."""
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.models import attention

    rng = np.random.default_rng(D)
    q, k, v, do = (torch.tensor(rng.standard_normal(s).astype(np.float32),
                                device=cuda_device)
                   for s in ((2, 4, 70, D), (2, 2, 70, D), (2, 2, 70, D), (2, 4, 70, D)))
    with torch.no_grad():
        assert attention.flash_attention(q, k, v).grad_fn is None
    qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
    fwd = tflash.KERNELS[tflash.variant(torch.float32, D)]
    bwd = tflash.BWD_KERNELS[tflash.bwd_variant(torch.float32, D)]
    n_f, n_b = fwd.launches, bwd.launches
    o = attention.flash_attention(qs, ks, vs)
    assert type(o.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad(o, (qs, ks, vs), do)
    assert (fwd.launches - n_f, bwd.launches - n_b) == (1, 1)
    lse = None
    if tflash.lse_route(torch.float32, D):
        lse = tflash.flash_attention(q, k, v, return_lse=True)[1]
    want = tflash.flash_attention_bwd(q, k, v, o.detach(), do, lse=lse)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cuda_flash_bwd_tf32_spills_nothing(cuda_device):
    """``tools/sass_report.py`` on ``flash_attention_bwd_tf32.cu``: the dq
    kernel at D 64 and 128 (with and without the forward's L) and (192,
    128) and the dkdv kernel at D 64 and 128 store and load nothing in local
    memory (no register spills); the
    (192, 128) dkdv kernel, ``flash_bwd_dkdv_tf32_mla_kernel``, is
    ``test_cuda_flash_bwd_mla_instances_spill_nothing``'s."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, str(root / "tools" / "sass_report.py"),
                          "flash_attention_bwd_tf32.cu"], capture_output=True, text=True,
                         check=True).stdout
    rows = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    for kernel, n in (("flash_bwd_dq_tf32_kernel", 5), ("flash_bwd_dkdv_tf32_kernel", 2)):
        mine = [r for r in rows if kernel in r["function"]]
        assert len(mine) == n, (kernel, rows)
        for r in mine:
            assert (r["local_stores"], r["local_loads"]) == (0, 0), r


@pytest.mark.parametrize("B,H,Hkv,T,D,Dv,causal,dtype", [
    (1, 4, 2, 130, 192, 128, True, "bfloat16"), (2, 4, 4, 256, 192, 128, False, "bfloat16"),
    (1, 4, 2, 130, 192, 128, True, "float32"), (2, 4, 4, 256, 192, 128, False, "float32"),
    (2, 4, 4, 64, 16, 8, True, "float32"), (1, 4, 2, 100, 16, 8, False, "float32"),
    (2, 4, 4, 64, 16, 8, True, "bfloat16"), (1, 4, 2, 100, 16, 8, False, "bfloat16")])
def test_cuda_flash_bwd_at_mla_pairs_matches_plain(cuda_device, B, H, Hkv, T, D, Dv, causal,
                                                  dtype):
    """``flash_attention_bwd`` at MLA's head-dim pairs (q and k of D
    columns, v, o and dO of Dv): the wgmma route (bf16 at (192, 128)), the
    tf32 route (float32 there) and the SIMT route ((16, 8), every dtype),
    against the plain version in float64 on the same inputs within 1e-5
    (float32) or 1e-2 (bf16) of each output's largest magnitude, the wgmma
    route also against ``flash_attention_bwd_bf16_ref``; one launch a call
    of that route and no other; two calls bitwise equal."""
    from repro_torch.kernels import flash_attention as tflash

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(T + D + Dv + H)
    q, k, v, do = (torch.tensor(rng.standard_normal(s).astype(np.float32),
                                device=cuda_device).to(dt)
                   for s in ((B, H, T, D), (B, Hkv, T, D), (B, Hkv, T, Dv), (B, H, T, Dv)))
    o = tflash.flash_attention(q, k, v, causal=causal)
    kind = tflash.bwd_variant(dt, D, Dv)
    assert kind == ("simt" if D == 16 else "wgmma" if dt == torch.bfloat16 else "tf32")
    counts = {name: kern.launches for name, kern in tflash.BWD_KERNELS.items()}
    got = tflash.flash_attention_bwd(q, k, v, o, do, causal=causal)
    again = tflash.flash_attention_bwd(q, k, v, o, do, causal=causal)
    torch.cuda.synchronize()
    assert {name: kern.launches - counts[name] for name, kern in
            tflash.BWD_KERNELS.items()} == {name: 2 * (name == kind) for name in counts}
    wants = [ref.flash_attention_bwd_ref(*(t.double() for t in (q, k, v, o, do)),
                                         causal=causal)]
    if kind == "wgmma":
        wants.append(ref.flash_attention_bwd_bf16_ref(q, k, v, o, do, causal=causal))
    rtol = 1e-5 if dt == torch.float32 else 1e-2
    for want in wants:
        for g, a, w, inp in zip(got, again, want, (q, k, v)):
            assert g.dtype == dt and g.shape == inp.shape
            assert torch.equal(g, a)
            assert float((g.double() - w.double()).abs().max()) <= rtol * float(
                w.abs().max())


@pytest.mark.parametrize("D,Dv,dtype", [(192, 128, "bfloat16"), (192, 128, "float32"),
                                        (16, 8, "float32")])
def test_cuda_model_attention_gradient_at_mla_pairs(cuda_device, D, Dv, dtype):
    """With a gradient asked for at MLA's pairs, ``models.attention
    .flash_attention`` is ``FlashAttentionFn``: the forward kernel once and
    the backward route ``bwd_variant`` names once, the gradients those of
    ``flash_attention_bwd`` bitwise, given the forward's L where
    ``lse_route`` holds (bf16 at (192, 128))."""
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.models import attention

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(D + Dv)
    q, k, v, do = (torch.tensor(rng.standard_normal(s).astype(np.float32),
                                device=cuda_device).to(dt)
                   for s in ((2, 4, 70, D), (2, 2, 70, D), (2, 2, 70, Dv), (2, 4, 70, Dv)))
    qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
    fwd = tflash.KERNELS[tflash.variant(dt, D, Dv)]
    bwd = tflash.BWD_KERNELS[tflash.bwd_variant(dt, D, Dv)]
    n_f, n_b = fwd.launches, bwd.launches
    o = attention.flash_attention(qs, ks, vs)
    assert type(o.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad(o, (qs, ks, vs), do)
    assert (fwd.launches - n_f, bwd.launches - n_b) == (1, 1)
    lse = None
    if tflash.lse_route(dt, D, Dv):
        lse = tflash.flash_attention(q, k, v, return_lse=True)[1]
    want = tflash.flash_attention_bwd(q, k, v, o.detach(), do, lse=lse)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.shape == x.shape and torch.equal(g, w)


@pytest.mark.parametrize("B,H,Hkv,T,causal", [(1, 4, 2, 130, True), (2, 4, 4, 256, False),
                                               (1, 8, 8, 1024, True)])
def test_cuda_flash_bwd_mla_with_lse_matches_float64(cuda_device, B, H, Hkv, T, causal):
    """bf16 at (192, 128): the forward with L (``return_lse``) gives the same
    o bitwise as without it and L within 1e-6 of the plain version's
    largest magnitude (sums in another order); ``flash_attention_bwd``
    given that L and without it are each within 1e-2 of each output's
    largest magnitude of the float64 plain version and of
    ``flash_attention_bwd_bf16_ref``, bitwise on a repeat, one wgmma
    forward and one wgmma backward launch a call."""
    from repro_torch.kernels import flash_attention as tflash

    rng = np.random.default_rng(T + H)
    q, k, v, do = (torch.tensor(rng.standard_normal(s).astype(np.float32),
                                device=cuda_device).to(torch.bfloat16)
                   for s in ((B, H, T, 192), (B, Hkv, T, 192), (B, Hkv, T, 128),
                             (B, H, T, 128)))
    fwd, bwd = tflash.FLASH_ATTENTION_WGMMA, tflash.FLASH_ATTENTION_BWD_WGMMA
    n_f = fwd.launches
    o = tflash.flash_attention(q, k, v, causal)
    o2, lse = tflash.flash_attention(q, k, v, causal, return_lse=True)
    torch.cuda.synchronize()
    assert fwd.launches - n_f == 2
    assert torch.equal(o, o2)
    rows = -(-T // tflash.BWD_ROWS) * tflash.BWD_ROWS
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (B, H, rows)
    assert bool(torch.isfinite(lse).all())
    want_lse = ref.flash_attention_lse_ref(q, k, v, causal=causal)
    assert float((lse[..., :T].cpu() - want_lse.cpu()).abs().max()) <= 1e-6 * float(
        want_lse.abs().max())
    wants = (ref.flash_attention_bwd_ref(*(t.double() for t in (q, k, v, o, do)),
                                         causal=causal),
             ref.flash_attention_bwd_bf16_ref(q, k, v, o, do, causal=causal))
    for given in (lse, None):
        n_b = bwd.launches
        got = tflash.flash_attention_bwd(q, k, v, o, do, causal, lse=given)
        again = tflash.flash_attention_bwd(q, k, v, o, do, causal, lse=given)
        torch.cuda.synchronize()
        assert bwd.launches - n_b == 2
        for want in wants:
            for g, a, w in zip(got, again, want):
                assert torch.equal(g, a)
                assert float((g.double() - w.double()).abs().max()) <= 1e-2 * float(
                    w.abs().max())


def test_cuda_flash_bwd_mla_instances_spill_nothing(cuda_device):
    """``tools/sass_report.py`` on the backward sources: the wgmma route's
    dq kernels at (192, 128) (with and without the forward's L) and its dkdv
    kernels there (split by product; without and with the prefix-LM mask),
    the tf32 route's dq kernel there and
    its ``flash_bwd_dkdv_tf32_mla_kernel``, and the SIMT route's float32 dq
    and dkdv kernels at (16, 8) store and load nothing in local memory.
    The SIMT route's bf16 instances at (16, 8) are left out: ptxas keeps 4
    bytes of the bf16 dkdv kernel in local memory (one store, two loads,
    at 80 of the 255 registers it may use), a choice of its own that it
    makes for the bf16 (8, 8) dq kernel too (12 bytes); their time is
    measured in ``chip_smoke.py``'s G rows."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, str(root / "tools" / "sass_report.py"),
                          "flash_attention_bwd_wgmma.cu", "flash_attention_bwd_tf32.cu",
                          "flash_attention_bwd.cu"], capture_output=True, text=True,
                         check=True).stdout
    rows = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    wanted = (("flash_bwd_dq_wgmma_kernelILi192ELi128E", 2),
              ("flash_bwd_dkdv_wgmma_kernelILi192ELi128E", 2),
              ("flash_bwd_dq_tf32_kernelILi192ELi128E", 1),
              ("flash_bwd_dkdv_tf32_mla_kernelILi192ELi128E", 1),
              ("flash_bwd_dq_kernelIfLi16ELi8E", 1), ("flash_bwd_dkdv_kernelIfLi16ELi8E", 1))
    for kernel, n in wanted:
        mine = [r for r in rows if kernel in r["function"]]
        assert len(mine) == n, (kernel, rows)
        for r in mine:
            assert (r["local_stores"], r["local_loads"]) == (0, 0), r


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,H,Hkv,T,D,causal", [
    (1, 4, 2, 130, 64, True), (2, 4, 4, 100, 64, False), (1, 8, 2, 257, 128, True),
    (1, 4, 1, 77, 128, False), (4, 32, 8, 1024, 64, True), (4, 16, 16, 1024, 128, True)])
def test_cuda_flash_bwd_with_lse_at_d64_d128_matches_float64(cuda_device, B, H, Hkv, T, D,
                                                            causal, dtype):
    """At (64, 64) and (128, 128), both routes: the forward with L
    (``return_lse``) gives the same o bitwise as without it and L within
    1e-6 of the plain version's largest magnitude; ``flash_attention_bwd``
    given that L is within 1e-2 (bf16) or 1e-5 (float32) of each output's
    largest magnitude of the float64 plain version, the bf16 route also of
    ``flash_attention_bwd_bf16_ref``; two calls bitwise equal; one forward
    launch a call and one backward launch a call of the dtype's route."""
    from repro_torch.kernels import flash_attention as tflash

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(T + D + H)
    q, k, v, do = (torch.tensor(rng.standard_normal(s).astype(np.float32),
                                device=cuda_device).to(dt)
                   for s in ((B, H, T, D), (B, Hkv, T, D), (B, Hkv, T, D), (B, H, T, D)))
    assert tflash.lse_route(dt, D)
    fwd = tflash.KERNELS[tflash.variant(dt, D)]
    bwd = tflash.BWD_KERNELS[tflash.bwd_variant(dt, D)]
    n_f = fwd.launches
    o = tflash.flash_attention(q, k, v, causal)
    o2, lse = tflash.flash_attention(q, k, v, causal, return_lse=True)
    torch.cuda.synchronize()
    assert fwd.launches - n_f == 2
    assert torch.equal(o, o2)
    rows = -(-T // tflash.BWD_ROWS) * tflash.BWD_ROWS
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (B, H, rows)
    want_lse = ref.flash_attention_lse_ref(q, k, v, causal=causal)
    assert float((lse[..., :T].cpu() - want_lse.cpu()).abs().max()) <= 1e-6 * float(
        want_lse.abs().max())
    wants = [ref.flash_attention_bwd_ref(*(t.double() for t in (q, k, v, o, do)),
                                         causal=causal)]
    if dt == torch.bfloat16:
        wants.append(ref.flash_attention_bwd_bf16_ref(q, k, v, o, do, causal=causal))
    n_b = bwd.launches
    got = tflash.flash_attention_bwd(q, k, v, o, do, causal, lse=lse)
    again = tflash.flash_attention_bwd(q, k, v, o, do, causal, lse=lse)
    torch.cuda.synchronize()
    assert bwd.launches - n_b == 2
    rtol = 1e-5 if dt == torch.float32 else 1e-2
    for want in wants:
        for g, a, w, inp in zip(got, again, want, (q, k, v)):
            assert g.dtype == dt and g.shape == inp.shape
            assert torch.equal(g, a)
            assert float((g.double() - w.double()).abs().max()) <= rtol * float(
                w.abs().max())


def test_cuda_flash_d64_d128_instances_spill_nothing(cuda_device):
    """``tools/sass_report.py`` on the four tensor-core flash sources, at
    (64, 64) and (128, 128): the wgmma route's dq kernels given L and its
    dkdv kernels without and with the prefix-LM mask (the D 128 ones split
    by product), and the tf32 route's dq
    kernels given L, store and load nothing in local memory; the forwards
    that write L (wgmma and tf32) keep in local memory what their no-L
    instances keep, no more (the bf16 forward at D 128 keeps 10 words there
    with L and without it, as the parent's build does)."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, str(root / "tools" / "sass_report.py"),
                          "flash_attention_wgmma.cu", "flash_attention_tf32.cu",
                          "flash_attention_bwd_wgmma.cu", "flash_attention_bwd_tf32.cu"],
                         capture_output=True, text=True, check=True).stdout
    rows = [json.loads(line) for line in out.splitlines() if line.startswith("{")]

    def local(kernel):
        mine = [r for r in rows if kernel in r["function"]]
        assert len(mine) == 1, (kernel, rows)
        return mine[0]["local_stores"], mine[0]["local_loads"]

    for d in (64, 128):
        for kernel in (f"flash_bwd_dq_wgmma_kernelILi{d}ELi{d}ELb1E",
                       f"flash_bwd_dkdv_wgmma_kernelILi{d}ELi{d}ELb0E",
                       f"flash_bwd_dkdv_wgmma_kernelILi{d}ELi{d}ELb1E",
                       f"flash_bwd_dq_tf32_kernelILi{d}ELi{d}ELb1E"):
            assert local(kernel) == (0, 0), kernel
        for kernel in ("flash_attention_wgmma_kernel", "flash_attention_tf32_kernel"):
            assert local(f"{kernel}ILi{d}ELi{d}ELb1E") == local(f"{kernel}ILi{d}ELi{d}ELb0E"), (
                kernel, d)


def test_cuda_deepseek_reduced_train_step_matches_cpu(cuda_device):
    """One ``make_train_step`` of the reduced deepseek (MLA (16, 8): the mma
    forward and the SIMT backward; MoE, capacity factor 4.0, nothing drops;
    the MTP head; remat ``full``; 2 microbatches, float32 accumulators) on
    the card against the same step on the CPU from the same parameters and
    batch, within ``test_cuda_train_step_matches_cpu``'s limits; the
    backward launches (2 layers + the MTP block) × 2 microbatches times.
    The router is float32 on both devices, and a near-tie between the k-th
    and (k + 1)-th expert could route a token differently: the check
    asserts that the two runs' routings agree before comparing."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.data import lm_data
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.launch import train
    from repro_torch.models import moe, registry
    from repro_torch.optim import optimizers

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("deepseek_v3_671b").reduced()
    api = registry.build(cfg)
    batch = lm_data._batch_for_step(cfg, ShapeSpec("t", 64, 4, "train"), 0, 0, "cpu")
    opt = optimizers.sgd(0.1, momentum=0.9)
    plan = train.TrainPlan(2, torch.float32)
    route, results = moe.moe_route, []
    for dev in ("cpu", cuda_device):
        experts = []

        def recorded(cfg_, router, x):
            experts.append(route(cfg_, router, x))
            return experts[-1]

        params = api.init(seed=0, device="cpu")
        params = pytree.tree_map(lambda t: t.to(dev), params)
        n = tflash.FLASH_ATTENTION_BWD.launches
        moe.moe_route = recorded
        try:
            new, state, metrics = train.make_train_step(cfg, api, opt, plan)(
                params, opt.init(params), batch)
        finally:
            moe.moe_route = route
        torch.cuda.synchronize()
        launched = tflash.FLASH_ATTENTION_BWD.launches - n
        results.append((float(metrics["loss"]), new, state["mu"], launched,
                        [r.experts.cpu() for r in experts]))
    (l_cpu, p_cpu, g_cpu, n_cpu, e_cpu), (l_gpu, p_gpu, g_gpu, n_gpu, e_gpu) = results
    assert all(torch.equal(a, b) for a, b in zip(e_cpu, e_gpu))
    assert (n_cpu, n_gpu) == (0, (cfg.n_layers + 1) * plan.n_microbatches)
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    for rtol, a, b in ((1e-4, g_cpu, g_gpu), (1e-5, p_cpu, p_gpu)):
        for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)):
            assert float((y.cpu() - x).abs().max()) <= rtol * float(x.abs().max())


def test_cuda_model_attention_gradient_bf16_takes_the_wgmma_backward(cuda_device):
    """The bf16 D 64 form of the test above: ``FlashAttentionFn`` launches
    the wgmma forward once and the wgmma backward once (the SIMT backward
    not at all), and its gradients are ``flash_attention_bwd``'s given the
    forward's L."""
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.models import attention

    rng = np.random.default_rng(64)
    q, k, v, do = (torch.tensor(rng.standard_normal(s).astype(np.float32),
                                device=cuda_device).to(torch.bfloat16)
                   for s in ((2, 4, 70, 64), (2, 2, 70, 64), (2, 2, 70, 64), (2, 4, 70, 64)))
    assert tflash.bwd_variant(torch.bfloat16, 64) == "wgmma"
    qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
    kernels = (tflash.FLASH_ATTENTION_WGMMA, tflash.FLASH_ATTENTION_BWD_WGMMA,
               tflash.FLASH_ATTENTION_BWD)
    before = [kern.launches for kern in kernels]
    o = attention.flash_attention(qs, ks, vs)
    assert type(o.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad(o, (qs, ks, vs), do)
    assert [kern.launches - n for kern, n in zip(kernels, before)] == [1, 1, 0]
    lse = tflash.flash_attention(q, k, v, return_lse=True)[1]
    want = tflash.flash_attention_bwd(q, k, v, o.detach(), do, lse=lse)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cuda_train_step_matches_cpu(cuda_device):
    """One ``make_train_step`` of the reduced llama3.2-1b (the mma forward
    and the backward kernel, remat ``full``, 2 microbatches) on the card
    against the same step on the CPU, from the same parameters and batch,
    within chip_smoke.py E2's limits: the loss 1e-5 relative, every
    gradient leaf 1e-4 and every parameter after the update 1e-5 of its
    largest magnitude.  SGD with momentum: AdamW's first step is nearly
    sign(g)·lr, which turns gradients within rounding of 0 into updates
    that differ by up to 2·lr."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.data import lm_data
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.launch import train
    from repro_torch.models import registry
    from repro_torch.optim import optimizers

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama3_2_1b").reduced()
    api = registry.build(cfg)
    batch = lm_data._batch_for_step(cfg, ShapeSpec("t", 64, 4, "train"), 0, 0, "cpu")
    opt = optimizers.sgd(0.1, momentum=0.9)
    plan = train.TrainPlan(2, torch.float32)
    results = []
    for dev in ("cpu", cuda_device):
        params = api.init(seed=0, device="cpu")
        params = pytree.tree_map(lambda t: t.to(dev), params)
        n = tflash.FLASH_ATTENTION_BWD.launches
        new, state, metrics = train.make_train_step(cfg, api, opt, plan)(
            params, opt.init(params), batch)
        torch.cuda.synchronize()
        launched = tflash.FLASH_ATTENTION_BWD.launches - n
        results.append((float(metrics["loss"]), new, state["mu"], launched))
    (l_cpu, p_cpu, g_cpu, n_cpu), (l_gpu, p_gpu, g_gpu, n_gpu) = results
    assert (n_cpu, n_gpu) == (0, cfg.n_layers * plan.n_microbatches)
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    for rtol, a, b in ((1e-4, g_cpu, g_gpu), (1e-5, p_cpu, p_gpu)):
        for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)):
            assert float((y.cpu() - x).abs().max()) <= rtol * float(x.abs().max())


def test_cuda_moe_layer_is_bitwise_repeatable_and_matches_cpu(cuda_device):
    """One MoE MLP of moonshot-v1-16b-a3b's routing shape (64 experts,
    top-6, 2 shared, capacity factor 1.25) at d 256, d_expert_ff 128, bf16,
    over 4,096 tokens (16 groups of 256, C = 32: slots drop), on the card:
    two calls, forward and backward, are bitwise equal in the output and in
    the gradients of x and of every weight (the dispatch has no float
    atomics), and the output equals the CPU's within 2⁻⁶ of its largest
    magnitude (bf16 GEMMs that round in another order move an element by
    a bf16 rounding, 2⁻⁹ of it, which the SwiGLU and the down projection
    carry on).  The router is drawn at a scale where each token's k-th and
    (k + 1)-th probabilities differ by at least 1e-4 of the k-th, so the
    card's and the CPU's float32 routers pick the same experts."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    base = get_config("moonshot_v1_16b_a3b")
    cfg = dataclasses.replace(base, d_model=256,
                              moe=dataclasses.replace(base.moe, d_expert_ff=128))
    rng = np.random.default_rng(0)
    params = {name: torch.tensor(rng.standard_normal(spec.shape, dtype=np.float32)
                                 * (1.0 if name == "router" else spec.shape[-2] ** -0.5))
              for name, spec in moe.moe_specs(cfg).items()}
    x = torch.tensor(rng.standard_normal((4096, cfg.d_model), dtype=np.float32))
    ct = torch.tensor(rng.standard_normal((4096, cfg.d_model), dtype=np.float32)).bfloat16()
    probs = moe.router_probs(params["router"].bfloat16(), x.bfloat16()).double()
    top = probs.topk(cfg.moe.top_k + 1, dim=-1).values
    assert float(((top[:, -2] - top[:, -1]) / top[:, -2]).min()) >= 1e-4

    def run(dev):
        p = {k: v.bfloat16().to(dev).requires_grad_() for k, v in params.items()}
        xs = x.bfloat16().to(dev).requires_grad_()
        y = moe.moe_apply(cfg, p, xs)
        names = sorted(p)
        grads = torch.autograd.grad(y, [p[n] for n in names] + [xs], ct.to(dev))
        return y.detach(), dict(zip(names + ["x"], grads))

    y1, g1 = run(cuda_device)
    y2, g2 = run(cuda_device)
    assert torch.equal(y1, y2)
    for name in g1:
        assert torch.equal(g1[name], g2[name]), name
    routing = moe.moe_route(cfg, params["router"].bfloat16().to(cuda_device),
                            x.bfloat16().to(cuda_device))
    assert (routing.groups, routing.capacity) == (16, 32)
    assert not bool(routing.kept.all())
    y_cpu, _ = run("cpu")
    err = float((y1.cpu().float() - y_cpu.float()).abs().max())
    assert err <= 2.0 ** -6 * float(y_cpu.float().abs().max()), err


# ---------------------------------------------------------------------------
# The encoder-decoder: cross-attention (non-causal, T ≠ Tk) on the card
# ---------------------------------------------------------------------------
#: (B, H, Hkv, T, Tk, D): seamless's decoder at its serving prompt against
#: 1024 encoder frames, and unaligned query and key lengths either way
CROSS_SHAPES = [(4, 16, 16, 128, 1024, 64), (1, 4, 2, 77, 300, 64), (1, 4, 4, 300, 77, 128)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,H,Hkv,T,Tk,D", CROSS_SHAPES)
def test_cuda_flash_cross_shapes_match_float64(cuda_device, B, H, Hkv, T, Tk, D, dtype):
    """The wgmma (bf16) and tf32 (float32) routes non-causal with a query
    length other than the key length, forward and backward, with and
    without L, against the plain version in float64: the forward within
    1e-5 of the largest output (float32) or one bf16 rounding of each
    element, its L within 1e-6, o bitwise the same with L asked for; the
    backward within E1's limits (1e-5 float32, 1e-2 bf16) of each output's
    largest magnitude, two calls bitwise equal, given L and without; one
    launch a call of the dtype's forward and backward kernels."""
    from repro_torch.kernels import flash_attention as tflash

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(T + Tk + D)
    q, k, v, do = (torch.tensor(rng.standard_normal(s).astype(np.float32),
                                device=cuda_device).to(dt)
                   for s in ((B, H, T, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D), (B, H, T, D)))
    fwd = tflash.KERNELS[tflash.variant(dt, D)]
    bwd = tflash.BWD_KERNELS[tflash.bwd_variant(dt, D)]
    n_f = fwd.launches
    o = tflash.flash_attention(q, k, v, False)
    o2, lse = tflash.flash_attention(q, k, v, False, return_lse=True)
    torch.cuda.synchronize()
    assert fwd.launches - n_f == 2
    assert torch.equal(o, o2)
    want = ref.flash_attention_ref(q.double(), k.double(), v.double(), causal=False)
    err = (o.double() - want).abs()
    scale = float(want.abs().max())
    if dt == torch.float32:
        assert float(err.max()) <= 1e-5 * scale
    else:
        assert bool((err <= 2.0 ** -8 * want.abs() + 1e-6 * scale).all())
    want_lse = ref.flash_attention_lse_ref(q, k, v, causal=False)
    assert float((lse[..., :T].cpu() - want_lse.cpu()).abs().max()) <= 1e-6 * float(
        want_lse.abs().max())
    wants = ref.flash_attention_bwd_ref(*(t.double() for t in (q, k, v, o, do)), causal=False)
    rtol = 1e-5 if dt == torch.float32 else 1e-2
    for given in (lse, None):
        n_b = bwd.launches
        got = tflash.flash_attention_bwd(q, k, v, o, do, False, lse=given)
        again = tflash.flash_attention_bwd(q, k, v, o, do, False, lse=given)
        torch.cuda.synchronize()
        assert bwd.launches - n_b == 2
        for g, a, w, inp in zip(got, again, wants, (q, k, v)):
            assert g.dtype == dt and g.shape == inp.shape
            assert torch.equal(g, a)
            assert float((g.double() - w).abs().max()) <= rtol * float(w.abs().max())


def test_cuda_seamless_reduced_prefill_and_decode_match_cpu(cuda_device):
    """The reduced seamless-m4t (2 encoder and 2 decoder layers, head dim
    16: the mma kernel in each encoder layer and in each decoder layer's
    self- and cross-attention, Tq 24 against Tk 16) on the card against
    the same weights and frames on the CPU: a prompt of 24, then 3 decode
    steps fed the same tokens; float32 logits and every cache leaf within
    1e-5 of their largest magnitude; 6 mma launches in the prefill, none in
    a decode step."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.models import layers, registry

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("seamless_m4t_large_v2").reduced()
    api = registry.build(cfg)
    params = api.init(seed=0, device="cpu")
    on_card = layers.map_tree(lambda t: t.to(cuda_device), params)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 27))
    frames = rng.standard_normal((2, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32)
    outs = []
    for p in (params, on_card):
        before = {name: kern.launches for name, kern in tflash.KERNELS.items()}
        logits, cache = api.prefill(p, {"tokens": toks[:, :24], "frames": frames}, 32)
        prefill = {name: kern.launches - before[name] for name, kern in tflash.KERNELS.items()}
        got = [logits]
        for pos in range(24, 27):
            logits, cache = api.decode_step(p, toks[:, pos], pos, cache)
            got.append(logits)
        total = {name: kern.launches - before[name] for name, kern in tflash.KERNELS.items()}
        outs.append(got + [cache[c] for c in ("k", "v", "xk", "xv")])
    assert prefill == total == {"wgmma": 0, "tf32": 0, "mma": 6}
    for a, b in zip(*outs):
        scale = float(a.abs().max())
        assert float((b.cpu() - a).abs().max()) <= 1e-5 * scale
