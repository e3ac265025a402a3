"""The port's optimizers, schedules and gradient compression ≡ the
reference's, on the CPU.

A random tree (numpy, seeded) of parameters and five steps of gradients
goes through both packages: ``sgd`` (plain and with momentum), ``adamw``
(with a bf16 leaf: upcast, updated and rounded back each step) and
``adafactor`` (factored and unfactored slots; also ``block_leading_axis``),
and the three learning-rate schedules, within 1e-6 of each leaf's largest
magnitude (float32 arithmetic of the same formulas; XLA and PyTorch round
the scalar coefficients and the means' sums alike or within an ulp).
PowerSGD compression (``compress_decompress``, ``compress_grads``,
``compression_ratio``, ``compressed_optimizer``) starts from the
reference's Q, carried across by ``convert.tree_from_numpy``; QR and the
products are float32 LAPACK/BLAS on both sides (1e-5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402

_torch_parity.cap_torch_threads()
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.optim import optimizers as roptim  # noqa: E402
from repro.optim import schedules as rsched  # noqa: E402
from repro.runtime import compression as rcomp  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.optim import optimizers, schedules  # noqa: E402
from repro_torch.runtime import compression  # noqa: E402

RTOL = 1e-6
STEPS = 5


def tree_np(seed: int, bf16: bool = False) -> dict:
    """Leaves of every kind the optimizers treat apart: a stacked [6, 160,
    130] matrix (factored, and more than 4 slices), a stacked [6, 130]
    leaf (unfactored), a [130, 200] matrix, a vector, a [1] leaf, a list
    node; optionally a bf16 leaf."""
    rng = np.random.default_rng(seed)
    out = {"layers": {"w": rng.standard_normal((6, 160, 130)).astype(np.float32),
                      "b": rng.standard_normal((6, 130)).astype(np.float32)},
           "head": rng.standard_normal((130, 200)).astype(np.float32),
           "norm": [rng.standard_normal(7).astype(np.float32),
                    rng.standard_normal(1).astype(np.float32)]}
    if bf16:
        out["emb"] = np.asarray(jnp.asarray(rng.standard_normal((64, 48)), jnp.bfloat16))
    return out


def grads_np(params, step: int) -> dict:
    rng = np.random.default_rng(100 + step)
    return jax.tree.map(lambda p: (0.1 * rng.standard_normal(p.shape)).astype(
        np.float32).astype(p.dtype), params)


def assert_trees_close(got, want, rtol=RTOL):
    got_leaves = jax.tree.leaves(convert.tree_to_numpy(got))
    want_leaves = jax.tree.leaves_with_path(want)
    assert len(got_leaves) == len(want_leaves)
    for g, (path, w) in zip(got_leaves, want_leaves):
        w = np.asarray(w).astype(np.float64)
        g = np.asarray(g).astype(np.float64)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        scale = float(np.abs(w).max()) or 1.0
        err = float(np.abs(g - w).max())
        assert err <= rtol * scale, (jax.tree_util.keystr(path), err, scale)


def run_both(make_ref, make_port, params, steps=STEPS):
    """``steps`` updates of both optimizers from ``params`` (numpy) on the
    same gradients; returns (ref params, ref state, port params, port
    state)."""
    ropt, opt = make_ref(), make_port()
    rp = jax.tree.map(jnp.asarray, params)
    rs = ropt.init(rp)
    tp = convert.tree_from_numpy(params, device="cpu")
    ts = opt.init(tp)
    for step in range(steps):
        g = grads_np(params, step)
        rp, rs = ropt.update(rp, rs, jax.tree.map(jnp.asarray, g))
        tp, ts = opt.update(tp, ts, convert.tree_from_numpy(g, device="cpu"))
    return rp, rs, tp, ts


def lr_cases():
    return {"constant": (1e-2, 1e-2),
            "warmup_cosine": (rsched.linear_warmup_cosine(3e-2, 2, 8),
                              schedules.linear_warmup_cosine(3e-2, 2, 8))}


@pytest.mark.parametrize("lr", ["constant", "warmup_cosine"])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_reference(momentum, lr):
    rlr, tlr = lr_cases()[lr]
    rp, rs, tp, ts = run_both(lambda: roptim.sgd(rlr, momentum=momentum),
                              lambda: optimizers.sgd(tlr, momentum=momentum),
                              tree_np(0))
    assert_trees_close(tp, rp)
    assert_trees_close(ts, rs)


@pytest.mark.parametrize("lr", ["constant", "warmup_cosine"])
def test_adamw_matches_reference_with_a_bf16_leaf(lr):
    rlr, tlr = lr_cases()[lr]
    params = tree_np(1, bf16=True)
    rp, rs, tp, ts = run_both(lambda: roptim.adamw(rlr), lambda: optimizers.adamw(tlr),
                              params)
    assert tp["emb"].dtype == torch.bfloat16 and ts["m"]["emb"].dtype == torch.float32
    assert int(ts["step"]) == STEPS and ts["step"].dtype == torch.int32
    # the bf16 leaf rounds once a step, as the reference's: equal bits
    np.testing.assert_array_equal(tp["emb"].float().numpy(),
                                  np.asarray(rp["emb"]).astype(np.float32))
    assert_trees_close(tp, rp)
    assert_trees_close(ts, rs)


@pytest.mark.parametrize("kw", [{}, {"weight_decay": 1e-2},
                                {"block_leading_axis": True}])
def test_adafactor_matches_reference(kw):
    rp, rs, tp, ts = run_both(lambda: roptim.adafactor(1e-2, **kw),
                              lambda: optimizers.adafactor(1e-2, **kw), tree_np(2))
    slot = ts["v"]["layers"]["w"]
    assert isinstance(slot, optimizers.FactoredSlot)
    assert slot.vr.shape == (6, 160) and slot.vc.shape == (6, 130)
    assert isinstance(ts["v"]["head"], optimizers.FactoredSlot)
    assert isinstance(ts["v"]["layers"]["b"], torch.Tensor)
    assert_trees_close(tp, rp)
    assert_trees_close(ts, rs)


def test_make_optimizer_names():
    for name in ("sgd", "adamw", "adafactor"):
        assert optimizers.make_optimizer(name, 1e-3).name == name
    with pytest.raises(ValueError):
        optimizers.make_optimizer("lion", 1e-3)


def test_global_norm_and_clip_match_reference():
    params = tree_np(3, bf16=True)
    want, wnorm = roptim.clip_by_global_norm(jax.tree.map(jnp.asarray, params), 1.0)
    got, norm = optimizers.clip_by_global_norm(convert.tree_from_numpy(params, "cpu"), 1.0)
    np.testing.assert_allclose(float(norm), float(wnorm), rtol=RTOL)
    np.testing.assert_allclose(float(optimizers.global_norm(
        convert.tree_from_numpy(params, "cpu"))), float(roptim.global_norm(
            jax.tree.map(jnp.asarray, params))), rtol=RTOL)
    assert_trees_close(got, want)


@pytest.mark.parametrize("name", ["constant", "cosine", "warmup_cosine"])
def test_schedules_match_reference(name):
    make = {"constant": lambda m: m.constant_schedule(3e-4),
            "cosine": lambda m: m.cosine_schedule(3e-4, 10, final_frac=0.2),
            "warmup_cosine": lambda m: m.linear_warmup_cosine(3e-4, 3, 12)}[name]
    rfn, tfn = make(rsched), make(schedules)
    for step in range(0, 15):
        got = tfn(torch.tensor(step, dtype=torch.int32))
        want = rfn(jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=0)


# ---------------------------------------------------------------------------
# PowerSGD compression
# ---------------------------------------------------------------------------
CCFG = dict(rank=4, min_size=4096, power_iters=1)


def test_compress_decompress_matches_reference():
    rng = np.random.default_rng(5)
    g = rng.standard_normal((96, 80)).astype(np.float32)
    err = (0.1 * rng.standard_normal((96, 80))).astype(np.float32)
    q = np.linalg.qr(rng.standard_normal((80, 4)))[0].astype(np.float32)
    for iters in (1, 2):
        rc, tc = rcomp.CompressionConfig(4, 1, iters), compression.CompressionConfig(4, 1, iters)
        want = rcomp.compress_decompress(jnp.asarray(g), jnp.asarray(err), jnp.asarray(q), rc)
        got = compression.compress_decompress(torch.tensor(g), torch.tensor(err),
                                              torch.tensor(q), tc)
        for a, b in zip(got, want):
            assert_trees_close(a, np.asarray(b), 1e-5)


def _comp_state_np(params):
    """The reference's initial compression state of ``params``, as numpy."""
    return jax.tree.map(np.asarray, rcomp.init_compression_state(
        jax.tree.map(jnp.asarray, params), rcomp.CompressionConfig(**CCFG)))


def test_init_compression_state_slots():
    params = tree_np(6)
    state = compression.init_compression_state(convert.tree_from_numpy(params, "cpu"),
                                               compression.CompressionConfig(**CCFG))
    ref = _comp_state_np(params)
    assert state["head"]["q"].shape == ref["head"]["q"].shape == (200, 4)
    torch.testing.assert_close(state["head"]["q"].T @ state["head"]["q"], torch.eye(4),
                               rtol=0, atol=1e-5)
    assert state["norm"] == [None, None] and state["layers"]["w"] is None
    assert ref["norm"] == [None, None] and ref["layers"]["w"] is None


def test_compress_grads_and_ratio_match_reference():
    params = tree_np(7)
    rc, tc = rcomp.CompressionConfig(**CCFG), compression.CompressionConfig(**CCFG)
    state_np = _comp_state_np(params)
    rstate = jax.tree.map(jnp.asarray, state_np)
    tstate = convert.tree_from_numpy(state_np, device="cpu")
    for step in range(3):
        g = grads_np(params, step)
        rg, rstate = rcomp.compress_grads(jax.tree.map(jnp.asarray, g), rstate, rc)
        tg, tstate = compression.compress_grads(convert.tree_from_numpy(g, "cpu"), tstate, tc)
        assert_trees_close(tg, rg, 1e-5)
        assert_trees_close(tstate, rstate, 1e-5)
    assert compression.compression_ratio(convert.tree_from_numpy(params, "cpu"), tc) == \
        pytest.approx(rcomp.compression_ratio(jax.tree.map(jnp.asarray, params), rc), rel=0)


def test_compressed_optimizer_matches_reference():
    params = tree_np(8)
    rc, tc = rcomp.CompressionConfig(**CCFG), compression.CompressionConfig(**CCFG)
    rp = jax.tree.map(jnp.asarray, params)
    ropt = rcomp.compressed_optimizer(roptim.adamw(1e-2), rp, rc)
    rs = ropt.init(rp)
    tp = convert.tree_from_numpy(params, "cpu")
    opt = compression.compressed_optimizer(optimizers.adamw(1e-2), tp, tc)
    assert opt.name == ropt.name == "adamw+powersgd4"
    ts = convert.tree_from_numpy(jax.tree.map(np.asarray, rs), device="cpu")
    assert set(opt.init(tp)) == {"base", "comp"}
    for step in range(3):
        g = grads_np(params, step)
        rp, rs = ropt.update(rp, rs, jax.tree.map(jnp.asarray, g))
        tp, ts = opt.update(tp, ts, convert.tree_from_numpy(g, "cpu"))
    assert_trees_close(tp, rp, 1e-5)
    assert_trees_close(ts["comp"], rs["comp"], 1e-5)


def test_state_carriers_round_trip():
    params = tree_np(9, bf16=True)
    opt = optimizers.adafactor(1e-2)
    state = opt.init(convert.tree_from_numpy(params, "cpu"))
    back = convert.tree_from_numpy(convert.tree_to_numpy(state), "cpu")
    assert isinstance(back["v"]["head"], optimizers.FactoredSlot)
    for a, b in zip(jax.tree.leaves(convert.tree_to_numpy(state)),
                    jax.tree.leaves(convert.tree_to_numpy(back))):
        np.testing.assert_array_equal(a, b)
    ref_state = jax.tree.map(np.asarray, roptim.adafactor(1e-2).init(
        jax.tree.map(jnp.asarray, params)))
    carried = convert.tree_from_numpy(ref_state, "cpu")
    assert isinstance(carried["v"]["head"], optimizers.FactoredSlot)
    assert list(carried) == ["step", "v"] and carried["step"].dtype == torch.int32
