"""The port's MoE MLP (``repro_torch.models.moe``) ≡ the reference's
``repro.models.moe``, on the CPU.

The same numpy inputs go through both.  Cases (``CASES``):

* ``reduced`` — moonshot-v1-16b-a3b's reduced config (4 experts, top-2,
  1 shared expert, capacity factor 4.0: nothing drops), T = 64;
* ``routing_4096`` — moonshot's own routing shape (64 experts, top-6, 2
  shared, capacity factor 1.25) at narrow widths (d 64, f 32) over 4,096
  tokens: 16 groups of 256, C = 32 against a mean load of 24, so slots drop;
* ``routing_36`` and ``routing_37`` — T whose ``dispatch_groups`` is 12
  and 1 (a prime);
* ``decode`` — T = B = 4: 4 groups of one token, C = 8.

The reference's routing is read inside its own ``_dispatch_group`` (its
module's ``jax`` and ``jnp`` names wrapped for the call, so ``top_k``'s
indices, ``jnp.where``'s ``keep`` and the buffer's capacity are recorded),
vmapped over the groups as its ``moe_apply`` does.  The port's top-k
indices, keep mask and capacity must equal them.  The router weights are
drawn at a scale (``ROUTER_STD``) where consecutive probabilities among each
token's k + 1 largest differ by at least ``MARGIN`` of the larger one
(checked in float64): far above the ~1e-6 by which float32 logits of XLA and
of PyTorch may differ, so both packages pick the same experts in the same
order.

Tolerances: outputs within 1e-5 of their largest magnitude (float32, the
tolerance of ``tests/test_torch_lm.py``: the same function, its matmuls
summed in another order); gradients within 1e-4 of each leaf's largest
magnitude (``tests/test_torch_train.py``'s); ``moe_load_balance_loss``
within 1e-6 relative; bf16 within 2⁻⁶ of the largest magnitude (a bf16
rounding is 2⁻⁹ of a value; GEMMs that round their outputs to bf16 in
another order move an element by one rounding, which the SwiGLU and the
down projection carry on).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402

_torch_parity.cap_torch_threads()
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.models import registry as rregistry  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import layers, moe, registry  # noqa: E402

ARCH = "moonshot_v1_16b_a3b"
RTOL = 1e-5
GRAD_RTOL = 1e-4
BF16_RTOL = 2.0 ** -6
#: the router's standard deviation, and the least relative gap between
#: consecutive probabilities of a token's k + 1 largest that the cases need
ROUTER_STD = 0.5
MARGIN = 1e-5

#: name -> (reduced config?, T); the others at moonshot's routing shape
CASES = {"reduced": (True, 64), "routing_4096": (False, 4096), "routing_36": (False, 36),
         "routing_37": (False, 37), "decode": (False, 4)}


def configs(reduced: bool):
    """(reference config, port config): moonshot's reduced config, or its
    full routing (64 experts, top-6, 2 shared, capacity factor 1.25) at d 64
    and an expert width of 32."""
    pair = []
    for get in (ref_config, get_config):
        cfg = get(ARCH)
        if reduced:
            cfg = cfg.reduced()
        else:
            cfg = dataclasses.replace(cfg, d_model=64,
                                      moe=dataclasses.replace(cfg.moe, d_expert_ff=32))
        pair.append(cfg)
    return pair


def numpy_moe_params(cfg, seed: int) -> dict:
    """One MoE layer's parameters drawn with numpy: the router at
    ROUTER_STD, every other matrix N / √fan_in (its input width)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in sorted(moe.moe_specs(cfg).items()):
        x = rng.standard_normal(spec.shape, dtype=np.float32)
        scale = ROUTER_STD if name == "router" else 1.0 / np.sqrt(spec.shape[-2])
        out[name] = x * np.float32(scale)
    return out


def inputs(name: str, dtype=np.float32):
    reduced, T = CASES[name]
    rcfg, cfg = configs(reduced)
    p = numpy_moe_params(cfg, seed=T)
    x = np.random.default_rng(T + 1).standard_normal((T, cfg.d_model), dtype=np.float32)
    return rcfg, cfg, p, x


def _to_torch(p, dtype=torch.float32):
    return {k: torch.tensor(v).to(dtype) for k, v in p.items()}


def _to_jax(p, dtype=jnp.float32):
    return {k: jnp.asarray(v, dtype) for k, v in p.items()}


def assert_rel(got, want, rtol, what=""):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


class _Wrapped:
    """A module with some of its names replaced."""

    def __init__(self, module, **names):
        self._module, self._names = module, names

    def __getattr__(self, name):
        return self._names[name] if name in self._names else getattr(self._module, name)


def reference_routing(rcfg, p, x, monkeypatch):
    """(top_e [T, k], keep [G, t·k], C) of the reference's dispatch of x,
    recorded inside ``_dispatch_group`` vmapped over the groups."""
    T, d = x.shape
    G = rmoe.dispatch_groups(T)
    seen: dict = {}

    def top_k(probs, k):
        vals, idx = jax.lax.top_k(probs, k)
        seen["top_e"] = idx
        return vals, idx

    def where(cond, a, b):
        seen["keep"] = cond
        return jnp.where(cond, a, b)

    def zeros(shape, dtype):
        if len(shape) == 3:  # the expert buffers [E, C, d]
            seen["C"] = shape[1]
        return jnp.zeros(shape, dtype)

    monkeypatch.setattr(rmoe, "jax", _Wrapped(jax, lax=_Wrapped(jax.lax, top_k=top_k)))
    monkeypatch.setattr(rmoe, "jnp", _Wrapped(jnp, where=where, zeros=zeros))

    def group(xt):
        rmoe._dispatch_group(rcfg, _to_jax(p), xt)
        return seen["top_e"], seen["keep"]

    top_e, keep = jax.jit(jax.vmap(group))(jnp.asarray(x).reshape(G, T // G, d))
    monkeypatch.undo()
    return np.asarray(top_e).reshape(T, -1), np.asarray(keep), seen["C"]


def check_margin(cfg, p, x) -> None:
    """The precondition of the routing comparison: consecutive
    probabilities among each token's k + 1 largest (float64) differ by at
    least MARGIN of the larger."""
    logits = x.astype(np.float64) @ p["router"].astype(np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top = -np.sort(-probs, axis=-1)[:, :cfg.moe.top_k + 1]
    gap = float(((top[:, :-1] - top[:, 1:]) / top[:, :-1]).min())
    assert gap >= MARGIN, gap


@pytest.mark.parametrize("name", list(CASES))
def test_moe_apply_and_routing_match_reference(name, monkeypatch):
    rcfg, cfg, p, x = inputs(name)
    check_margin(cfg, p, x)
    T = x.shape[0]
    want = jax.jit(lambda p_, x_: rmoe.moe_apply(rcfg, p_, x_))(_to_jax(p), jnp.asarray(x))
    r_top_e, r_keep, r_C = reference_routing(rcfg, p, x, monkeypatch)

    tp, tx = _to_torch(p), torch.tensor(x)
    got = moe.moe_apply(cfg, tp, tx)
    assert got.dtype == torch.float32 and got.shape == (T, cfg.d_model)
    assert_rel(got, want, RTOL)

    routing = moe.moe_route(cfg, tp["router"], tx)
    k = cfg.moe.top_k
    G, t = routing.groups, T // routing.groups
    assert G == rmoe.dispatch_groups(T)
    assert routing.capacity == r_C
    top_e = moe.top_k(moe.router_probs(tp["router"], tx), k)[1]
    np.testing.assert_array_equal(top_e.numpy(), r_top_e)
    np.testing.assert_array_equal(routing.experts.numpy(), np.sort(r_top_e, axis=-1))
    # the reference's keep lists each group's slots sorted by (expert, token)
    order = np.argsort(routing.experts.reshape(G, t * k).numpy(), axis=-1, kind="stable")
    kept = np.take_along_axis(routing.kept.reshape(G, t * k).numpy(), order, axis=-1)
    np.testing.assert_array_equal(kept, r_keep)
    # the maps are inverse partial bijections, one buffer row a kept slot
    src, dst = routing.src.numpy(), routing.dst.numpy()
    n_rows = cfg.moe.n_experts * G * routing.capacity
    assert src.shape == (n_rows,) and dst.shape == (T * k,)
    filled = src < T * k
    np.testing.assert_array_equal(dst[src[filled]], np.flatnonzero(filled))
    assert int(filled.sum()) == int(r_keep.sum())
    dropped = int((~r_keep).sum())
    if name == "routing_4096":
        assert (routing.groups, routing.capacity) == (16, 32)
        assert dropped > 0
    if name == "reduced":
        assert dropped == 0


@pytest.mark.parametrize("name", ["reduced", "routing_4096"])
def test_moe_apply_gradient_matches_jax_grad(name):
    rcfg, cfg, p, x = inputs(name)
    check_margin(cfg, p, x)
    ct = np.random.default_rng(5).standard_normal(x.shape, dtype=np.float32)

    def ref_objective(p_, x_):
        return jnp.sum(rmoe.moe_apply(rcfg, p_, x_) * jnp.asarray(ct))

    r_gp, r_gx = jax.jit(jax.grad(ref_objective, argnums=(0, 1)))(_to_jax(p), jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in _to_torch(p).items()}
    tx = torch.tensor(x, requires_grad=True)
    y = moe.moe_apply(cfg, tp, tx)
    names = sorted(tp)
    grads = torch.autograd.grad(y, [tp[n] for n in names] + [tx], torch.tensor(ct))
    for n, g in zip(names, grads):
        assert_rel(g, r_gp[n], GRAD_RTOL, n)
    assert_rel(grads[-1], r_gx, GRAD_RTOL, "x")


def test_moe_apply_bf16_matches_reference():
    """bf16 parameters and activations through both (the rounding points:
    SiLU in float32 cast to bf16, the slot weights cast to bf16, each
    token's slots added one at a time in bf16)."""
    rcfg, cfg, p, x = inputs("routing_4096")
    want = jax.jit(lambda p_, x_: rmoe.moe_apply(rcfg, p_, x_))(
        _to_jax(p, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16))
    got = moe.moe_apply(cfg, _to_torch(p, torch.bfloat16), torch.tensor(x).bfloat16())
    assert got.dtype == torch.bfloat16
    assert_rel(got, want, BF16_RTOL)


@pytest.mark.parametrize("name", ["reduced", "routing_4096"])
def test_load_balance_loss_matches_reference(name):
    rcfg, cfg, p, x = inputs(name)
    want = float(rmoe.moe_load_balance_loss(rcfg, _to_jax(p), jnp.asarray(x)))
    got = moe.moe_load_balance_loss(cfg, _to_torch(p), torch.tensor(x))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= 1e-6 * abs(want)


def test_dispatch_groups_and_capacity():
    for T in (1, 4, 36, 37, 64, 1024, 4096, 4100):
        assert moe.dispatch_groups(T) == rmoe.dispatch_groups(T)
    # moonshot's shapes: a 4 × 1024 prefill, a 2 × 512 one, a decode of 4
    assert moe.capacity(256, 6, 64, 1.25) == 32
    assert moe.capacity(64, 6, 64, 1.25) == 8
    assert moe.capacity(1, 6, 64, 1.25) == 8


def test_top_k_breaks_ties_to_the_lower_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3, 0.1]])
    vals, idx = moe.top_k(probs, 4)
    r_vals, r_idx = jax.lax.top_k(jnp.asarray(probs.numpy()), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(r_vals))


@pytest.mark.parametrize("reduced", [False, True])
def test_parameter_counts_match_reference(reduced):
    """Spec trees only, nothing allocated."""
    rcfg, cfg = ref_config(ARCH), get_config(ARCH)
    if reduced:
        rcfg, cfg = rcfg.reduced(), cfg.reduced()
    rapi, api = rregistry.build(rcfg), registry.build(cfg)
    assert api.n_params() == rapi.n_params()
    assert api.n_active_params() == rapi.n_active_params()
    if not reduced:
        assert (api.n_params(), api.n_active_params()) == (28_888_467_456, 4_799_072_256)


def test_dense_active_params_are_all_params():
    api = registry.build(get_config("llama3_2_1b"))
    assert api.n_active_params() == api.n_params() == 1_236_338_688


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_draws_a_stacked_moe_leaf_at_the_reference_scale(dtype, monkeypatch):
    """``init_from_spec`` of moonshot's reduced MoE layer stacked over 6
    periods: each normal leaf at ``init_scale`` (1/√fan_in over the stacked
    shape; 0.01 for the router), in ``dtype``, and no float32 draw larger
    than one leading-axis slice or the draw limit (here cut to 4,096
    elements, so the expert leaves are drawn a period at a time)."""
    cfg = get_config(ARCH).reduced()
    specs = layers.stack_specs(moe.moe_specs(cfg), 6)
    draws = []
    randn = torch.randn

    def counted(*args, **kw):
        out = randn(*args, **kw)
        draws.append(out.numel())
        return out

    monkeypatch.setattr(layers, "INIT_DRAW_ELEMS", 4096)
    monkeypatch.setattr(torch, "randn", counted)
    tree = layers.init_from_spec(specs, torch.Generator().manual_seed(0), dtype)
    n_draws = len(draws)
    again = layers.init_from_spec(specs, torch.Generator().manual_seed(0), dtype)
    monkeypatch.undo()
    draws = draws[:n_draws]
    assert specs["w_gate"].shape == (6, 4, 64, 64)
    for name, spec in specs.items():
        t = tree[name]
        assert tuple(t.shape) == spec.shape and t.dtype == dtype
        want = layers.init_scale(spec)
        assert abs(float(t.float().std()) / want - 1.0) < 0.05, (name, want)
    assert layers.init_scale(specs["router"]) == 0.01
    assert layers.init_scale(specs["w_gate"]) == 1 / np.sqrt(6 * 4 * 64)
    slice_max = max(int(np.prod(s.shape[1:])) for s in specs.values())
    assert max(draws) <= max(4096, slice_max)
    assert draws.count(4 * 64 * 64) == 18   # w_gate, w_up, w_down: one a period
    assert all(torch.equal(again[n], tree[n]) for n in specs)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_combine_adds_in_the_reference_order(dtype):
    """Each token's weighted slots, added by ``moe.combine`` in ascending
    expert order, equal the reference's scatter-add into zeros in its
    sorted-slot order (``.at[sorted_tok].add``), bitwise: slot values of
    magnitudes spread over 2¹⁶, so that another order rounds otherwise."""
    _, cfg, p, x = inputs("routing_4096")
    routing = moe.moe_route(cfg, torch.tensor(p["router"]), torch.tensor(x))
    T, k, d = x.shape[0], cfg.moe.top_k, 16
    rng = np.random.default_rng(3)
    y = (rng.standard_normal((T, k, d)) * 2.0 ** rng.integers(-8, 8, (T, k, d)))
    y = torch.tensor(y, dtype=torch.float32).to(dtype)
    got = moe.combine(y)
    # the reference's order: each group's slots sorted by (expert, token)
    G, t = routing.groups, T // routing.groups
    flat_e = routing.experts.reshape(G, t * k).numpy()
    order = np.argsort(flat_e, axis=-1, kind="stable")
    slot = (np.arange(G)[:, None] * t * k + order).reshape(-1)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    y_sorted = jnp.asarray(y.float().numpy().reshape(T * k, d)[slot], jdt)
    want = jnp.zeros((T, d), jdt).at[jnp.asarray(slot // k)].add(y_sorted)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    # and the sum in another order differs: the test can see the order
    other = y[:, -1]
    for r in range(k - 2, -1, -1):
        other = other + y[:, r]
    assert not torch.equal(other, got)
