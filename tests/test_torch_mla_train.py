"""MLA training in the port ≡ the reference's, on the CPU.

deepseek-v3-671b's attention takes q and k of one head dim and v of another
(its reduced config 16 → 8, the full one 192 → 128).  The same numpy inputs
go through both packages, the reference run as its own tests run it
(``JAX_PLATFORMS=cpu``, XLA).  Cases:

* the plain attention backward (``kernels.ref.flash_attention_bwd_ref``,
  what ``flash_attention_bwd`` takes on CPU tensors at float32) at (16, 8)
  and at (192, 128) with a few narrow heads, G 1 and 2, causal and not:
  against ``jax.vjp`` of ``flash_attention_jnp`` in float32, within 1e-5 of
  each output's largest magnitude (the same function, sums in another
  order), and against autograd of ``flash_attention_ref`` in float64, within
  1e-12;
* its bf16 form (``flash_attention_bwd_bf16_ref``, the wgmma route's plain
  version) at (192, 128): within 1e-2 of float64, and within 1e-2 plus the
  reference's own bf16 error of ``jax.vjp`` in bf16 (the reference rounds
  dP to bf16 before Δ is subtracted, so its own error is the larger one, as
  ``tests/test_torch_flash_bwd.py`` states);
* ``bwd_variant`` at MLA's pairs, the CPU wrapper taking the route's plain
  version, and refusals: pairs outside ``BWD_PAIRS``, o and dO of q's head
  dim, the SIMT route by name at (192, 128);
* the reduced deepseek's ``lm_loss`` (MoE, MTP head on and off) and every
  parameter's gradient against ``jax.value_and_grad`` of the reference's
  loss (the loss within 1e-5 relative, each gradient leaf within 1e-4 of
  its largest magnitude: ``tests/test_torch_train.py``'s LOSS_RTOL and
  GRAD_RTOL);
* one ``make_train_step`` at 1 and 2 microbatches against the reference's
  (SGD with momentum; parameters within 1e-5 and the accumulated gradient
  within 1e-4 of each leaf's largest magnitude), and ``remat="full"``
  bitwise equal to ``"none"``.

The reduced config's MoE (capacity factor 4.0) drops nothing, so routing is
the same function in both packages.
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
from repro.launch import train as rtrain  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import registry as rregistry  # noqa: E402
from repro.optim import optimizers as roptim  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import layers, registry  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

ARCH = "deepseek_v3_671b"
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
B, S = 2, 16

#: (B, H, Hkv, T, D, Dv, causal): the reduced config's pair at G 1 and 2,
#: and the full config's with two or four narrow heads; T never a multiple
#: of 64
BWD_SHAPES = [(2, 4, 4, 24, 16, 8, True), (2, 4, 4, 24, 16, 8, False),
              (1, 4, 2, 17, 16, 8, True), (1, 4, 2, 17, 16, 8, False),
              (1, 2, 2, 20, 192, 128, True), (1, 2, 2, 20, 192, 128, False),
              (1, 4, 2, 33, 192, 128, True), (1, 4, 2, 33, 192, 128, False)]


def _qkvo(seed, B_, H, Hkv, T, D, Dv, dtype):
    """q, k, v and dO as numpy arrays of ``dtype``."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in
            ((B_, H, T, D), (B_, Hkv, T, D), (B_, Hkv, T, Dv), (B_, H, T, Dv))]


def assert_rel(got, want, rtol, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


# ---------------------------------------------------------------------------
# The plain backward at Dv ≠ D
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B_,H,Hkv,T,D,Dv,causal", BWD_SHAPES)
def test_plain_backward_matches_jax_vjp(B_, H, Hkv, T, D, Dv, causal):
    q, k, v, do = _qkvo(1, B_, H, Hkv, T, D, Dv, np.float32)

    def f(q_, k_, v_):
        return rattn.flash_attention_jnp(q_, k_, v_, causal=causal)

    o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = ref.flash_attention_bwd_ref(*(torch.tensor(a) for a in (q, k, v, np.asarray(o),
                                                                  do)), causal=causal)
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.dtype == torch.float32 and g.shape == x.shape
        assert_rel(g, w, 1e-5, name)


@pytest.mark.parametrize("B_,H,Hkv,T,D,Dv,causal", BWD_SHAPES)
def test_plain_backward_matches_autograd_in_float64(B_, H, Hkv, T, D, Dv, causal):
    q, k, v, do = (torch.tensor(a, requires_grad=i < 3) for i, a in
                   enumerate(_qkvo(0, B_, H, Hkv, T, D, Dv, np.float64)))
    o = ref.flash_attention_ref(q, k, v, causal=causal)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(), do,
                                      causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float64
        assert_rel(g, w, 1e-12, name)


def _bf16_np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _err(got, want) -> float:
    """max |got − want| over max |want|."""
    got, want = got.double(), torch.as_tensor(np.asarray(want, np.float64))
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Hkv", [1, 2])
def test_bf16_plain_backward_at_192_128(Hkv, causal):
    """The wgmma route's plain version at (192, 128): within 1e-2 of
    float64, and within 1e-2 plus the reference's own error of the
    reference's bf16 ``jax.vjp``."""
    arrs = [_bf16_np(a) for a in _qkvo(3, 1, 2, Hkv, 40, 192, 128, np.float32)]
    qj, kj, vj, doj = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrs)

    def f(q_, k_, v_):
        return rattn.flash_attention_jnp(q_, k_, v_, causal=causal)

    o, vjp = jax.vjp(f, qj, kj, vj)
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(doj)]
    q, k, v, o_t, do = (torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
                        for a in (*arrs[:3], np.asarray(o.astype(jnp.float32)), arrs[3]))
    assert tflash.bwd_variant(torch.bfloat16, 192, 128) == "wgmma"
    got = tflash.flash_attention_bwd(q, k, v, o_t, do, causal=causal)
    exact = ref.flash_attention_bwd_ref(*(t.double() for t in (q, k, v, o_t, do)),
                                        causal=causal)
    for name, g, w, x, inp in zip(("dq", "dk", "dv"), got, want, exact, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == inp.shape
        ref_err, port_err = _err(torch.tensor(w), x), _err(g, x)
        assert _err(g, w) <= 1e-2 + ref_err, (
            f"{name}: port vs reference {_err(g, w):.3e}; reference vs float64 "
            f"{ref_err:.3e}; port vs float64 {port_err:.3e}")
        assert port_err <= 1e-2, (name, port_err)


# ---------------------------------------------------------------------------
# Routes and refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,D,Dv,want", [
    (torch.bfloat16, 192, 128, "wgmma"), (torch.float32, 192, 128, "tf32"),
    (torch.float32, 16, 8, "simt"), (torch.bfloat16, 16, 8, "simt")])
def test_bwd_variant_takes_mla_pairs(dtype, D, Dv, want):
    assert (D, Dv) in tflash.BWD_PAIRS
    assert tflash.bwd_variant(dtype, D, Dv) == want
    assert ((D, Dv) in tflash.SIMT_BWD_PAIRS) == (want == "simt")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,Dv", [(16, 8), (192, 128)])
def test_cpu_wrapper_takes_the_routes_plain_version_at_mla_pairs(dtype, D, Dv):
    q, k, v, do = (torch.tensor(a).to(dtype) for a in _qkvo(4, 1, 4, 2, 24, D, Dv,
                                                              np.float32))
    o = tflash.flash_attention(q, k, v)
    counts = [kern.launches for kern in tflash.BWD_KERNELS.values()]
    got = tflash.flash_attention_bwd(q, k, v, o, do)
    plain = tflash.BWD_PLAIN[tflash.bwd_variant(dtype, D, Dv)]
    for g, w, x in zip(got, plain(q, k, v, o, do), (q, k, v)):
        assert g.shape == x.shape and g.dtype == dtype
        assert torch.equal(g, w.to(dtype))
    assert [kern.launches for kern in tflash.BWD_KERNELS.values()] == counts


@pytest.mark.parametrize("D,Dv", [(64, 32), (192, 64), (128, 192), (16, 16 + 8)])
def test_backward_refuses_pairs_outside_bwd_pairs(D, Dv):
    q, k, v, do = (torch.tensor(a) for a in _qkvo(5, 1, 2, 2, 8, D, Dv, np.float32))
    assert (D, Dv) not in tflash.BWD_PAIRS
    with pytest.raises(ValueError, match=f"q/k {D}, v {Dv}"):
        tflash.flash_attention_bwd(q, k, v, do, do)


def test_backward_refuses_o_and_do_of_the_qk_head_dim():
    q, k, v, do = (torch.tensor(a) for a in _qkvo(6, 1, 2, 2, 8, 16, 8, np.float32))
    with pytest.raises(ValueError, match="expected"):
        tflash.flash_attention_bwd(q, k, v, q, q)


def test_simt_backward_by_name_refuses_192_128():
    q, k, v, do = (torch.tensor(a) for a in _qkvo(7, 1, 2, 2, 8, 192, 128, np.float32))
    with pytest.raises(ValueError, match="simt backward does not take"):
        tflash.bwd_launch("simt", q, k, v, do, do)
    with pytest.raises(ValueError, match="tf32 backward does not take"):
        tflash.bwd_launch("tf32", *(t.to(torch.bfloat16) for t in (q, k, v, do, do)))


# ---------------------------------------------------------------------------
# deepseek-v3-671b reduced: loss, gradients, train step
# ---------------------------------------------------------------------------
def numpy_params(specs, seed: int) -> dict:
    """A parameter tree of the spec tree's shapes drawn with numpy: norms
    1 + 0.1·N, biases 0.1·N, embeddings 0.02·N, matrices N / √fan_in."""
    rng = np.random.default_rng(seed)

    def leaf(spec):
        x = rng.standard_normal(spec.shape, dtype=np.float32)
        if spec.init == "ones":
            return 1.0 + 0.1 * x
        if spec.init == "zeros":
            return 0.1 * x
        if spec.init == "embed":
            return 0.02 * x
        shape = spec.shape[1:] if spec.axes[0] == "layers" else spec.shape
        fan_in = int(np.prod(shape[:-1])) if spec.axes[-1] == "embed" else shape[0]
        return x / np.float32(np.sqrt(fan_in))

    return layers.map_tree(leaf, specs)


def both(**replace):
    """(reference config, port config, numpy parameter tree) of the reduced
    deepseek with ``replace`` applied to both configs."""
    rcfg = dataclasses.replace(ref_config(ARCH).reduced(), **replace)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **replace)
    return rcfg, cfg, numpy_params(registry.build(cfg).specs, seed=len(ARCH))


def batch_np(cfg, seed=0) -> dict:
    """Tokens and labels [B, S] with a few labels −1 (masked)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    labels[1, -2:] = -1
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": labels}


def port_loss_and_grads(cfg, tree, batch):
    api = registry.build(cfg)
    params = convert.tree_from_numpy(tree, device="cpu")
    leaves, spec = pytree.tree_flatten(params)
    xs = [p.requires_grad_() for p in leaves]
    loss, metrics = api.loss(pytree.tree_unflatten(xs, spec), batch)
    grads = torch.autograd.grad(loss, xs)
    return loss, metrics, pytree.tree_unflatten(list(grads), spec)


def assert_trees_rel(got, want, rtol):
    """Every leaf of the port's tree within ``rtol`` of the largest
    magnitude of the reference's leaf at the same path."""
    want_leaves = jax.tree.leaves_with_path(want)
    got_leaves = jax.tree.leaves(convert.tree_to_numpy(got))
    assert len(got_leaves) == len(want_leaves)
    for g, (path, w) in zip(got_leaves, want_leaves):
        assert_rel(g, w, rtol, jax.tree_util.keystr(path))


@pytest.mark.parametrize("mtp", [False, True])
def test_deepseek_loss_and_grads_match_reference(mtp):
    rcfg, cfg, tree = both(mtp=mtp)
    assert (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim,
            cfg.mla.v_head_dim) == (16, 8)
    batch = batch_np(cfg)
    rapi = rregistry.build(rcfg)
    (r_loss, r_metrics), r_grads = jax.value_and_grad(
        lambda p: rapi.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jax.tree.map(jnp.asarray, tree))
    t_loss, t_metrics, t_grads = port_loss_and_grads(cfg, tree, batch)
    assert t_loss.dtype == torch.float32 and t_loss.shape == ()
    assert set(t_metrics) == set(r_metrics) == (
        {"loss", "tokens", "mtp_loss"} if mtp else {"loss", "tokens"})
    for k in r_metrics:
        assert_rel(t_metrics[k], r_metrics[k], LOSS_RTOL, k)
    assert_trees_rel(t_grads, r_grads, GRAD_RTOL)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_deepseek_train_step_matches_reference(n_micro):
    """One step of the reduced deepseek (MTP on) at 4 × 16 from the same
    parameters and batch, SGD with momentum (its ``mu`` is the accumulated
    gradient), as ``tests/test_torch_train.py`` holds granite-3-2b."""
    rcfg, cfg, tree = both(mtp=True)
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (4, S)).astype(np.int32)}
    ropt, opt = roptim.sgd(0.1, momentum=0.9), optimizers.sgd(0.1, momentum=0.9)
    rplan = rtrain.TrainPlan(n_microbatches=n_micro, accum_dtype=jnp.float32)
    plan = train.TrainPlan(n_microbatches=n_micro, accum_dtype=torch.float32)
    rp = jax.tree.map(jnp.asarray, tree)
    r_new, r_state, r_metrics = rtrain.make_train_step(
        rcfg, rregistry.build(rcfg), ropt, rplan)(
        rp, ropt.init(rp), {k: jnp.asarray(v) for k, v in batch.items()})
    params = convert.tree_from_numpy(tree, device="cpu")
    new, state, metrics = train.make_train_step(cfg, registry.build(cfg), opt, plan)(
        params, opt.init(params), batch)
    for k in ("loss", "grad_norm"):
        assert metrics[k].shape == () and metrics[k].dtype == torch.float32
        assert_rel(metrics[k], r_metrics[k], LOSS_RTOL, k)
    assert_trees_rel(new, r_new, LOSS_RTOL)
    assert_trees_rel(state["mu"], r_state["mu"], GRAD_RTOL)
    assert int(state["step"]) == int(r_state["step"]) == 1


def test_deepseek_remat_full_equals_none_bitwise():
    _, cfg, tree = both(mtp=True)
    batch = batch_np(cfg, seed=1)
    got = [port_loss_and_grads(dataclasses.replace(cfg, remat=remat), tree, batch)
           for remat in ("full", "none")]
    assert torch.equal(got[0][0], got[1][0])
    for a, b in zip(pytree.tree_leaves(got[0][2]), pytree.tree_leaves(got[1][2])):
        assert torch.equal(a, b)
