"""The port's VLM ≡ the reference's, on the CPU: paligemma-3b (a stub vision
front-end's patch embeddings times ``vision_proj`` in front of the text,
the prefix-LM mask, loss and logits on the text positions only, decode
from position P + T).

The reduced config (2 layers, d_model 64, 4 heads over 1 KV head of 16, 16
patches, vocab 256 padded to 512), float32, parameters drawn with numpy in
the reference's layout (every norm perturbed) and carried into both
packages with ``convert.tree_from_numpy``; the reference's functions are
jitted on the CPU.

* ``lm_specs`` and ``n_params`` of the full and reduced configs
  (2,513,512,448 and 106,816).
* ``attention.flash_attention`` with ``prefix_len`` against the reference's
  ``flash_attention_jnp`` on both CPU branches (plain at S 40 with P 16,
  chunked at (1, 2, 1, 2048, 16) with P 256), and the kernels' plain
  versions (``ref.flash_attention_ref``, the wrapper's CPU path and the
  SIMT route's plain backward against ``jax.vjp``), within 1e-6 of the
  largest magnitude (the backward 1e-5); the refusals: a prefix with
  ``causal=False`` or T ≠ Tk (``ValueError``).
* The tensor-core routes' plain backwards with a prefix, at (256, 256) and
  D 64 in both dtypes, and ``FlashAttentionFn``'s gradient at (256, 256),
  against ``jax.vjp`` (float32 within 1e-5; bf16, whose route rounds P and
  dS and its outputs to bf16, within 1e-2, the card's gate); ``BWD_PAIRS``
  is ``PAIRS`` and the SIMT route refuses D 256 (``ValueError``).
* A narrow config of paligemma-3b's shape at head dim 256 (2 layers, 2
  query heads over 1 KV head, the 256-patch prefix, the reduced vocab):
  ``lm_loss`` and its gradient against ``jax.value_and_grad``, and a
  2-microbatch ``make_train_step`` against the reference's.
* ``lm_loss`` within 1e-5 and its gradient within 1e-4 of each leaf's
  largest magnitude, against ``jax.value_and_grad``, some labels < 0.
* ``lm_prefill``'s logits (1e-5) and every cache leaf (1e-4), then 3
  decode steps at P + T, P + T + 1, … (1e-4); ``Server.generate`` against
  ``examples/serve_lm.py``'s ``Server`` (equal tokens).
* ``lm_data`` batches (tokens, labels, patches) bitwise; ``batch_spec`` for
  train, prefill and decode; one ``make_train_step`` step in 2
  microbatches (patches split with the tokens) against the reference's;
  ``tree_from_numpy`` carries ``vision_proj``.
"""
import functools
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402

_torch_parity.cap_torch_threads()
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.base import ShapeSpec as RShape  # noqa: E402
from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.data import lm_data as rdata  # noqa: E402
from repro.launch import train as rtrain  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import registry as rregistry  # noqa: E402
from repro.models.layers import P as RP  # noqa: E402
from repro.optim import optimizers as roptim  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ShapeSpec, get_config  # noqa: E402
from repro_torch.data import lm_data  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import attention, layers, registry  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "paligemma_3b"
FLASH_RTOL = 1e-6
RTOL = 1e-5
CACHE_RTOL = 1e-4
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
B = 2


def numpy_params(specs, seed: int) -> dict:
    """A parameter tree of the spec tree's shapes drawn with numpy: ones
    1 + 0.1·N, embeddings 0.02·N, matrices N / √fan_in (the stacked layer
    axis excluded)."""
    rng = np.random.default_rng(seed)

    def leaf(spec):
        x = rng.standard_normal(spec.shape, dtype=np.float32)
        if spec.init == "ones":
            return 1.0 + 0.1 * x
        if spec.init == "embed":
            return 0.02 * x
        shape = spec.shape[1:] if spec.axes[0] == "layers" else spec.shape
        fan_in = int(np.prod(shape[:-1])) if spec.axes[-1] == "embed" else shape[0]
        return x / np.float32(np.sqrt(fan_in))

    return layers.map_tree(leaf, specs)


@functools.lru_cache(maxsize=None)
def both():
    """(reference api, port api, reference params, port params, jitted
    reference prefill and decode step), built once a module (no test
    writes into the parameters)."""
    rcfg, cfg = ref_config(ARCH).reduced(), get_config(ARCH).reduced()
    rapi, api = rregistry.build(rcfg), registry.build(cfg)
    tree = numpy_params(api.specs, seed=7)
    return (rapi, api, jax.tree.map(jnp.asarray, tree),
            convert.tree_from_numpy(tree, device="cpu"),
            jax.jit(rapi.prefill, static_argnums=2), jax.jit(rapi.decode_step))


def tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def patches(cfg, seed=0, batch=B):
    return np.random.default_rng(100 + seed).standard_normal(
        (batch, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32)


def qkv(seed, Bq, H, Hkv, T, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((Bq, H, T, D), dtype=np.float32),
            rng.standard_normal((Bq, Hkv, T, D), dtype=np.float32),
            rng.standard_normal((Bq, Hkv, T, D), dtype=np.float32))


def assert_close(got, want, rtol=RTOL, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


def assert_cache_close(got, want, rtol=CACHE_RTOL, where=""):
    """Every cache leaf: values, shape and dtype."""
    assert set(got) == set(want) == {"sub0"}
    for c, w in want["sub0"].items():
        assert str(got["sub0"][c].dtype).split(".")[-1] == w.dtype.name, c
        assert_close(got["sub0"][c], w, rtol, f"{where} {c}")


@pytest.mark.parametrize("reduced,want", [(False, 2_513_512_448), (True, 106_816)])
def test_specs_and_n_params_match_reference(reduced, want):
    """Spec trees only, nothing allocated: the same leaves (paths, shapes,
    logical axes, init kinds) and counts as the reference's, ``vision_proj``
    [d, d] among them."""
    rcfg, cfg = ref_config(ARCH), get_config(ARCH)
    if reduced:
        rcfg, cfg = rcfg.reduced(), cfg.reduced()
    rapi, api = rregistry.build(rcfg), registry.build(cfg)
    assert api.n_params() == rapi.n_params() == want
    rleaves = jax.tree.leaves_with_path(rapi.specs, is_leaf=lambda x: isinstance(x, RP))
    got = [(path, (s.shape, s.axes, s.init)) for path, s in layers.iter_specs(api.specs)]
    assert got == [(tuple(str(k.key) for k in path), (s.shape, s.axes, s.init))
                   for path, s in rleaves]
    assert api.specs["vision_proj"].shape == (cfg.d_model, cfg.d_model)


@pytest.mark.parametrize("reduced", [False, True])
def test_every_config_builds(reduced):
    """``registry.build`` takes every config of ``repro_torch.configs`` (the
    VLM was the last to raise), each with the reference's parameter count."""
    from repro_torch.configs.base import ARCH_IDS

    for arch in ARCH_IDS:
        rcfg, cfg = ref_config(arch), get_config(arch)
        if reduced:
            rcfg, cfg = rcfg.reduced(), cfg.reduced()
        assert registry.build(cfg).n_params() == rregistry.build(rcfg).n_params(), arch


@pytest.mark.parametrize("Bq,H,Hkv,T,D,P", [(2, 4, 1, 40, 16, 16), (1, 2, 1, 2048, 16, 256)])
def test_prefix_flash_attention_matches_reference(Bq, H, Hkv, T, D, P):
    """``attention.flash_attention(..., prefix_len=P)`` on the plain branch
    (S 40) and the chunked one ((1, 2, 1, 2048, 16)), and the kernels'
    plain versions, against the reference's ``flash_attention_jnp``."""
    q, k, v = qkv(T + P, Bq, H, Hkv, T, D)
    want = rattn.flash_attention_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=True, prefix_len=P)
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    assert_close(attention.flash_attention(tq, tk, tv, prefix_len=P), want, FLASH_RTOL,
                 "attention")
    assert_close(ref.flash_attention_ref(tq, tk, tv, prefix_len=P), want, FLASH_RTOL, "ref")
    if T <= 64:
        assert_close(tflash.flash_attention(tq, tk, tv, prefix_len=P), want, FLASH_RTOL,
                     "wrapper")
        causal = rattn.flash_attention_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        assert np.abs(np.asarray(want) - np.asarray(causal)).max() > 1e-2


def test_prefix_mask_rule_and_layers_mask():
    """``layers.prefix_lm_mask`` is the reference's; the kernels' rule, row
    r sees keys 0..max(r, P − 1), is the same mask at every P (P = 0 the
    causal mask)."""
    from repro.models import layers as rlayers

    for P in (0, 1, 5, 12, 13):
        want = np.asarray(rlayers.prefix_lm_mask(13, 13, P))
        np.testing.assert_array_equal(layers.prefix_lm_mask(13, 13, P).numpy(), want)
        r, kk = np.arange(13)[:, None], np.arange(13)[None, :]
        np.testing.assert_array_equal(kk <= np.maximum(r, P - 1), want)
        np.testing.assert_array_equal(ref.attention_mask(13, 13, True, P).numpy(), want)


def test_prefix_plain_backward_matches_jax_vjp():
    """The SIMT route's plain version with a prefix (``flash_attention_bwd``
    on CPU tensors, float32 at (16, 16)) against ``jax.vjp`` of the
    reference's ``flash_attention_jnp``."""
    q, k, v = qkv(3, 2, 4, 1, 40, 16)
    do = np.random.default_rng(4).standard_normal((2, 4, 40, 16), dtype=np.float32)
    out, vjp = jax.vjp(lambda a, b, c: rattn.flash_attention_jnp(a, b, c, prefix_len=16),
                       *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.as_tensor, (q, k, v, do))
    o = tflash.flash_attention(tq, tk, tv, prefix_len=16)
    assert tflash.bwd_variant(torch.float32, 16) == "simt"
    got = tflash.flash_attention_bwd(tq, tk, tv, o, tdo, prefix_len=16)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert_close(g, w, RTOL, name)


@pytest.mark.parametrize("fn", ["attention", "kernel", "ref"])
def test_prefix_refuses_non_causal_and_unequal_lengths(fn):
    call = {"attention": lambda *a, **kw: attention.flash_attention(*a, **kw),
            "kernel": tflash.flash_attention, "ref": ref.flash_attention_ref}[fn]
    q, k, v = map(torch.as_tensor, qkv(5, 1, 2, 1, 16, 16))
    with pytest.raises(ValueError, match="needs causal=True"):
        call(q, k, v, causal=False, prefix_len=4)
    with pytest.raises(ValueError, match="T == Tk"):
        call(q[:, :, :8], k, v, causal=True, prefix_len=4)
    with pytest.raises(ValueError, match="outside"):
        call(q, k, v, prefix_len=17)


#: the bf16 route's gate: P and dS enter their products rounded to bf16 and
#: each gradient is rounded to bf16 (2⁻⁹ of a value)
BF16_RTOL = 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,P", [(256, 24), (64, 20)])
def test_tensor_core_plain_backward_with_prefix_matches_jax_vjp(D, P, dtype):
    """``flash_attention_bwd`` on CPU tensors with a prefix, where
    ``bwd_variant`` names a tensor-core route (tf32 for float32, wgmma for
    bf16: plain versions ``ref.flash_attention_bwd_ref`` and
    ``flash_attention_bwd_bf16_ref``), given the forward's L and without,
    against ``jax.vjp`` of the reference's ``flash_attention_jnp`` on the
    same (bf16-representable) inputs in float32."""
    dt = getattr(torch, dtype)
    q, k, v = qkv(D + P, 2, 4, 1, 40, D)
    do = np.random.default_rng(D).standard_normal((2, 4, 40, D), dtype=np.float32)
    q, k, v, do = (torch.as_tensor(x).to(dt).float().numpy() for x in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b, c: rattn.flash_attention_jnp(a, b, c, prefix_len=P),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.as_tensor(x).to(dt) for x in (q, k, v, do))
    assert tflash.bwd_variant(dt, D) == ("tf32" if dt == torch.float32 else "wgmma")
    o, lse = tflash.flash_attention(tq, tk, tv, return_lse=True, prefix_len=P)
    rtol = RTOL if dt == torch.float32 else BF16_RTOL
    for given in (lse, None):
        got = tflash.flash_attention_bwd(tq, tk, tv, o, tdo, lse=given, prefix_len=P)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.dtype == dt
            assert_close(g.float(), w, rtol, f"{name} given L: {given is not None}")


def test_flash_attention_fn_gradient_at_d256_with_prefix_matches_jax_vjp():
    """``FlashAttentionFn`` (the function autograd runs on the card) on CPU
    tensors at (256, 256) with a prefix of 24 rows: its output and its
    gradient (the tf32 route's plain backward given L) against
    ``jax.vjp``."""
    q, k, v = qkv(9, 2, 4, 1, 40, 256)
    do = np.random.default_rng(10).standard_normal((2, 4, 40, 256), dtype=np.float32)
    out, vjp = jax.vjp(lambda a, b, c: rattn.flash_attention_jnp(a, b, c, prefix_len=24),
                       *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    xs = [torch.as_tensor(x).requires_grad_() for x in (q, k, v)]
    got = tflash.FlashAttentionFn.apply(*xs, True, 24)
    assert_close(got, out, FLASH_RTOL, "o")
    grads = torch.autograd.grad(got, xs, torch.as_tensor(do))
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        assert_close(g, w, RTOL, name)


def test_backward_pairs_and_the_simt_route_at_d256():
    """Every forward pair has a backward (``BWD_PAIRS`` is ``PAIRS``): at
    (256, 256) the wgmma route for bf16 and the tf32 route for float32,
    both given L by the forward; the SIMT route has no (256, 256) instance
    and ``bwd_launch("simt", ...)`` raises ``ValueError`` there, as at
    (192, 128)."""
    assert tflash.BWD_PAIRS == tflash.PAIRS
    assert (256, 256) not in tflash.SIMT_BWD_PAIRS
    assert tflash.bwd_variant(torch.bfloat16, 256) == "wgmma"
    assert tflash.bwd_variant(torch.float32, 256) == "tf32"
    assert tflash.lse_route(torch.bfloat16, 256) and tflash.lse_route(torch.float32, 256)
    for dt in (torch.float32, torch.bfloat16):
        for D, Dv in ((256, 256), (192, 128)):
            q, k = (torch.zeros((1, n, 8, D), dtype=dt) for n in (2, 1))
            v, o = torch.zeros((1, 1, 8, Dv), dtype=dt), torch.zeros((1, 2, 8, Dv), dtype=dt)
            with pytest.raises(ValueError, match="simt backward does not take"):
                tflash.bwd_launch("simt", q, k, v, o, o, prefix_len=4)


@functools.lru_cache(maxsize=None)
def narrow_d256():
    """(reference api, port api, reference params, port params) of a narrow
    config of paligemma-3b's shape at head dim 256: the reduced config with
    2 query heads over 1 KV head of 256 and the full config's 256 patches."""
    import dataclasses

    kw = dict(n_heads=2, n_kv_heads=1, d_head=256,
              n_frontend_tokens=get_config(ARCH).n_frontend_tokens)
    rcfg = dataclasses.replace(ref_config(ARCH).reduced(), **kw)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **kw)
    rapi, api = rregistry.build(rcfg), registry.build(cfg)
    tree = numpy_params(api.specs, seed=8)
    return (rapi, api, jax.tree.map(jnp.asarray, tree),
            convert.tree_from_numpy(tree, device="cpu"))


def test_narrow_d256_loss_and_grads_match_reference():
    """``lm_loss`` and its gradient through 2 layers at head dim 256 under
    the 256-row prefix against ``jax.value_and_grad``, as the reduced
    config's (above)."""
    rapi, api, rp, tp = narrow_d256()
    cfg = api.cfg
    assert cfg.head_dim == 256 and cfg.n_frontend_tokens == 256
    rng = np.random.default_rng(2)
    labels = rng.integers(0, cfg.vocab_size, (B, 8)).astype(np.int32)
    labels[0, :2] = -1
    batch = {"tokens": tokens(cfg, (B, 8), seed=2), "labels": labels,
             "patches": patches(cfg, seed=2)}
    (r_loss, _), r_grads = jax.jit(jax.value_and_grad(
        lambda p: rapi.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True))(rp)
    leaves, spec = pytree.tree_flatten(tp)
    xs = [p.detach().requires_grad_() for p in leaves]
    loss, _ = api.loss(pytree.tree_unflatten(xs, spec), batch)
    grads = torch.autograd.grad(loss, xs)
    assert_close(loss, r_loss, LOSS_RTOL, "loss")
    want = jax.tree.leaves_with_path(r_grads)
    assert len(want) == len(grads)
    for g, (path, w) in zip(grads, want):
        assert_close(g, w, GRAD_RTOL, jax.tree_util.keystr(path))


def test_narrow_d256_train_step_in_two_microbatches_matches_reference():
    """One step of 4 sequences (256 patches + 6 tokens) in 2 microbatches
    at head dim 256, SGD with momentum, against the reference's, as the
    reduced config's (below)."""
    rapi, api, rp, tp = narrow_d256()
    cfg = api.cfg
    rng = np.random.default_rng(3)
    batch = {"tokens": tokens(cfg, (4, 6), seed=3),
             "labels": rng.integers(0, cfg.vocab_size, (4, 6)).astype(np.int32),
             "patches": patches(cfg, seed=3, batch=4)}
    ropt, opt = roptim.sgd(0.1, momentum=0.9), optimizers.sgd(0.1, momentum=0.9)
    r_new, r_state, r_metrics = rtrain.make_train_step(
        rapi.cfg, rapi, ropt, rtrain.TrainPlan(n_microbatches=2, accum_dtype=jnp.float32))(
        rp, ropt.init(rp), {k: jnp.asarray(v) for k, v in batch.items()})
    new, state, metrics = train.make_train_step(
        cfg, api, opt, train.TrainPlan(n_microbatches=2, accum_dtype=torch.float32))(
        tp, opt.init(tp), batch)
    for k in ("loss", "grad_norm"):
        assert_close(metrics[k], r_metrics[k], LOSS_RTOL, k)
    for (path, w), g in zip(jax.tree.leaves_with_path(r_new), pytree.tree_leaves(new)):
        assert_close(g, w, LOSS_RTOL, jax.tree_util.keystr(path))
    for (path, w), g in zip(jax.tree.leaves_with_path(r_state["mu"]),
                            pytree.tree_leaves(state["mu"])):
        assert_close(g, w, GRAD_RTOL, jax.tree_util.keystr(path))


def test_loss_and_grads_match_reference():
    rapi, api, rp, tp, _, _ = both()
    cfg = api.cfg
    rng = np.random.default_rng(1)
    labels = rng.integers(0, cfg.vocab_size, (B, 12)).astype(np.int32)
    labels[0, :3] = -1
    labels[1, -2:] = -5
    batch = {"tokens": tokens(cfg, (B, 12)), "labels": labels, "patches": patches(cfg)}
    (r_loss, r_metrics), r_grads = jax.jit(jax.value_and_grad(
        lambda p: rapi.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True))(rp)
    leaves, spec = pytree.tree_flatten(tp)
    xs = [p.detach().requires_grad_() for p in leaves]
    loss, metrics = api.loss(pytree.tree_unflatten(xs, spec), batch)
    grads = torch.autograd.grad(loss, xs)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert set(metrics) == set(r_metrics) == {"loss", "tokens"}
    assert float(metrics["tokens"]) == float(r_metrics["tokens"]) == 2 * 12 - 5
    assert_close(loss, r_loss, LOSS_RTOL, "loss")
    want = jax.tree.leaves_with_path(r_grads)
    assert len(want) == len(grads)
    for g, (path, w) in zip(grads, want):
        assert_close(g, w, GRAD_RTOL, jax.tree_util.keystr(path))


@pytest.mark.parametrize("T", [8, 24])
def test_prefill_and_decode_match_reference(T):
    """Prefill of 16 patches and T prompt tokens into a cache of 16 + T + 8,
    then 3 decode steps at 16 + T, … fed the same tokens."""
    rapi, api, rp, tp, r_prefill, r_decode = both()
    cfg = api.cfg
    n_p = cfg.n_frontend_tokens
    toks, pt = tokens(cfg, (B, T), seed=T), patches(cfg, seed=T)
    cache_len = n_p + T + 8
    r_logits, r_cache = r_prefill(rp, {"tokens": jnp.asarray(toks),
                                       "patches": jnp.asarray(pt)}, cache_len)
    t_logits, t_cache = api.prefill(tp, {"tokens": toks, "patches": pt}, cache_len)
    assert t_logits.shape == (B, cfg.padded_vocab)
    assert_close(t_logits, r_logits, RTOL, "prefill")
    assert_cache_close(t_cache, r_cache, CACHE_RTOL, "prefill")
    assert t_cache["sub0"]["k"].shape[3] == cache_len
    assert t_cache["sub0"]["k"][:, :, :, n_p + T - 1].any()
    assert not t_cache["sub0"]["k"][:, :, :, n_p + T:].any()
    fed = tokens(cfg, (B, 3), seed=T + 1)
    for i, pos in enumerate(range(n_p + T, n_p + T + 3)):
        r_logits, r_cache = r_decode(rp, jnp.asarray(fed[:, i]), jnp.asarray(pos, jnp.int32),
                                     r_cache)
        t_logits, t_cache = api.decode_step(tp, fed[:, i], pos, t_cache)
        assert_close(t_logits, r_logits, CACHE_RTOL, f"decode {pos}")
    assert_cache_close(t_cache, r_cache, CACHE_RTOL, "decode")


def test_server_generate_matches_reference_server():
    """Greedy tokens of ``Server.generate`` (the batch's patches handed to
    the prefill, the first decode position P + T) equal those of
    ``examples/serve_lm.py``'s ``Server`` on the same weights."""
    from repro_torch.serve_lm import Server

    rapi, api, rp, tp, _, _ = both()
    spec = importlib.util.spec_from_file_location("reference_serve_lm",
                                                  ROOT / "examples" / "serve_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    batch = {"tokens": tokens(api.cfg, (B, 20), seed=5), "patches": patches(api.cfg, seed=5)}
    want = mod.Server(rapi.cfg, params=rp, cache_len=48).generate(
        {k: jnp.asarray(v) for k, v in batch.items()}, 12)
    got = Server(api.cfg, params=tp, cache_len=48, device="cpu").generate(batch, 12)
    assert got.tokens.shape == (B, 12) and got.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


@pytest.mark.parametrize("step", [0, 3])
def test_lm_data_batches_match_reference_bitwise(step):
    """tokens and labels (S − 16 text positions) and patches (drawn after
    the tokens from the same generator) bitwise the reference's."""
    rcfg, cfg = ref_config(ARCH).reduced(), get_config(ARCH).reduced()
    want = rdata._batch_for_step(rcfg, RShape("t", 40, 4, "train"), 11, step)
    got = lm_data._batch_for_step(cfg, ShapeSpec("t", 40, 4, "train"), 11, step, "cpu")
    assert set(got) == set(want) == {"tokens", "labels", "patches"}
    assert got["tokens"].shape == (4, 24) and got["patches"].shape == (4, 16, 64)
    assert got["patches"].dtype == torch.float32 and got["tokens"].dtype == torch.int32
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_batch_spec_matches_reference(kind):
    """``batch_spec`` of the full config (512-position cells: 256 text
    tokens, patches [4, 256, 2048]) as the reference's; ``real_batch`` of
    the reduced one draws every input at its spec's shape."""
    rspecs = rregistry.batch_spec(ref_config(ARCH), RShape("c", 512, 4, kind))
    specs = registry.batch_spec(get_config(ARCH), ShapeSpec("c", 512, 4, kind))
    assert list(specs) == list(rspecs)
    for name, s in specs.items():
        assert (s.shape, s.axes) == (rspecs[name].shape, rspecs[name].axes), name
    if kind != "decode":
        assert specs["patches"].shape == (4, 256, 2048)
        assert specs["tokens"].shape == (4, 256)
    cfg = get_config(ARCH).reduced()
    batch = registry.real_batch(cfg, ShapeSpec("c", 40, 4, kind),
                                torch.Generator().manual_seed(0))
    for name, s in registry.batch_spec(cfg, ShapeSpec("c", 40, 4, kind)).items():
        assert tuple(batch[name].shape) == s.shape, name
    if kind != "decode":
        assert batch["patches"].dtype == torch.float32


def test_train_step_in_two_microbatches_matches_reference():
    """One step of 4 sequences in 2 microbatches from the same parameters
    and batch, SGD with momentum (its ``mu`` is the accumulated gradient):
    ``make_train_step`` splits ``patches`` with the tokens and labels, as
    the reference's does; the parameters within 1e-5 and ``mu`` within
    1e-4 of each leaf's largest magnitude."""
    rapi, api, rp, tp, _, _ = both()
    cfg = api.cfg
    rng = np.random.default_rng(6)
    batch = {"tokens": tokens(cfg, (4, 10), seed=6),
             "labels": rng.integers(0, cfg.vocab_size, (4, 10)).astype(np.int32),
             "patches": patches(cfg, seed=6, batch=4)}
    ropt, opt = roptim.sgd(0.1, momentum=0.9), optimizers.sgd(0.1, momentum=0.9)
    r_new, r_state, r_metrics = rtrain.make_train_step(
        rapi.cfg, rapi, ropt, rtrain.TrainPlan(n_microbatches=2, accum_dtype=jnp.float32))(
        rp, ropt.init(rp), {k: jnp.asarray(v) for k, v in batch.items()})
    new, state, metrics = train.make_train_step(
        cfg, api, opt, train.TrainPlan(n_microbatches=2, accum_dtype=torch.float32))(
        tp, opt.init(tp), batch)
    for k in ("loss", "grad_norm"):
        assert_close(metrics[k], r_metrics[k], LOSS_RTOL, k)
    for (path, w), g in zip(jax.tree.leaves_with_path(r_new), pytree.tree_leaves(new)):
        assert_close(g, w, LOSS_RTOL, jax.tree_util.keystr(path))
    for (path, w), g in zip(jax.tree.leaves_with_path(r_state["mu"]),
                            pytree.tree_leaves(state["mu"])):
        assert_close(g, w, GRAD_RTOL, jax.tree_util.keystr(path))


def test_tree_from_numpy_carries_vision_proj():
    """``convert.tree_from_numpy`` of the reference's VLM tree: the port's
    tree leaf for leaf in ``jax.tree.flatten``'s order (keys sorted),
    bitwise, the same paths as the port's own ``init``, ``vision_proj``
    among them."""
    rapi, api, _, _, _, _ = both()
    tree = jax.tree.map(np.asarray, rapi.init(jax.random.PRNGKey(3)))
    got = convert.tree_from_numpy(tree, device="cpu")
    rleaves = jax.tree.leaves_with_path(tree)
    leaves = list(layers.iter_specs(got))
    assert [tuple(str(k.key) for k in p) for p, _ in rleaves] == [p for p, _ in leaves]
    assert [p for p, _ in leaves] == [p for p, _ in layers.iter_specs(api.init(device="cpu"))]
    assert ("vision_proj",) in [p for p, _ in leaves]
    for (_, w), (_, g) in zip(rleaves, leaves):
        np.testing.assert_array_equal(g.numpy(), w)
