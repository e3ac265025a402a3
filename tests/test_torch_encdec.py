"""The port's encoder-decoder ≡ the reference's, on the CPU: seamless-m4t
(``models/encdec.py``: a bidirectional encoder over stub frame embeddings,
a causal decoder with cross-attention over the frames).

The reduced config (2 encoder + 2 decoder layers, d_model 64, 4 heads over
2 KV heads of 16, 16 frames, vocab 256 padded to 512), float32, parameters
drawn with numpy in the reference's layout (every norm perturbed) and
carried into both packages with ``convert.tree_from_numpy``; the
reference's functions are jitted on the CPU.

* ``encdec_specs`` and ``n_params`` of the full and reduced configs
  (2,036,459,520 and 242,432).
* ``encode``, ``_cross_forward`` (queries of the text against the frames,
  S ≠ F) and ``_cross_decode`` within 1e-5 of the largest magnitude;
  ``decode_stack`` with and without ``collect_cache``.
* ``encdec_loss`` within 1e-5 and its gradient within 1e-4 of each leaf's
  largest magnitude, against ``jax.value_and_grad``, some labels < 0.
* ``encdec_prefill``'s logits (1e-5) and every cache leaf (1e-4), then 3
  teacher-forced ``encdec_decode`` steps (1e-4); the port's own decode
  against its prefill over the extended prompt; ``Server.generate``
  against ``examples/serve_lm.py``'s ``Server`` (equal tokens).
* ``lm_data`` batches (tokens, labels, frames) bitwise; ``batch_spec``
  for train, prefill and decode; the bf16 cache's dtypes and shapes; one
  ``make_train_step`` step in 2 microbatches (frames split with the
  tokens) against the reference's; ``tree_from_numpy`` carries the tree.
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
from repro.models import encdec as rencdec  # noqa: E402
from repro.models import registry as rregistry  # noqa: E402
from repro.models.layers import P as RP  # noqa: E402
from repro.optim import optimizers as roptim  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ShapeSpec, get_config  # noqa: E402
from repro_torch.data import lm_data  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import encdec, layers, registry  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "seamless_m4t_large_v2"
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


def frames(cfg, seed=0, batch=B):
    return np.random.default_rng(100 + seed).standard_normal(
        (batch, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32)


def assert_close(got, want, rtol=RTOL, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


def assert_cache_close(got, want, rtol=CACHE_RTOL, where=""):
    """Every cache leaf: values, shape and dtype."""
    assert set(got) == set(want) == {"k", "v", "xk", "xv"}
    for c, w in want.items():
        assert str(got[c].dtype).split(".")[-1] == w.dtype.name, c
        assert_close(got[c], w, rtol, f"{where} {c}")


def layer(tree, n=0):
    """Layer ``n`` of a stacked tree (port tensors or reference arrays)."""
    if isinstance(tree, dict):
        return {k: layer(v, n) for k, v in tree.items()}
    return tree[n]


@pytest.mark.parametrize("reduced,want", [(False, 2_036_459_520), (True, 242_432)])
def test_specs_and_n_params_match_reference(reduced, want):
    """Spec trees only, nothing allocated: the same leaves (paths, shapes,
    logical axes, init kinds) and counts as the reference's."""
    rcfg, cfg = ref_config(ARCH), get_config(ARCH)
    if reduced:
        rcfg, cfg = rcfg.reduced(), cfg.reduced()
    rapi, api = rregistry.build(rcfg), registry.build(cfg)
    assert api.n_params() == rapi.n_params() == want
    assert api.n_active_params() == rapi.n_active_params() == want
    rleaves = jax.tree.leaves_with_path(rapi.specs, is_leaf=lambda x: isinstance(x, RP))
    got = [(path, (s.shape, s.axes, s.init)) for path, s in layers.iter_specs(api.specs)]
    assert got == [(tuple(str(k.key) for k in path), (s.shape, s.axes, s.init))
                   for path, s in rleaves]


def test_encode_matches_reference():
    rapi, api, rp, tp, _, _ = both()
    f = frames(api.cfg)
    want = jax.jit(lambda p, x: rencdec.encode(rapi.cfg, p, x))(rp, jnp.asarray(f))
    got = encdec.encode(api.cfg, tp, torch.as_tensor(f))
    assert got.dtype == torch.float32
    assert_close(got, want, RTOL, "encode")


@pytest.mark.parametrize("S", [5, 24])
def test_cross_attention_matches_reference(S):
    """``_cross_forward`` of S queries against the 16 frames, S below and
    above F, ``_cross_kv`` and ``_cross_decode`` against the cached frames
    (every frame attended)."""
    rapi, api, rp, tp, _, _ = both()
    cfg = api.cfg
    rng = np.random.default_rng(S)
    x = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    enc = rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32)
    rpc, tpc = layer(rp["dec_layers"])["cross"], layer(tp["dec_layers"])["cross"]
    rk, rv = rencdec._cross_kv(rapi.cfg, rpc, jnp.asarray(enc))
    k, v = encdec._cross_kv(cfg, tpc, torch.as_tensor(enc))
    want = rencdec._cross_forward(rapi.cfg, rpc, jnp.asarray(x), jnp.asarray(enc))
    got = encdec._cross_forward(cfg, tpc, torch.as_tensor(x), k, v)
    assert_close(got, want, RTOL, "cross forward")
    assert_close(k, rk, RTOL, "xk")
    assert_close(v, rv, RTOL, "xv")
    want = rencdec._cross_decode(rapi.cfg, rpc, jnp.asarray(x[:, 0]), rk, rv)
    got = encdec._cross_decode(cfg, tpc, torch.as_tensor(x[:, 0]), k, v)
    assert_close(got, want, RTOL, "cross decode")


@pytest.mark.parametrize("collect_cache", [False, True])
def test_decode_stack_matches_reference(collect_cache):
    rapi, api, rp, tp, _, _ = both()
    cfg = api.cfg
    toks = tokens(cfg, (B, 12), seed=3)
    enc = np.random.default_rng(4).standard_normal(
        (B, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32)
    h_want, c_want = jax.jit(lambda p, t, e: rencdec.decode_stack(
        rapi.cfg, p, t, e, collect_cache=collect_cache))(rp, jnp.asarray(toks),
                                                        jnp.asarray(enc))
    h, c = encdec.decode_stack(cfg, tp, torch.as_tensor(toks).long(), torch.as_tensor(enc),
                               collect_cache=collect_cache)
    assert_close(h, h_want, RTOL, "h")
    if not collect_cache:
        assert c is None and c_want is None
        return
    assert_cache_close(c, c_want, RTOL, "decode_stack")
    assert c["k"].shape == (cfg.n_layers, B, cfg.n_kv_heads, 12, cfg.head_dim)
    assert c["xk"].shape == (cfg.n_layers, B, cfg.n_kv_heads, cfg.n_frontend_tokens,
                             cfg.head_dim)


def test_loss_and_grads_match_reference():
    rapi, api, rp, tp, _, _ = both()
    cfg = api.cfg
    rng = np.random.default_rng(1)
    labels = rng.integers(0, cfg.vocab_size, (B, 12)).astype(np.int32)
    labels[0, :3] = -1
    labels[1, -2:] = -5
    batch = {"tokens": tokens(cfg, (B, 12)), "labels": labels, "frames": frames(cfg)}
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


@pytest.mark.parametrize("S", [8, 24])
def test_prefill_and_decode_match_reference(S):
    """Prefill of S prompt tokens (below and above the 16 frames) into a
    cache of S + 8, then 3 decode steps fed the same tokens."""
    rapi, api, rp, tp, r_prefill, r_decode = both()
    cfg = api.cfg
    toks, f = tokens(cfg, (B, S), seed=S), frames(cfg, seed=S)
    r_logits, r_cache = r_prefill(rp, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(f)},
                                  S + 8)
    t_logits, t_cache = api.prefill(tp, {"tokens": toks, "frames": f}, S + 8)
    assert t_logits.shape == (B, cfg.padded_vocab)
    assert_close(t_logits, r_logits, RTOL, "prefill")
    assert_cache_close(t_cache, r_cache, CACHE_RTOL, "prefill")
    assert not t_cache["k"][:, :, :, S:].any()
    fed = tokens(cfg, (B, 3), seed=S + 1)
    for i, pos in enumerate(range(S, S + 3)):
        r_logits, r_cache = r_decode(rp, jnp.asarray(fed[:, i]), jnp.asarray(pos, jnp.int32),
                                     r_cache)
        t_logits, t_cache = api.decode_step(tp, fed[:, i], pos, t_cache)
        assert_close(t_logits, r_logits, CACHE_RTOL, f"decode {pos}")
    assert_cache_close(t_cache, r_cache, CACHE_RTOL, "decode")


def test_decode_matches_own_longer_prefill():
    """Greedy decode steps after a prompt of 10 against the port's prefill
    over the extended prompt (the same frames): its last logits within 1e-4
    of their largest magnitude."""
    _, api, _, tp, _, _ = both()
    cfg = api.cfg
    f = torch.as_tensor(frames(cfg, seed=9))
    toks = torch.as_tensor(tokens(cfg, (B, 10), seed=9))
    logits, cache = api.prefill(tp, {"tokens": toks, "frames": f}, 16)
    tok, cur = logits.argmax(-1), toks
    for i in range(6):
        logits_d, cache = api.decode_step(tp, tok, 10 + i, cache)
        cur = torch.cat([cur, tok[:, None]], dim=1)
        logits_ref, _ = api.prefill(tp, {"tokens": cur, "frames": f})
        assert_close(logits_d, logits_ref.numpy(), 1e-4, f"step {i}")
        tok = logits_d.argmax(-1)


def test_server_generate_matches_reference_server():
    """Greedy tokens of ``Server.generate`` (the batch's frames handed to the
    prefill, the first decode position the prompt's length) equal those of
    ``examples/serve_lm.py``'s ``Server`` on the same weights."""
    from repro_torch.serve_lm import Server

    rapi, api, rp, tp, _, _ = both()
    spec = importlib.util.spec_from_file_location("reference_serve_lm",
                                                  ROOT / "examples" / "serve_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    batch = {"tokens": tokens(api.cfg, (B, 20), seed=5), "frames": frames(api.cfg, seed=5)}
    want = mod.Server(rapi.cfg, params=rp, cache_len=40).generate(
        {k: jnp.asarray(v) for k, v in batch.items()}, 12)
    got = Server(api.cfg, params=tp, cache_len=40, device="cpu").generate(batch, 12)
    assert got.tokens.shape == (B, 12) and got.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


@pytest.mark.parametrize("step", [0, 3])
def test_lm_data_batches_match_reference_bitwise(step):
    """tokens, labels and frames (drawn after the tokens from the same
    generator) bitwise the reference's."""
    rcfg, cfg = ref_config(ARCH).reduced(), get_config(ARCH).reduced()
    want = rdata._batch_for_step(rcfg, RShape("t", 12, 4, "train"), 11, step)
    got = lm_data._batch_for_step(cfg, ShapeSpec("t", 12, 4, "train"), 11, step, "cpu")
    assert set(got) == set(want) == {"tokens", "labels", "frames"}
    assert got["frames"].dtype == torch.float32 and got["tokens"].dtype == torch.int32
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    stream = lm_data.synthetic_lm_batches(cfg, ShapeSpec("t", 12, 4, "train"), seed=11,
                                          start_step=step, device="cpu")
    np.testing.assert_array_equal(next(stream)["frames"].numpy(), np.asarray(want["frames"]))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_batch_spec_matches_reference(kind):
    """``batch_spec`` of the full config (frames [B, 1024, 1024] for train
    and prefill) as the reference's; ``real_batch`` of the reduced one draws
    every input at its spec's shape (frames in ``act_dtype``)."""
    rspecs = rregistry.batch_spec(ref_config(ARCH), RShape("c", 128, 4, kind))
    specs = registry.batch_spec(get_config(ARCH), ShapeSpec("c", 128, 4, kind))
    assert list(specs) == list(rspecs)
    for name, s in specs.items():
        assert (s.shape, s.axes) == (rspecs[name].shape, rspecs[name].axes), name
    if kind != "decode":
        assert specs["frames"].shape == (4, 1024, 1024)
    cfg = get_config(ARCH).reduced()
    batch = registry.real_batch(cfg, ShapeSpec("c", 12, 4, kind),
                                torch.Generator().manual_seed(0))
    for name, s in registry.batch_spec(cfg, ShapeSpec("c", 12, 4, kind)).items():
        assert tuple(batch[name].shape) == s.shape, name
    if kind != "decode":
        assert batch["frames"].dtype == torch.float32


def test_bf16_cache_dtypes_match_reference():
    """``init_cache`` and a prefill of the reduced config in bf16: every leaf
    bf16 at the reference's shapes (the reference's by ``jax.eval_shape``)."""
    import dataclasses

    rcfg = dataclasses.replace(ref_config(ARCH).reduced(), act_dtype="bfloat16",
                               param_dtype="bfloat16")
    cfg = dataclasses.replace(get_config(ARCH).reduced(), act_dtype="bfloat16",
                              param_dtype="bfloat16")
    rapi, api = rregistry.build(rcfg), registry.build(cfg)
    want = rapi.init_cache(B, 24, jnp.bfloat16)
    got = api.init_cache(B, 24, torch.bfloat16, device="cpu")
    assert set(got) == set(want)
    for c, w in want.items():
        assert tuple(got[c].shape) == w.shape and got[c].dtype == torch.bfloat16, c
        assert not got[c].any()
    params = api.init(seed=0, device="cpu")
    batch = {"tokens": tokens(cfg, (B, 10)), "frames": frames(cfg)}
    _, r_cache = jax.eval_shape(lambda p, b: rapi.prefill(p, b, 24),
                                rapi.init(jax.random.PRNGKey(0)),
                                {k: jnp.asarray(v) for k, v in batch.items()})
    logits, cache = api.prefill(params, batch, 24)
    assert logits.dtype == torch.bfloat16
    for c, w in r_cache.items():
        assert tuple(cache[c].shape) == w.shape, c
        assert str(cache[c].dtype).split(".")[-1] == w.dtype.name == "bfloat16", c


def test_train_step_in_two_microbatches_matches_reference():
    """One step of 4 sequences in 2 microbatches from the same parameters
    and batch, SGD with momentum (its ``mu`` is the accumulated gradient):
    ``make_train_step`` splits ``frames`` with the tokens and labels, as
    the reference's does; the parameters within 1e-5 and ``mu`` within
    1e-4 of each leaf's largest magnitude."""
    rapi, api, rp, tp, _, _ = both()
    cfg = api.cfg
    rng = np.random.default_rng(6)
    batch = {"tokens": tokens(cfg, (4, 10), seed=6),
             "labels": rng.integers(0, cfg.vocab_size, (4, 10)).astype(np.int32),
             "frames": frames(cfg, seed=6, batch=4)}
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


def test_tree_from_numpy_carries_the_tree():
    """``convert.tree_from_numpy`` of the reference's enc-dec tree: the port's
    tree leaf for leaf in ``jax.tree.flatten``'s order (keys sorted), bitwise,
    the same paths as the port's own ``init``; ``tree_to_numpy`` gives it
    back."""
    rapi, api, _, _, _, _ = both()
    tree = jax.tree.map(np.asarray, rapi.init(jax.random.PRNGKey(3)))
    got = convert.tree_from_numpy(tree, device="cpu")
    rleaves = jax.tree.leaves_with_path(tree)
    leaves = list(layers.iter_specs(got))
    assert [tuple(str(k.key) for k in p) for p, _ in rleaves] == [p for p, _ in leaves]
    assert [p for p, _ in leaves] == [p for p, _ in layers.iter_specs(api.init(device="cpu"))]
    assert all(a is b for a, (_, b) in zip(pytree.tree_leaves(got), leaves))
    for (_, w), (_, g) in zip(rleaves, leaves):
        np.testing.assert_array_equal(g.numpy(), w)
    back = convert.tree_to_numpy(got)
    for (_, w), b in zip(rleaves, jax.tree.leaves(back)):
        np.testing.assert_array_equal(b, w)
