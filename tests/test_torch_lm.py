"""The port's LM serving path ≡ the reference's, on the CPU.

Reduced configs of the four dense GQA models (llama3.2-1b, llama3.2-3b,
qwen2-1.5b with its QKV bias, granite-3-2b), of the MoE moonshot-v1-16b-a3b
and of deepseek-v3-671b (MLA attention, whose cache holds the kv latent and
the rope key), float32.  Parameters are the
reference's pytree, either its own init (``registry.build(cfg).init``) or
drawn with numpy at per-layer scales with every norm and bias perturbed (so
that none of them is a no-op), moved into the port with
``convert.tree_from_numpy``.  The same tokens go through both.

Tolerances: logits and K/V caches within 1e-5 of their largest magnitude.
Both packages compute the same float32 function; the dot products and sums
are taken in other orders (XLA's against PyTorch's), each rounding at
~6e-8 of the running value, and the measured differences stay below
1.5e-6.  The port's own decode against its prefill over the extended
prompt is held to the 5e-3 of ``tests/test_decode_consistency.py``.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402

_torch_parity.cap_torch_threads()
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.models import blocks as rblocks  # noqa: E402
from repro.models import registry as rregistry  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import blocks, layers, registry  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["llama3_2_1b", "llama3_2_3b", "qwen2_1_5b", "granite_3_2b",
         "moonshot_v1_16b_a3b", "deepseek_v3_671b"]
RTOL = 1e-5
S = 16


def assert_close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = float(np.abs(want).max())
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= rtol * scale, (err, scale)


def numpy_params(specs, seed: int) -> dict:
    """A parameter tree of the spec tree's shapes drawn with numpy: norms
    1 + 0.1·N, biases 0.1·N, embeddings 0.02·N, matrices N / √fan_in with
    fan_in the per-layer input width (the stacked layer axis excluded)."""
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
        # into the model width: all input axes; out of it: the first
        fan_in = int(np.prod(shape[:-1])) if spec.axes[-1] == "embed" else shape[0]
        return x / np.float32(np.sqrt(fan_in))

    return layers.map_tree(leaf, specs)


def both(arch: str, init: str = "numpy"):
    """(reference api, port api, reference params, port params)."""
    rcfg, cfg = ref_config(arch).reduced(), get_config(arch).reduced()
    rapi, api = rregistry.build(rcfg), registry.build(cfg)
    if init == "reference":
        tree = jax.tree.map(np.asarray, rapi.init(jax.random.PRNGKey(0)))
    else:
        tree = numpy_params(api.specs, seed=len(arch))
    rparams = jax.tree.map(jnp.asarray, tree)
    return rapi, api, rparams, convert.tree_from_numpy(tree, device="cpu")


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _assert_cache_close(got, want):
    """Every cache entry of every layer: GQA's {"k", "v"}, MLA's {"c_kv",
    "k_rope"}."""
    assert set(got) == set(want)
    for sub in want:
        assert set(got[sub]) == set(want[sub])
        for c in want[sub]:
            assert_close(got[sub][c], want[sub][c])


@pytest.mark.parametrize("init", ["reference", "numpy"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, init):
    rapi, api, rp, tp = both(arch, init)
    toks = _tokens(api.cfg, (2, S))
    r_logits, r_cache = rapi.prefill(rp, {"tokens": jnp.asarray(toks)}, S + 8)
    t_logits, t_cache = api.prefill(tp, {"tokens": toks}, S + 8)
    assert t_logits.shape == (2, api.cfg.padded_vocab)
    assert_close(t_logits, r_logits)
    _assert_cache_close(t_cache, r_cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_reference(arch):
    """Two decode steps fed the same tokens (not each package's argmax)."""
    rapi, api, rp, tp = both(arch)
    toks = _tokens(api.cfg, (2, S))
    fed = _tokens(api.cfg, (2, 2), seed=1)
    _, r_cache = rapi.prefill(rp, {"tokens": jnp.asarray(toks)}, S + 8)
    _, t_cache = api.prefill(tp, {"tokens": toks}, S + 8)
    for i in range(2):
        r_logits, r_cache = rapi.decode_step(rp, jnp.asarray(fed[:, i]),
                                             jnp.asarray(S + i, jnp.int32), r_cache)
        t_logits, t_cache = api.decode_step(tp, fed[:, i], S + i, t_cache)
        assert_close(t_logits, r_logits)
        _assert_cache_close(t_cache, r_cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_prefill(arch):
    """As tests/test_decode_consistency.py: each of two greedy decode steps
    equals the port's prefill over the extended prompt (weights drawn by the
    port's own init from a seeded generator)."""
    cfg = get_config(arch).reduced()
    api = registry.build(cfg)
    params = api.init(seed=0, device="cpu")
    toks = torch.as_tensor(_tokens(cfg, (2, S)))
    logits, cache = api.prefill(params, {"tokens": toks}, S + 8)
    assert bool(torch.isfinite(logits).all())
    tok = logits.argmax(-1)
    cur = toks
    for i in range(2):
        logits_d, cache = api.decode_step(params, tok, S + i, cache)
        cur = torch.cat([cur, tok[:, None]], dim=1)
        logits_ref, _ = api.prefill(params, {"tokens": cur}, S + 8)
        err = float((logits_d - logits_ref).abs().max())
        assert err < 5e-3, (arch, i, err)
        tok = logits_d.argmax(-1)


def test_full_width_block_matches_reference():
    """One llama3.2-1b block at full width (d 2048, 32 heads over 8 KV
    heads, head dim 64, d_ff 8192), float32, B = 1, T = 16."""
    rcfg = ref_config("llama3_2_1b")
    cfg = get_config("llama3_2_1b")
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff) == \
        (2048, 32, 8, 64, 8192)
    tree = numpy_params(blocks.block_specs(cfg, "attn", 0), seed=7)
    x = np.random.default_rng(8).standard_normal((1, 16, cfg.d_model), dtype=np.float32)
    pos = np.arange(16)[None, :]
    r_y, r_kv = rblocks.apply_block(rcfg, "attn", jax.tree.map(jnp.asarray, tree),
                                    jnp.asarray(x), jnp.asarray(pos), return_kv=True)
    bp = layers.map_tree(torch.tensor, tree)
    t_y, t_kv = blocks.apply_block(cfg, "attn", bp, torch.tensor(x),
                                   torch.tensor(pos), return_kv=True)
    assert_close(t_y, r_y)
    for c in ("k", "v"):
        assert_close(t_kv[c], r_kv[c])


def _reference_server_module():
    spec = importlib.util.spec_from_file_location(
        "reference_serve_lm", ROOT / "examples" / "serve_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_server_generate_matches_reference_server():
    """Greedy tokens of the port's ``Server.generate`` on the CPU equal
    those of ``examples/serve_lm.py``'s ``Server`` on the same weights."""
    from repro_torch.serve_lm import Server

    rapi, api, rp, tp = both("llama3_2_1b")
    prompts = _tokens(api.cfg, (4, 24))
    want = _reference_server_module().Server(
        rapi.cfg, params=rp, cache_len=64).generate({"tokens": jnp.asarray(prompts)}, 12)
    got = Server(api.cfg, params=tp, cache_len=64, device="cpu").generate(
        {"tokens": prompts}, 12)
    assert got.tokens.shape == (4, 12) and got.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


def test_swap_adapter_matches_reference():
    from repro_torch.serve_lm import Server

    rapi, api, rp, tp = both("llama3_2_1b")
    rng = np.random.default_rng(3)
    u = np.zeros(api.cfg.padded_vocab, np.float32)
    u[:64] = 0.3
    v = rng.standard_normal(api.cfg.d_model).astype(np.float32) * 0.1
    ref_server = _reference_server_module().Server(rapi.cfg, params=rp, cache_len=32)
    ref_server.swap_adapter_rank_r(("embed",), jnp.asarray(u), jnp.asarray(v))
    server = Server(api.cfg, params=tp, cache_len=32, device="cpu")
    server.swap_adapter_rank_r(("embed",), u, v)
    np.testing.assert_array_equal(server.params["embed"].numpy(),
                                  np.asarray(ref_server.params["embed"]))
    with pytest.raises(ValueError, match="2-D"):
        server.swap_adapter_rank_r(("final_norm",), u, v)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trip(arch):
    _, api, rp, tp = both(arch, "reference")
    back = convert.tree_to_numpy(tp)
    ref_leaves = jax.tree.leaves_with_path(rp)
    got_leaves = jax.tree.leaves_with_path(back)
    assert [p for p, _ in got_leaves] == [p for p, _ in ref_leaves]
    for (_, g), (_, w) in zip(got_leaves, ref_leaves):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_parameter_count_matches_reference(arch):
    """Spec trees only, nothing allocated: llama3.2-1b has 1,236,338,688."""
    want = rregistry.build(ref_config(arch)).n_params()
    assert registry.build(get_config(arch)).n_params() == want
    if arch == "llama3_2_1b":
        assert want == 1_236_338_688


def test_init_follows_the_reference_scales():
    """The port's init draws every normal leaf at the reference's scale:
    1/√fan_in over the stacked shape (layer axis included), 0.02 for the
    embedding; norms are ones and biases zeros."""
    cfg = get_config("qwen2_1_5b").reduced()
    api = registry.build(cfg)
    tree = api.init(seed=0, device="cpu")
    for path, spec in layers.iter_specs(api.specs):
        t = tree
        for key in path:
            t = t[key]
        assert tuple(t.shape) == spec.shape and t.dtype == torch.float32
        if spec.init == "ones":
            assert torch.equal(t, torch.ones_like(t)), path
        elif spec.init == "zeros":
            assert torch.equal(t, torch.zeros_like(t)), path
        else:
            want = layers.init_scale(spec)
            assert abs(float(t.std()) / want - 1.0) < 0.1, (path, float(t.std()), want)
    # a seeded generator on the device: the same seed gives the same weights
    again = api.init(seed=0, device="cpu")
    assert torch.equal(again["layers"]["sub0"]["attn"]["wq"],
                       tree["layers"]["sub0"]["attn"]["wq"])


def test_convert_bf16_tree():
    """A bf16 reference pytree (numpy's extension dtype) arrives as bf16
    tensors, exactly, and comes back as float32 of the same values."""
    rcfg, cfg = ref_config("granite_3_2b").reduced(), get_config("granite_3_2b").reduced()
    tree = jax.tree.map(np.asarray, rregistry.build(rcfg).init(jax.random.PRNGKey(1),
                                                               jnp.bfloat16))
    params = convert.tree_from_numpy(tree, device="cpu")
    assert params["embed"].dtype == torch.bfloat16
    back = convert.tree_to_numpy(params)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w.astype(np.float32))
