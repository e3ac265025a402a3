"""The port's MLA attention and deepseek-v3-671b ≡ the reference's, on the CPU.

The same numpy inputs go through both packages; parameters are drawn with
numpy (norms 1 + 0.1·N, matrices N / √fan_in) and moved into the port with
``convert.tree_from_numpy``.  Cases:

* ``mla_specs`` of the full and the reduced config: shapes and axes;
* ``mla_forward`` (output, and the cache entries of ``return_kv``) and the
  absorbed ``mla_decode`` at three positions, reduced config, float32;
* ``flash_attention`` at MLA's head-dim pairs (q/k 16, v 8: the reduced
  config; q/k 192, v 128: the full one), causal and not, T 24–64, through
  the kernel wrapper's plain version and the model's CPU branch, against
  the reference's ``flash_attention_jnp``; a pair no kernel takes raises;
* deepseek-v3-671b's reduced config through ``registry.build``: parameter
  counts (reduced and full), the prefill's logits and cache, three decode
  steps fed the same tokens, ``lm_loss`` with its MTP term under
  ``torch.no_grad()`` (its gradients: ``tests/test_torch_mla_train.py``).

Tolerances: float32 outputs within 1e-5 of their largest magnitude (the
tolerance of ``tests/test_torch_lm.py``: the same function, its products
summed in another order), the attention alone within 1e-6 (one softmax,
no projections around it).  The reduced config's MoE (capacity factor 4.0)
drops nothing, so routing is the same function in both.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402

_torch_parity.cap_torch_threads()
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import registry as rregistry  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.models import attention, layers, registry  # noqa: E402

ARCH = "deepseek_v3_671b"
RTOL = 1e-5
FLASH_RTOL = 1e-6
S = 16


def assert_close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= rtol * scale, (err, scale)


def numpy_params(specs, seed: int) -> dict:
    """A tree of the spec tree's shapes drawn with numpy: norms 1 + 0.1·N,
    embeddings 0.02·N, matrices N / √fan_in (the per-layer input width)."""
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


def configs():
    return ref_config(ARCH).reduced(), get_config(ARCH).reduced()


@pytest.mark.parametrize("reduced", [False, True])
def test_mla_specs_match_reference(reduced):
    rcfg, cfg = ref_config(ARCH), get_config(ARCH)
    if reduced:
        rcfg, cfg = rcfg.reduced(), cfg.reduced()
    want = rattn.mla_specs(rcfg)
    got = attention.mla_specs(cfg)
    assert sorted(got) == sorted(want)
    for name, spec in want.items():
        assert (got[name].shape, got[name].axes, got[name].init) == (
            spec.shape, spec.axes, spec.init), name


def _module_inputs(T: int = S):
    rcfg, cfg = configs()
    tree = numpy_params(attention.mla_specs(cfg), seed=3)
    x = np.random.default_rng(4).standard_normal((2, T, cfg.d_model), dtype=np.float32)
    return rcfg, cfg, tree, x


def test_mla_forward_matches_reference():
    rcfg, cfg, tree, x = _module_inputs()
    pos = np.arange(S)[None, :]
    r_y, (r_c, r_kr) = rattn.mla_forward(rcfg, jax.tree.map(jnp.asarray, tree),
                                         jnp.asarray(x), jnp.asarray(pos), return_kv=True)
    p = convert.tree_from_numpy(tree, device="cpu")
    t_y, (t_c, t_kr) = attention.mla_forward(cfg, p, torch.tensor(x), torch.tensor(pos),
                                             return_kv=True)
    assert_close(t_y, r_y)
    assert_close(t_c, r_c)
    assert_close(t_kr, r_kr)
    assert_close(attention.mla_forward(cfg, p, torch.tensor(x), torch.tensor(pos)), r_y)


def test_mla_decode_matches_reference_at_three_positions():
    """The prefill's cache padded to S + 3, then three absorbed decode steps
    at positions S, S + 1, S + 2: outputs and both cache entries."""
    rcfg, cfg, tree, x = _module_inputs(S + 3)
    pos = np.arange(S)[None, :]
    rp = jax.tree.map(jnp.asarray, tree)
    p = convert.tree_from_numpy(tree, device="cpu")
    _, (c, kr) = rattn.mla_forward(rcfg, rp, jnp.asarray(x[:, :S]), jnp.asarray(pos),
                                   return_kv=True)
    pad = ((0, 0), (0, 3), (0, 0))
    r_cache = {"c_kv": jnp.pad(c, pad), "k_rope": jnp.pad(kr, pad)}
    t_cache = {name: torch.tensor(np.asarray(a)) for name, a in r_cache.items()}
    assert {n: t.shape for n, t in t_cache.items()} == {
        n: t.shape for n, t in attention.mla_init_cache(cfg, 2, S + 3, torch.float32,
                                                        "cpu").items()}
    for i in range(3):
        r_y, r_cache = rattn.mla_decode(rcfg, rp, jnp.asarray(x[:, S + i]), r_cache,
                                        jnp.asarray(S + i, jnp.int32))
        t_y, t_cache = attention.mla_decode(cfg, p, torch.tensor(x[:, S + i]), t_cache,
                                            S + i)
        assert_close(t_y, r_y)
        for name in ("c_kv", "k_rope"):
            assert_close(t_cache[name], r_cache[name])


def _qkv(seed, B, H, T, D, Dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, T, D)).astype(np.float32),
            rng.standard_normal((B, H, T, D)).astype(np.float32),
            rng.standard_normal((B, H, T, Dv)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,T,D,Dv", [(2, 4, 24, 16, 8), (1, 4, 64, 16, 8),
                                        (1, 2, 40, 192, 128), (2, 2, 64, 192, 128)])
def test_flash_attention_at_mla_pairs_matches_reference(B, H, T, D, Dv, causal):
    """The kernel wrapper (its plain version on CPU tensors) and the model's
    CPU branch: [B, H, T, Dv] within 1e-6 of ``flash_attention_jnp``."""
    q, k, v = _qkv(T + D + Dv, B, H, T, D, Dv)
    want = np.asarray(rattn.flash_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                                jnp.asarray(v), causal=causal))
    assert want.shape == (B, H, T, Dv)
    tq, tk, tv = map(torch.tensor, (q, k, v))
    assert_close(tflash.flash_attention(tq, tk, tv, causal=causal), want, FLASH_RTOL)
    assert_close(attention.flash_attention(tq, tk, tv, causal=causal), want, FLASH_RTOL)


@pytest.mark.parametrize("dtype,D,Dv,want", [
    (torch.bfloat16, 192, 128, "wgmma"), (torch.float32, 192, 128, "tf32"),
    (torch.bfloat16, 16, 8, "mma"), (torch.float32, 16, 8, "mma"),
    (torch.bfloat16, 128, 128, "wgmma"), (torch.float32, 64, None, "tf32")])
def test_variant_takes_the_pair(dtype, D, Dv, want):
    assert tflash.variant(dtype, D, Dv) == want
    assert (D, D if Dv is None else Dv) in tflash.PAIRS


@pytest.mark.parametrize("D,Dv", [(64, 32), (192, 64), (128, 192), (16, 16 + 8)])
def test_unsupported_pair_raises(D, Dv):
    q, k, v = map(torch.tensor, _qkv(0, 1, 2, 8, D, Dv))
    with pytest.raises(ValueError, match=f"q/k {D}, v {Dv}"):
        tflash.flash_attention(q, k, v)


def test_simt_and_backward_refuse_mla_pairs():
    """The SIMT forward kernel by name takes D = Dv only, and the SIMT
    backward by name every pair but (192, 128) (before any launch); the
    backward's own routes take both MLA pairs
    (``tests/test_torch_mla_train.py``)."""
    q, k, v = map(torch.tensor, _qkv(1, 1, 2, 8, 16, 8))
    with pytest.raises(ValueError, match="simt kernel takes D = Dv"):
        tflash.launch("simt", q, k, v)
    q, k, v = map(torch.tensor, _qkv(1, 1, 2, 8, 192, 128))
    o = tflash.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="simt backward does not take"):
        tflash.bwd_launch("simt", q, k, v, o, o)


def _both(seed: int = 5):
    rcfg, cfg = configs()
    rapi, api = rregistry.build(rcfg), registry.build(cfg)
    tree = numpy_params(api.specs, seed=seed)
    return rapi, api, jax.tree.map(jnp.asarray, tree), convert.tree_from_numpy(
        tree, device="cpu")


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("reduced", [False, True])
def test_parameter_counts_match_reference(reduced):
    """Spec trees only: the full config has 715,411,535,872 parameters,
    38,141,106,176 active a token."""
    rcfg, cfg = ref_config(ARCH), get_config(ARCH)
    if reduced:
        rcfg, cfg = rcfg.reduced(), cfg.reduced()
    rapi, api = rregistry.build(rcfg), registry.build(cfg)
    assert api.n_params() == rapi.n_params()
    assert api.n_active_params() == rapi.n_active_params()
    if not reduced:
        assert (api.n_params(), api.n_active_params()) == (715_411_535_872, 38_141_106_176)


def _assert_cache_close(got, want):
    assert set(got) == set(want)
    for sub in want:
        assert set(got[sub]) == set(want[sub]) == {"c_kv", "k_rope"}
        for name in want[sub]:
            assert_close(got[sub][name], want[sub][name])


def test_prefill_and_decode_match_reference():
    """The reduced deepseek's prefill (logits over the padded vocab, the
    latent cache padded to S + 8) and three decode steps fed the same
    tokens."""
    rapi, api, rp, tp = _both()
    toks = _tokens(api.cfg, (2, S))
    fed = _tokens(api.cfg, (2, 3), seed=1)
    r_logits, r_cache = rapi.prefill(rp, {"tokens": jnp.asarray(toks)}, S + 8)
    with torch.no_grad():
        t_logits, t_cache = api.prefill(tp, {"tokens": toks}, S + 8)
    assert t_logits.shape == (2, api.cfg.padded_vocab)
    assert_close(t_logits, r_logits)
    _assert_cache_close(t_cache, r_cache)
    for i in range(3):
        r_logits, r_cache = rapi.decode_step(rp, jnp.asarray(fed[:, i]),
                                             jnp.asarray(S + i, jnp.int32), r_cache)
        with torch.no_grad():
            t_logits, t_cache = api.decode_step(tp, fed[:, i], S + i, t_cache)
        assert_close(t_logits, r_logits)
        _assert_cache_close(t_cache, r_cache)


def test_loss_with_mtp_matches_reference():
    rapi, api, rp, tp = _both(seed=6)
    toks = _tokens(api.cfg, (2, S + 1), seed=2)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1  # masked positions
    batch = {"tokens": toks[:, :-1], "labels": labels}
    r_loss, r_metrics = rapi.loss(rp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        t_loss, t_metrics = api.loss(tp, batch)
    assert set(t_metrics) == set(r_metrics) == {"loss", "tokens", "mtp_loss"}
    assert_close(t_loss, r_loss)
    assert_close(t_metrics["mtp_loss"], r_metrics["mtp_loss"])
    assert float(t_metrics["tokens"]) == float(r_metrics["tokens"])


def test_server_generates_with_deepseek_reduced():
    """``Server.generate`` on the CPU: the port's own decode, step by step,
    equals its prefill over the extended prompt (greedy tokens), and the
    logits stay finite."""
    from repro_torch.serve_lm import Server

    cfg = get_config(ARCH).reduced()
    server = Server(cfg, cache_len=S + 4, seed=0, device="cpu")
    prompts = _tokens(cfg, (2, S))
    res = server.generate({"tokens": prompts}, 4)
    assert res.tokens.shape == (2, 4) and res.tokens.dtype == np.int32
    seq = torch.as_tensor(prompts).long()
    with torch.no_grad():
        for i in range(4):
            logits, _ = server.api.prefill(server.params, {"tokens": seq})
            assert bool(torch.isfinite(logits).all())
            np.testing.assert_array_equal(logits.argmax(-1).numpy(), res.tokens[:, i])
            seq = torch.cat([seq, torch.as_tensor(res.tokens[:, i:i + 1]).long()], dim=1)
