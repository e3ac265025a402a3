"""The port's SSM and hybrid LMs ≡ the reference's, on the CPU: xlstm-1.3b
(mLSTM and sLSTM blocks) and jamba-v0.1-52b (Mamba blocks, a GQA layer a
period whose decode cache is a ring buffer of ``sliding_window`` slots, the
MoE MLP on every second layer).

Reduced configs (2 periods, d_model 64, jamba's window 32 and its MoE at
capacity factor 4, so nothing drops), float32, parameters drawn with numpy
in the reference's layout (every norm and bias perturbed) and carried into
both packages with ``convert.tree_from_numpy``; the reference's entry
points are jitted on the CPU.

* ``lm_loss`` and its gradient against ``jax.grad``: loss within 1e-5,
  every gradient leaf within 1e-4 of its largest magnitude.
* ``lm_prefill`` for prompts of 20, 32 and 40 tokens, then teacher-forced
  ``lm_decode`` steps up to position 46 (past jamba's 32 slots): the
  prefill's logits within 1e-5, every cache leaf and each decode step's
  logits within 1e-4.  Both packages compute the same float32 function,
  but behind jamba's seven Mamba layers their float32 roundings reach
  2e-5: after a prompt of 32 the attention layers' K cache is 2.0e-5 (the
  port) and 9.4e-6 (the reference) of its largest magnitude from the
  port's float64 run, 1.1e-5 from each other; at position 37 after a
  prompt of 20 the logits are 1.5e-5 and 1.8e-5 from float64, 3.1e-5
  from each other.  A prompt of 40 pins the reference's
  ring-buffer eviction, which the port keeps (``test_ring_buffer_eviction``).
* The port's own decode against its prefill over the extended prompt
  within the window (5e-3, ``tests/test_decode_consistency.py``'s bound);
  ``Server.generate`` against ``examples/serve_lm.py``'s ``Server``;
  jamba's Adafactor steps the reduced model; ``registry.build`` and
  ``n_params`` on the full configs.
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

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.models import registry as rregistry  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import layers, registry  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["xlstm_1_3b", "jamba_v0_1_52b"]
RTOL = 1e-5
CACHE_RTOL = 1e-4
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
B = 2
#: the last decode position of the cache tests: past jamba's 32 slots for
#: every prompt length
LAST_POS = 46
WINDOW = 32


def numpy_params(specs, seed: int) -> dict:
    """A parameter tree of the spec tree's shapes drawn with numpy: ones
    1 + 0.1·N, zeros 0.1·N, embeddings 0.02·N, matrices N / √fan_in (the
    stacked layer axis excluded; sLSTM's recurrence [H, dh, 4·dh] over
    dh)."""
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
        axes = spec.axes[1:] if spec.axes[0] == "layers" else spec.axes
        if axes[-1] == "embed":
            fan_in = int(np.prod(shape[:-1]))
        else:
            fan_in = shape[1] if axes[0] is None and len(shape) == 3 else shape[0]
        return x / np.float32(np.sqrt(fan_in))

    return layers.map_tree(leaf, specs)


@functools.lru_cache(maxsize=None)
def both(arch: str):
    """(reference api, port api, reference params, port params, jitted
    reference prefill and decode step), built once a module (no test
    writes into the parameters)."""
    rcfg, cfg = ref_config(arch).reduced(), get_config(arch).reduced()
    rapi, api = rregistry.build(rcfg), registry.build(cfg)
    tree = numpy_params(api.specs, seed=len(arch))
    return (rapi, api, jax.tree.map(jnp.asarray, tree),
            convert.tree_from_numpy(tree, device="cpu"),
            jax.jit(rapi.prefill, static_argnums=2), jax.jit(rapi.decode_step))


def tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def assert_close(got, want, rtol=RTOL, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


def assert_cache_close(got, want, rtol=RTOL, where=""):
    """Every leaf of every layer's cache: values, shape and dtype."""
    assert set(got) == set(want)
    for sub in want:
        assert set(got[sub]) == set(want[sub]), sub
        for c, w in want[sub].items():
            assert str(got[sub][c].dtype).split(".")[-1] == w.dtype.name, (sub, c)
            assert_close(got[sub][c], w, rtol, f"{where} {sub}.{c}")


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(arch):
    rapi, api, rp, tp, _, _ = both(arch)
    cfg = api.cfg
    rng = np.random.default_rng(1)
    labels = rng.integers(0, cfg.vocab_size, (B, 16)).astype(np.int32)
    labels[0, :3] = -1
    batch = {"tokens": tokens(cfg, (B, 16)), "labels": labels}
    (r_loss, r_metrics), r_grads = jax.jit(jax.value_and_grad(
        lambda p: rapi.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True))(rp)
    leaves, spec = pytree.tree_flatten(tp)
    xs = [p.detach().requires_grad_() for p in leaves]
    loss, metrics = api.loss(pytree.tree_unflatten(xs, spec), batch)
    grads = torch.autograd.grad(loss, xs)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert set(metrics) == set(r_metrics)
    for k in r_metrics:
        assert_close(metrics[k], r_metrics[k], LOSS_RTOL, k)
    want = jax.tree.leaves_with_path(r_grads)
    assert len(want) == len(grads)
    for g, (path, w) in zip(grads, want):
        assert_close(g, w, GRAD_RTOL, jax.tree_util.keystr(path))


@pytest.mark.parametrize("S", [20, WINDOW, 40])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, S):
    """Prefill into a cache of S + 16 (jamba's attention layers: min(S +
    16, 32) slots), then decode steps fed the same tokens up to LAST_POS."""
    rapi, api, rp, tp, r_prefill, r_decode = both(arch)
    toks = tokens(api.cfg, (B, S), seed=S)
    r_logits, r_cache = r_prefill(rp, {"tokens": jnp.asarray(toks)}, S + 16)
    t_logits, t_cache = api.prefill(tp, {"tokens": toks}, S + 16)
    assert t_logits.shape == (B, api.cfg.padded_vocab)
    assert_close(t_logits, r_logits, RTOL, "prefill")
    assert_cache_close(t_cache, r_cache, CACHE_RTOL, "prefill")
    if arch == "jamba_v0_1_52b":
        assert t_cache["sub3"]["k"].shape[3] == min(S + 16, WINDOW)
    fed = tokens(api.cfg, (B, LAST_POS + 1 - S), seed=S + 1)
    for i, pos in enumerate(range(S, LAST_POS + 1)):
        r_logits, r_cache = r_decode(rp, jnp.asarray(fed[:, i]), jnp.asarray(pos, jnp.int32),
                                     r_cache)
        t_logits, t_cache = api.decode_step(tp, fed[:, i], pos, t_cache)
        assert_close(t_logits, r_logits, CACHE_RTOL, f"decode {pos}")
    assert_cache_close(t_cache, r_cache, CACHE_RTOL, "decode")


def test_ring_buffer_eviction():
    """The reference's ring buffer, kept for parity (ROADMAP Queue 3): a
    prompt of S = 40 > W = 32 keeps positions 8…39 at slots 0…31, and the
    decode writes slot pos % W, so its first step (pos 40, slot 8)
    overwrites position S − W + (S mod W) = 16, not the oldest (8, slot
    0).  Both packages evict the same entry."""
    rapi, api, rp, tp, r_prefill, r_decode = both("jamba_v0_1_52b")
    S = 40
    toks = tokens(api.cfg, (B, S), seed=S)
    _, full = api.prefill(tp, {"tokens": toks}, S)        # no eviction yet: 32 slots
    _, t_cache = api.prefill(tp, {"tokens": toks}, S + 8)
    _, r_cache = r_prefill(rp, {"tokens": jnp.asarray(toks)}, S + 8)
    k0 = t_cache["sub3"]["k"].clone()                       # [periods, B, KV, 32, hd]
    r_k0 = np.asarray(r_cache["sub3"]["k"])
    assert torch.equal(k0, full["sub3"]["k"])
    fed = tokens(api.cfg, (B, 1), seed=7)
    _, t_cache = api.decode_step(tp, fed[:, 0], S, t_cache)
    _, r_cache = r_decode(rp, jnp.asarray(fed[:, 0]), jnp.asarray(S, jnp.int32), r_cache)
    k1 = t_cache["sub3"]["k"]
    changed = sorted({int(j) for j in torch.nonzero((k1 != k0).any(-1))[:, 3]})
    slot = S % WINDOW
    assert changed == [slot]
    evicted = S - WINDOW + slot                              # the position slot 8 held
    assert evicted == S - WINDOW + (S % WINDOW) == 16
    # slot j held position S - W + j: the oldest (8) survives at slot 0
    assert torch.equal(k1[:, :, :, 0], k0[:, :, :, 0])
    r_k1 = np.asarray(r_cache["sub3"]["k"])
    r_changed = sorted(set(np.nonzero(np.any(r_k1 != r_k0, -1))[3]))
    assert r_changed == [slot]
    assert_close(k1, r_k1, CACHE_RTOL, "k after the evicting step")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_prefill_within_the_window(arch):
    """Greedy decode steps after a prompt of 16 against the port's prefill
    over the extended prompt, up to 24 tokens (within jamba's window, where
    a ring buffer holds every position: beyond it the reference's prefill
    attends to all positions and its decode to the last W)."""
    _, api, _, tp, _, _ = both(arch)
    toks = torch.as_tensor(tokens(api.cfg, (B, 16)))
    logits, cache = api.prefill(tp, {"tokens": toks}, 40)
    tok, cur = logits.argmax(-1), toks
    for i in range(8):
        logits_d, cache = api.decode_step(tp, tok, 16 + i, cache)
        cur = torch.cat([cur, tok[:, None]], dim=1)
        logits_ref, _ = api.prefill(tp, {"tokens": cur})
        err = float((logits_d - logits_ref).abs().max())
        assert err < 5e-3, (arch, i, err)
        tok = logits_d.argmax(-1)


@pytest.mark.parametrize("arch", ARCHS)
def test_server_generate_matches_reference_server(arch):
    """Greedy tokens of ``Server.generate`` (its cache holds the SSM
    states; jamba's ring buffer wraps at 32) equal those of
    ``examples/serve_lm.py``'s ``Server`` on the same weights."""
    from repro_torch.serve_lm import Server

    rapi, api, rp, tp, _, _ = both(arch)
    spec = importlib.util.spec_from_file_location("reference_serve_lm",
                                                  ROOT / "examples" / "serve_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    prompts = tokens(api.cfg, (B, 24), seed=5)
    want = mod.Server(rapi.cfg, params=rp, cache_len=64).generate(
        {"tokens": jnp.asarray(prompts)}, 14)
    got = Server(api.cfg, params=tp, cache_len=64, device="cpu").generate(
        {"tokens": prompts}, 14)
    assert got.tokens.shape == (B, 14) and got.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


def test_jamba_adafactor_steps_the_reduced_model(tmp_path):
    """``run_training`` of the reduced jamba with its configured Adafactor:
    finite losses, every parameter moved (the reduced widths are below
    Adafactor's 128 for a factored slot: the full config's matrices get
    them, its Mamba and MoE matrices included)."""
    from repro_torch.launch.train import run_training
    from repro_torch.optim.optimizers import FactoredSlot, make_optimizer

    cfg = get_config("jamba_v0_1_52b").reduced()
    assert cfg.optimizer == "adafactor"
    api = registry.build(cfg)
    start = api.init(seed=0, device="cpu")
    opt = make_optimizer(cfg.optimizer, 1e-3)
    assert opt.name == "adafactor"
    # the full config's slots, from meta tensors of its spec tree
    full = registry.build(get_config("jamba_v0_1_52b")).specs
    slots = opt.init(layers.map_tree(lambda s: torch.empty(s.shape, device="meta"), full))
    factored = slots["v"]["layers"]["sub0"]
    assert isinstance(factored["mamba"]["in_proj"], FactoredSlot)
    assert isinstance(slots["v"]["layers"]["sub1"]["moe"]["w_gate"], FactoredSlot)
    params, history = run_training(cfg, steps=2, batch_size=2, seq_len=16, seed=0,
                                   log_every=0, device="cpu")
    assert len(history) == 2 and all(np.isfinite(h["loss"]) for h in history)
    moved = [not torch.equal(a, b) for a, b in zip(pytree.tree_leaves(params),
                                                  pytree.tree_leaves(start))]
    assert all(moved)


@pytest.mark.parametrize("arch,want", [("xlstm_1_3b", 2_625_259_712),
                                       ("jamba_v0_1_52b", 51_570_315_264)])
def test_full_and_reduced_configs_build(arch, want):
    """Spec trees only, nothing allocated: the full configs' counts are the
    reference's, and so are the reduced ones'."""
    api = registry.build(get_config(arch))
    assert api.n_params() == rregistry.build(ref_config(arch)).n_params() == want
    assert api.n_active_params() == rregistry.build(ref_config(arch)).n_active_params()
    small = registry.build(get_config(arch).reduced())
    assert small.n_params() == rregistry.build(ref_config(arch).reduced()).n_params()


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_cache_dtypes_match_reference(arch):
    """``init_cache`` in bf16: the attention cache and Mamba's conv state
    bf16, every other SSM state float32 (mLSTM's conv state too), at the
    reference's shapes (jamba's attention layer: min(seq, 32) slots)."""
    rapi, api, _, _, _, _ = both(arch)
    for seq in (16, 64):
        want = rapi.init_cache(B, seq, jnp.bfloat16)
        got = api.init_cache(B, seq, torch.bfloat16, device="cpu")
        assert set(got) == set(want)
        for sub in want:
            for c, w in want[sub].items():
                assert tuple(got[sub][c].shape) == w.shape, (sub, c)
                assert str(got[sub][c].dtype).split(".")[-1] == w.dtype.name, (sub, c)
                np.testing.assert_array_equal(got[sub][c].float().numpy(),
                                              np.asarray(w, np.float32))


@pytest.mark.parametrize("pos", [5, WINDOW - 1, WINDOW, 45])
def test_windowed_decode_attention_matches_reference(pos):
    """``decode_attention`` over a ring buffer of 32 slots (``window``):
    slots below min(pos + 1, 32) attended, as the reference's; and
    ``gqa_decode``'s slot ``pos % 32``."""
    from repro.models import attention as rattn
    from repro_torch.models import attention

    rng = np.random.default_rng(pos)
    q = rng.standard_normal((B, 4, 16)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, 2, WINDOW, 16)).astype(np.float32) for _ in range(2))
    want = rattn.decode_attention(*map(jnp.asarray, (q, kc, vc)), pos, window=WINDOW)
    got = attention.decode_attention(*map(torch.tensor, (q, kc, vc)), pos, window=WINDOW)
    assert_close(got, want, 1e-6)
    rapi, api, rp, tp, _, _ = both("jamba_v0_1_52b")
    x = rng.standard_normal((B, api.cfg.d_model)).astype(np.float32)
    p_ref = jax.tree.map(lambda a: a[0], rp["layers"]["sub3"]["attn"])
    p = {k: v[0] for k, v in tp["layers"]["sub3"]["attn"].items()}
    cache = {"k": kc, "v": vc}
    y_want, c_want = rattn.gqa_decode(rapi.cfg, p_ref, jnp.asarray(x),
                                      jax.tree.map(jnp.asarray, cache), pos, window=WINDOW)
    y, c = attention.gqa_decode(api.cfg, p, torch.tensor(x),
                                {k: torch.tensor(a) for k, a in cache.items()}, pos,
                                window=WINDOW)
    assert_close(y, y_want, 1e-5)
    for k in cache:
        assert_close(c[k], c_want[k], 1e-6, k)
        changed = sorted(set(np.nonzero(np.any(c[k].numpy() != cache[k], -1))[2]))
        assert changed == [pos % WINDOW]
