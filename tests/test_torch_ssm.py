"""The port's SSM blocks (``repro_torch.models.ssm``) ≡ the reference's
``repro.models.ssm``, function by function, on the CPU.

Mamba at the reduced jamba-v0.1-52b (d_model 64, d_inner 128, d_state 4,
conv 4, chunk 8), mLSTM and sLSTM at the reduced xlstm-1.3b (d_model 64, 4
heads), float32.  The same seeded numpy inputs and weights go to both
packages (weights through ``convert.tree_from_numpy``); every norm, bias
and gate bias is perturbed, so that none of them is a no-op.

Tolerances, of the largest magnitude of the reference's output:

* one step (``_conv1d_step``, ``_slstm_step``, the ``*_decode``
  functions): 1e-6.  Both packages compute the same float32 function, a
  handful of roundings deep.
* the chunked scans and whole blocks: 1e-5.  The chunked scans run at S =
  12 with chunk 8, which the chunk rule cuts to chunks of 4.  Mamba's scan
  inside a chunk is a doubling scan where the reference takes
  ``lax.associative_scan``: the same products and sums, associated in
  another order, so float32 rounding differs at ~1e-7.
* decode after forward equal to forward, the reference's own 2e-3
  (``tests/test_ssm.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402

_torch_parity.cap_torch_threads()
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.models import blocks as rblocks  # noqa: E402
from repro.models import ssm as rssm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import blocks, layers, ssm  # noqa: E402

STEP_RTOL = 1e-6
SCAN_RTOL = 1e-5
DECODE_RTOL = 2e-3
B, S, CHUNK = 2, 12, 8
ARCH = {"mamba": "jamba_v0_1_52b", "mlstm": "xlstm_1_3b", "slstm": "xlstm_1_3b"}
SPECS = {"mamba": "mamba_specs", "mlstm": "mlstm_specs", "slstm": "slstm_specs"}
FORWARD = {"mamba": "mamba_forward", "mlstm": "mlstm_forward", "slstm": "slstm_forward"}
DECODE = {"mamba": "mamba_decode", "mlstm": "mlstm_decode", "slstm": "slstm_decode"}


def configs(kind: str):
    return ref_config(ARCH[kind]).reduced(), get_config(ARCH[kind]).reduced()


def assert_close(got, want, rtol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    scale = float(np.abs(want).max())
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= rtol * scale, (what, err, scale)


def assert_states_close(got: dict, want: dict, rtol):
    assert set(got) == set(want)
    for c in want:
        assert_close(got[c], want[c], rtol, c)


def numpy_params(specs, seed: int) -> dict:
    """Weights of the spec tree's shapes drawn with numpy: norms and other
    ones 1 + 0.1·N, zeros 0.1·N, matrices N / √fan_in with fan_in the
    second-last axis (a tensor's input axis in every SSM spec)."""
    rng = np.random.default_rng(seed)

    def leaf(spec):
        x = rng.standard_normal(spec.shape, dtype=np.float32)
        if spec.init == "ones":
            return 1.0 + 0.1 * x
        if spec.init == "zeros":
            return 0.1 * x
        return x / np.float32(np.sqrt(spec.shape[-2]))

    return layers.map_tree(leaf, specs)


def both(tree):
    """(reference pytree, port tree) of one numpy tree."""
    return jax.tree.map(jnp.asarray, tree), convert.tree_from_numpy(tree, device="cpu")


def normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def random_state(kind: str, cfg, rng) -> dict:
    """A decode state of ``kind`` with random values (m finite)."""
    st = {c: t.numpy() for c, t in
          {"mamba": lambda: ssm.mamba_init_state(cfg, B, torch.float32, "cpu"),
           "mlstm": lambda: ssm.mlstm_init_state(cfg, B, device="cpu"),
           "slstm": lambda: ssm.slstm_init_state(cfg, B, device="cpu")}[kind]().items()}
    return {c: normal(rng, *a.shape, scale=0.5) for c, a in st.items()}


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_specs_match_reference(kind):
    rcfg, cfg = configs(kind)
    want = getattr(rssm, SPECS[kind])(rcfg)
    got = getattr(ssm, SPECS[kind])(cfg)
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert (g.shape, g.axes, g.init, g.scale) == (w.shape, w.axes, w.init, w.scale), name


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_init_states_match_reference(kind):
    """Names, shapes, dtypes and values (m at −1e30) of the zero states;
    Mamba's conv state has the activation dtype, every other leaf float32."""
    rcfg, cfg = configs(kind)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = {"mamba": lambda: rssm.mamba_init_state(rcfg, B, jdtype),
                "mlstm": lambda: rssm.mlstm_init_state(rcfg, B),
                "slstm": lambda: rssm.slstm_init_state(rcfg, B)}[kind]()
        got = {"mamba": ssm.mamba_init_state, "mlstm": ssm.mlstm_init_state,
               "slstm": ssm.slstm_init_state}[kind](cfg, B, dtype, "cpu")
        assert set(got) == set(want)
        for c, w in want.items():
            assert str(got[c].dtype).split(".")[-1] == w.dtype.name, (c, got[c].dtype)
            np.testing.assert_array_equal(got[c].float().numpy(), np.asarray(w, np.float32))


def test_causal_conv1d_and_step_match_reference():
    rng = np.random.default_rng(0)
    x, w, b = normal(rng, B, S, 16), normal(rng, 4, 16), normal(rng, 16)
    assert_close(ssm._causal_conv1d(*map(torch.tensor, (x, w, b))),
                 rssm._causal_conv1d(*map(jnp.asarray, (x, w, b))), STEP_RTOL)
    st = normal(rng, B, 3, 16)
    got = ssm._conv1d_step(*map(torch.tensor, (x[:, 0], st, w, b)))
    want = rssm._conv1d_step(*map(jnp.asarray, (x[:, 0], st, w, b)))
    for g, v in zip(got, want):
        assert_close(g, v, STEP_RTOL)


@pytest.mark.parametrize("chunk", [CHUNK, 5, S])
def test_mamba_scan_matches_reference(chunk):
    """At S = 12: chunk 8 runs chunks of 4, chunk 5 chunks of 2, chunk 12
    one chunk; also against the recurrence in float64."""
    rng = np.random.default_rng(1)
    di, N = 6, 4
    a = np.exp(-np.abs(normal(rng, B, S, di, N)))
    b, Cp, h0 = normal(rng, B, S, di, N), normal(rng, B, S, N), normal(rng, B, di, N)
    h_got, y_got = ssm._mamba_scan(*map(torch.tensor, (a, b, Cp, h0)), chunk)
    h_want, y_want = rssm._mamba_scan(*map(jnp.asarray, (a, b, Cp, h0)), chunk)
    assert_close(h_got, h_want, SCAN_RTOL)
    assert_close(y_got, y_want, SCAN_RTOL)
    h, ys = h0.astype(np.float64), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        ys.append(np.einsum("bdn,bn->bd", h, Cp[:, t]))
    assert_close(y_got.double(), np.stack(ys, 1), SCAN_RTOL)
    assert_close(h_got.double(), h, SCAN_RTOL)


def mlstm_inputs(rng, L=S, dh=8, H=3):
    q, k, v = (normal(rng, B, H, L, dh) for _ in range(3))
    logi = normal(rng, B, H, L, scale=0.5)
    logf = np.log(1.0 / (1.0 + np.exp(-normal(rng, B, H, L)))).astype(np.float32)
    state = (normal(rng, B, H, dh, dh, scale=0.5), normal(rng, B, H, dh, scale=0.5),
             normal(rng, B, H, scale=0.5))
    return q, k, v, logi, logf, state


def test_mlstm_chunk_matches_reference():
    """One chunk from a carried (random) state."""
    q, k, v, logi, logf, state = mlstm_inputs(np.random.default_rng(2), L=4)
    h_got, st_got = ssm._mlstm_chunk(*map(torch.tensor, (q, k, v, logi, logf)),
                                     tuple(map(torch.tensor, state)))
    h_want, st_want = rssm._mlstm_chunk(*map(jnp.asarray, (q, k, v, logi, logf)),
                                        tuple(map(jnp.asarray, state)))
    assert_close(h_got, h_want, SCAN_RTOL)
    for g, w in zip(st_got, st_want):
        assert_close(g, w, SCAN_RTOL)


@pytest.mark.parametrize("carried", [False, True])
def test_mlstm_cell_matches_reference_and_sequential(carried):
    """The chunked cell at S = 12, chunk 8 (chunks of 4), and the
    sequential cell, each against the reference's, from zero (m −1e30) or
    a carried state; the chunked form against the sequential one within
    the reference's own 1e-3."""
    q, k, v, logi, logf, state = mlstm_inputs(np.random.default_rng(3))
    if not carried:
        state = (np.zeros_like(state[0]), np.zeros_like(state[1]),
                 np.full_like(state[2], -1e30))
    args_t = (*map(torch.tensor, (q, k, v, logi, logf)), tuple(map(torch.tensor, state)))
    args_j = (*map(jnp.asarray, (q, k, v, logi, logf)), tuple(map(jnp.asarray, state)))
    h_c, st_c = ssm.mlstm_cell(*args_t, CHUNK)
    h_s, st_s = ssm.mlstm_cell_sequential(*args_t)
    for (got_h, got_st), (want_h, want_st) in (
            ((h_c, st_c), rssm.mlstm_cell(*args_j, CHUNK)),
            ((h_s, st_s), rssm.mlstm_cell_sequential(*args_j))):
        assert_close(got_h, want_h, SCAN_RTOL)
        for g, w in zip(got_st, want_st):
            assert_close(g, w, SCAN_RTOL)
    np.testing.assert_allclose(h_c.numpy(), h_s.numpy(), rtol=1e-3, atol=1e-3)


def test_slstm_step_matches_reference():
    rcfg, cfg = configs("slstm")
    rng = np.random.default_rng(4)
    tree = numpy_params(ssm.slstm_specs(cfg), seed=5)
    rp, tp = both(tree)
    st = random_state("slstm", cfg, rng)
    xw = normal(rng, B, 4 * cfg.d_model)
    keys = ("c", "n", "h", "m")
    got = ssm._slstm_step(cfg, tp, tuple(torch.tensor(st[c]) for c in keys),
                          torch.tensor(xw))
    want = rssm._slstm_step(rcfg, rp, tuple(jnp.asarray(st[c]) for c in keys),
                            jnp.asarray(xw))
    for c, g, w in zip(keys, got, want):
        assert_close(g, w, STEP_RTOL, c)


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_decode_matches_reference(kind):
    """One ``*_decode`` step from a random state: output and new state."""
    rcfg, cfg = configs(kind)
    rng = np.random.default_rng(6)
    rp, tp = both(numpy_params(getattr(ssm, SPECS[kind])(cfg), seed=7))
    st = random_state(kind, cfg, rng)
    x = normal(rng, B, cfg.d_model)
    y, new = getattr(ssm, DECODE[kind])(
        cfg, tp, torch.tensor(x), {c: torch.tensor(a) for c, a in st.items()})
    y_want, new_want = getattr(rssm, DECODE[kind])(
        rcfg, rp, jnp.asarray(x), {c: jnp.asarray(a) for c, a in st.items()})
    assert_close(y, y_want, STEP_RTOL)
    assert_states_close(new, new_want, STEP_RTOL)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_forward_matches_reference(kind, carried):
    """``*_forward`` over S = 12 (the chunked scans at chunks of 4), from
    the zero state (None) or a carried random one: output and final state."""
    rcfg, cfg = configs(kind)
    rng = np.random.default_rng(8)
    rp, tp = both(numpy_params(getattr(ssm, SPECS[kind])(cfg), seed=9))
    x = normal(rng, B, S, cfg.d_model)
    st = random_state(kind, cfg, rng) if carried else None
    y, new = getattr(ssm, FORWARD[kind])(
        cfg, tp, torch.tensor(x), st and {c: torch.tensor(a) for c, a in st.items()})
    y_want, new_want = getattr(rssm, FORWARD[kind])(
        rcfg, rp, jnp.asarray(x), st and {c: jnp.asarray(a) for c, a in st.items()})
    assert_close(y, y_want, SCAN_RTOL)
    assert_states_close(new, new_want, SCAN_RTOL)


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_block_decode_equals_forward(kind):
    """As the reference's test: feeding tokens one at a time through
    ``*_decode`` equals the full-sequence ``*_forward``, output and state,
    within its 2e-3 (weights from the port's own init)."""
    _, cfg = configs(kind)
    gen = torch.Generator().manual_seed(3)
    p = layers.init_from_spec(getattr(ssm, SPECS[kind])(cfg), gen)
    x = torch.tensor(normal(np.random.default_rng(2), B, S, cfg.d_model, scale=0.5))
    y_full, st_full = getattr(ssm, FORWARD[kind])(cfg, p, x)
    st = None
    ys = []
    for t in range(S):
        if st is None:
            st = {"mamba": lambda: ssm.mamba_init_state(cfg, B, x.dtype, "cpu"),
                  "mlstm": lambda: ssm.mlstm_init_state(cfg, B, device="cpu"),
                  "slstm": lambda: ssm.slstm_init_state(cfg, B, device="cpu")}[kind]()
        y, st = getattr(ssm, DECODE[kind])(cfg, p, x[:, t], st)
        ys.append(y)
    torch.testing.assert_close(torch.stack(ys, 1), y_full, rtol=DECODE_RTOL, atol=DECODE_RTOL)
    for c in st_full:
        torch.testing.assert_close(st[c], st_full[c], rtol=DECODE_RTOL, atol=DECODE_RTOL)


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_blocks_match_reference(kind):
    """``blocks.apply_block`` (jamba's Mamba block: ln1, the mixer, ln2 and
    the dense MLP; xLSTM's blocks: the mixer alone) and ``decode_block``
    against the reference's, spec trees equal."""
    rcfg, cfg = configs(kind)
    specs = blocks.block_specs(cfg, kind, 0)
    want_specs = rblocks.block_specs(rcfg, kind, 0)
    assert jax.tree.structure(jax.tree.map(lambda s: 0, want_specs,
                                           is_leaf=lambda s: hasattr(s, "axes"))) == \
        jax.tree.structure(layers.map_tree(lambda s: 0, specs))
    assert set(specs) == ({"ln1", "mamba", "ln2", "mlp"} if kind == "mamba" else {kind})
    rng = np.random.default_rng(10)
    rp, tp = both(numpy_params(specs, seed=11))
    x = normal(rng, B, S, cfg.d_model)
    pos = np.arange(S)[None, :]
    y, st = blocks.apply_block(cfg, kind, tp, torch.tensor(x), torch.tensor(pos))
    y_want, st_want = rblocks.apply_block(rcfg, kind, rp, jnp.asarray(x), jnp.asarray(pos))
    assert_close(y, y_want, SCAN_RTOL)
    assert_states_close(st, st_want, SCAN_RTOL)
    xd = normal(rng, B, cfg.d_model)
    yd, std = blocks.decode_block(cfg, kind, tp, torch.tensor(xd), S, state=st)
    yd_want, std_want = rblocks.decode_block(rcfg, kind, rp, jnp.asarray(xd), S,
                                             state=st_want)
    assert_close(yd, yd_want, SCAN_RTOL)
    assert_states_close(std, std_want, SCAN_RTOL)


def test_bf16_mlstm_conv_state_is_written_into_the_float32_cache_exactly():
    """``mlstm_decode`` returns its new conv state in the activation dtype
    (bf16), as the reference's does; ``lm_decode`` writes it into the
    cache's float32 leaf in place, where the bf16 values are exact.  The
    cache after one step of the reduced xlstm in bf16 holds exactly the
    step's own bf16 conv states, and keeps the reference's dtypes."""
    import dataclasses

    from repro_torch.models import lm, registry

    cfg = dataclasses.replace(get_config("xlstm_1_3b").reduced(), act_dtype="bfloat16",
                              param_dtype="bfloat16")
    api = registry.build(cfg)
    params = api.init(seed=0, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, 8))
    _, cache = api.prefill(params, {"tokens": toks})
    assert cache["sub0"]["conv"].dtype == torch.float32           # mLSTM
    assert cache["sub1"]["c"].dtype == torch.float32              # sLSTM
    before = {c: t[0].clone() for c, t in cache["sub0"].items()}
    x = lm._embed(cfg, params, torch.as_tensor(toks[:, 0]))
    _, own = ssm.mlstm_decode(cfg, lm.layer_params(cfg, params)[0]["mlstm"], x, before)
    assert own["conv"].dtype == torch.bfloat16
    _, cache = api.decode_step(params, toks[:, 0], 8, cache)
    assert cache["sub0"]["conv"].dtype == torch.float32
    assert torch.equal(cache["sub0"]["conv"][0], own["conv"].float())
    assert torch.equal(cache["sub0"]["C"][0], own["C"])
