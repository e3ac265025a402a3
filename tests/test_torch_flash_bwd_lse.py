"""L from the forward, taken by the backward where ``lse_route`` holds, on
the CPU.

On the card the bf16 forward (``csrc/flash_attention_wgmma.cu``) at (64,
64), (128, 128) and (192, 128), and the float32 forward
(``csrc/flash_attention_tf32.cu``) at (64, 64) and (128, 128), also write
L, each row's logsumexp in base 2 of the scaled, masked scores, and
``FlashAttentionFn`` hands it to the backward (``csrc/
flash_attention_bwd_wgmma.cu``, ``csrc/flash_attention_bwd_tf32.cu``),
whose dq kernel then drops the pass that computes L.  The kernels run only
on the card; here their plain versions, at small shapes (T 17–40, not a
multiple of 64; G 1 and 2; causal and not), on the same numpy inputs:

* the plain L (``ref.flash_attention_lse_ref``) at (64, 64), (128, 128),
  (192, 128) and (16, 8) against ``jax.nn.logsumexp`` of the reference's
  scaled, masked scores (``flash_attention_jnp``'s: q kᵀ / √D, -1e30 above
  the diagonal) over ln 2, in float32, within 1e-6 of L's largest
  magnitude;
* the backward given L against the backward without it: the bf16 route
  through ``flash_attention_bwd`` (its plain version) at the wgmma pairs,
  the float32 route the same way at (64, 64) and (128, 128), and the
  float32 plain version ``ref.flash_attention_bwd_ref`` directly at every
  pair.  L given is the same number through one more float32 rounding
  (base 2 and back), so P moves by a few float32 roundings: float32 outputs
  within 1e-6 of their largest magnitude; bf16 ones within 2⁻⁸ (one bf16
  rounding of the largest magnitude, where P or dS crosses a rounding
  boundary), and both within 1e-2 of float64;
* ``FlashAttentionFn`` (it asks the forward for L and hands it to the
  backward) against ``jax.vjp`` of ``flash_attention_jnp``: in bf16 at the
  wgmma pairs within 1e-2 plus the reference's own error of float64, and
  within 1e-2 of float64 (``tests/test_torch_flash_bwd.py``'s limits); in
  float32 at (64, 64) and (128, 128) within 1e-5 of each output's largest
  magnitude (float32 sums in another order);
* what takes L and what does not: ``lse_route``, ``return_lse`` and
  ``lse=`` refused elsewhere, and an L of the wrong shape refused.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402

_torch_parity.cap_torch_threads()
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.models import attention as rattn  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

#: (B, H, Hkv, T, D, Dv, causal): MLA's full pair with a few narrow heads,
#: its reduced pair, and the wgmma and tf32 routes' D = Dv pairs, G 1 and 2,
#: T never a multiple of 64
SHAPES = [(1, 2, 2, 20, 192, 128, True), (1, 2, 2, 20, 192, 128, False),
          (1, 4, 2, 33, 192, 128, True), (2, 2, 1, 40, 192, 128, False),
          (2, 4, 4, 24, 16, 8, True), (1, 4, 2, 17, 16, 8, False),
          (1, 2, 2, 20, 64, 64, True), (1, 4, 2, 33, 64, 64, False),
          (2, 2, 1, 40, 128, 128, True), (1, 4, 2, 17, 128, 128, False)]
#: the shapes where bf16 takes L (the wgmma pairs) and where float32 does
#: (the tf32 route's D = Dv pairs)
BF16_LSE = [s for s in SHAPES if tflash.lse_route(torch.bfloat16, s[4], s[5])]
F32_LSE = [s for s in SHAPES if tflash.lse_route(torch.float32, s[4], s[5])]
#: each output within this of its largest magnitude (float64, jax.vjp)
RTOL = 1e-2


def _inputs(seed, B, H, Hkv, T, D, Dv):
    """q, k, v, dO as float32 numpy arrays holding bf16 values."""
    rng = np.random.default_rng(seed + T + D + H)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, H, T, D), (B, Hkv, T, D), (B, Hkv, T, Dv), (B, H, T, Dv))]
    return [np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
            for a in arrs]


def _err(got, want) -> float:
    """max |got − want| over max |want|."""
    got, want = (x.double() if isinstance(x, torch.Tensor)
                 else torch.as_tensor(np.asarray(x, np.float64)) for x in (got, want))
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("B,H,Hkv,T,D,Dv,causal", SHAPES)
def test_plain_lse_matches_jax_logsumexp(B, H, Hkv, T, D, Dv, causal):
    q, k, v, _ = _inputs(0, B, H, Hkv, T, D, Dv)
    got = ref.flash_attention_lse_ref(*(torch.tensor(a) for a in (q, k, v)), causal=causal)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, T)
    kr = jnp.repeat(jnp.asarray(k), H // Hkv, axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), kr) * (1.0 / math.sqrt(D))
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((T, T), bool)), s, rattn.NEG_INF)
    want = np.asarray(jax.nn.logsumexp(s, axis=-1) / math.log(2.0))
    assert _err(got, want) <= 1e-6


@pytest.mark.parametrize("B,H,Hkv,T,D,Dv,causal", BF16_LSE)
def test_bf16_backward_with_lse_equals_without(B, H, Hkv, T, D, Dv, causal):
    q, k, v, do = (torch.tensor(a).to(torch.bfloat16)
                   for a in _inputs(1, B, H, Hkv, T, D, Dv))
    o, lse = tflash.flash_attention(q, k, v, causal, return_lse=True)
    assert torch.equal(o, tflash.flash_attention(q, k, v, causal))
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (B, H, T)
    with_lse = tflash.flash_attention_bwd(q, k, v, o, do, causal, lse=lse)
    without = tflash.flash_attention_bwd(q, k, v, o, do, causal)
    exact = ref.flash_attention_bwd_ref(*(t.double() for t in (q, k, v, o, do)),
                                        causal=causal)
    for name, a, b, x in zip(("dq", "dk", "dv"), with_lse, without, exact):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert _err(a, b) <= 2.0 ** -8, name
        assert _err(a, x) <= RTOL and _err(b, x) <= RTOL, name


@pytest.mark.parametrize("B,H,Hkv,T,D,Dv,causal", SHAPES)
def test_float32_plain_backward_with_lse_equals_without(B, H, Hkv, T, D, Dv, causal):
    q, k, v, do = (torch.tensor(a) for a in _inputs(2, B, H, Hkv, T, D, Dv))
    o = ref.flash_attention_ref(q, k, v, causal=causal)
    lse = ref.flash_attention_lse_ref(q, k, v, causal=causal)
    with_lse = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal, lse=lse)
    without = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), with_lse, without):
        assert a.dtype == torch.float32
        assert _err(a, b) <= 1e-6, name


@pytest.mark.parametrize("B,H,Hkv,T,D,Dv,causal", F32_LSE)
def test_float32_backward_with_lse_equals_without(B, H, Hkv, T, D, Dv, causal):
    q, k, v, do = (torch.tensor(a) for a in _inputs(6, B, H, Hkv, T, D, Dv))
    o, lse = tflash.flash_attention(q, k, v, causal, return_lse=True)
    assert torch.equal(o, tflash.flash_attention(q, k, v, causal))
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (B, H, T)
    with_lse = tflash.flash_attention_bwd(q, k, v, o, do, causal, lse=lse)
    without = tflash.flash_attention_bwd(q, k, v, o, do, causal)
    exact = ref.flash_attention_bwd_ref(*(t.double() for t in (q, k, v, o, do)),
                                        causal=causal)
    for name, a, b, x in zip(("dq", "dk", "dv"), with_lse, without, exact):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert _err(a, b) <= 1e-6, name
        assert _err(a, x) <= 1e-5, name


@pytest.mark.parametrize("B,H,Hkv,T,D,Dv,causal", BF16_LSE)
def test_flash_attention_fn_at_192_128_matches_jax_vjp(monkeypatch, B, H, Hkv, T, D, Dv,
                                                        causal):
    arrs = _inputs(3, B, H, Hkv, T, D, Dv)
    qj, kj, vj, doj = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrs)

    def f(q_, k_, v_):
        return rattn.flash_attention_jnp(q_, k_, v_, causal=causal)

    _, vjp = jax.vjp(f, qj, kj, vj)
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(doj)]
    q, k, v, do = (torch.tensor(a).to(torch.bfloat16) for a in arrs)
    given = []
    bwd = tflash.flash_attention_bwd

    def spy(*args, **kwargs):
        given.append(args[6] if len(args) > 6 else kwargs.get("lse"))
        return bwd(*args, **kwargs)

    monkeypatch.setattr(tflash, "flash_attention_bwd", spy)
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    o = tflash.FlashAttentionFn.apply(qs, ks, vs, causal)
    got = torch.autograd.grad(o, (qs, ks, vs), do)
    assert len(given) == 1 and given[0] is not None and tuple(given[0].shape) == (B, H, T)
    exact = ref.flash_attention_bwd_ref(*(t.double() for t in (q, k, v, o.detach(), do)),
                                        causal=causal)
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, exact):
        assert g.dtype == torch.bfloat16
        ref_err, port_err = _err(torch.tensor(w), x), _err(g, x)
        assert _err(g, w) <= RTOL + ref_err, (name, _err(g, w), ref_err)
        assert port_err <= RTOL, (name, port_err)


@pytest.mark.parametrize("B,H,Hkv,T,D,Dv,causal", F32_LSE)
def test_flash_attention_fn_float32_matches_jax_vjp(monkeypatch, B, H, Hkv, T, D, Dv,
                                                     causal):
    arrs = _inputs(7, B, H, Hkv, T, D, Dv)

    def f(q_, k_, v_):
        return rattn.flash_attention_jnp(q_, k_, v_, causal=causal)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in arrs[:3]))
    want = [np.asarray(g) for g in vjp(jnp.asarray(arrs[3]))]
    q, k, v, do = (torch.tensor(a) for a in arrs)
    given = []
    bwd = tflash.flash_attention_bwd

    def spy(*args, **kwargs):
        given.append(args[6] if len(args) > 6 else kwargs.get("lse"))
        return bwd(*args, **kwargs)

    monkeypatch.setattr(tflash, "flash_attention_bwd", spy)
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    o = tflash.FlashAttentionFn.apply(qs, ks, vs, causal)
    got = torch.autograd.grad(o, (qs, ks, vs), do)
    assert len(given) == 1 and given[0] is not None and tuple(given[0].shape) == (B, H, T)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32
        assert _err(g, w) <= 1e-5, (name, _err(g, w))


@pytest.mark.parametrize("dtype,D,Dv,want", [
    (torch.bfloat16, 192, 128, True), (torch.float32, 192, 128, False),
    (torch.bfloat16, 64, 64, True), (torch.float32, 128, None, True),
    (torch.bfloat16, 16, 8, False), (torch.float32, 32, None, False)])
def test_lse_route_is_at_the_wgmma_and_tf32_pairs(dtype, D, Dv, want):
    assert tflash.lse_route(dtype, D, Dv) is want


@pytest.mark.parametrize("dtype,D,Dv", [(torch.float32, 192, 128), (torch.bfloat16, 32, 32),
                                        (torch.bfloat16, 16, 8)])
def test_lse_refused_where_no_route_takes_it(dtype, D, Dv):
    q, k, v, do = (torch.tensor(a).to(dtype) for a in _inputs(4, 1, 2, 2, 20, D, Dv))
    with pytest.raises(ValueError, match="no L from the forward"):
        tflash.flash_attention(q, k, v, return_lse=True)
    o = tflash.flash_attention(q, k, v)
    lse = torch.zeros((1, 2, 20))
    with pytest.raises(ValueError, match="takes no L"):
        tflash.flash_attention_bwd(q, k, v, o, do, lse=lse)


@pytest.mark.parametrize("shape,dtype", [((1, 2, 19), torch.float32),
                                         ((1, 1, 20), torch.float32),
                                         ((1, 2, 20), torch.float64),
                                         ((2, 20), torch.float32)])
def test_backward_refuses_an_lse_of_another_shape_or_dtype(shape, dtype):
    q, k, v, do = (torch.tensor(a).to(torch.bfloat16)
                   for a in _inputs(5, 1, 2, 2, 20, 192, 128))
    o = tflash.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="lse is"):
        tflash.flash_attention_bwd(q, k, v, o, do, lse=torch.zeros(shape, dtype=dtype))
