"""The wgmma route of the port's attention backward, on the CPU.

``csrc/flash_attention_bwd_wgmma.cu`` runs only on the card; its plain
version ``kernels.ref.flash_attention_bwd_bf16_ref`` (P and dS rounded once
to bf16 where they enter their products, everything else float32) is what
the CPU wrapper takes for bf16 at D 64/128, and what the card tests hold the
kernel to.  Here, at small shapes (T 24–80, not a multiple of 64; D 64 and
128; G 1 and 2; causal and not), on the same numpy inputs rounded to bf16:

* the plain version against ``flash_attention_bwd_ref`` in float64, within
  1e-2 of each output's largest magnitude;
* the plain version against the reference's own ``jax.vjp`` of
  ``flash_attention_jnp`` in bf16.  The reference rounds dP = dO Vᵀ to bf16
  before Δ is subtracted from it (the kernel and SDPA keep dP in float32
  and round dS), so its own error to float64 is the larger of the two and
  can pass 1e-2 itself: the port is held within 1e-2 plus that error of
  the reference's gradient, and within 1e-2 of float64, with both errors
  reported in the assertion message;
* ``bwd_variant`` for every dtype and head dim (three routes: wgmma, tf32,
  simt), and the CPU wrapper taking the plain version of the route it
  names.
"""
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

#: (B, H, Hkv, T, D, causal): T 24–80 and never a multiple of 64, D 64
#: and 128, G = H / Hkv 1 and 2
SHAPES = [(1, 2, 2, 24, 64, True), (1, 2, 2, 24, 64, False),
          (2, 4, 2, 80, 64, True), (1, 4, 2, 72, 64, False),
          (1, 2, 1, 40, 128, True), (1, 4, 2, 72, 128, False),
          (1, 2, 2, 56, 128, True), (2, 2, 1, 80, 128, False)]
#: each output within this of its largest magnitude
RTOL = 1e-2


def _inputs(B, H, Hkv, T, D, seed=0):
    """q, k, v, dO as float32 numpy arrays holding bf16 values."""
    rng = np.random.default_rng(seed + T + D + H)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, H, T, D), (B, Hkv, T, D), (B, Hkv, T, D), (B, H, T, D))]
    return [np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
            for a in arrs]


def _bf16(a):
    return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)


def _err(got, want) -> float:
    """max |got − want| over max |want|."""
    got, want = got.double(), torch.as_tensor(np.asarray(want, np.float64))
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("B,H,Hkv,T,D,causal", SHAPES)
def test_bf16_plain_backward_within_1e2_of_float64(B, H, Hkv, T, D, causal):
    q, k, v, do = (_bf16(a) for a in _inputs(B, H, Hkv, T, D))
    o = ref.flash_attention_ref(q.double(), k.double(), v.double(),
                                causal=causal).to(torch.bfloat16)
    got = ref.flash_attention_bwd_bf16_ref(q, k, v, o, do, causal=causal)
    want = ref.flash_attention_bwd_ref(*(t.double() for t in (q, k, v, o, do)),
                                       causal=causal)
    for name, g, w, inp in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.dtype == torch.float32 and g.shape == inp.shape
        assert _err(g.to(torch.bfloat16), w) <= RTOL, name


@pytest.mark.parametrize("B,H,Hkv,T,D,causal", SHAPES)
def test_bf16_plain_backward_matches_jax_vjp_in_bf16(B, H, Hkv, T, D, causal):
    arrs = _inputs(B, H, Hkv, T, D, seed=1)
    qj, kj, vj, doj = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrs)

    def f(q_, k_, v_):
        return rattn.flash_attention_jnp(q_, k_, v_, causal=causal)

    o, vjp = jax.vjp(f, qj, kj, vj)
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(doj)]
    o = np.asarray(o.astype(jnp.float32))
    q, k, v, o_t, do = (_bf16(a) for a in (*arrs[:3], o, arrs[3]))
    got = tflash.flash_attention_bwd(q, k, v, o_t, do, causal=causal)
    exact = ref.flash_attention_bwd_ref(*(t.double() for t in (q, k, v, o_t, do)),
                                        causal=causal)
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, exact):
        assert g.dtype == torch.bfloat16
        ref_err, port_err = _err(torch.tensor(w), x), _err(g, x)
        assert _err(g, w) <= RTOL + ref_err, (
            f"{name}: port vs reference {_err(g, w):.3e}; reference vs float64 "
            f"{ref_err:.3e}; port vs float64 {port_err:.3e}")
        assert port_err <= RTOL, (name, port_err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", tflash.HEAD_DIMS)
def test_bwd_variant_by_dtype_and_head_dim(dtype, D):
    """At D 64/128 bf16 takes the wgmma route and float32 the TF32 route
    (tests/test_torch_flash_bwd_tf32.py); every dtype at D ≤ 32 the SIMT
    route."""
    want = "simt"
    if D in (64, 128):
        want = "wgmma" if dtype == torch.bfloat16 else "tf32"
    assert tflash.bwd_variant(dtype, D) == want
    assert tflash.BWD_KERNELS[want].source == {
        "wgmma": "flash_attention_bwd_wgmma.cu", "tf32": "flash_attention_bwd_tf32.cu",
        "simt": "flash_attention_bwd.cu"}[want]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64, 128])
def test_cpu_wrapper_takes_the_routes_plain_version(dtype, D):
    """On CPU tensors ``flash_attention_bwd`` is the plain version of the
    route ``bwd_variant`` names, cast to the inputs' dtype, bitwise; no
    kernel of any route launches.  The TF32 route (float32 at D 64/128)
    takes ``flash_attention_bwd_ref``."""
    q, k, v, do = (_bf16(a).to(dtype) for a in _inputs(1, 4, 2, 40, D, seed=2))
    o = tflash.flash_attention(q, k, v)
    counts = {name: kern.launches for name, kern in tflash.BWD_KERNELS.items()}
    got = tflash.flash_attention_bwd(q, k, v, o, do)
    kind = tflash.bwd_variant(dtype, D)
    plain = tflash.BWD_PLAIN[kind]
    if kind == "tf32":
        assert plain is ref.flash_attention_bwd_ref
    for g, w in zip(got, plain(q, k, v, o, do)):
        assert torch.equal(g, w.to(dtype))
    assert {name: kern.launches for name, kern in tflash.BWD_KERNELS.items()} == counts


def test_bwd_launch_refuses_a_route_that_does_not_take_the_input():
    q = torch.zeros((1, 2, 8, 64), dtype=torch.float32)
    with pytest.raises(ValueError, match="wgmma backward does not take"):
        tflash.bwd_launch("wgmma", q, q, q, q, q)
    with pytest.raises(ValueError, match="tf32 backward does not take"):
        tflash.bwd_launch("tf32", *(q.to(torch.bfloat16) for _ in range(5)))
