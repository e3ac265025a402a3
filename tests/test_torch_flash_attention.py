"""The port's flash attention ≡ the reference's, on the CPU.

The same numpy inputs, made from a seed, go through both packages:

* the reference's ``kernels.ref.flash_attention_ref`` and
  ``kernels.ops.flash_attention(backend="interpret")`` (the Pallas kernel in
  interpret mode) against the port's ``kernels.ref.flash_attention_ref``
  and ``kernels.ops.flash_attention(device="cpu")`` (the kernel wrapper's
  plain version), at the four shapes of ``tests/test_kernels.py`` and one
  aligned non-causal shape;
* the reference's ``models.attention.flash_attention_jnp`` against the
  port's ``models.attention.flash_attention`` in both CPU branches: plain
  masked attention at T = 64 and the chunked online softmax at
  (B, H, Hkv, T, D) = (1, 2, 1, 2048, 16);
* the one-token ``decode_attention`` of both.

Tolerance: float32 outputs within 1e-5 of the output's largest magnitude.
Both compute the same softmax, but take the dot products and sums in other
orders (XLA's, the Pallas kernel's 128-key blocks, PyTorch's), each
rounding at ~6e-8 of the running value; the measured differences are
below 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402

_torch_parity.cap_torch_threads()
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention  # noqa: E402

RTOL = 1e-5
#: (B, H, Hkv, T, D, causal): tests/test_kernels.py's four causal shapes and
#: one aligned non-causal shape
SHAPES = [(1, 2, 1, 16, 8, True), (2, 4, 2, 64, 16, True),
          (2, 8, 8, 128, 32, True), (1, 4, 1, 96, 64, True),
          (2, 4, 2, 128, 16, False)]


def _qkv(seed, B, H, Hkv, T, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, T, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    return q, k, v


def assert_close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = float(np.abs(want).max())
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= rtol * scale, (err, scale)


@pytest.mark.parametrize("B,H,Hkv,T,D,causal", SHAPES)
def test_ref_matches_reference_ref(B, H, Hkv, T, D, causal):
    q, k, v = _qkv(T + D, B, H, Hkv, T, D)
    want = rref.flash_attention_ref(q, k, v, causal=causal)
    got = ref.flash_attention_ref(*map(torch.tensor, (q, k, v)), causal=causal)
    assert_close(got, want)


@pytest.mark.parametrize("B,H,Hkv,T,D,causal", SHAPES)
def test_ops_matches_reference_pallas_interpret(B, H, Hkv, T, D, causal):
    q, k, v = _qkv(T + D + 1, B, H, Hkv, T, D)
    want = rops.flash_attention(q, k, v, causal=causal, backend="interpret")
    got = ops.flash_attention(q, k, v, causal=causal, device="cpu")
    assert got.device.type == "cpu"
    assert tflash.FLASH_ATTENTION.launches == 0  # the plain version ran
    assert_close(got, want)


@pytest.mark.parametrize("B,H,Hkv,T,D", [(2, 4, 2, 64, 16), (1, 2, 1, 2048, 16)],
                         ids=["plain", "chunked"])
def test_model_flash_attention_matches_flash_attention_jnp(B, H, Hkv, T, D):
    q, k, v = _qkv(T, B, H, Hkv, T, D)
    # the reference's branch rule: chunked only above 4096²/16 scores
    assert (T * T > 4096 * 4096 // 16) == (T == 2048)
    want = rattn.flash_attention_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=True)
    got = attention.flash_attention(*map(torch.tensor, (q, k, v)), causal=True)
    assert_close(got, want)


def test_chunked_branch_agrees_with_plain_branch():
    """The port's two CPU branches compute the same function (small blocks
    force the chunked one at T = 64)."""
    q, k, v = map(torch.tensor, _qkv(3, 2, 4, 2, 64, 16))
    plain = attention.flash_attention(q, k, v)
    chunked = attention._chunked_attention(
        q.reshape(2, 2, 2, 64, 16).transpose(1, 2), k[:, None], v[:, None],
        True, 1.0 / 4.0, 16, 16, q.dtype).transpose(1, 2).reshape(2, 4, 64, 16)
    assert_close(chunked, plain.numpy())


@pytest.mark.parametrize("pos", [0, 5, 23])
def test_decode_attention_matches_reference(pos):
    rng = np.random.default_rng(pos)
    q = rng.standard_normal((2, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 2, 24, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 2, 24, 16)).astype(np.float32)
    want = rattn.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), pos)
    got = attention.decode_attention(*map(torch.tensor, (q, kc, vc)), pos)
    assert_close(got, want)


def test_wrapper_keeps_q_dtype_on_the_cpu():
    q, k, v = (torch.tensor(a).to(torch.bfloat16) for a in _qkv(1, 1, 4, 2, 33, 32))
    out = ops.flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    want = ref.flash_attention_ref(q, k, v).to(torch.bfloat16)
    assert torch.equal(out, want)


@pytest.mark.parametrize("what", ["head_dim", "causal_lengths", "dtype", "mixed",
                                  "heads", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(what):
    q, k, v = map(torch.tensor, _qkv(2, 1, 4, 2, 16, 16))
    if what == "head_dim":
        q, k, v = (t[..., :12] for t in (q, k, v))
    elif what == "causal_lengths":
        k, v = k[:, :, :8], v[:, :, :8]
    elif what == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif what == "mixed":
        k = k.to(torch.bfloat16)
    elif what == "heads":
        q = q[:, :3]
    else:
        q, k, v = (t.to("meta") for t in (q, k, v))
    with pytest.raises((ValueError, TypeError)):
        tflash.flash_attention(q, k, v, causal=True)


@pytest.mark.parametrize("T,Tk", [(16, 8), (8, 16)])
def test_causal_attention_with_unequal_lengths_raises(T, Tk):
    """The reference aligns a causal mask with T != Tk at the last query in
    its plain version and at the first in its Pallas kernel; the port takes
    neither and refuses the call on every device."""
    q = torch.tensor(_qkv(1, 1, 2, 1, T, 16)[0])
    _, k, v = map(torch.tensor, _qkv(1, 1, 2, 1, Tk, 16))
    with pytest.raises(ValueError, match="causal attention needs T == Tk"):
        tflash.flash_attention(q, k, v, causal=True)
    out = tflash.flash_attention(q, k, v, causal=False)
    assert out.shape == q.shape


@pytest.mark.parametrize("kw", [{"window": 8}])
def test_unported_attention_raises(kw):
    q, k, v = map(torch.tensor, _qkv(4, 1, 2, 1, 16, 8))
    with pytest.raises(NotImplementedError, match="Queue 1 item 20"):
        attention.flash_attention(q, k, v, **kw)
