"""The tensor-core flash kernel's dispatch and arithmetic, on the CPU.

``csrc/flash_attention_wgmma.cu`` runs only on the card, so its numerics
are held here through a plain-torch emulation of its arithmetic, kept in
this file and used by nothing else: QKᵀ of bf16 values in float32, an
online softmax over tiles of 128 keys with the running max of the raw
scores and P = exp2(s·c − m·c), c = log₂e / √D, P split by truncation into
three bf16 terms (P_1 = P with the low 16 bits of its float32 cleared, P_2
the same of P − P_1, P_3 = P − P_1 − P_2: exactly P), and PV as the three
products accumulated in float32.  The inputs are bf16 values, drawn with
numpy from a seed.

* Rounded to bf16, the emulation is within 2⁻⁸·|ref| + 1e-6·max|ref| of
  the plain version in float64: the bound ``chip_smoke.py`` and
  ``tests/test_torch_cuda.py`` hold the kernel to.
* Unrounded, it is within 1e-5 of the largest output of the reference's
  ``flash_attention_jnp`` and of its Pallas kernel in interpret mode, both
  in float32 on the same values: the three terms sum to P exactly.
* Two terms are not enough: their residual reaches 2⁻¹⁶·P, and a row over
  few keys does not average it out, so an output near zero misses the
  per-element bound (``test_two_terms_miss_the_bf16_bound``).
* The same holds at MLA's pair, q and k of 192 columns and v of 128
  (``MLA_SHAPES``): against float64, and unrounded against the reference's
  ``flash_attention_jnp`` (its Pallas kernel takes one head dim).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402

_torch_parity.cap_torch_threads()
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as rops  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

LOG2E = 1.4426950408889634
BLOCK_K = 128
RTOL = 1e-5
#: (B, H, Hkv, T, D, causal): unaligned T at both head dims, GQA groups
#: 1, 4 and 8, a non-causal case (the Pallas kernel needs aligned Tk there)
SHAPES = [(1, 4, 1, 77, 64, True), (1, 2, 2, 257, 128, True),
          (2, 8, 2, 130, 64, True), (1, 8, 1, 200, 128, True),
          (1, 4, 4, 128, 64, False), (1, 2, 1, 256, 128, False)]
#: (B, H, Hkv, T, causal) at (D, Dv) = (192, 128), deepseek-v3's MLA (H =
#: Hkv): unaligned T causal and not
MLA_SHAPES = [(1, 2, 2, 77, True), (1, 2, 2, 200, False), (2, 2, 2, 130, True)]


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 8, "mma"), (torch.bfloat16, 16, "mma"),
    (torch.bfloat16, 32, "mma"), (torch.float32, 64, "tf32"),
    (torch.float32, 128, "tf32"), (torch.float32, 16, "mma"),
    (torch.float32, 8, "mma"), (torch.float32, 32, "mma")])
def test_variant_names_the_kernel(dtype, D, want):
    assert tflash.variant(dtype, D) == want
    kernel = tflash.KERNELS[want]
    assert kernel.source == {"wgmma": "flash_attention_wgmma.cu",
                             "tf32": "flash_attention_tf32.cu",
                             "mma": "flash_attention.cu"}[want]


def _bf16_qkv(seed, B, H, Hkv, T, D, Dv=None):
    """float32 arrays holding bf16 values (each exact in both types); v of
    Dv columns (default D)."""
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(s).astype(np.float32))
            .to(torch.bfloat16).float().numpy()
            for s in ((B, H, T, D), (B, Hkv, T, D), (B, Hkv, T, Dv or D))]


def _wgmma_emulation(q, k, v, causal: bool, terms: int = 3) -> torch.Tensor:
    """The wgmma kernel's arithmetic on float32 tensors of bf16 values
    (q [B, H, T, D], k [B, Hkv, Tk, D], v [B, Hkv, Tk, Dv]) -> unrounded
    float32 output [B, H, T, Dv]; P enters PV as ``terms`` bf16 terms by
    truncation (the kernel's 3)."""
    B, H, T, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    k = k.repeat_interleave(H // Hkv, dim=1)
    v = v.repeat_interleave(H // Hkv, dim=1)
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    scale_log2 = scale * torch.tensor(LOG2E, dtype=torch.float32)
    m = torch.full((B, H, T), -1e30)
    l = torch.zeros((B, H, T))
    acc = torch.zeros((B, H, T, v.shape[-1]))
    qpos = torch.arange(T)[:, None]
    for k0 in range(0, Tk, BLOCK_K):
        kt, vt = k[:, :, k0:k0 + BLOCK_K], v[:, :, k0:k0 + BLOCK_K]
        s = torch.einsum("bhqd,bhkd->bhqk", q, kt)
        if causal:
            kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = torch.where(kpos > qpos, torch.tensor(-1e30), s)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_new) * scale_log2)
        p = torch.exp2(s * scale_log2 - (m_new * scale_log2)[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None]
        rest = p
        for _ in range(terms):
            term = (rest.view(torch.int32) & -65536).view(torch.float32)
            acc = acc + term @ vt
            rest = rest - term
        m = m_new
    return acc / l.clamp(min=1e-30)[..., None]


def _bf16_bound_excess(B, H, Hkv, T, D, causal, terms, Dv=None):
    """Largest err / (2⁻⁸·|ref| + 1e-6·max|ref|) of the rounded emulation."""
    q, k, v = map(torch.tensor, _bf16_qkv(T + D, B, H, Hkv, T, D, Dv))
    got = _wgmma_emulation(q, k, v, causal, terms).to(torch.bfloat16).double()
    want = ref.flash_attention_ref(q.double(), k.double(), v.double(), causal=causal)
    bound = 2.0 ** -8 * want.abs() + 1e-6 * want.abs().max()
    return float(((got - want).abs() / bound).max())


@pytest.mark.parametrize("B,H,Hkv,T,D,causal", SHAPES)
def test_emulation_rounded_is_within_one_bf16_rounding(B, H, Hkv, T, D, causal):
    assert _bf16_bound_excess(B, H, Hkv, T, D, causal, terms=3) <= 1.0


@pytest.mark.parametrize("B,H,Hkv,T,D,causal", SHAPES)
def test_emulation_matches_reference_in_float32(B, H, Hkv, T, D, causal):
    q, k, v = _bf16_qkv(T + D + 1, B, H, Hkv, T, D)
    got = _wgmma_emulation(*map(torch.tensor, (q, k, v)), causal).numpy()
    jnp_out = np.asarray(rattn.flash_attention_jnp(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    pallas = np.asarray(rops.flash_attention(q, k, v, causal=causal,
                                             backend="interpret"))
    for want in (jnp_out, pallas):
        assert want.dtype == np.float32 and want.shape == got.shape
        scale = float(np.abs(want).max())
        err = float(np.abs(got.astype(np.float64) - want).max())
        assert err <= RTOL * scale, (err, scale)


@pytest.mark.parametrize("B,H,Hkv,T,causal", MLA_SHAPES)
def test_mla_pair_emulation_within_one_bf16_rounding(B, H, Hkv, T, causal):
    assert _bf16_bound_excess(B, H, Hkv, T, 192, causal, terms=3, Dv=128) <= 1.0


@pytest.mark.parametrize("B,H,Hkv,T,causal", MLA_SHAPES)
def test_mla_pair_emulation_matches_reference_in_float32(B, H, Hkv, T, causal):
    q, k, v = _bf16_qkv(T + 1, B, H, Hkv, T, 192, 128)
    got = _wgmma_emulation(*map(torch.tensor, (q, k, v)), causal).numpy()
    want = np.asarray(rattn.flash_attention_jnp(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    assert want.shape == got.shape == (B, H, T, 128)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= RTOL * float(np.abs(want).max())


def test_two_terms_miss_the_bf16_bound():
    """Why the kernel splits P in three: with two bf16 terms an output near
    zero (a row over few keys) lands beyond the per-element bound, with
    three every element is within it (the first shape)."""
    assert _bf16_bound_excess(*SHAPES[0], terms=2) > 1.0


def test_three_truncated_terms_sum_to_p():
    """P_1 + P_2 + P_3 == P bit for bit, for probabilities from 1 down to
    2⁻¹⁰⁰ (the last term stays a normal float32): each term is a bf16 value
    (low 16 bits zero) and each difference is exact."""
    rng = np.random.default_rng(0)
    p = torch.tensor(np.exp2(-rng.uniform(0, 100, 100_000)).astype(np.float32))
    rest, terms = p, []
    for _ in range(3):
        term = (rest.view(torch.int32) & -65536).view(torch.float32)
        terms.append(term)
        rest = rest - term
    assert all(bool((t.view(torch.int32) & 0xFFFF == 0).all()) for t in terms)
    assert bool((rest == 0).all())
    assert torch.equal((terms[0].double() + terms[1].double()) + terms[2].double(),
                       p.double())
