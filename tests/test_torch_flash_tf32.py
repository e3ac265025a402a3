"""The TF32 tensor-core flash kernel's arithmetic, on the CPU.

``csrc/flash_attention_tf32.cu`` runs only on the card, so its numerics are
held here through an emulation, kept in this file and used by nothing
else: ``cvt.rna.tf32`` (round a float32 to 10 mantissa bits, nearest, ties
away from zero), each operand split into x_hi = rna(x) and x_lo = rna(x −
x_hi), every product taken as the three terms a_hi·b_hi + a_hi·b_lo +
a_lo·b_hi (here accumulated in float64), an online softmax over tiles of
32 keys in float32 with P = exp2(s·c − m·c), c = log₂e / √D, and each
tile's P V added to O·alpha.  The inputs are float32, drawn with numpy from
a seed.

* hi + lo is x within 2⁻²² of |x|.
* The emulation is within FLASH_F32_RTOL (1e-5 of the largest output) of
  the reference's ``flash_attention_jnp`` and of its Pallas kernel in
  interpret mode, both in float32 on the same values.
* One TF32 term is not enough: a_hi·b_hi alone misses FLASH_F32_RTOL on
  the same data (``test_one_term_misses_the_float32_bound``), so the gate
  sees TF32 rounding.
* The PV fragments need no shuffle: with Vᵀ's keys permuted within each
  group of 8 as the kernel writes them, the S accumulator's registers are
  the register-A fragment of P, and P·V is the unpermuted product.
* At MLA's pair, q and k of 192 columns and v of 128 (``MLA_SHAPES``), the
  emulation is within the gate of ``flash_attention_jnp`` and of float64.
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
#: keys of a K/V tile (kN in the source)
BLOCK_K = 32
#: the float32 gate of chip_smoke.py and tests/test_torch_cuda.py
FLASH_F32_RTOL = 1e-5
#: (B, H, Hkv, T, D, causal): unaligned T at both head dims, GQA groups 1,
#: 4 and 8, non-causal cases (the Pallas kernel needs aligned Tk there)
SHAPES = [(1, 4, 1, 77, 64, True), (1, 2, 2, 257, 128, True),
          (2, 8, 2, 130, 64, True), (1, 4, 4, 128, 64, False), (1, 2, 1, 256, 128, False)]
#: (B, H, Hkv, T, causal) at (D, Dv) = (192, 128), deepseek-v3's MLA
MLA_SHAPES = [(1, 2, 2, 77, True), (1, 2, 2, 100, False), (2, 2, 2, 130, True)]


#: cvt.rna.tf32 and the hi/lo split, one copy for every TF32 emulation
tf32_rna, split = _torch_parity.tf32_rna, _torch_parity.split


def three_terms(a: torch.Tensor, b: torch.Tensor, eq: str, terms: int = 3) -> torch.Tensor:
    """einsum ``eq`` of float32 a and b as TF32 terms, the products summed
    in float64 and rounded once to float32: three terms (hi·hi + hi·lo +
    lo·hi), or one (hi·hi)."""
    (ah, al), (bh, bl) = split(a), split(b)
    prods = [(ah, bh), (ah, bl), (al, bh)][:terms]
    return sum(torch.einsum(eq, x.double(), y.double()) for x, y in prods).float()


def tf32_emulation(q, k, v, causal: bool, terms: int = 3) -> torch.Tensor:
    """The TF32 kernel's arithmetic on float32 q [B, H, T, D], k [B, Hkv,
    Tk, D], v [B, Hkv, Tk, Dv] -> float32 output [B, H, T, Dv]."""
    B, H, T, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    k = k.repeat_interleave(H // Hkv, dim=1)
    v = v.repeat_interleave(H // Hkv, dim=1)
    c = torch.tensor(float(np.float32(1.0 / math.sqrt(D))), dtype=torch.float32) * \
        torch.tensor(LOG2E, dtype=torch.float32)
    m = torch.full((B, H, T), -1e30)
    l = torch.zeros((B, H, T))
    acc = torch.zeros((B, H, T, v.shape[-1]))
    qpos = torch.arange(T)[:, None]
    for k0 in range(0, Tk, BLOCK_K):
        kt, vt = k[:, :, k0:k0 + BLOCK_K], v[:, :, k0:k0 + BLOCK_K]
        s = three_terms(q, kt, "bhqd,bhkd->bhqk", terms)
        if causal:
            kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = torch.where(kpos > qpos, torch.tensor(-1e30), s)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_new) * c)
        p = torch.exp2(s * c - (m_new * c)[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + three_terms(p, vt, "bhqk,bhkd->bhqd", terms)
        m = m_new
    return acc / l.clamp(min=1e-30)[..., None]


def _qkv(seed, B, H, Hkv, T, D, Dv=None):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, T, D), (B, Hkv, T, D), (B, Hkv, T, Dv or D))]


def _rel_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got.astype(np.float64) - want).max() / np.abs(want).max())


def test_hi_plus_lo_is_x_within_2_pow_minus_22():
    rng = np.random.default_rng(0)
    mags = np.exp2(rng.uniform(-60, 60, 200_000))
    x = torch.tensor((rng.choice([-1.0, 1.0], 200_000) * mags * rng.uniform(1, 2, 200_000))
                     .astype(np.float32))
    hi, lo = split(x)
    assert bool((hi.view(torch.int32) & 0x1FFF == 0).all())
    assert bool((lo.view(torch.int32) & 0x1FFF == 0).all())
    err = (x.double() - (hi.double() + lo.double())).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    # round to nearest: |x - hi| is at most half a TF32 ulp (2⁻¹¹ of |x|)
    assert bool(((x.double() - hi.double()).abs() <= 2.0 ** -11 * x.double().abs()).all())


def test_rna_rounds_ties_away_from_zero():
    one = 1.0 + 2.0 ** -11  # halfway between 1 and the next TF32 value
    x = torch.tensor([one, -one, 1.0 + 2.0 ** -12], dtype=torch.float32)
    assert tf32_rna(x).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]


@pytest.mark.parametrize("B,H,Hkv,T,D,causal", SHAPES)
def test_emulation_matches_reference_in_float32(B, H, Hkv, T, D, causal):
    q, k, v = _qkv(T + D, B, H, Hkv, T, D)
    got = tf32_emulation(*map(torch.tensor, (q, k, v)), causal).numpy()
    jnp_out = np.asarray(rattn.flash_attention_jnp(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    pallas = np.asarray(rops.flash_attention(q, k, v, causal=causal, backend="interpret"))
    for want in (jnp_out, pallas):
        assert want.dtype == np.float32 and want.shape == got.shape
        assert _rel_err(got, want) <= FLASH_F32_RTOL


@pytest.mark.parametrize("B,H,Hkv,T,D,causal", SHAPES)
def test_emulation_is_near_float64(B, H, Hkv, T, D, causal):
    """Against the plain version in float64 the three-term emulation stays
    an order of magnitude inside the gate (the card measures ~1e-6)."""
    q, k, v = map(torch.tensor, _qkv(T + D, B, H, Hkv, T, D))
    got = tf32_emulation(q, k, v, causal).numpy()
    want = ref.flash_attention_ref(q.double(), k.double(), v.double(), causal=causal).numpy()
    assert _rel_err(got, want) <= FLASH_F32_RTOL / 4


@pytest.mark.parametrize("B,H,Hkv,T,causal", MLA_SHAPES)
def test_mla_pair_emulation_matches_reference_and_float64(B, H, Hkv, T, causal):
    q, k, v = _qkv(T + 3, B, H, Hkv, T, 192, 128)
    got = tf32_emulation(*map(torch.tensor, (q, k, v)), causal).numpy()
    want = np.asarray(rattn.flash_attention_jnp(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    assert want.shape == got.shape == (B, H, T, 128)
    assert _rel_err(got, want) <= FLASH_F32_RTOL
    f64 = ref.flash_attention_ref(*(torch.tensor(a).double() for a in (q, k, v)),
                                  causal=causal).numpy()
    assert _rel_err(got, f64) <= FLASH_F32_RTOL / 4


def test_one_term_misses_the_float32_bound():
    """Why each product takes three TF32 terms: with a_hi·b_hi alone the
    first shape lands beyond FLASH_F32_RTOL of float64, with three it is
    within (``test_emulation_is_near_float64``)."""
    q, k, v = map(torch.tensor, _qkv(1, *SHAPES[0][:5]))
    want = ref.flash_attention_ref(q.double(), k.double(), v.double()).numpy()
    assert _rel_err(tf32_emulation(q, k, v, True, terms=1).numpy(), want) > FLASH_F32_RTOL
    assert _rel_err(tf32_emulation(q, k, v, True, terms=3).numpy(), want) <= FLASH_F32_RTOL


def _acc_pos(lane: int, i: int):
    """(row, column) of float32 accumulator element i (of one 8-column
    group) of a lane in a warp's 16 rows: rows g and g + 8, columns 2t and
    2t + 1 (g = lane / 4, t = lane % 4)."""
    g, t = divmod(lane, 4)
    return g + 8 * ((i >> 1) & 1), 2 * t + (i & 1)


def _frag_pos(lane: int, j: int):
    """(row, k) of register j of the tf32 register-A fragment of a k-step:
    rows g and g + 8, k indices t and t + 4."""
    g, t = divmod(lane, 4)
    return g + 8 * (j & 1), t + 4 * (j >> 1)


#: the accumulator element the kernel puts in fragment register j
KERNEL_REG = [((j & 1) << 1) + (j >> 1) for j in range(4)]
#: the key the kernel writes at position j of each group of 8 of Vᵀ
KERNEL_KEY_ORDER = [2 * j if j < 4 else 2 * (j - 4) + 1 for j in range(8)]


def test_key_permutation_is_a_bijection_matching_the_fragments():
    """Register j of every lane holds the accumulator element of the same
    row, and the k index it stands at maps to one key: together a
    bijection of the 8 keys, the order the kernel writes Vᵀ in."""
    order = {}
    for lane in range(32):
        for j in range(4):
            frow, kidx = _frag_pos(lane, j)
            arow, key = _acc_pos(lane, KERNEL_REG[j])
            assert frow == arow
            assert order.setdefault(kidx, key) == key
    assert sorted(order) == list(range(8)) and sorted(order.values()) == list(range(8))
    assert [order[j] for j in range(8)] == KERNEL_KEY_ORDER


def test_permuted_v_gives_the_unpermuted_product():
    """P [16 x 8] as the lanes hold it in accumulator layout, fed as the
    register-A fragment, times Vᵀ with keys permuted: the product the
    tensor core forms, Σ_k A[row, k] Vᵀ[d, k], equals P V."""
    rng = np.random.default_rng(4)
    P = rng.standard_normal((16, 8))
    V = rng.standard_normal((8, 16))
    A = np.full((16, 8), np.nan)
    for lane in range(32):
        for j in range(4):
            row, kidx = _frag_pos(lane, j)
            A[row, kidx] = P[_acc_pos(lane, KERNEL_REG[j])]
    Vt = V[KERNEL_KEY_ORDER].T  # position j of Vᵀ holds key KERNEL_KEY_ORDER[j]
    assert not np.isnan(A).any()
    assert np.allclose(A @ Vt.T, P @ V, rtol=0, atol=1e-12)
    # without the permutation the same registers give another product
    assert not np.allclose(A @ V, P @ V)


def test_variant_and_kernel_object():
    assert tflash.variant(torch.float32, 64) == tflash.variant(torch.float32, 128) == "tf32"
    assert tflash.KERNELS["tf32"] is tflash.FLASH_ATTENTION_TF32
    assert tflash.FLASH_ATTENTION_TF32.source == "flash_attention_tf32.cu"
    assert tflash.FLASH_ATTENTION_TF32.entry == "repro_flash_attention_tf32"
