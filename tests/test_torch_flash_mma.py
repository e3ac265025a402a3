"""The small-head-dim flash kernel on tensor cores (``mma.sync``), on the CPU.

``csrc/flash_attention.cu``'s mma kernel (D ∈ {8, 16, 32}) runs only on the
card, so its arithmetic is held here through a numpy emulation, kept in
this file and used by nothing else: K/V tiles of 64 keys; S = Q Kᵀ (bf16:
products of bf16 values, exact in float32; float32: three TF32 terms
a_hi·b_hi + a_hi·b_lo + a_lo·b_hi); an online softmax in float32 with the
running max of the raw scores and P = exp2(s·c − m·c), c = log₂e / √D;
each tile's P V (bf16: P as three bf16 terms by truncation, which sum to
P, added into O·alpha; float32: three TF32 terms into a fresh
accumulator, added to O·alpha by one fmaf); the denominator floored at
1e-30.  Sums the tensor cores accumulate are taken in float64 and rounded
once.  Inputs are drawn with numpy from a seed.

* float32: within FLASH_F32_RTOL (1e-5 of the largest output) of the
  reference's ``flash_attention_jnp`` and of its Pallas kernel in
  interpret mode, and within a quarter of it of float64;
* bf16 (bf16 inputs): rounded once to bf16, within one bf16 rounding
  (2⁻⁸·|ref| + 1e-6·max|ref|) of the float64 result; unrounded, within
  FLASH_F32_RTOL of the reference's jnp and Pallas outputs on the same
  values;
* at D 8, 16 and 32, causal and not, at T = 100 and 64 (path D's reduced
  leg), under GQA;
* at the reduced MLA pair, q and k of 16 columns and v of 8, in both
  dtypes, against the reference's ``flash_attention_jnp`` and float64;
* the fragment claim the kernel's PV rests on: S's accumulator registers
  are P's A fragments (bf16 m16n8k16 as they stand; TF32 m16n8k8 with V
  read at keys 2t and 2t + 1), so P needs no shuffle.
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
#: keys of a staged K/V tile (kMmaKeys in the source)
BLOCK_K = 64
#: the float32 gate of chip_smoke.py and tests/test_torch_cuda.py
FLASH_F32_RTOL = 1e-5
#: (B, H, Hkv, T, causal): GQA groups 1, 2 and 4, T = 100 causal and not,
#: path D's reduced leg (2, 4, 2, 64), a ragged causal T = 130
SHAPES = [(1, 4, 1, 100, True), (2, 4, 2, 100, False), (2, 4, 2, 64, True),
          (1, 2, 2, 64, False), (1, 8, 2, 130, True)]
#: (B, H, Hkv, T, causal) at (D, Dv) = (16, 8), the reduced deepseek's MLA:
#: its chip_smoke.py shape (2, 4, 4, 64) and ragged T causal and not
MLA_SHAPES = [(2, 4, 4, 64, True), (1, 4, 4, 100, False), (1, 4, 4, 130, True)]


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: float32 to 10 mantissa bits, nearest, ties
    away from zero."""
    bits = np.ascontiguousarray(x, np.float32).view(np.int32)
    return ((bits + 0x1000) & -0x2000).view(np.float32)


def split(x: np.ndarray):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def bf16_terms(p: np.ndarray, terms: int = 3):
    """P as ``terms`` bf16 values by truncation (the low 16 bits cleared),
    each difference exact."""
    out, rest = [], np.ascontiguousarray(p, np.float32)
    for _ in range(terms):
        term = (rest.view(np.int32) & -65536).view(np.float32)
        out.append(term)
        rest = rest - term
    return out


def _products(a, b, eq, tf32: bool, terms: int = 3):
    """einsum ``eq`` as the tensor cores take it, summed in float64 and
    rounded once: TF32 terms (three, or hi·hi), or bf16 values as they
    are (exact products)."""
    if not tf32:
        return np.einsum(eq, a.astype(np.float64), b.astype(np.float64)).astype(np.float32)
    (ah, al), (bh, bl) = split(a), split(b)
    pairs = [(ah, bh), (ah, bl), (al, bh)][:terms]
    return sum(np.einsum(eq, x.astype(np.float64), y.astype(np.float64))
               for x, y in pairs).astype(np.float32)


def mma_emulation(q, k, v, causal: bool, tf32: bool, terms: int = 3) -> np.ndarray:
    """The mma kernel's arithmetic on float32 arrays (bf16 values when not
    ``tf32``): q [B, H, T, D], k [B, Hkv, Tk, D], v [B, Hkv, Tk, Dv] ->
    unrounded float32 [B, H, T, Dv]."""
    B, H, T, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    k = np.repeat(k, H // Hkv, axis=1)
    v = np.repeat(v, H // Hkv, axis=1)
    c = np.float32(np.float32(1.0 / math.sqrt(D)) * np.float32(LOG2E))
    m = np.full((B, H, T), -1e30, np.float32)
    l = np.zeros((B, H, T), np.float32)
    acc = np.zeros((B, H, T, v.shape[-1]), np.float32)
    qpos = np.arange(T)[:, None]
    for k0 in range(0, Tk, BLOCK_K):
        kt, vt = k[:, :, k0:k0 + BLOCK_K], v[:, :, k0:k0 + BLOCK_K]
        s = _products(q, kt, "bhqd,bhkd->bhqk", tf32, terms)
        if causal:
            kpos = np.arange(k0, k0 + kt.shape[2])[None, :]
            s = np.where(kpos > qpos, np.float32(-1e30), s)
        m_new = np.maximum(m, s.max(-1))
        alpha = np.exp2((m - m_new) * c)
        mc = m_new * c
        # exp2f(fmaf(s, c, -m·c)): the product and the difference rounded once
        p = np.exp2((s.astype(np.float64) * c - mc[..., None]).astype(np.float32))
        l = l * alpha + p.sum(-1, dtype=np.float32)
        if tf32:
            tile = _products(p, vt, "bhqk,bhkd->bhqd", True, terms)
            acc = (acc.astype(np.float64) * alpha[..., None] + tile).astype(np.float32)
        else:  # O·alpha, then the terms' products accumulated into it
            acc = acc * alpha[..., None]
            acc = (acc.astype(np.float64) + sum(
                np.einsum("bhqk,bhkd->bhqd", t.astype(np.float64), vt.astype(np.float64))
                for t in bf16_terms(p, terms))).astype(np.float32)
        m = m_new
    return acc / np.maximum(l, np.float32(1e-30))[..., None]


def _qkv(seed, B, H, Hkv, T, D, bf16: bool, Dv=None):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(s).astype(np.float32)
           for s in ((B, H, T, D), (B, Hkv, T, D), (B, Hkv, T, Dv or D))]
    if bf16:  # bf16 values, exact in both types
        out = [torch.tensor(a).to(torch.bfloat16).float().numpy() for a in out]
    return out


def _rel_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got.astype(np.float64) - want).max() / np.abs(want).max())


def _references(q, k, v, causal: bool):
    """The reference's jnp path, and its Pallas kernel in interpret mode
    where it takes the shape (non-causal needs Tk a multiple of 8)."""
    outs = [np.asarray(rattn.flash_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                                 jnp.asarray(v), causal=causal))]
    if causal or k.shape[2] % 8 == 0:
        outs.append(np.asarray(rops.flash_attention(q, k, v, causal=causal,
                                                    backend="interpret")))
    return outs


def _float64(q, k, v, causal: bool) -> np.ndarray:
    return ref.flash_attention_ref(*(torch.tensor(a).double() for a in (q, k, v)),
                                   causal=causal).numpy()


@pytest.mark.parametrize("D", [8, 16, 32])
@pytest.mark.parametrize("B,H,Hkv,T,causal", SHAPES)
def test_float32_emulation_matches_reference(B, H, Hkv, T, causal, D):
    q, k, v = _qkv(T + D, B, H, Hkv, T, D, bf16=False)
    got = mma_emulation(q, k, v, causal, tf32=True)
    for want in _references(q, k, v, causal):
        assert want.dtype == np.float32 and want.shape == got.shape
        assert _rel_err(got, want) <= FLASH_F32_RTOL
    assert _rel_err(got, _float64(q, k, v, causal)) <= FLASH_F32_RTOL / 4


@pytest.mark.parametrize("D", [8, 16, 32])
@pytest.mark.parametrize("B,H,Hkv,T,causal", SHAPES)
def test_bf16_emulation_within_one_bf16_rounding(B, H, Hkv, T, causal, D):
    q, k, v = _qkv(T + D + 1, B, H, Hkv, T, D, bf16=True)
    got = mma_emulation(q, k, v, causal, tf32=False)
    for want in _references(q, k, v, causal):
        assert _rel_err(got, want) <= FLASH_F32_RTOL
    want = _float64(q, k, v, causal)
    rounded = torch.tensor(got).to(torch.bfloat16).double().numpy()
    bound = 2.0 ** -8 * np.abs(want) + 1e-6 * np.abs(want).max()
    assert np.all(np.abs(rounded - want) <= bound)


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,T,causal", MLA_SHAPES)
def test_mla_pair_emulation_matches_reference(B, H, Hkv, T, causal, bf16):
    q, k, v = _qkv(T + 7, B, H, Hkv, T, 16, bf16, Dv=8)
    got = mma_emulation(q, k, v, causal, tf32=not bf16)
    want = np.asarray(rattn.flash_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                                jnp.asarray(v), causal=causal))
    assert want.shape == got.shape == (B, H, T, 8)
    assert _rel_err(got, want) <= FLASH_F32_RTOL
    f64 = _float64(q, k, v, causal)
    if bf16:
        rounded = torch.tensor(got).to(torch.bfloat16).double().numpy()
        bound = 2.0 ** -8 * np.abs(f64) + 1e-6 * np.abs(f64).max()
        assert np.all(np.abs(rounded - f64) <= bound)
    else:
        assert _rel_err(got, f64) <= FLASH_F32_RTOL / 4


def test_one_tf32_term_misses_the_float32_gate():
    """Why float32 takes three TF32 terms a product at these head dims too:
    with a_hi·b_hi alone the error against float64 exceeds FLASH_F32_RTOL."""
    q, k, v = _qkv(5, 1, 4, 1, 100, 32, bf16=False)
    want = _float64(q, k, v, True)
    assert _rel_err(mma_emulation(q, k, v, True, tf32=True, terms=1), want) > FLASH_F32_RTOL
    assert _rel_err(mma_emulation(q, k, v, True, tf32=True), want) <= FLASH_F32_RTOL


def test_three_bf16_terms_sum_to_p():
    rng = np.random.default_rng(1)
    p = np.exp2(-rng.uniform(0, 100, 50_000)).astype(np.float32)
    terms = bf16_terms(p)
    assert all(np.all(t.view(np.int32) & 0xFFFF == 0) for t in terms)
    np.testing.assert_array_equal((terms[0].astype(np.float64) + terms[1]) + terms[2], p)


def _acc_pos(lane: int, i: int):
    """(row, column) of register i of an m16n8 float32 accumulator: rows g
    and g + 8 (i >> 1), columns 2t and 2t + 1 (i & 1), g = lane / 4,
    t = lane % 4."""
    g, t = divmod(lane, 4)
    return g + 8 * (i >> 1), 2 * t + (i & 1)


def _bf16_a_pos(lane: int, reg: int, half: int):
    """(row, k) of half ``half`` of register ``reg`` of m16n8k16's bf16 A
    fragment: registers 0-3 hold (g, 2t), (g + 8, 2t), (g, 2t + 8),
    (g + 8, 2t + 8), the high half one column on."""
    g, t = divmod(lane, 4)
    return g + 8 * (reg & 1), 2 * t + 8 * (reg >> 1) + half


def _tf32_a_pos(lane: int, reg: int):
    """(row, k) of register ``reg`` of m16n8k8's TF32 A fragment: (g, t),
    (g + 8, t), (g, t + 4), (g + 8, t + 4)."""
    g, t = divmod(lane, 4)
    return g + 8 * (reg & 1), t + 4 * (reg >> 1)


def test_bf16_accumulators_are_the_pv_a_fragments():
    """k-step s of PV (16 keys) takes S's n-tiles 2s and 2s + 1: register j
    of the fragment is the pair (accumulator n-tile 2s + (j >> 1), registers
    2(j & 1) and 2(j & 1) + 1), at the same row and key, for every lane."""
    for lane in range(32):
        for j in range(4):
            nt = j >> 1
            for half in range(2):
                row, key = _acc_pos(lane, 2 * (j & 1) + half)
                assert _bf16_a_pos(lane, j, half) == (row, 8 * nt + key)


def test_tf32_accumulators_are_the_pv_a_fragments():
    """k-step s of PV (8 keys) is S's n-tile s: fragment register j is
    accumulator register (0, 2, 1, 3)[j]; position t holds key 2t and
    position t + 4 key 2t + 1, the keys the kernel reads V's B fragment at,
    and the product the tensor core forms is P V."""
    regs = (0, 2, 1, 3)
    key_at = {}
    for lane in range(32):
        for j in range(4):
            frow, pos = _tf32_a_pos(lane, j)
            arow, key = _acc_pos(lane, regs[j])
            assert frow == arow
            assert key_at.setdefault(pos, key) == key
    assert [key_at[p] for p in range(8)] == [0, 2, 4, 6, 1, 3, 5, 7]
    rng = np.random.default_rng(2)
    P, V = rng.standard_normal((16, 8)), rng.standard_normal((8, 8))
    A = np.full((16, 8), np.nan)
    Bf = np.full((8, 8), np.nan)  # B[position, n]
    for lane in range(32):
        g, t = divmod(lane, 4)
        for j in range(4):
            row, pos = _tf32_a_pos(lane, j)
            A[row, pos] = P[_acc_pos(lane, regs[j])]
        Bf[t, g], Bf[t + 4, g] = V[2 * t, g], V[2 * t + 1, g]  # b0, b1
    assert not np.isnan(A).any() and not np.isnan(Bf).any()
    assert np.allclose(A @ Bf, P @ V, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [8, 16, 32])
def test_variant_is_mma_at_small_head_dims(dtype, D):
    assert tflash.variant(dtype, D) == "mma"
    assert tflash.KERNELS["mma"] is tflash.FLASH_ATTENTION
    assert "simt" not in tflash.KERNELS
