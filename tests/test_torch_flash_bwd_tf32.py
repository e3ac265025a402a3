"""The TF32 route of the port's attention backward, on the CPU.

``csrc/flash_attention_bwd_tf32.cu`` runs only on the card; its plain version
is ``kernels.ref.flash_attention_bwd_ref``, which the CPU wrapper takes for
float32 at D 64/128.  The kernels' arithmetic is held here through an
emulation, kept in this file: every product (S = Q Kᵀ, dP = dO Vᵀ, dV = Pᵀ
dO, dQ = dS K, dK = dSᵀ Q) in three TF32 terms (a_hi·b_hi + a_hi·b_lo +
a_lo·b_hi, x_hi = rna(x), x_lo = rna(x − x_hi), P and dS split too), summed
in float64 within a tile and rounded once to float32; the dq kernel's tiles
of 32 keys (16 at MLA's (192, 128); pass 1 the row maximum and sum, so L
in base 2; pass 2 dS = P ∘ (dP − Δ)); the dkdv kernel's blocks of 64 keys
and tiles of 32 queries (16 at D 128 and at (192, 128)) over the G query
heads of a group, at D 64 the even and odd tiles summed apart and added
once at the end; each tile's product added once to a float32 sum.  On
numpy inputs from a seed, in float32, at T 24–130 (never a multiple of
64), D 64 and 128 and (D, Dv) = (192, 128), G 1, 2 and 4, causal and not:

* the emulation within 1e-5 of each output's largest magnitude of
  ``flash_attention_bwd_ref`` in float64;
* the emulation against the reference's ``jax.vjp`` of
  ``flash_attention_jnp`` in float32, within 1e-5 plus the reference's own
  error to float64 (both errors in the assertion message);
* one TF32 term (a_hi·b_hi alone) misses 1e-5 on the same data, so the gate
  sees TF32 rounding;
* with the contracted index permuted within each group of 8 as the
  producer writes Kᵀ, Qᵀ and dOᵀ, the accumulator registers fed as A
  fragments give dS K, Pᵀ dO and dSᵀ Q.
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

LOG2E = 1.4426950408889634
#: keys of the dq kernel's K/V tiles by q/k head dim (DqCfg::kN)
DQ_KEYS = {64: 32, 128: 32, 192: 16}
#: keys of a dkdv block (DkvCfg::kKeys, MlaKvCfg::kKeys)
DKV_KEYS = 64
#: queries of a dkdv tile by q/k head dim (DkvCfg::kQ, MlaKvCfg::kQ)
DKV_QUERIES = {64: 32, 128: 16, 192: 16}
#: the float32 gate of chip_smoke.py E1 and tests/test_torch_cuda.py
RTOL = 1e-5
#: (B, H, Hkv, T, D, causal): T 24–130 and never a multiple of 64, D 64
#: and 128, G = H / Hkv 1, 2 and 4, causal and not
SHAPES = [(1, 4, 1, 130, 64, False), (1, 2, 2, 24, 64, True), (2, 4, 2, 100, 64, True),
          (1, 4, 2, 72, 64, False), (1, 4, 1, 130, 128, True), (1, 2, 2, 40, 128, False),
          (1, 4, 2, 100, 128, False), (2, 4, 1, 72, 128, True)]
#: (B, H, Hkv, T, causal) at MLA's (D, Dv) = (192, 128): T not a multiple
#: of 16 or 64, G 1 and 2
MLA_SHAPES = [(1, 2, 2, 40, True), (1, 4, 2, 72, False), (2, 2, 1, 100, True)]


def product(a: torch.Tensor, b: torch.Tensor, eq: str, terms: int = 3) -> torch.Tensor:
    """einsum ``eq`` of float32 a and b as the tensor cores take it: TF32
    terms summed in float64 and rounded once to float32, three (hi·hi +
    hi·lo + lo·hi) or one (hi·hi)."""
    (ah, al), (bh, bl) = _torch_parity.split(a), _torch_parity.split(b)
    prods = [(ah, bh), (ah, bl), (al, bh)][:terms]
    return sum(torch.einsum(eq, x.double(), y.double()) for x, y in prods).float()


def _fma_exp2(s: torch.Tensor, c, sub: torch.Tensor) -> torch.Tensor:
    """exp2f(fmaf(s, c, −sub)) in float32 (the fma's one rounding taken in
    float64)."""
    return torch.exp2((s.double() * float(c) - sub.double()).float())


def dq_emulation(q, k, v, o, do, causal: bool, terms: int = 3):
    """The dq kernel on float32 q, o, do [B, H, T, D], k, v [B, Hkv, Tk, D]:
    (dq, L in base 2, Δ), each float32."""
    B, H, T, D = q.shape
    Tk = k.shape[2]
    G = H // k.shape[1]
    n = DQ_KEYS[D]
    kr, vr = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    c = scale * torch.tensor(LOG2E, dtype=torch.float32)
    delta = (do.double() * o.double()).sum(-1).float()
    rows = torch.arange(T)[:, None]

    def scores(k0):
        s = product(q, kr[:, :, k0:k0 + n], "bhqd,bhkd->bhqk", terms)
        if causal:
            keys = torch.arange(k0, min(k0 + n, Tk))[None, :]
            s = torch.where(keys > rows, torch.tensor(-1e30), s)
        return s

    m = torch.full((B, H, T), -1e30)
    l = torch.zeros((B, H, T))
    for k0 in range(0, Tk, n):
        s = scores(k0)
        mx = torch.maximum(m, s.amax(-1))
        l = l * torch.exp2((m - mx) * c) + _fma_exp2(s, c, (mx * c)[..., None]).sum(-1)
        m = mx
    lse = m * c + torch.log2(l.clamp(min=1e-30))
    acc = torch.zeros((B, H, T, D))
    for k0 in range(0, Tk, n):
        s = scores(k0)
        dp = product(do, vr[:, :, k0:k0 + n], "bhqd,bhkd->bhqk", terms)
        ds = _fma_exp2(s, c, lse[..., None]) * (dp - delta[..., None])
        acc = acc + product(ds, kr[:, :, k0:k0 + n], "bhqk,bhkd->bhqd", terms)
    return acc * scale, lse, delta


def dkdv_emulation(q, k, v, do, lse, delta, causal: bool, terms: int = 3):
    """The dkdv kernel, from the dq kernel's L and Δ: (dk, dv) float32."""
    B, H, T, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    G = H // Hkv
    kq = DKV_QUERIES[D]
    alternate = D == 64  # the two warpgroups sum the even and odd tiles apart
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    c = scale * torch.tensor(LOG2E, dtype=torch.float32)
    qg, dog = (t.reshape(B, Hkv, G, T, t.shape[-1]) for t in (q, do))
    lg, dg = (t.reshape(B, Hkv, G, T) for t in (lse, delta))
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, Tk, DKV_KEYS):
        kb, vb = k[:, :, k0:k0 + DKV_KEYS], v[:, :, k0:k0 + DKV_KEYS]
        keys = torch.arange(k0, k0 + kb.shape[2])[:, None]
        sums = [[torch.zeros_like(kb), torch.zeros_like(vb)] for _ in range(2)]
        tiles = [(g, q0) for g in range(G)
                 for q0 in range((k0 // kq) * kq if causal else 0, T, kq)]
        for it, (g, q0) in enumerate(tiles):
            qt, dot = qg[:, :, g, q0:q0 + kq], dog[:, :, g, q0:q0 + kq]
            st = product(kb, qt, "bnkd,bnqd->bnkq", terms)
            dpt = product(vb, dot, "bnkd,bnqd->bnkq", terms)
            pt = _fma_exp2(st, c, lg[:, :, g, None, q0:q0 + kq])
            if causal:
                queries = torch.arange(q0, q0 + qt.shape[2])[None, :]
                pt = torch.where(keys > queries, torch.tensor(0.0), pt)
            dst = pt * (dpt - dg[:, :, g, None, q0:q0 + kq])
            part = sums[it % 2 if alternate else 0]
            part[0] = part[0] + product(dst, qt, "bnkq,bnqd->bnkd", terms)
            part[1] = part[1] + product(pt, dot, "bnkq,bnqd->bnkd", terms)
        dk[:, :, k0:k0 + DKV_KEYS] = (sums[0][0] + sums[1][0]) * scale
        dv[:, :, k0:k0 + DKV_KEYS] = sums[0][1] + sums[1][1]
    return dk, dv


def tf32_emulation(q, k, v, o, do, causal: bool, terms: int = 3):
    """(dq, dk, dv) of the two kernels in order, float32."""
    dq, lse, delta = dq_emulation(q, k, v, o, do, causal, terms)
    return (dq, *dkdv_emulation(q, k, v, do, lse, delta, causal, terms))


def _inputs(B, H, Hkv, T, D, seed=0, Dv=None):
    """q, k, v, dO from a seed; v and dO of Dv columns (default D)."""
    rng = np.random.default_rng(seed + T + D + H)
    Dv = Dv or D
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, H, T, D), (B, Hkv, T, D), (B, Hkv, T, Dv), (B, H, T, Dv))]


def _err(got, want) -> float:
    """max |got − want| over max |want|."""
    got, want = got.double(), torch.as_tensor(np.array(want, dtype=np.float64))
    return float((got - want).abs().max() / want.abs().max())


def _exact(q, k, v, o, do, causal):
    return ref.flash_attention_bwd_ref(*(t.double() for t in (q, k, v, o, do)),
                                       causal=causal)


@pytest.mark.parametrize("B,H,Hkv,T,D,causal", SHAPES)
def test_emulation_within_1e5_of_float64(B, H, Hkv, T, D, causal):
    q, k, v, do = (torch.tensor(a) for a in _inputs(B, H, Hkv, T, D))
    o = ref.flash_attention_ref(q.double(), k.double(), v.double(), causal=causal).float()
    got = tf32_emulation(q, k, v, o, do, causal)
    for name, g, w, inp in zip(("dq", "dk", "dv"), got, _exact(q, k, v, o, do, causal),
                               (q, k, v)):
        assert g.dtype == torch.float32 and g.shape == inp.shape
        assert _err(g, w) <= RTOL, (name, _err(g, w))


@pytest.mark.parametrize("B,H,Hkv,T,causal", MLA_SHAPES)
def test_mla_emulation_within_1e5_of_float64(B, H, Hkv, T, causal):
    """The same at MLA's pair: q and k of 192 columns, v, o and dO of 128;
    the dq kernel's 16-key tiles and the dkdv kernel's 16-query tiles."""
    q, k, v, do = (torch.tensor(a) for a in _inputs(B, H, Hkv, T, 192, Dv=128))
    o = ref.flash_attention_ref(q.double(), k.double(), v.double(), causal=causal).float()
    got = tf32_emulation(q, k, v, o, do, causal)
    for name, g, w, inp in zip(("dq", "dk", "dv"), got, _exact(q, k, v, o, do, causal),
                               (q, k, v)):
        assert g.dtype == torch.float32 and g.shape == inp.shape
        assert _err(g, w) <= RTOL, (name, _err(g, w))


@pytest.mark.parametrize("B,H,Hkv,T,causal", MLA_SHAPES)
def test_mla_emulation_matches_jax_vjp_in_float32(B, H, Hkv, T, causal):
    """At MLA's pair against the reference's ``jax.vjp`` of
    ``flash_attention_jnp`` (which takes v of another head dim), as below."""
    _check_against_vjp(_inputs(B, H, Hkv, T, 192, seed=1, Dv=128), causal)


@pytest.mark.parametrize("B,H,Hkv,T,D,causal", SHAPES)
def test_emulation_matches_jax_vjp_in_float32(B, H, Hkv, T, D, causal):
    _check_against_vjp(_inputs(B, H, Hkv, T, D, seed=1), causal)


def _check_against_vjp(arrs, causal: bool) -> None:
    """The emulation on ``arrs`` (q, k, v, dO) against the reference's
    ``jax.vjp`` in float32, within RTOL plus the reference's own error to
    float64, and within RTOL of float64."""

    def f(q_, k_, v_):
        return rattn.flash_attention_jnp(q_, k_, v_, causal=causal)

    o, vjp = jax.vjp(f, *(jnp.asarray(a) for a in arrs[:3]))
    want = [np.asarray(g) for g in vjp(jnp.asarray(arrs[3]))]
    q, k, v, o_t, do = (torch.tensor(np.asarray(a)) for a in (*arrs[:3], o, arrs[3]))
    got = tf32_emulation(q, k, v, o_t, do, causal)
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, _exact(q, k, v, o_t, do, causal)):
        assert w.dtype == np.float32
        ref_err, port_err = _err(torch.tensor(w), x), _err(g, x)
        assert _err(g, w) <= RTOL + ref_err, (
            f"{name}: port vs reference {_err(g, w):.3e}; reference vs float64 "
            f"{ref_err:.3e}; port vs float64 {port_err:.3e}")
        assert port_err <= RTOL, (name, port_err)


def test_one_term_misses_1e5():
    """Why every product takes three TF32 terms: a_hi·b_hi alone lands
    beyond 1e-5 of float64 on the first shape's data, three terms within."""
    B, H, Hkv, T, D, causal = SHAPES[0]
    q, k, v, do = (torch.tensor(a) for a in _inputs(B, H, Hkv, T, D))
    o = ref.flash_attention_ref(q.double(), k.double(), v.double(), causal=causal).float()
    want = _exact(q, k, v, o, do, causal)
    one = max(_err(g, w) for g, w in zip(tf32_emulation(q, k, v, o, do, causal, terms=1), want))
    three = max(_err(g, w) for g, w in zip(tf32_emulation(q, k, v, o, do, causal), want))
    assert one > RTOL >= three, (one, three)


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


#: the accumulator element the kernels put in fragment register j
#: (``frag_elem`` of the source, within a group of 8)
KERNEL_REG = [((j & 1) << 1) + (j >> 1) for j in range(4)]


def transposed_order(n: int) -> list:
    """The tile row that ``transpose_split`` writes at each position of a
    transposed copy of an n-row tile: chunk jq (positions 4jq .. 4jq + 3)
    takes rows r, r + 2, r + 4, r + 6 with r = 8(jq / 2) + jq % 2."""
    order = []
    for jq in range(n // 4):
        r = 8 * (jq // 2) + (jq & 1)
        order += [r, r + 2, r + 4, r + 6]
    return order


@pytest.mark.parametrize("n", [16, 32])
def test_transposed_copies_permute_within_groups_of_8(n):
    """The producer's order is the fragments' order in every group of 8: the
    k index register j of a lane stands at holds the column of the
    accumulator element the lane puts there."""
    order = transposed_order(n)
    assert sorted(order) == list(range(n))
    for lane in range(32):
        for j in range(4):
            frow, kidx = _frag_pos(lane, j)
            arow, col = _acc_pos(lane, KERNEL_REG[j])
            assert frow == arow
            for group in range(n // 8):
                assert order[8 * group + kidx] == 8 * group + col


def _tensor_core(X: np.ndarray, copy: np.ndarray) -> np.ndarray:
    """Σ over the k-steps g of A_g Bᵀ_g: A_g the register-A fragments the
    lanes form from the accumulator X [16 x 32] (``KERNEL_REG``), B_g the
    positions 8g .. 8g + 7 of the transposed copy [D x 32]."""
    got = np.zeros((X.shape[0], copy.shape[0]))
    for g in range(X.shape[1] // 8):
        A = np.full((16, 8), np.nan)
        for lane in range(32):
            for j in range(4):
                row, kidx = _frag_pos(lane, j)
                arow, col = _acc_pos(lane, KERNEL_REG[j])
                A[row, kidx] = X[arow, 8 * g + col]
        assert not np.isnan(A).any()
        got += A @ copy[:, 8 * g:8 * g + 8].T
    return got


@pytest.mark.parametrize("name", ["dS K", "Pᵀ dO", "dSᵀ Q"])
def test_accumulator_as_fragment_gives_the_product(name):
    """X [16 x 32] as the lanes hold it in accumulator layout (S for dS K,
    Sᵀ for Pᵀ dO and dSᵀ Q), fed k-step by k-step as register-A fragments,
    times the transposed copy of Y [32 x 64] (K, dO or Q) in the producer's
    order: the tensor core's Σ_k A[row, k] Yᵀ[d, k] is X Y; the copy in
    Y's own order gives another product."""
    rng = np.random.default_rng(["dS K", "Pᵀ dO", "dSᵀ Q"].index(name))
    X = rng.standard_normal((16, 32))
    Y = rng.standard_normal((32, 64))
    permuted = Y[transposed_order(32)].T  # row d, position q: Y[order[q], d]
    assert np.allclose(_tensor_core(X, permuted), X @ Y, rtol=0, atol=1e-12)
    assert not np.allclose(_tensor_core(X, Y.T), X @ Y)


def test_route_and_kernel_object():
    for D in (64, 128):
        assert tflash.bwd_variant(torch.float32, D) == "tf32"
    assert tflash.BWD_KERNELS["tf32"] is tflash.FLASH_ATTENTION_BWD_TF32
    assert tflash.BWD_PLAIN["tf32"] is ref.flash_attention_bwd_ref
    assert tflash.FLASH_ATTENTION_BWD_TF32.source == "flash_attention_bwd_tf32.cu"
    assert tflash.FLASH_ATTENTION_BWD_TF32.entry == "repro_flash_attention_bwd_tf32"
