"""Plain PyTorch versions of the port's kernels (the ground truth in tests).

The ⊎ kernels (``ring_scatter``, ``segment_ring_sum``) are built on
``index_add_``; rows whose id is < 0 or >= S drop.  The kernel-ops layer
(``ops``: cofactor statistics, the degree-m product, the rank-1 chain, flash
attention) is plain tensor arithmetic.  Each wrapper takes its plain version
for tensors on the CPU; on the card the kernels are held against these.
"""
from __future__ import annotations

import math

import torch


def _valid(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    return (ids >= 0) & (ids < num_segments)


def scatter_add_ref(view: torch.Tensor, seg_ids: torch.Tensor,
                    values: torch.Tensor) -> torch.Tensor:
    """view [S, d] += values [B, d] at seg_ids [B], in place; returns view."""
    keep = _valid(seg_ids, view.shape[0])
    return view.index_add_(0, seg_ids[keep].long(), values[keep])


def segment_ring_sum_ref(values: torch.Tensor, seg_ids: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """Group-by ⊕ of payload rows: values [B, d], ids [B] -> new [S, d]."""
    out = torch.zeros((num_segments, values.shape[1]), dtype=torch.float32,
                      device=values.device)
    return scatter_add_ref(out, seg_ids, values.to(torch.float32))


def gather_mul_scatter_ref(view: torch.Tensor, out_ids: torch.Tensor,
                           src: torch.Tensor, in_ids: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """view [S, d] += scale[b] · src[in_ids[b]] at out_ids[b], in place;
    in_ids clamp into [0, Sg - 1] (the reference's ``mode="clip"``)."""
    rows = in_ids.clamp(0, src.shape[0] - 1).long()
    return scatter_add_ref(view, out_ids, src.index_select(0, rows)
                           * scale[:, None])


# ---------------------------------------------------------------------------
# Plain versions of the kernel-ops layer (``kernels/ops.py``): cofactor
# statistics, the batched degree-m product and the rank-1 chain pieces.
# Inputs are cast to float32, as the reference's ``.astype(jnp.float32)``.
# ---------------------------------------------------------------------------
def cofactor_update_ref(x: torch.Tensor, w: torch.Tensor):
    """(c, s, Q) = (Σw, Σ w·x, Xᵀ diag(w) X) of x [B, m], w [B] in float32;
    c is a 0-d tensor, as the reference's."""
    xf, wf = x.to(torch.float32), w.to(torch.float32)
    xw = xf * wf[:, None]
    return wf.sum(), xw.sum(dim=0), xw.T @ xf


def ring_mul_ref(ca, sa, Qa, cb, sb, Qb):
    """Degree-m ring product batched over K keys (Def. 7.2), in
    ``Ring.mul``'s term order ``((cb·Qa + ca·Qb) + sa sbᵀ) + sb saᵀ``; the
    outer products are elementwise products, so every term is rounded once
    and the result is independent of how the device would contract it."""
    ca, sa, Qa, cb, sb, Qb = (t.to(torch.float32) for t in (ca, sa, Qa, cb, sb, Qb))
    c = ca * cb
    s = cb[:, None] * sa + ca[:, None] * sb
    Q = (cb[:, None, None] * Qa + ca[:, None, None] * Qb
         + sa[:, :, None] * sb[:, None, :] + sb[:, :, None] * sa[:, None, :])
    return c, s, Q


def matvec_ref(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x in float32; A [n, k] (any strides), x [k]."""
    return A.to(torch.float32) @ x.to(torch.float32)


def outer_accumulate_ref(V: torch.Tensor, u: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """V + u vᵀ into a new float32 tensor (one multiply, then one add)."""
    return V.to(torch.float32) + torch.outer(u.to(torch.float32),
                                             v.to(torch.float32))


def rank1_chain_ref(A1, u, v, A3, V) -> torch.Tensor:
    """V + (A1 u)(vᵀ A3): the factorized delta of the chain A1·δA2·A3 with
    δA2 = u vᵀ (Example 7.1); nothing bigger than V is formed."""
    u2 = matvec_ref(A1, u)
    v2 = v.to(torch.float32) @ A3.to(torch.float32)
    return outer_accumulate_ref(V, u2, v2)


def check_prefix(causal: bool, T: int, Tk: int, prefix_len) -> int:
    """The prefix length as an int (0: none) after checking it: a prefix-LM
    mask needs ``causal`` and T == Tk (the reference's plain branch ignores
    ``causal`` under a prefix and its chunked branch does not, so the port
    takes neither reading), and 0 <= prefix_len <= T."""
    if prefix_len is None:
        return 0
    if not causal:
        raise ValueError(f"a prefix-LM mask (prefix_len {prefix_len}) needs causal=True")
    if T != Tk:
        raise ValueError(f"a prefix-LM mask needs T == Tk, got {T} and {Tk}")
    if not 0 <= prefix_len <= T:
        raise ValueError(f"prefix_len {prefix_len} is outside [0, {T}]")
    return int(prefix_len)


def attention_mask(T: int, Tk: int, causal: bool, prefix_len=None, device=None):
    """The [T, Tk] boolean mask (True = attend) of the flash kernels, or
    None with no mask: causal aligned at the last query (``tril(ones, Tk -
    T)``); with ``prefix_len`` P (T == Tk) row r sees keys 0..max(r, P − 1),
    which is the reference's ``(k <= r) | (r < P & k < P)``, and P = 0 is
    the causal mask."""
    P = check_prefix(causal, T, Tk, prefix_len)
    if not causal:
        return None
    mask = torch.ones((T, Tk), dtype=torch.bool, device=device).tril(Tk - T)
    if P:
        mask[:P, :P] = True
    return mask


def flash_attention_ref(q, k, v, causal: bool = True, scale=None, prefix_len=None):
    """Plain attention: q [B, H, T, D], k [B, Hkv, Tk, D] and v [B, Hkv, Tk,
    Dv] (KV heads are repeated, q-head h reading kv-head h // (H / Hkv);
    Dv ≠ D is MLA's) -> [B, H, T, Dv] in float32, or in float64 for float64
    inputs, with scale 1/√D.  Scores are masked with -1e30 by
    ``attention_mask`` (causal aligned at the last query, or the prefix-LM
    mask of ``prefix_len``)."""
    B, H, T, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    mask = attention_mask(T, Tk, causal, prefix_len, q.device)
    dt = torch.float64 if q.dtype == torch.float64 else torch.float32
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
    if scale is None:  # computed in the working dtype, as the reference's
        scale = 1.0 / torch.sqrt(torch.tensor(float(D), dtype=dt, device=q.device))
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(dt), k.to(dt)) * scale
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(dt))


def flash_attention_lse_ref(q, k, v, causal: bool = True, prefix_len=None):
    """L [B, H, T] of q [B, H, T, D] over k [B, Hkv, Tk, D]: each row's
    logsumexp in base 2 of the scores scaled by 1/√D and masked at -1e30 (the
    denominator floored at 1e-30), in float32 (float64 for float64 inputs):
    the L the backward computes (``_attention_bwd``), as the forward kernel
    gives it where ``flash_attention.lse_route`` holds; ``prefix_len`` as
    ``flash_attention_ref``'s.  v is checked by the callers and not read."""
    dt = torch.float64 if q.dtype == torch.float64 else torch.float32
    s = _scores(q, k, causal, dt, prefix_len)
    return (_lse(s) * (1.0 / math.log(2.0))).squeeze(-1)


def _scores(q, k, causal: bool, dt, prefix_len=None):
    """The scores of ``_attention_bwd``: q kᵀ (kv-heads repeated) times the
    double 1/√D in ``dt``, masked at -1e30 by ``attention_mask``."""
    B, H, T, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    mask = attention_mask(T, Tk, causal, prefix_len, q.device)
    kr = k.to(dt).repeat_interleave(H // Hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(dt), kr) * (1.0 / math.sqrt(D))
    if mask is not None:
        s = torch.where(mask, s, -1e30)
    return s


def _lse(s):
    """The row logsumexp (natural) of scores s, the denominator floored at
    1e-30, keeping the last axis."""
    m = s.amax(dim=-1, keepdim=True)
    return m + torch.log(torch.exp(s - m).sum(dim=-1, keepdim=True).clamp(min=1e-30))


def flash_attention_bwd_ref(q, k, v, o, do, causal: bool = True, lse=None,
                            prefix_len=None):
    """The gradient of ``flash_attention`` (the plain version of
    ``csrc/flash_attention_bwd.cu``): (dq, dk, dv) of q [B, H, T, D], k [B,
    Hkv, Tk, D], v [B, Hkv, Tk, Dv], the forward's output o and its gradient
    do [B, H, T, Dv], in float32 (float64 for float64 inputs), written from
    the formulas (Dv ≠ D is MLA's).

    P is recomputed from the scores (scale 1/√D, masked at -1e30) and the
    row logsumexp L (the denominator floored at 1e-30) and stays in the
    working dtype, as the kernels keep it; then Δ = rowsum(dO∘O) over the Dv
    columns, dV = Pᵀ dO, dS = P∘(dO Vᵀ − Δ), dQ = dS K·scale and dK = dSᵀ
    Q·scale, the scale 1/√D at any Dv.
    q-head h reads kv-head h // G (G = H / Hkv); dK and dV sum over the G
    query heads of their group.  The causal mask is aligned at the last
    query, as ``flash_attention_ref``'s, or the prefix-LM mask of
    ``prefix_len``.  ``lse``, the forward's L [B, H, R ≥ T] in base 2
    (``flash_attention_lse_ref``), is taken in place of L where it is
    given."""
    dt = torch.float64 if q.dtype == torch.float64 else torch.float32
    return _attention_bwd(q, k, v, o, do, causal, dt, None, lse, prefix_len)


def flash_attention_bwd_bf16_ref(q, k, v, o, do, causal: bool = True, lse=None,
                                 prefix_len=None):
    """The plain version of ``csrc/flash_attention_bwd_wgmma.cu`` (bf16 at
    (D, Dv) ∈ {(64, 64), (128, 128), (192, 128)}): ``flash_attention_bwd_ref``
    in float32 with P rounded once to bf16 where it enters dV = Pᵀ dO, and
    dS (formed from the float32 P) rounded once to bf16 where it enters dQ =
    dS K and dK = dSᵀ Q, as the kernel feeds them to the tensor cores; S,
    dP, the softmax and every sum stay float32.  ``lse`` and ``prefix_len``
    as ``flash_attention_bwd_ref``'s."""
    return _attention_bwd(q, k, v, o, do, causal, torch.float32, torch.bfloat16, lse,
                          prefix_len)


def _attention_bwd(q, k, v, o, do, causal, dt, rounded, lse2=None, prefix_len=None):
    """FlashAttention-2's backward in ``dt``, with P and dS rounded to
    ``rounded`` (None: not rounded) where they enter their products, and L
    from ``lse2`` (base 2, rows past T ignored) where it is given."""
    B, H, T, D = q.shape
    Hkv, Tk, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)  # the kernel's: a double, rounded to the working dtype
    s = _scores(q, k, causal, dt, prefix_len)
    q, k, v, o, do = (t.to(dt) for t in (q, k, v, o, do))
    kr, vr = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    if lse2 is None:
        lse = _lse(s)
    else:
        lse = lse2[..., :T, None].to(dt) * math.log(2.0)
    p = torch.exp(s - lse)
    delta = (do * o).sum(dim=-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do, vr) - delta)
    if rounded is not None:
        p, ds = p.to(rounded).to(dt), ds.to(rounded).to(dt)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale
    return (dq, dk.reshape(B, Hkv, G, Tk, D).sum(dim=2),
            dv.reshape(B, Hkv, G, Tk, Dv).sum(dim=2))
