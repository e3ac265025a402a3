"""Causal flash attention on the card.

Wrapper for the Hopper counterparts of
``repro/kernels/flash_attention.py::flash_attention``: online-softmax
attention of q [B, H, T, D] over k [B, Hkv, Tk, D] and v [B, Hkv, Tk, Dv],
with scale 1/√D, masked scores at -1e30, running max, denominator and
accumulator in float32, the denominator floored at 1e-30 and one rounding
of the output [B, H, T, Dv] to q's dtype (float32 or bfloat16).  The head
dims are a pair of ``PAIRS``: D = Dv ∈ {8, 16, 32, 64, 128, 256}, or MLA's
(the reference's ``flash_attention_jnp`` takes Dv ≠ D): deepseek-v3-671b's
(192, 128) and its reduced config's (16, 8).  GQA is by index: q-head h
reads kv-head h // (H / Hkv), so K and V are never repeated in memory.
Any T works; causal attention needs T == Tk (query i sees keys 0..i).
``prefix_len`` P is paligemma-3b's prefix-LM mask (causal, T == Tk): row r
sees keys 0..max(r, P − 1), the reference's ``prefix_lm_mask``; every
forward and backward kernel takes it.  A CPU tensor takes the
plain version (``ref``), cast to q's dtype; any other dtype, device or
head-dim pair raises.

Three kernels, chosen by :func:`variant` from the dtype and head dims alone:

* ``csrc/flash_attention_wgmma.cu`` for bf16 at (64, 64), (128, 128),
  (192, 128) and (256, 256), the head dims of every full-size config the
  port builds:
  tensor cores (wgmma) fed by TMA, with P split into three bf16 terms for
  PV (they sum to the float32 P exactly);
* ``csrc/flash_attention_tf32.cu`` for float32 at the same pairs, the
  path's precision check: TF32 tensor cores (wgmma) fed by TMA, each
  product taken as three TF32 terms (a_hi·b_hi + a_hi·b_lo + a_lo·b_hi),
  float32 accuracy;
* ``csrc/flash_attention.cu``'s mma kernel for every dtype at (8, 8), (16,
  16), (32, 32) and (16, 8) (the reduced configs): warp-level tensor cores
  (``mma.sync``) fed by ``cp.async``, with the same three-term products
  (bf16: P in three bf16 terms; float32: three TF32 terms).

The same library also holds the first, SIMT kernel (float32 CUDA-core
FMAs, every D = Dv), which :func:`launch` runs only when asked for by
name (``"simt"``): ``chip_smoke.py`` times it beside the others.  The
tensor-core kernels read 16-byte aligned q, k and v (TMA, ``cp.async``);
one at an offset that is not is copied once.

The gradient: :class:`FlashAttentionFn` is the forward as an autograd
function; its backward is :func:`flash_attention_bwd`, hand kernels with no
Pallas original (the reference trains by ``jax.grad`` through
``flash_attention_jnp``): dQ, dK and dV, float32 accumulation, no atomics
(two calls are bitwise equal), at every pair of ``PAIRS`` (``BWD_PAIRS``:
every config trains, paligemma-3b at head dim 256 with its prefix too),
each under the prefix-LM mask where one is given.  Three routes, chosen by
:func:`bwd_variant` from the dtype and head dims alone:

* ``csrc/flash_attention_bwd_wgmma.cu`` (``FLASH_ATTENTION_BWD_WGMMA``) for
  bf16 at (64, 64), (128, 128), (192, 128) and (256, 256), the training
  path of every full-size config: a dq and a dkdv kernel on tensor cores
  (wgmma) fed by TMA, with P and dS rounded once to bf16 where they enter
  their products (plain version ``ref.flash_attention_bwd_bf16_ref``); at
  every pair the forward kernel also writes each row's logsumexp L
  (``LSE_PAIRS``) and ``FlashAttentionFn`` hands it to this route, whose
  dq kernel then makes one pass;
* ``csrc/flash_attention_bwd_tf32.cu`` (``FLASH_ATTENTION_BWD_TF32``) for
  float32 at the same pairs, the training path's precision check: the same
  products on the TF32 tensor cores, every product taken as three TF32
  terms (a_hi·b_hi + a_hi·b_lo + a_lo·b_hi, P and dS split too), float32
  accuracy (plain version ``ref.flash_attention_bwd_ref``); at D = Dv it
  takes the TF32 forward's L as the bf16 route does;
* ``csrc/flash_attention_bwd.cu`` (``FLASH_ATTENTION_BWD``) for every dtype
  at D = Dv ∈ {8, 16, 32} and MLA's reduced (16, 8): two SIMT float32
  kernels, P and dS never rounded (plain version
  ``ref.flash_attention_bwd_ref``).

:func:`bwd_launch` runs any of them by name; the SIMT route takes every
dtype at every pair of ``SIMT_BWD_PAIRS`` (all but (192, 128) and (256,
256)), so ``chip_smoke.py`` times it beside the tensor-core routes.
``models.attention.flash_attention`` takes the backward on CUDA tensors
when a gradient is asked for; serving keeps the plain launch.
"""
from __future__ import annotations

import torch

from . import ref
from ._cuda import I32, PTR, CudaKernel, on_card, stream_handle

FLASH_ATTENTION = CudaKernel("flash_attention.cu", "repro_flash_attention",
                             [PTR] * 4 + [I32] * 11)
FLASH_ATTENTION_WGMMA = CudaKernel("flash_attention_wgmma.cu",
                                   "repro_flash_attention_wgmma", [PTR] * 5 + [I32] * 9)
FLASH_ATTENTION_TF32 = CudaKernel("flash_attention_tf32.cu",
                                  "repro_flash_attention_tf32", [PTR] * 5 + [I32] * 9)
FLASH_ATTENTION_BWD = CudaKernel("flash_attention_bwd.cu",
                                 "repro_flash_attention_bwd",
                                 [PTR] * 10 + [I32] * 10)
FLASH_ATTENTION_BWD_WGMMA = CudaKernel("flash_attention_bwd_wgmma.cu",
                                       "repro_flash_attention_bwd_wgmma",
                                       [PTR] * 10 + [I32] * 10)
FLASH_ATTENTION_BWD_TF32 = CudaKernel("flash_attention_bwd_tf32.cu",
                                      "repro_flash_attention_bwd_tf32",
                                      [PTR] * 10 + [I32] * 10)

#: head dims the SIMT kernels are compiled for with q, k and v of one head dim
HEAD_DIMS = (8, 16, 32, 64, 128)
#: (q/k head dim, v head dim) pairs the forward kernels take: D = Dv, MLA's
#: (deepseek-v3-671b's 128 + 64 → 128, its reduced config's 8 + 8 → 8) and
#: paligemma-3b's 256
PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((16, 8), (192, 128), (256, 256))
#: pairs of the wgmma forward kernels (wgmma: bf16, tf32: float32)
WGMMA_PAIRS = ((64, 64), (128, 128), (192, 128), (256, 256))
#: pairs the backward kernels take: every forward pair (the tensor-core
#: backward kernels take WGMMA_PAIRS, as the forward's)
BWD_PAIRS = PAIRS
#: pairs of the SIMT backward kernels: all but (192, 128) and (256, 256)
SIMT_BWD_PAIRS = tuple(p for p in BWD_PAIRS if p not in ((192, 128), (256, 256)))
#: the tensor-core backwards' L and Δ scratch has T rounded up to a multiple
#: of this (the wgmma route's dq tile)
BWD_ROWS = 128
#: pairs at which the forward kernel of each dtype writes L, each row's
#: logsumexp in base 2, and the backward takes it in place of a pass of its
#: own: the wgmma routes at every pair, the tf32 routes at D = Dv (their
#: (192, 128) dq kernel still makes its own pass)
LSE_PAIRS = {torch.bfloat16: WGMMA_PAIRS,
             torch.float32: ((64, 64), (128, 128), (256, 256))}
#: dtype codes of ``csrc/flash_attention.cu``'s C entry
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def variant(dtype: torch.dtype, head_dim: int, v_head_dim: int | None = None) -> str:
    """The kernel that takes (dtype, head_dim, v_head_dim) on the card
    (``v_head_dim`` defaults to ``head_dim``): at a pair of WGMMA_PAIRS
    ``"wgmma"`` (``FLASH_ATTENTION_WGMMA``) for bf16 and ``"tf32"``
    (``FLASH_ATTENTION_TF32``) for float32, else ``"mma"``
    (``FLASH_ATTENTION``'s mma kernel)."""
    if (head_dim, head_dim if v_head_dim is None else v_head_dim) in WGMMA_PAIRS:
        if dtype == torch.bfloat16:
            return "wgmma"
        if dtype == torch.float32:
            return "tf32"
    return "mma"


def lse_route(dtype: torch.dtype, head_dim: int, v_head_dim: int | None = None) -> bool:
    """True where the forward gives L (``flash_attention(...,
    return_lse=True)``) and the backward takes it (``flash_attention_bwd(...,
    lse=L)``): at a pair of ``LSE_PAIRS[dtype]`` (the wgmma and tf32
    routes)."""
    pair = (head_dim, head_dim if v_head_dim is None else v_head_dim)
    return pair in LSE_PAIRS.get(dtype, ())


#: the kernel object of each variant
KERNELS = {"wgmma": FLASH_ATTENTION_WGMMA, "tf32": FLASH_ATTENTION_TF32,
           "mma": FLASH_ATTENTION}


def bwd_variant(dtype: torch.dtype, head_dim: int, v_head_dim: int | None = None) -> str:
    """The backward route of (dtype, head_dim, v_head_dim) on the card
    (``v_head_dim`` defaults to ``head_dim``): at a pair of WGMMA_PAIRS
    ``"wgmma"`` (``FLASH_ATTENTION_BWD_WGMMA``) for bf16 and ``"tf32"``
    (``FLASH_ATTENTION_BWD_TF32``) for float32, else ``"simt"``
    (``FLASH_ATTENTION_BWD``)."""
    pair = (head_dim, head_dim if v_head_dim is None else v_head_dim)
    if pair in WGMMA_PAIRS:
        if dtype == torch.bfloat16:
            return "wgmma"
        if dtype == torch.float32:
            return "tf32"
    return "simt"


#: the kernel object and the plain version of each backward route
BWD_KERNELS = {"wgmma": FLASH_ATTENTION_BWD_WGMMA, "tf32": FLASH_ATTENTION_BWD_TF32,
               "simt": FLASH_ATTENTION_BWD}
BWD_PLAIN = {"wgmma": ref.flash_attention_bwd_bf16_ref,
             "tf32": ref.flash_attention_bwd_ref,
             "simt": ref.flash_attention_bwd_ref}


def _check(q, k, v, causal: bool, prefix_len=None) -> int:
    """Raise unless q [B, H, T, D], k [B, Hkv, Tk, D] and v [B, Hkv, Tk,
    Dv] are what the kernels take, with ``prefix_len`` (a prefix-LM mask:
    ``causal`` and T == Tk, ``ref.check_prefix``); returns the prefix
    length, 0 for none."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"expected q [B,H,T,D], k [B,Hkv,Tk,D] and v [B,Hkv,Tk,Dv]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, T, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or H % Hkv:
        raise ValueError(f"k and v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if causal and T != Tk:
        raise ValueError(f"causal attention needs T == Tk, got {T} and {Tk}")
    prefix = ref.check_prefix(causal, T, Tk, prefix_len)
    if (D, v.shape[3]) not in PAIRS:
        raise ValueError(f"head dims (q/k {D}, v {v.shape[3]}) are not a pair the "
                         f"kernels take: {PAIRS}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, q is "
                             f"{q.dtype} on {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"q has dtype {q.dtype}, expected float32 or bfloat16")
    if on_card(q) and B * H > 65535:
        raise ValueError(f"B·H = {B * H} exceeds the grid's 65,535")
    return prefix


def flash_attention(q, k, v, causal: bool = True, return_lse: bool = False,
                    prefix_len=None):
    """q [B, H, T, D], k [B, Hkv, Tk, D], v [B, Hkv, Tk, Dv] -> [B, H, T,
    Dv] in q's dtype; with ``return_lse`` (where ``lse_route`` holds, Tk >
    0) the pair (o, L): L float32 [B, H, R], each row's logsumexp of the
    scaled, masked scores in base 2, R = T on the CPU (the plain version)
    and T rounded up to BWD_ROWS on the card (rows past T finite).  With
    ``prefix_len`` P (causal, T == Tk) row r sees keys 0..max(r, P − 1),
    the reference's prefix-LM mask; every kernel takes it."""
    prefix = _check(q, k, v, causal, prefix_len)
    if return_lse and not (lse_route(q.dtype, q.shape[3], v.shape[3]) and k.shape[2]):
        raise ValueError(f"no L from the forward of {q.dtype} at (D, Dv) = "
                         f"({q.shape[3]}, {v.shape[3]}) over {k.shape[2]} keys; "
                         f"it is given at {LSE_PAIRS.get(q.dtype, ())}")
    if not on_card(q):
        o = ref.flash_attention_ref(q, k, v, causal=causal, prefix_len=prefix_len).to(q.dtype)
        if return_lse:
            return o, ref.flash_attention_lse_ref(q, k, v, causal=causal, prefix_len=prefix_len)
        return o
    return launch(variant(q.dtype, q.shape[3], v.shape[3]), q, k, v, causal, return_lse,
                  prefix)


def flash_attention_bwd(q, k, v, o, do, causal: bool = True, lse=None, prefix_len=None):
    """(dq, dk, dv) of ``flash_attention(q, k, v, causal, prefix_len=...)``
    whose output is o [B, H, T, Dv], for the output gradient do [B, H, T,
    Dv]; each in q's dtype and the shape of its input.  ``lse``, where
    ``lse_route`` holds, is the forward's L (``flash_attention(...,
    return_lse=True)``): the route then takes it in place of computing it.
    CUDA tensors launch the route ``bwd_variant`` names (one call); CPU
    tensors take that route's plain version (``BWD_PLAIN``).  Every route
    takes ``prefix_len`` (the prefix-LM mask, as the forward).  A pair
    outside ``PAIRS`` raises ``ValueError`` (``_check``)."""
    prefix = _check(q, k, v, causal, prefix_len)
    D, Dv = q.shape[3], v.shape[3]
    want = (*q.shape[:3], Dv)
    for name, t in (("o", o), ("do", do)):
        if t.shape != want or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} is {tuple(t.shape)} {t.dtype} on {t.device}; "
                             f"expected {want} {q.dtype} on {q.device}")
    if lse is not None:
        _check_lse(lse, q, D, Dv)
    kind = bwd_variant(q.dtype, D, Dv)
    if not on_card(q):
        return tuple(g.to(q.dtype) for g in
                     BWD_PLAIN[kind](q, k, v, o, do, causal=causal, lse=lse,
                                     prefix_len=prefix_len))
    return bwd_launch(kind, q, k, v, o, do, causal, lse, prefix)


def _check_lse(lse, q, D: int, Dv: int) -> None:
    """Raise unless ``lse`` is L as ``flash_attention(q, ...,
    return_lse=True)`` gives it on q's device."""
    B, H, T = q.shape[:3]
    if not lse_route(q.dtype, D, Dv):
        raise ValueError(f"the backward of {q.dtype} at (D, Dv) = ({D}, {Dv}) takes no "
                         f"L; it does at {LSE_PAIRS.get(q.dtype, ())}")
    rows = -(-T // BWD_ROWS) * BWD_ROWS if on_card(q) else T
    if (lse.dtype != torch.float32 or lse.device != q.device
            or tuple(lse.shape) != (B, H, rows) or not lse.is_contiguous()):
        raise ValueError(f"lse is {tuple(lse.shape)} {lse.dtype} on {lse.device}; "
                         f"expected contiguous {(B, H, rows)} float32 on {q.device}")


def bwd_launch(kind: str, q, k, v, o, do, causal: bool = True, lse=None,
               prefix_len: int = 0):
    """Launch the ``kind`` backward (a key of BWD_KERNELS) on CUDA tensors
    that ``flash_attention_bwd`` has checked, with the forward's L where it
    is given and a prefix of ``prefix_len`` rows (0: none).  The wrapper
    passes ``bwd_variant``'s choice; ``chip_smoke.py`` also passes
    ``"simt"`` at the tensor-core routes' shapes of SIMT_BWD_PAIRS, to time
    them on the same inputs."""
    B, H, T, D = q.shape
    Hkv, Tk, Dv = k.shape[1], k.shape[2], v.shape[3]
    if kind == "simt" and (D, Dv) not in SIMT_BWD_PAIRS:
        raise ValueError(f"the simt backward does not take (D, Dv) = ({D}, {Dv})")
    if kind != "simt" and bwd_variant(q.dtype, D, Dv) != kind:
        raise ValueError(f"the {kind} backward does not take {q.dtype} at "
                         f"(D, Dv) = ({D}, {Dv})")
    if lse is not None and kind == "simt":
        raise ValueError(f"the {kind} backward takes no L")
    q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
    if kind != "simt":  # TMA reads 16-byte aligned rows
        q, k, v, o, do = (t if t.data_ptr() % 16 == 0 else t.clone()
                          for t in (q, k, v, o, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if not q.numel():
        return dq, dk.zero_(), dv.zero_()
    # the row logsumexp (base 2), the forward's or written by the first
    # kernel, and Δ, written by the first kernel
    rows = T if kind == "simt" else -(-T // BWD_ROWS) * BWD_ROWS
    delta = torch.empty((B * H, rows), dtype=torch.float32, device=q.device)
    lse2 = torch.empty_like(delta) if lse is None else lse
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse2.data_ptr(),
            delta.data_ptr(), B, H, Hkv, T, Tk, D, Dv)
    if kind != "simt":
        BWD_KERNELS[kind].launch(*args, int(causal), int(prefix_len), int(lse is not None),
                                 stream_handle(q))
    else:
        FLASH_ATTENTION_BWD.launch(*args, DTYPES[q.dtype], int(causal), int(prefix_len),
                                   stream_handle(q))
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with its gradient: the forward launches the
    kernel ``variant`` names, as ``flash_attention`` does, and keeps q, k,
    v, its output, the prefix and, where ``lse_route`` holds, its L; the
    backward is :func:`flash_attention_bwd`, given that L and the prefix."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True, prefix_len=None):
        lse = None
        if lse_route(q.dtype, q.shape[3], v.shape[3]) and k.shape[2]:
            o, lse = flash_attention(q, k, v, causal, return_lse=True, prefix_len=prefix_len)
        else:
            o = flash_attention(q, k, v, causal, prefix_len=prefix_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.prefix_len = causal, prefix_len
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, ctx.causal, lse, ctx.prefix_len)
        return dq, dk, dv, None, None


def launch(kind: str, q, k, v, causal: bool = True, return_lse: bool = False,
           prefix_len: int = 0):
    """Launch the ``kind`` kernel (a key of KERNELS, or ``"simt"``) on CUDA
    tensors that ``flash_attention`` has checked, with a prefix of
    ``prefix_len`` rows (0: none); with ``return_lse`` (the wgmma or tf32
    kernel where ``lse_route`` holds) it returns (o, L).  The wrapper
    passes ``variant``'s choice; ``chip_smoke.py`` also passes ``"simt"``
    (the SIMT kernel of ``FLASH_ATTENTION``, at D = Dv of HEAD_DIMS), to
    time the kernels on the same inputs."""
    B, H, T, D = q.shape
    Hkv, Tk, Dv = k.shape[1], k.shape[2], v.shape[3]
    if kind == "simt" and (Dv != D or D not in HEAD_DIMS):
        raise ValueError(f"the simt kernel takes D = Dv in {HEAD_DIMS} only, "
                         f"not ({D}, {Dv})")
    if kind != "simt" and variant(q.dtype, D, Dv) != kind:
        raise ValueError(f"the {kind} kernel does not take {q.dtype} at "
                         f"(D, Dv) = ({D}, {Dv})")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if kind != "simt":  # TMA and cp.async read 16-byte aligned rows
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    if return_lse and (kind not in ("wgmma", "tf32") or not lse_route(q.dtype, D, Dv)
                       or not Tk):
        raise ValueError(f"the {kind} kernel gives no L at (D, Dv) = ({D}, {Dv}), Tk {Tk}")
    o = q.new_empty((B, H, T, Dv))
    lse = (torch.empty((B, H, -(-T // BWD_ROWS) * BWD_ROWS), dtype=torch.float32,
                       device=q.device) if return_lse else None)
    if not o.numel():
        return (o, lse) if return_lse else o
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, Hkv, T,
            Tk, D, Dv)
    if kind in ("wgmma", "tf32"):
        KERNELS[kind].launch(*args[:4], None if lse is None else lse.data_ptr(), *args[4:],
                             int(causal), int(prefix_len), stream_handle(q))
        return (o, lse) if return_lse else o
    FLASH_ATTENTION.launch(*args, DTYPES[q.dtype], int(causal), int(prefix_len),
                           int(kind == "simt"), stream_handle(q))
    return o
