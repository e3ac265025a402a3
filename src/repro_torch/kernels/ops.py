"""Public wrappers of the kernel-ops layer (port of ``repro.kernels.ops``).

Same functions, signatures, result shapes and dtypes as the reference's
(``c`` of :func:`cofactor_update` has shape [1]; every result is float32
but ``flash_attention``'s, which has q's dtype), without its ``backend=``
and its padding to TPU block multiples: the port's kernels take any B, m,
K, n and T.  Each casts its inputs as the reference does and hands them to
the kernel's wrapper, which launches the CUDA kernel for tensors on the
card and runs the plain version (``ref``) for tensors on the CPU.  Tensors
stay on their device; anything else (numpy arrays) goes to ``device``, by
default ``"cuda"``, which raises on a host without CUDA.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from . import cofactor_update as _cofactor
from . import flash_attention as _flash
from . import rank1_chain as _rank1
from . import ring_mul as _ring_mul
from . import segment_ring_sum as _segsum


def _as(t, dtype, device):
    """``t`` as a ``dtype`` tensor (its own dtype for None): a tensor stays
    on its device unless ``device`` is given; anything else goes to
    ``device`` (default cuda)."""
    if isinstance(t, torch.Tensor):
        dtype = dtype or t.dtype
        return t.to(dtype) if device is None else t.to(resolve_device(device), dtype)
    return torch.as_tensor(t, dtype=dtype, device=resolve_device(device or "cuda"))


def cofactor_update(x, w, device=None):
    """(c [1], s [m], Q [m, m]) sufficient statistics of a weighted batch
    x [B, m], w [B]."""
    x = _as(x, torch.float32, device).contiguous()
    return _cofactor.cofactor_update(x, _as(w, torch.float32, x.device).contiguous())


def ring_mul(ca, sa, Qa, cb, sb, Qb, device=None):
    """Batched degree-m ring product: c [K], s [K, m], Q [K, m, m] each."""
    sa = _as(sa, torch.float32, device)
    ca, Qa, cb, sb, Qb = (_as(t, torch.float32, sa.device)
                          for t in (ca, Qa, cb, sb, Qb))
    return _ring_mul.ring_mul(ca, sa, Qa, cb, sb, Qb)


def segment_ring_sum(values, seg_ids, num_segments: int, device=None):
    """Segment-sum payload rows values [B, d] by seg_ids [B] into
    [num_segments, d]; ids < 0 or >= num_segments drop."""
    values = _as(values, torch.float32, device).contiguous()
    seg_ids = _as(seg_ids, torch.int32, values.device).contiguous()
    return _segsum.segment_ring_sum(values, seg_ids, num_segments)


def matvec(A, x, device=None):
    """y [n] = A [n, k] x [k]; A row-major or a transposed view of one is
    read in place, any other layout is copied row-major first."""
    A = _as(A, torch.float32, device)
    if not (A.is_contiguous() or A.T.is_contiguous()):
        A = A.contiguous()
    return _rank1.matvec(A, _as(x, torch.float32, A.device).contiguous())


def rank1_chain_update(A1, u, v, A3, V, device=None):
    """V + (A1 u)(vᵀ A3): the O(n²) factorized chain delta (Example 7.1),
    as a new float32 tensor; A3ᵀ is never formed."""
    V = _as(V, torch.float32, device).contiguous()
    u2 = matvec(A1, u, device=V.device)
    v2 = matvec(_as(A3, torch.float32, V.device).T, v, device=V.device)
    return _rank1.outer_accumulate(V, u2, v2)


def flash_attention(q, k, v, causal: bool = True, device=None):
    """q [B,H,T,D], k/v [B,Hkv,Tk,D] -> [B,H,T,D] in q's dtype (float32 or
    bfloat16).  GQA by index: q-head h reads kv-head h // (H // Hkv)."""
    q = _as(q, None, device)
    k, v = (_as(t, q.dtype, q.device) for t in (k, v))
    return _flash.flash_attention(q, k, v, causal=causal)
