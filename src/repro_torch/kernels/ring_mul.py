"""Batched degree-m ring product on the card.

Wrapper for ``csrc/ring_mul.cu``, the Hopper counterpart of
``repro/kernels/ring_mul.py::ring_mul``: for K keys, (ca, sa, Qa) ⊗
(cb, sb, Qb) = (c [K], s [K, m], Q [K, m, m]) in float32, equal bit for bit
to ``ref.ring_mul_ref`` and ``DegreeMRing.mul`` on any data.  The operands
may be strided over the keys (each key's s and Q dense and row-major), so
the column slices of an engine's [S, d] payload plane go in without a copy.
A CPU tensor takes the plain version (``ref``).
"""
from __future__ import annotations

import math

import torch

from . import ref
from ._cuda import I32, I64, PTR, CudaKernel, on_card, stream_handle

RING_MUL = CudaKernel("ring_mul.cu", "repro_ring_mul",
                      [PTR, PTR, PTR, I64, I64, I64,
                       PTR, PTR, PTR, I64, I64, I64, I64, I32, PTR, PTR, PTR])


def _operand(name: str, c, s, Q, K: int, m: int, device) -> list:
    """Pointers and per-key strides of one operand; raises unless it is
    float32 on ``device`` with shapes [K], [K, m], [K, m, m] and each key's
    s and Q dense and row-major."""
    for part, t, shape in (("c", c, (K,)), ("s", s, (K, m)), ("Q", Q, (K, m, m))):
        if t.device != device:
            raise ValueError(f"{name}.{part} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}.{part} has dtype {t.dtype}, expected float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}.{part} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        inner = [st for n, st in zip(t.shape[1:], t.stride()[1:]) if n > 1]
        dense = [math.prod(t.shape[i + 1:]) for i in range(1, t.dim())
                 if t.shape[i] > 1]
        if inner != dense:
            raise ValueError(f"{name}.{part} must be dense within each key")
    return [c.data_ptr(), s.data_ptr(), Q.data_ptr(),
            c.stride(0), s.stride(0), Q.stride(0)]


def ring_mul(ca, sa, Qa, cb, sb, Qb):
    """(ca [K], sa [K, m], Qa [K, m, m]) ⊗ (cb, sb, Qb) -> new (c, s, Q)."""
    K, m = sa.shape
    dev = sa.device
    a = _operand("a", ca, sa, Qa, K, m, dev)
    b = _operand("b", cb, sb, Qb, K, m, dev)
    if not on_card(sa):
        return ref.ring_mul_ref(ca, sa, Qa, cb, sb, Qb)
    c = torch.empty(K, dtype=torch.float32, device=dev)
    s = torch.empty((K, m), dtype=torch.float32, device=dev)
    Q = torch.empty((K, m, m), dtype=torch.float32, device=dev)
    RING_MUL.launch(*a, *b, K, m, c.data_ptr(), s.data_ptr(), Q.data_ptr(),
                    stream_handle(sa))
    return c, s, Q
