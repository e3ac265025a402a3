"""Factorized (rank-1) delta propagation on the card (paper Example 7.1).

A rank-1 update δA₂ = u vᵀ to the chain A₁A₂A₃ propagates as two matvecs
and one rank-1 accumulate, all O(n²):

    u₂ = A₁ u ;  v₂ = vᵀ A₃ ;  V' = V + u₂ v₂ᵀ

Wrappers for ``csrc/matvec.cu`` and ``csrc/outer_accumulate.cu``, the
Hopper counterparts of ``repro/kernels/rank1_chain.py``'s ``matvec`` and
``outer_accumulate``; ``ops.rank1_chain_update`` composes them.
:func:`matvec` takes A row-major or as the transpose
of a row-major matrix (``A3.T``): the latter runs the kernel's column
variant over A3's own rows, so Aᵀ is never copied.  A CPU tensor takes the
plain version (``ref``).
"""
from __future__ import annotations

import torch

from . import ref
from ._cuda import I32, I64, PTR, CudaKernel, check_tensor, on_card, stream_handle

MATVEC = CudaKernel("matvec.cu", "repro_matvec",
                    [PTR, PTR, I64, I64, I32, I32, I64, PTR, PTR])
OUTER_ACCUMULATE = CudaKernel("outer_accumulate.cu", "repro_outer_accumulate",
                              [PTR, PTR, PTR, I64, I64, PTR])

#: blocks the column variant aims for: four per SM of an H100 (132 SMs)
TARGET_BLOCKS = 4 * 132
#: fewest rows a chunk of the column variant is given
MIN_CHUNK = 64


def column_splits(rows: int, cols: int) -> tuple[int, int]:
    """(chunks, rows per chunk) for the column variant over a row-major
    [rows, cols] matrix: strips of 128 columns (32 where cols % 4 != 0)
    times chunks fill the card, no chunk shorter than MIN_CHUNK rows."""
    if rows <= 0:
        return 1, 0
    strips = max(1, -(-cols // (128 if cols % 4 == 0 else 32)))
    splits = max(1, min(-(-TARGET_BLOCKS // strips), -(-rows // MIN_CHUNK), 65535))
    chunk = -(-rows // splits)
    return -(-rows // chunk), chunk


def matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y [n] = A [n, k] x [k], float32; A row-major or the transpose of a
    row-major matrix (any other layout raises)."""
    n, k = A.shape
    check_tensor("x", x, torch.float32, (k,), A.device)
    if A.dtype != torch.float32:
        raise TypeError(f"A has dtype {A.dtype}, expected float32")
    if not on_card(A):
        return ref.matvec_ref(A, x)
    y = torch.empty(n, dtype=torch.float32, device=A.device)
    if A.is_contiguous():
        MATVEC.launch(A.data_ptr(), x.data_ptr(), n, k, 0, 1, 0, None,
                      y.data_ptr(), stream_handle(A))
    elif A.T.is_contiguous():
        # y = (Aᵀ)ᵀ x: the column variant over Aᵀ's k rows of n columns
        splits, chunk = column_splits(k, n)
        ws = torch.empty(splits * n, dtype=torch.float32, device=A.device)
        MATVEC.launch(A.data_ptr(), x.data_ptr(), k, n, 1, splits, chunk,
                      ws.data_ptr(), y.data_ptr(), stream_handle(A))
    else:
        raise ValueError("A must be row-major or the transpose of a row-major "
                         "matrix")
    return y


def outer_accumulate(V: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """V [n, m] + u [n] v [m]ᵀ into a new float32 tensor (all contiguous
    float32), equal bit for bit to ``V + torch.outer(u, v)``."""
    n, m = V.shape
    check_tensor("V", V, torch.float32, (n, m), V.device)
    check_tensor("u", u, torch.float32, (n,), V.device)
    check_tensor("v", v, torch.float32, (m,), V.device)
    if not on_card(V):
        return ref.outer_accumulate_ref(V, u, v)
    out = torch.empty((n, m), dtype=torch.float32, device=V.device)
    OUTER_ACCUMULATE.launch(V.data_ptr(), u.data_ptr(), v.data_ptr(), n, m,
                            out.data_ptr(), stream_handle(V))
    return out

