"""Factorized (rank-1) delta propagation on the card (paper Example 7.1).

A rank-1 update δA₂ = u vᵀ to the chain A₁A₂A₃ propagates as two matvecs
and one rank-1 accumulate, all O(n²):

    u₂ = A₁ u ;  v₂ = vᵀ A₃ ;  V' = V + u₂ v₂ᵀ

Wrappers for ``csrc/matvec.cu`` and ``csrc/outer_accumulate.cu``, the
Hopper counterparts of ``repro/kernels/rank1_chain.py``'s ``matvec`` and
``outer_accumulate``; ``ops.rank1_chain_update`` composes them, and an
engine's factorized trigger plans reach them through
``core.plan.factorized_route`` (a rank-1 join with its marginalization is
one :func:`matvec`, a rank-1 ⊎ into a matrix view one
:func:`outer_accumulate`).
:func:`matvec` takes A row-major or as the transpose of a row-major matrix
(``A3.T``): the latter runs the kernel's cols layout over A3's own rows,
so Aᵀ is never copied.  A CPU tensor takes the plain version (``ref``).

:func:`matvec_plan` picks the kernel from the shape and layout alone.
The rows layout takes the TMA kernel (one launch, A streamed through
shared memory by bulk copies) where A and x are 16-byte aligned and A has
a multiple of 4 columns (and no empty side), else the SIMT rows kernel.
Every cols layout takes the SIMT cols kernel, also one launch: it adds
the splits' partials inside the launch, through ticket counters and a
partials buffer kept per device and stream (``_cuda.ScratchCache``, at
most SCRATCH_STREAMS streams a device), so no call allocates more than its
output.  The kernels sum in a fixed order (:func:`block_stages` gives the
TMA kernel's stages), so a call is bitwise repeatable.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import ref
from ._cuda import (I32, I64, PTR, CudaKernel, ScratchCache, check_tensor, on_card,
                    stream_handle)

MATVEC = CudaKernel("matvec.cu", "repro_matvec",
                    [PTR, PTR, I64, I64, I32, I32, I32, I64, PTR, PTR, PTR])
OUTER_ACCUMULATE = CudaKernel("outer_accumulate.cu", "repro_outer_accumulate",
                              [PTR, PTR, PTR, I64, I64, PTR])

#: floats of a stage of the TMA kernel's ring (kStageFloats), and of x held
#: in shared memory at once (kXMax)
STAGE_FLOATS = 8192
#: stages of the ring (kStages)
STAGES = 4
#: warps of a block (kWarps)
WARPS = 8
#: columns of a strip of the SIMT cols kernel
SIMT_STRIP = 32
#: blocks the SIMT cols kernel aims for: four per SM of an H100 (132 SMs)
TARGET_BLOCKS = 4 * 132
#: fewest rows a split of the SIMT cols kernel is given
MIN_CHUNK = 64
#: streams a device whose scratch is kept
SCRATCH_STREAMS = 4


class MatvecPlan(NamedTuple):
    """One call's kernel (``"tma"`` or ``"simt"``) and cut: ``blocks`` the
    TMA grid (at most one block an SM) or the cols kernel's splits of
    ``chunk`` rows, and the int32 ticket counters and float32 partials the
    cols layout takes from the scratch (0 for the rows layout)."""
    kernel: str
    blocks: int
    chunk: int
    counter_words: int
    partial_floats: int


def column_splits(rows: int, cols: int) -> tuple[int, int]:
    """(splits, rows per split) for the SIMT cols kernel over a row-major
    [rows, cols] matrix: strips of SIMT_STRIP columns times splits fill the
    card, no split shorter than MIN_CHUNK rows."""
    if rows <= 0:
        return 1, 0
    strips = max(1, -(-cols // SIMT_STRIP))
    splits = max(1, min(-(-TARGET_BLOCKS // strips), -(-rows // MIN_CHUNK), 65535))
    chunk = -(-rows // splits)
    return -(-rows // chunk), chunk


def rows_run(cols: int) -> int:
    """Rows of a stage of the TMA rows kernel: STAGE_FLOATS over the widest
    chunk of x (``chunk_bounds``)."""
    chunks = -(-cols // STAGE_FLOATS)
    return STAGE_FLOATS // (4 * -(-(cols // 4) // chunks))


@functools.lru_cache(maxsize=256)
def matvec_plan(rows: int, cols: int, transposed: bool, aligned: bool,
                sms: int) -> MatvecPlan:
    """The plan of y = A x (``transposed`` False) or xᵀ A (True) over a
    row-major A [rows, cols] on a card of ``sms`` SMs.  ``aligned``: A, and
    in the rows layout x, start 16-byte aligned.  The rows layout takes the TMA kernel where
    ``aligned``, cols % 4 == 0 and rows, cols > 0, a block an SM, at most
    one a run of ``rows_run`` rows; else the SIMT rows kernel.  The cols
    layout takes the SIMT cols kernel, cut by ``column_splits``: partials
    splits·cols floats, a counter a strip of SIMT_STRIP columns."""
    if not transposed:
        if aligned and cols % 4 == 0 and rows > 0 and cols > 0:
            return MatvecPlan("tma", min(sms, -(-rows // rows_run(cols))), 0, 0, 0)
        return MatvecPlan("simt", 1, 0, 0, 0)
    splits, chunk = column_splits(rows, cols)
    return MatvecPlan("simt", splits, chunk, -(-cols // SIMT_STRIP), splits * cols)


def chunk_bounds(cols: int) -> list[tuple[int, int]]:
    """(first column, width) of each chunk of x the TMA rows kernel holds in
    shared memory: ceil(cols / STAGE_FLOATS) chunks splitting the float4s
    of a row evenly."""
    k4, chunks = cols // 4, -(-cols // STAGE_FLOATS)
    lo = [4 * (k4 * c // chunks) for c in range(chunks + 1)]
    return [(lo[c], lo[c + 1] - lo[c]) for c in range(chunks)]


def block_stages(plan: MatvecPlan, rows: int, cols: int,
                 b: int) -> list[tuple[int, int, int, int, int]]:
    """The stages block b of a TMA plan reads, in the kernel's order, each
    (chunk, first row, rows, first column, width): runs of R = ``rows_run``
    rows, block b taking runs b, b + B, ..., chunk by chunk."""
    B, R = plan.blocks, rows_run(cols)
    return [(c, r, min(R, rows - r), c0, w)
            for c, (c0, w) in enumerate(chunk_bounds(cols))
            for r in range(b * R, rows, B * R)]


@functools.lru_cache(maxsize=16)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of the card."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


#: (device index, stream handle) -> (counters, partials) of the cols layout
_scratch = ScratchCache(SCRATCH_STREAMS)


def layout(A: torch.Tensor, x: torch.Tensor) -> tuple[bool, int, int, bool]:
    """(transposed, rows, cols, aligned) of the kernel call for y = A x:
    the rows layout over A itself where A is row-major, else the cols
    layout over the row-major Aᵀ (any other layout raises); ``aligned``
    where A, and in the rows layout x, start 16-byte aligned."""
    n, k = A.shape
    if A.is_contiguous():
        transposed, rows, cols = False, n, k
    elif A.T.is_contiguous():
        # y = (Aᵀ)ᵀ x: the cols layout over Aᵀ's k rows of n columns
        transposed, rows, cols = True, k, n
    else:
        raise ValueError("A must be row-major or the transpose of a row-major "
                         "matrix")
    aligned = A.data_ptr() % 16 == 0 and (transposed or x.data_ptr() % 16 == 0)
    return transposed, rows, cols, aligned


def matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y [n] = A [n, k] x [k], float32; A row-major or the transpose of a
    row-major matrix (any other layout raises)."""
    n, k = A.shape
    check_tensor("x", x, torch.float32, (k,), A.device)
    if A.dtype != torch.float32:
        raise TypeError(f"A has dtype {A.dtype}, expected float32")
    if not on_card(A):
        return ref.matvec_ref(A, x)
    transposed, rows, cols, aligned = layout(A, x)
    device = A.device
    plan = matvec_plan(rows, cols, transposed, aligned, sm_count(device.index))
    y = torch.empty(n, dtype=torch.float32, device=device)
    stream = stream_handle(A)
    counters = partials = None
    if plan.counter_words:
        c, p = _scratch.take(device, stream, plan.counter_words, plan.partial_floats)
        counters, partials = c.data_ptr(), p.data_ptr()
    MATVEC.launch(A.data_ptr(), x.data_ptr(), rows, cols, int(transposed),
                  int(plan.kernel == "tma"), plan.blocks, plan.chunk, counters, partials,
                  y.data_ptr(), stream)
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
