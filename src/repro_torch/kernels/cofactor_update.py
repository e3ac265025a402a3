"""Weighted sufficient statistics (c, s, Q) of a tuple batch on the card.

Wrapper for ``csrc/cofactor_update.cu``, the Hopper counterpart of
``repro/kernels/cofactor_update.py::cofactor_update``: x [B, m] and w [B]
give c [1] = Σw, s [m] = Σ w·x and Q [m, m] = Xᵀ diag(w) X, all float32.
The kernel splits the batch into chunks (:func:`cofactor_splits`), one
partial tile of Q per block and chunk, and sums the chunks in order, so a
call is deterministic.  A CPU tensor takes the plain version (``ref``).
"""
from __future__ import annotations

import torch

from . import ref
from ._cuda import I32, I64, PTR, CudaKernel, check_tensor, on_card, stream_handle

COFACTOR_UPDATE = CudaKernel("cofactor_update.cu", "repro_cofactor_update",
                             [PTR, PTR, I64, I32, I32, I64, PTR, PTR, PTR, PTR])

#: edge of the kernel's Q tiles (kTile in the source)
TILE = 64
#: blocks one call aims for: one wave at four per SM of an H100 (132 SMs;
#: the kernel's 64 registers a thread let four 256-thread blocks share an SM)
TARGET_BLOCKS = 4 * 132
#: fewest batch rows a chunk is given, so a block's partial tile is worth
#: writing out and summing
MIN_CHUNK = 256


def cofactor_splits(B: int, m: int) -> tuple[int, int]:
    """(chunks, rows per chunk) of a batch of B rows at width m: as many
    chunks as let the (m/64)² tiles times the chunks stay within one wave
    of TARGET_BLOCKS blocks (a block past it would run alone after the
    rest), none shorter than MIN_CHUNK rows."""
    if B <= 0:
        return 1, 0
    tiles = max(1, -(-m // TILE)) ** 2
    splits = max(1, min(TARGET_BLOCKS // tiles, -(-B // MIN_CHUNK), 65535))
    chunk = -(-B // splits)
    return -(-B // chunk), chunk


def cofactor_update(x: torch.Tensor, w: torch.Tensor):
    """x [B, m], w [B] float32 (contiguous) -> (c [1], s [m], Q [m, m])."""
    B, m = x.shape
    check_tensor("x", x, torch.float32, (B, m), x.device)
    check_tensor("w", w, torch.float32, (B,), x.device)
    if not on_card(x):
        c, s, Q = ref.cofactor_update_ref(x, w)
        return c.reshape(1), s, Q
    splits, chunk = cofactor_splits(B, m)
    ws = torch.empty(splits * (m * m + m + 1), dtype=torch.float32, device=x.device)
    c = torch.empty(1, dtype=torch.float32, device=x.device)
    s = torch.empty(m, dtype=torch.float32, device=x.device)
    Q = torch.empty((m, m), dtype=torch.float32, device=x.device)
    COFACTOR_UPDATE.launch(x.data_ptr(), w.data_ptr(), B, m, splits, chunk,
                           ws.data_ptr(), c.data_ptr(), s.data_ptr(), Q.data_ptr(),
                           stream_handle(x))
    return c, s, Q
