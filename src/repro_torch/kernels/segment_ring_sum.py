"""Segment sum of ring payload rows on the card.

Wrapper for ``csrc/segment_ring_sum.cu``, the Hopper counterpart of
``repro/kernels/segment_ring_sum.py::segment_ring_sum``: values [B, d] with
segment ids [B] reduce into a new [S, d] float32 plane; ids < 0 or >= S
drop.  One launch and no sort: each block of the kernel owns a run of
segments, streams the ids in row order and adds each segment's rows in
ascending row order, with no atomics, so the result is deterministic.  The
wrapper allocates only the output (the kernel writes every element).  A
CPU tensor takes the plain version (``ref``).
"""
from __future__ import annotations

import torch

from . import ref
from ._cuda import I32, I64, PTR, CudaKernel, check_tensor, on_card, stream_handle

SEGMENT_RING_SUM = CudaKernel("segment_ring_sum.cu", "repro_segment_ring_sum",
                              [PTR, PTR, I32, I64, I32, PTR])


def segment_ring_sum(values: torch.Tensor, seg_ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """values [B, d] float32, seg_ids [B] int32 -> [num_segments, d]."""
    B, d = values.shape
    S = int(num_segments)
    check_tensor("values", values, torch.float32, (B, d), values.device)
    check_tensor("seg_ids", seg_ids, torch.int32, (B,), values.device)
    if not on_card(values):
        return ref.segment_ring_sum_ref(values, seg_ids, S)
    if B >= 2 ** 31:
        raise ValueError(f"B = {B} rows exceed the kernel's int32 row index")
    out = values.new_empty((S, d))
    if S * d == 0:
        return out
    SEGMENT_RING_SUM.launch(values.data_ptr(), seg_ids.data_ptr(), B, S, d,
                            out.data_ptr(), stream_handle(values))
    return out
