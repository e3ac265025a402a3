"""Segment sum of ring payload rows on the card.

Wrapper for ``csrc/segment_ring_sum.cu``, the Hopper counterpart of
``repro/kernels/segment_ring_sum.py::segment_ring_sum``: values [B, d] with
segment ids [B] reduce into a new [S, d] float32 plane; ids < 0 or >= S
drop.  The wrapper sorts the ids (stable) and computes each segment's run
in torch, as the reference argsorts and ranks outside its kernel; the
kernel then sums each segment with one warp and no atomics, so the result
is deterministic.  A CPU tensor takes the plain version (``ref``).
"""
from __future__ import annotations

import torch

from . import ref
from ._cuda import I32, I64, PTR, CudaKernel, check_tensor, on_card, stream_handle

SEGMENT_RING_SUM = CudaKernel("segment_ring_sum.cu", "repro_segment_ring_sum",
                              [PTR, PTR, PTR, I64, I32, PTR])


def segment_ring_sum(values: torch.Tensor, seg_ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """values [B, d] float32, seg_ids [B] int32 -> [num_segments, d]."""
    B, d = values.shape
    S = int(num_segments)
    check_tensor("values", values, torch.float32, (B, d), values.device)
    check_tensor("seg_ids", seg_ids, torch.int32, (B,), values.device)
    if not on_card(values):
        return ref.segment_ring_sum_ref(values, seg_ids, S)
    out = torch.empty((S, d), dtype=torch.float32, device=values.device)
    if S * d == 0:
        return out
    sorted_ids, order = torch.sort(seg_ids, stable=True)
    bounds = torch.arange(S + 1, dtype=torch.int32, device=values.device)
    # offsets[s] = rows with id < s: segment s is order[offsets[s]:offsets[s+1]]
    offsets = torch.searchsorted(sorted_ids, bounds, out_int32=True)
    order = order.to(torch.int32)
    SEGMENT_RING_SUM.launch(values.data_ptr(), order.data_ptr(),
                            offsets.data_ptr(), S, d, out.data_ptr(),
                            stream_handle(values))
    return out
