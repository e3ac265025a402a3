"""Plain PyTorch versions of the ⊎ kernels (the ground truth in tests).

Each is the function its CUDA kernel computes, built on ``index_add_``.
The kernel wrappers (``ring_scatter``, ``segment_ring_sum``) take these for
tensors on the CPU; on the card they are what the kernels are held against.
Rows whose id is < 0 or >= S drop.
"""
from __future__ import annotations

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
