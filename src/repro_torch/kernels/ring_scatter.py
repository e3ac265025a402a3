"""⊎ kernels on the card: scatter-add and the fused gather-⊗-⊎.

Wrappers for ``csrc/scatter_add.cu`` and ``csrc/gather_mul_scatter.cu``,
the Hopper counterparts of ``repro/kernels/ring_scatter.py``'s
``scatter_add_onehot`` and ``gather_mul_scatter``.  Both accumulate in
place into an ``[S, d]`` float32 view and return it.  A CPU tensor takes
the plain version (``ref``); a CUDA tensor launches the kernel on the
current stream, without synchronising, or raises.

Key linearization, payload flattening and the backend choice live in
``scatter_ops``; these wrappers see only flat planes.
"""
from __future__ import annotations

import torch

from . import ref
from ._cuda import I32, I64, PTR, CudaKernel, check_tensor, on_card, stream_handle

SCATTER_ADD = CudaKernel("scatter_add.cu", "repro_scatter_add",
                         [PTR, PTR, PTR, I64, I32, I64])
GATHER_MUL_SCATTER = CudaKernel(
    "gather_mul_scatter.cu", "repro_gather_mul_scatter",
    [PTR, PTR, PTR, PTR, PTR, I64, I64, I32, I64])


def scatter_add(view: torch.Tensor, seg_ids: torch.Tensor,
                values: torch.Tensor) -> torch.Tensor:
    """view [S, d] += values [B, d] at seg_ids [B] (int32), in place;
    ids < 0 or >= S drop.  Returns ``view``."""
    S, d = view.shape
    B = seg_ids.shape[0]
    check_tensor("view", view, torch.float32, (S, d), view.device)
    check_tensor("seg_ids", seg_ids, torch.int32, (B,), view.device)
    check_tensor("values", values, torch.float32, (B, d), view.device)
    if not on_card(view):
        return ref.scatter_add_ref(view, seg_ids, values)
    if B * d:
        SCATTER_ADD.launch(view.data_ptr(), seg_ids.data_ptr(),
                           values.data_ptr(), S, d, B, stream_handle(view))
    return view


def gather_mul_scatter(view: torch.Tensor, out_ids: torch.Tensor,
                       src: torch.Tensor, in_ids: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """view [S, d] += scale[b] · src [Sg, d] row in_ids[b], at out_ids[b],
    in place.  out_ids < 0 or >= S drop; in_ids clamp into [0, Sg - 1].
    Returns ``view``."""
    S, d = view.shape
    Sg = src.shape[0]
    B = out_ids.shape[0]
    if Sg == 0 and B:
        raise ValueError("gather source has no rows")
    check_tensor("view", view, torch.float32, (S, d), view.device)
    check_tensor("out_ids", out_ids, torch.int32, (B,), view.device)
    check_tensor("src", src, torch.float32, (Sg, d), view.device)
    check_tensor("in_ids", in_ids, torch.int32, (B,), view.device)
    check_tensor("scale", scale, torch.float32, (B,), view.device)
    if not on_card(view):
        return ref.gather_mul_scatter_ref(view, out_ids, src, in_ids, scale)
    if B * d:
        GATHER_MUL_SCATTER.launch(
            view.data_ptr(), out_ids.data_ptr(), src.data_ptr(),
            in_ids.data_ptr(), scale.data_ptr(), S, Sg, d, B,
            stream_handle(view))
    return view
