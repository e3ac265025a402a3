"""⊎ kernels on the card: scatter-add, its tile-dedup variant and the
fused gather-⊗-⊎.

Wrappers for ``csrc/scatter_add.cu``, ``csrc/scatter_dedup.cu`` and
``csrc/gather_mul_scatter.cu``, the Hopper counterparts of
``repro/kernels/ring_scatter.py``'s ``scatter_add_onehot`` (without and
with ``dedup=True``) and ``gather_mul_scatter``.  All accumulate in place
into an ``[S, d]`` float32 view and return it.  A CPU tensor takes the
plain version (``ref``, :func:`scatter_dedup_ref`); a CUDA tensor launches
the kernel on the current stream, without synchronising, or raises.

Key linearization, payload flattening and the backend choice live in
``scatter_ops``; these wrappers see only flat planes.
"""
from __future__ import annotations

import functools

import torch

from . import ref
from ._cuda import I32, I64, PTR, CudaKernel, check_tensor, on_card, stream_handle

SCATTER_ADD = CudaKernel("scatter_add.cu", "repro_scatter_add",
                         [PTR, PTR, PTR, I64, I32, I64])
SCATTER_DEDUP = CudaKernel("scatter_dedup.cu", "repro_scatter_dedup",
                           [PTR, PTR, PTR, I64, I32, I64, I32])
GATHER_MUL_SCATTER = CudaKernel(
    "gather_mul_scatter.cu", "repro_gather_mul_scatter",
    [PTR, PTR, PTR, PTR, PTR, I64, I64, I32, I64, I32])


#: batch rows per tile of the tile-dedup kernels hold at most this many
#: payload elements (tile_rows · d), within [8, 32] rows: a tile's ids fit
#: on the lanes of one warp
TILE_ELEMS = 1024


@functools.cache
def tile_rows(d: int) -> int:
    """Batch rows per dedup tile of ``scatter_dedup``, ``fused_chain`` and
    ``gather_mul_scatter`` at
    payload width ``d``: the largest power of two in [8, 32] with
    ``rows · d <= TILE_ELEMS`` (32 rows for scalar rings, 8 at the degree-10
    width 111).  A tile's ids sit on the lanes of one warp, which finds
    their duplicates with one ``__match_any_sync``; at d = 1 the warp's 32
    threads are the tile's rows, wider a warp takes a row.  ``fused_chain``
    stages a tile's grouped rows in shared memory (``tile_rows · d``
    floats), so wide rows keep tiles short.  Cached: the wrappers call it
    on every launch."""
    rows = 8
    while rows < 32 and 2 * rows * max(int(d), 1) <= TILE_ELEMS:
        rows *= 2
    return rows


def tile_dedup(ids: torch.Tensor, vals: torch.Tensor):
    """Per-tile key dedup (plain version of the dedup of
    ``csrc/scatter_dedup.cu``, ``csrc/fused_chain.cu`` and
    ``csrc/gather_mul_scatter.cu``; the reference's
    ``ring_scatter.tile_dedup``).

    ``ids`` ``[..., n]``, ``vals`` ``[..., n, d]``, one tile per leading
    index.  Returns ``(mids, sums)``: ``sums[i]`` is the sum of the tile's
    rows whose id equals ``ids[i]`` where row i is that id's first
    occurrence, and ``mids`` masks every later duplicate and every padding
    id (< 0) to -1.  The duplicate sum is a 0/1 matmul, as in the
    reference, so integer-valued float32 payloads dedup exactly."""
    n = ids.shape[-1]
    eq = ids[..., :, None] == ids[..., None, :]
    earlier = torch.ones((n, n), dtype=torch.bool, device=ids.device).tril(-1)
    # row i is its id's first occurrence iff no earlier row matches
    first = ~(eq & earlier).any(dim=-1)
    sums = (eq & first[..., :, None]).to(vals.dtype) @ vals
    mids = torch.where(first & (ids >= 0), ids, torch.full_like(ids, -1))
    return mids, sums


def scatter_dedup_ref(view: torch.Tensor, seg_ids: torch.Tensor,
                      values: torch.Tensor) -> torch.Tensor:
    """Plain version of ``scatter_dedup``: :func:`tile_dedup` over tiles of
    ``tile_rows(d)`` batch rows, then the plain scatter of each tile's
    first occurrences.  In place; returns ``view``."""
    d = view.shape[1]
    B = seg_ids.shape[0]
    T = tile_rows(d)
    pad = -B % T
    ids = torch.cat([seg_ids, seg_ids.new_full((pad,), -1)]).reshape(-1, T)
    vals = torch.cat([values, values.new_zeros((pad, d))]).reshape(-1, T, d)
    mids, sums = tile_dedup(ids, vals)
    return ref.scatter_add_ref(view, mids.reshape(-1), sums.reshape(-1, d))


def row_split(d: int, offset: int) -> tuple[int, int, int]:
    """(head, vectors, tail) of the ⊎ kernels' split of one view row of
    ``d`` floats that starts ``offset`` floats past a 16-byte boundary
    (``repro::RowSplit``, ``csrc/common.cuh``): ``head`` scalar adds up to
    the boundary, ``vectors`` adds of four floats (Hopper's vector
    reduction, 16-byte aligned), ``tail`` scalar adds after them.  At
    d = 111 the offset, and so the split, depends on the row's id."""
    head = min(d, -offset % 4)
    vectors = (d - head) // 4
    return head, vectors, d - head - 4 * vectors


def scatter_add(view: torch.Tensor, seg_ids: torch.Tensor,
                values: torch.Tensor, dedup: bool = False) -> torch.Tensor:
    """view [S, d] += values [B, d] at seg_ids [B] (int32), in place;
    ids < 0 or >= S drop.  ``dedup`` sums each tile's duplicate ids before
    the ⊎ (the ``scatter_dedup`` kernel).  Returns ``view``."""
    S, d = view.shape
    B = seg_ids.shape[0]
    check_tensor("view", view, torch.float32, (S, d), view.device)
    check_tensor("seg_ids", seg_ids, torch.int32, (B,), view.device)
    check_tensor("values", values, torch.float32, (B, d), view.device)
    if not on_card(view):
        if dedup:
            return scatter_dedup_ref(view, seg_ids, values)
        return ref.scatter_add_ref(view, seg_ids, values)
    if B * d == 0:
        return view
    if dedup:
        SCATTER_DEDUP.launch(view.data_ptr(), seg_ids.data_ptr(),
                             values.data_ptr(), S, d, B, tile_rows(d),
                             stream_handle(view))
    else:
        SCATTER_ADD.launch(view.data_ptr(), seg_ids.data_ptr(),
                           values.data_ptr(), S, d, B, stream_handle(view))
    return view


def gather_mul_scatter(view: torch.Tensor, out_ids: torch.Tensor,
                       src: torch.Tensor, in_ids: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """view [S, d] += scale[b] · src [Sg, d] row in_ids[b], at out_ids[b],
    in place.  out_ids < 0 or >= S drop; in_ids clamp into [0, Sg - 1].
    The kernel sums each tile's duplicate out ids (``tile_rows(d)`` rows)
    before the ⊎, in a fixed order.  Returns ``view``."""
    S, d = view.shape
    Sg = src.shape[0]
    B = out_ids.shape[0]
    if Sg == 0 and B:
        raise ValueError("gather source has no rows")
    dev = view.device
    check_tensor("view", view, torch.float32, (S, d), dev)
    check_tensor("out_ids", out_ids, torch.int32, (B,), dev)
    check_tensor("src", src, torch.float32, (Sg, d), dev)
    check_tensor("in_ids", in_ids, torch.int32, (B,), dev)
    check_tensor("scale", scale, torch.float32, (B,), dev)
    if not on_card(view):
        return ref.gather_mul_scatter_ref(view, out_ids, src, in_ids, scale)
    if B * d:
        GATHER_MUL_SCATTER.launch(
            view.data_ptr(), out_ids.data_ptr(), src.data_ptr(),
            in_ids.data_ptr(), scale.data_ptr(), S, Sg, d, B, tile_rows(d),
            stream_handle(view))
    return view
