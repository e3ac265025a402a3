"""Weighted sufficient statistics (c, s, Q) of a tuple batch on the card.

Wrapper for ``csrc/cofactor_update.cu``, the Hopper counterpart of
``repro/kernels/cofactor_update.py::cofactor_update``: x [B, m] and w [B]
give c [1] = Σw, s [m] = Σ w·x and Q [m, m] = Xᵀ diag(w) X, all float32, in
one kernel launch.  A CPU tensor takes the plain version (``ref``).

The kernel sums x' = [x | 1] over the upper triangle of its (m+1)² product
(Q, then s in column m and c at (m, m)) in a fixed order
(:func:`cofactor_plan`): each block over its own rows, the blocks of a
cluster of :data:`CLUSTER` in rank order, the clusters of a set of
:data:`SET` in order, the sets in order, then the ``B % 4`` last rows.  A
call is therefore bitwise repeatable.  Q is mirrored: Q[j, i] is the sum
for (i, j), Σ (x_i·w)·x_j, where the plain version's Q[j, i] is
Σ (x_j·w)·x_i.  The two are equal on integer-valued data (every sum
exact); on other data they agree within float32 rounding, as do the other
sums, which are taken in another order than the plain version's.

Up to m = 191 one block holds every tile of the triangle; from m = 192 on
the grid's second dimension walks the pairs of bands of :data:`BAND` tile
columns (:func:`tiles`), so the card takes any m whose passes fit a grid
(m up to about 69,000).

The kernel keeps, per device and stream, a buffer of ticket counters
(which the last cluster to arrive resets, so they are zeroed only when the
buffer is allocated) and one of cluster and set partials, so no call
allocates more than its output and two streams never share a counter.  At
most :data:`SCRATCH_STREAMS` streams a device keep theirs; the least
recently used beyond them is dropped.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import ref
from ._cuda import (I32, I64, PTR, CudaKernel, ScratchCache, check_tensor, on_card,
                    stream_handle)

COFACTOR_UPDATE = CudaKernel("cofactor_update.cu", "repro_cofactor_update",
                             [PTR, PTR, I64, I32, I32, I32, I32, I32, I32, PTR, PTR, PTR])

#: blocks of a thread block cluster, whose sums add over distributed shared
#: memory (kCluster in the source)
CLUSTER = 4
#: clusters whose partials the last of them adds (kSet in the source)
SET = 8
#: tile columns of a band of the banded kernel (kBand), one thread a tile
#: of a pair of bands: 576 threads
BAND = 24
#: most tiles of a narrow block (the TI 8 kernel's 320 threads)
NARROW_TILES = 320
#: rows of a stage of the banded kernel
BAND_STAGE_ROWS = 16
#: most blocks of a call: two per SM of an H100 (132 SMs)
MAX_BLOCKS = 2 * 132
#: bytes of x and w one stage of the shared-memory ring aims for
STAGE_BYTES = 16384
#: streams a device whose scratch is kept
SCRATCH_STREAMS = 4


class Plan(NamedTuple):
    """How one call cuts the work: ``tile`` edge of a thread's register
    tile of the (m+1)² triangle, ``groups`` copies of the tile set in a
    block (a thread a tile), ``stage_rows`` rows a stage, ``blocks`` along
    the batch and ``passes`` along the triangle (1, or the pairs of bands
    of the banded kernel), the 32-bit words of ticket counters (for each
    pass one for its sets and one a set) and the floats of partials (for
    each pass one a cluster and, with two sets or more, one a set, each
    the pass's tile slots of tile² + 4 floats)."""
    tile: int
    groups: int
    stage_rows: int
    blocks: int
    passes: int
    counter_words: int
    partial_floats: int


def tile_edge(m: int) -> int:
    """4 for m + 1 <= 40 (path A's m = 32: 45 tiles a group, five groups a
    block), else 8 (m = 130: 153 tiles of 64 sums, one group)."""
    return 4 if m + 1 <= 40 else 8


def banded(m: int) -> bool:
    """Whether m takes the banded kernel: more tiles than a narrow block
    holds (m >= 192)."""
    nt = -(-(m + 1) // tile_edge(m))
    return nt * (nt + 1) // 2 > NARROW_TILES


def tiles(m: int) -> list[list[tuple[int, int] | None]]:
    """The kernel's thread-slot-to-tile map (``slot_tile``), one list a
    pass: the tiles (ti, tj), ti <= tj, of the upper triangle of x'ᵀ x' in
    tile units.  Narrow: one pass, first the tiles with tj < nt - 1 row by
    row, then the last tile column, which holds column m (the ones) and
    the padding.  Banded: a pass a pair of bands (bi <= bj) row by row,
    BAND² slots each, None where the slot lies below the diagonal or past
    the last tile column."""
    nt = -(-(m + 1) // tile_edge(m))
    if not banded(m):
        inner = [(i, j) for i in range(nt - 1) for j in range(i, nt - 1)]
        return [inner + [(i, nt - 1) for i in range(nt)]]
    nb = -(-nt // BAND)
    out = []
    for bi in range(nb):
        for bj in range(bi, nb):
            slots = [(bi * BAND + t // BAND, bj * BAND + t % BAND) for t in range(BAND * BAND)]
            out.append([(i, j) if i <= j < nt else None for i, j in slots])
    return out


def stage_rows(m: int) -> int:
    """Rows of one stage of the narrow kernels: the largest power of two in
    [4, 256] whose rows of x and w fit in STAGE_BYTES (64 at m = 32, 16 at
    m = 130).  A multiple of 4, so that every stage starts and ends 16-byte
    aligned."""
    rows = 4
    while rows < 256 and 2 * rows * 4 * (m + 1) <= STAGE_BYTES:
        rows *= 2
    return rows


@functools.lru_cache(maxsize=256)
def cofactor_plan(B: int, m: int, max_blocks: int) -> Plan:
    """The cut of a (B, m) call: as many blocks along the batch as give each
    block two stages or more, at most ``max_blocks`` (what the card runs
    in one wave, :func:`max_blocks`) over all passes, at least one
    cluster, rounded up to whole clusters; groups of tiles up to 256
    threads, at most 8 (the groups add up in turn)."""
    tile = tile_edge(m)
    nt = -(-(m + 1) // tile)
    ntiles = nt * (nt + 1) // 2
    if banded(m):
        nb = -(-nt // BAND)
        groups, passes, slots, rows = 1, nb * (nb + 1) // 2, BAND * BAND, BAND_STAGE_ROWS
    else:
        groups, passes, slots, rows = max(1, min(8, 256 // ntiles)), 1, ntiles, stage_rows(m)
    if passes > 65535:
        raise ValueError(f"cofactor_update: m = {m} needs {passes} passes, more than "
                         f"a grid holds (65535)")
    wave = max(CLUSTER, max_blocks // passes // CLUSTER * CLUSTER)
    blocks = min(wave, max(1, -(-(B // 4 * 4) // (2 * rows))))
    blocks = -(-blocks // CLUSTER) * CLUSTER
    clusters = blocks // CLUSTER
    sets = -(-clusters // SET)
    partials = clusters + (sets if sets > 1 else 0)
    return Plan(tile, groups, rows, blocks, passes, passes * (1 + sets),
                passes * partials * slots * (tile * tile + 4))


def block_rows(B: int, blocks: int, b: int) -> tuple[int, int]:
    """Rows [lo, hi) of block b: an equal share of the batch's whole quads
    of rows.  Rows from 4·(B // 4) on are added by the last cluster."""
    quads = B // 4
    return 4 * (quads * b // blocks), 4 * (quads * (b + 1) // blocks)


@functools.lru_cache(maxsize=64)
def max_blocks(device_index: int, m: int) -> int:
    """Most blocks of a call at width m that the card runs in one wave: the
    kernel's own count of clusters that fit at once (an H100 holds 62
    clusters of the 70 KB blocks of m = 32, not the 66 that two blocks an SM
    would give), at most MAX_BLOCKS.  A grid past it would run its last
    clusters after the rest."""
    plan = cofactor_plan(0, m, MAX_BLOCKS)
    fn = COFACTOR_UPDATE.library().repro_cofactor_max_clusters
    fn.argtypes = [I32, I32, I32, I32, I32, ctypes.POINTER(ctypes.c_int)]
    clusters = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = fn(m, plan.tile, plan.groups, plan.stage_rows, plan.passes,
                ctypes.byref(clusters))
    if rc != 0 or clusters.value < 1:
        raise RuntimeError(f"repro_cofactor_max_clusters failed: CUDA error {rc}")
    return min(MAX_BLOCKS, clusters.value * CLUSTER)


#: (device index, stream handle) -> (counters, partials)
_scratch = ScratchCache(SCRATCH_STREAMS)


def _scratch_for(device: torch.device, stream: int, plan: Plan):
    """The kernel's counters (int32, zeroed when allocated) and partials
    (float32) on ``device`` for ``stream``, at least as large as ``plan``
    needs (``ScratchCache.take``)."""
    return _scratch.take(device, stream, plan.counter_words, plan.partial_floats)


def cofactor_update(x: torch.Tensor, w: torch.Tensor):
    """x [B, m], w [B] float32 (contiguous) -> (c [1], s [m], Q [m, m])."""
    B, m = x.shape
    check_tensor("x", x, torch.float32, (B, m), x.device)
    check_tensor("w", w, torch.float32, (B,), x.device)
    if not on_card(x):
        c, s, Q = ref.cofactor_update_ref(x, w)
        return c.reshape(1), s, Q
    plan = cofactor_plan(B, m, max_blocks(x.device.index, m))
    # the kernel's bulk copies need 16-byte aligned rows: a view at another
    # offset is copied once
    if x.data_ptr() % 16:
        x = x.clone()
    if w.data_ptr() % 16:
        w = w.clone()
    stream = stream_handle(x)
    counters, partials = _scratch_for(x.device, stream, plan)
    out = torch.empty(m * m + m + 1, dtype=torch.float32, device=x.device)
    COFACTOR_UPDATE.launch(x.data_ptr(), w.data_ptr(), B, m, plan.tile, plan.groups,
                           plan.stage_rows, plan.blocks, plan.passes, counters.data_ptr(),
                           partials.data_ptr(), out.data_ptr(), stream)
    return out[m * m + m:], out[m * m:m * m + m], out[:m * m].view(m, m)
