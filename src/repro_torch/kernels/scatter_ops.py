"""Dispatch layer for the ring scatter subsystem (⊎ / gather-⊗-⊎).

PyTorch port of ``repro/kernels/scatter_ops.py``.  Every view-maintenance
⊎ funnels through here: ``DenseRelation.scatter_add`` (base-relation bumps),
``BatchedDelta.apply_to`` and the slot scatters of a hashed-COO
``SparseRelation`` (whose segments are its table's slots, resolved by the
hash kernels first).  The layer owns what the kernels don't:

* **Key linearization + payload shim** — COO keys ``[B, k]`` flatten to
  row-major segment ids and a ring payload to one ``[S, d]`` plane (the
  degree-m (c, s, Q) triple is one ``d = 1 + m + m²`` plane), from
  ``repro_torch.core.storage``.
* **Compaction** (``compact``) — sort and rank the batch's ids, sum the
  duplicates over local ranks with ``segment_ring_sum``, then scatter at
  most B unique rows: the work scales with the batch, not the domain.
* **Backend choice** — ``torch`` (the plain versions), ``scatter`` (the
  scatter kernels), ``scatter_dedup`` (the scatter with in-tile key dedup,
  the counterpart of the reference's ``onehot_dedup``; the fused gather
  keeps ``gather_mul_scatter``), ``compact`` or ``auto``.  An explicit
  argument wins, then ``use_backend``/``set_backend``, then the
  environment variable ``REPRO_TORCH_SCATTER_BACKEND``, then ``auto``:
  ``torch`` for CPU tensors; for CUDA tensors ``scatter`` while
  S <= max(4096, 8·B), else ``compact``.  ``auto`` never picks
  ``scatter_dedup``, as the reference's never picks ``onehot_dedup``.

The ⊎ accumulates into the view's own storage where the layout allows (the
engine owns its views); callers always use the returned payload.
"""
from __future__ import annotations

import contextlib
import os

import torch

from ..core.storage import (comp_width, flatten_payload, linear_ids,
                            payload_width, unflatten_payload)
from . import ref
from .ring_scatter import gather_mul_scatter, scatter_add
from .segment_ring_sum import segment_ring_sum

ENV_VAR = "REPRO_TORCH_SCATTER_BACKEND"

BACKENDS = ("auto", "torch", "scatter", "scatter_dedup", "compact")

#: S up to this (or 8·B) takes ``scatter``, above it ``compact``.  The value
#: is the reference's TPU-era onehot/compact crossover, not yet measured on
#: the H100 (chip_smoke.py prints both paths' times at the slice's shapes).
MIN_COMPACT_SEGMENTS = 4096

_override: str | None = None


def _check_backend(backend: str | None) -> None:
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown scatter backend {backend!r}; one of {BACKENDS}")


def set_backend(backend: str | None) -> None:
    """Process-wide backend override (None restores env/auto resolution)."""
    global _override
    _check_backend(backend)
    _override = backend


@contextlib.contextmanager
def use_backend(backend: str | None):
    """Scoped backend override (tests and benches sweep the paths)."""
    global _override
    prev = _override
    set_backend(backend)
    try:
        yield
    finally:
        _override = prev


def active_override() -> str | None:
    """The forced backend (``use_backend`` scope / ``set_backend`` / env
    var), or None.  Part of the trigger-plan cache key: plans bake their
    resolved backends in, so an override change must recompile them."""
    return _override or os.environ.get(ENV_VAR)


def resolve_backend(num_segments: int, batch: int, width: int,
                    backend: str | None = None, *, device) -> str:
    """Explicit arg > ``use_backend`` override > env var > ``auto``."""
    b = backend or active_override() or "auto"
    _check_backend(b)
    if b != "auto":
        return b
    if torch.device(device).type != "cuda":
        return "torch"
    cross = max(MIN_COMPACT_SEGMENTS, 8 * batch)
    return "scatter" if num_segments <= cross else "compact"


def kernelable(ring, *payloads) -> bool:
    """The kernels accumulate in float32; any other dtype (count rings are
    int32) keeps the plain exact ``index_put_`` path, on the card too."""
    if ring.dtype != torch.float32:
        return False
    return all(leaf.dtype == torch.float32
               for p in payloads for leaf in p.values())


# ---------------------------------------------------------------------------
# flat [S, d] entry points
# ---------------------------------------------------------------------------
def scatter_add_flat(view, seg_ids, values, backend: str | None = None):
    """view [S, d] ⊎ values [B, d] at seg_ids [B]; ids < 0 or >= S are
    padding.  Accumulates into ``view`` and returns it."""
    S, d = view.shape
    backend = resolve_backend(S, seg_ids.shape[0], d, backend,
                              device=view.device)
    seg_ids = seg_ids.to(torch.int32).contiguous()
    values = values.contiguous()
    if backend == "torch":
        return ref.scatter_add_ref(view, seg_ids, values)
    if backend == "compact":
        return _compact_scatter(view, seg_ids, values)
    return scatter_add(view, seg_ids, values,
                       dedup=(backend == "scatter_dedup"))


def _compact_scatter(view, seg_ids, values):
    """Key-dedup + local accumulate: sort the batch's ids, rank distinct
    keys, segment-sum duplicates over *local* ranks (B segments — the work
    scales with the batch, not the domain), then scatter at most B unique
    rows.  Padding ids (< 0) rank first and map out of range, so they
    drop."""
    S = view.shape[0]
    B = seg_ids.shape[0]
    if B == 0:
        return view
    order = torch.argsort(seg_ids, stable=True)
    sid = seg_ids[order]
    first = torch.ones((B,), dtype=torch.bool, device=view.device)
    first[1:] = sid[1:] != sid[:-1]
    rank_sorted = (torch.cumsum(first, 0) - 1).to(torch.int32)
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    # unique id per rank slot; unused slots and the padding segment point
    # out of range and drop in the final scatter
    uniq = torch.full((B,), S, dtype=torch.int32, device=view.device)
    uniq[rank.long()] = torch.where(seg_ids < 0, S, seg_ids)
    sums = segment_ring_sum(values, rank, B)
    return scatter_add(view, uniq, sums)


def gather_mul_scatter_flat(view, out_ids, src, in_ids, scale,
                            backend: str | None = None):
    """view [S, d] ⊎ (scale[b] · src[in_ids[b]]) at out_ids[b] — the fused
    sibling-gather ⊗ scatter of ``BatchedDelta.apply_to``.  ``src`` is a
    dense view's flattened plane, or a sparse view's ``[C + 1, d]`` plane
    whose zero row C the missed probes index.  Accumulates into ``view``
    and returns it."""
    S, d = view.shape
    backend = resolve_backend(S, out_ids.shape[0], d, backend,
                              device=view.device)
    return _gather_mul_scatter(view, out_ids, src, in_ids, scale, backend)


def _int32(ids):
    """``ids`` as a contiguous int32 tensor: itself when it is one already
    (a ``.to`` that changes nothing still costs host microseconds)."""
    if ids.dtype is torch.int32 and ids.is_contiguous():
        return ids
    return ids.to(torch.int32).contiguous()


def _gather_mul_scatter(view, out_ids, src, in_ids, scale, backend: str):
    """:func:`gather_mul_scatter_flat` under a resolved ``backend``."""
    out_ids, in_ids = _int32(out_ids), _int32(in_ids)
    scale, src = scale.contiguous(), src.contiguous()
    if backend == "torch":
        return ref.gather_mul_scatter_ref(view, out_ids, src, in_ids, scale)
    if backend == "compact":
        # compaction dedups output keys; the gather stays separate
        rows = in_ids.clamp(0, src.shape[0] - 1).long()
        vals = src.index_select(0, rows) * scale[:, None]
        return _compact_scatter(view, out_ids, vals)
    return gather_mul_scatter(view, out_ids, src, in_ids, scale)


# ---------------------------------------------------------------------------
# payload entry points (what the core calls)
# ---------------------------------------------------------------------------
def _index_tuple(keys):
    return tuple(keys[:, i].long() for i in range(keys.shape[1]))


def scatter_add_payload(view_payload, domains, keys, values, ring,
                        backend: str | None = None):
    """``view ⊎ COO batch`` over a ring payload.

    view_payload leaves: ``[*domains, *comp]``; keys ``[B, k]``; values
    leaves ``[B, *comp]``.  Returns the updated payload dict.
    """
    domains = tuple(int(x) for x in domains)
    S = comp_width(domains)
    B = keys.shape[0]
    resolved = resolve_backend(S, B, payload_width(ring), backend,
                               device=keys.device)
    if resolved == "torch" or not kernelable(ring, view_payload, values):
        idx = _index_tuple(keys)
        return {c: view_payload[c].index_put_(idx, values[c], accumulate=True)
                for c in ring.components}
    ids = linear_ids(keys, domains)
    flat_view = flatten_payload(ring, view_payload, domains)
    flat_vals = flatten_payload(ring, values, (B,))
    out = scatter_add_flat(flat_view, ids, flat_vals, backend=resolved)
    return unflatten_payload(ring, out, domains)


def gather_mul_scatter_payload(view_payload, domains, keys, src_plane,
                               in_ids, scale, ring,
                               backend: str | None = None):
    """``view ⊎ (scale ⊗ src[in_ids])`` for single-scalar-component rings —
    the deferred sibling gather of ``BatchedDelta.join_dense`` fused with
    the final scatter.  ``src_plane``: [Sg, 1] flattened source plane."""
    comp = next(iter(ring.components))
    if len(ring.components) != 1 or ring.components[comp] != ():
        raise ValueError("fused gather-scatter serves scalar payload rings only")
    domains = tuple(int(x) for x in domains)
    S = comp_width(domains)
    B = keys.shape[0]
    resolved = resolve_backend(S, B, 1, backend, device=keys.device)
    if resolved == "torch" or not kernelable(ring, view_payload) \
            or src_plane.dtype != torch.float32:
        rows = in_ids.clamp(0, src_plane.shape[0] - 1).long()
        vals = scale * src_plane[:, 0].index_select(0, rows)
        return {comp: view_payload[comp].index_put_(_index_tuple(keys), vals,
                                                    accumulate=True)}
    ids = linear_ids(keys, domains)
    flat_view = flatten_payload(ring, view_payload, domains)
    out = _gather_mul_scatter(flat_view, ids, src_plane, in_ids, scale,
                              resolved)
    return {comp: out.reshape(domains)}


def gather_ringmul_scatter_payload(view_payload, domains, keys, src_plane,
                                   in_ids, delta_payload, ring,
                                   backend: str | None = None):
    """``view ⊎ (delta ⊗ src[in_ids])`` for bilinear non-scalar rings: one
    flat gather of the concatenated component plane, a row-wise ring
    product, then the ordinary payload scatter (which dispatches to the
    kernels)."""
    B = keys.shape[0]
    rows = in_ids.clamp(0, src_plane.shape[0] - 1).long()
    gp = unflatten_payload(ring, src_plane.index_select(0, rows), (B,),
                           dtype=ring.dtype)
    vals = ring.mul(delta_payload, gp)
    return scatter_add_payload(view_payload, domains, keys, vals, ring,
                               backend=backend)
