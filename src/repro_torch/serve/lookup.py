"""Batched lookups over both storage backends (PyTorch port of
``repro.serve.lookup``).

Every function takes a view snapshot (a ``DenseRelation`` or
``SparseRelation`` copy published by the
:class:`~repro_torch.serve.registry.SnapshotRegistry`) and returns tensors
on the view's device; nothing here reads a value on the host, so no lookup
synchronises.

Lowering per backend:

* **point** — dense: the tuple-index gather.  sparse: one keyed
  ``hash_probe`` launch (``SparseRelation.gather_batched``) that linearizes
  the key columns, probes the table and names the plane row each key reads:
  absent keys read the plane's zero row, and zombie slots (deleted keys
  still holding their slot with a ring-zero payload) read as absent keys
  do.  Key rows with a negative column are padding: they are clamped to 0
  for the gather and read ring zero.
* **range** — over *linearized* key order (``storage.linear_ids``' row-major
  ids), ``[lo, hi)`` given as Python ints or device scalars.
  ``range_sum`` is the masked ⊕ over the range (every ring's ⊕ is
  componentwise addition); ``range_scan`` returns the first ``k`` *live*
  keys of the range in ascending linearized order (live = non-zero
  payload: zombies and free slots never surface).  Dense masks the flat
  ``[S]`` id axis; sparse masks the slot axis by the stored table ids.
* **top_k** — the best ``k`` live keys by one scalar entry of a payload
  component; dead keys score the dtype's lowest value.  Ties keep the lower
  position first, as ``lax.top_k`` does (a stable descending sort).

``k`` larger than the position axis raises ``ValueError``, as the
reference's ``lax.top_k`` does.
"""
from __future__ import annotations

import torch

from ..core.storage import SparseRelation, comp_width, unlinearize_ids


def _flat_leaf(view, comp: str) -> torch.Tensor:
    """Payload leaf with key dims flattened to one leading axis (``[S,
    *comp]`` dense, ``[C, *comp]`` sparse — the *position* axis the range
    and top-k lookups index)."""
    shp = view.ring.components[comp]
    return view.payload[comp].reshape((-1,) + tuple(shp))


def _position_ids_alive(view):
    """(ids [P], alive [P]) over the backend's position axis: the linearized
    key stored at each position and whether it is live (non-zero payload;
    sparse also requires an occupied slot)."""
    ring = view.ring
    if isinstance(view, SparseRelation):
        flat = {c: _flat_leaf(view, c) for c in ring.components}
        return view.table, (view.table >= 0) & ~ring.is_zero(flat)
    S = comp_width(view.domains)
    device = next(iter(view.payload.values())).device
    ids = torch.arange(S, dtype=torch.int32, device=device)
    return ids, ~ring.is_zero(view.payload).reshape(S)


def _check_k(k: int, positions: int) -> None:
    if k > positions:
        raise ValueError(f"k argument to top_k must be no larger than size "
                         f"along axis; got k={k} with {positions} positions")


def _mask(valid: torch.Tensor, x: torch.Tensor, shp) -> torch.Tensor:
    """``x`` where ``valid`` (one flag a row, ``x``'s rows of payload shape
    ``shp``), else zero; broadcasts an unbatched ``x`` to the rows."""
    m = valid.reshape((-1,) + (1,) * len(shp))
    return torch.where(m, x, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------- point
def point(view, keys: torch.Tensor) -> dict:
    """Batched point lookup: keys [B, k] -> payload leaves [B, *comp].

    Absent (and zombied) keys read ring zero; keys with any negative column
    are padding and read ring zero too."""
    if keys.shape[1]:
        pad = (keys < 0).any(dim=1)
    else:
        pad = torch.zeros((keys.shape[0],), dtype=torch.bool,
                          device=keys.device)
    out = view.gather_batched(keys.clamp(min=0))
    return {c: _mask(~pad, out[c], shp)
            for c, shp in view.ring.components.items()}


# ---------------------------------------------------------------------- range
def range_sum(view, lo, hi) -> dict:
    """⊕ of all payloads with linearized key id in [lo, hi).

    Returns a scalar-key payload dict.  Componentwise addition is every
    ring's ⊕, so a masked sum over the position axis is the ring fold;
    zombies hold ring zero and add nothing.  The sum keeps the ring's dtype
    (an int32 count ring sums to int32, as the reference's)."""
    ids, _ = _position_ids_alive(view)
    in_range = (ids >= lo) & (ids < hi)
    if isinstance(view, SparseRelation):
        in_range &= ids >= 0
    out = {}
    for c, shp in view.ring.components.items():
        leaf = _flat_leaf(view, c)
        out[c] = _mask(in_range, leaf, shp).sum(dim=0, dtype=leaf.dtype)
    return out


def range_scan(view, lo, hi, k: int):
    """First ``k`` live keys with linearized id in [lo, hi), ascending.

    Returns ``(keys [k, nk], payload leaves [k, *comp], valid [k])``; rows
    past the range's live population have valid=False and ring-zero
    payload.  Live means non-zero payload: free slots, zombies and dense
    zero entries never surface."""
    ids, alive = _position_ids_alive(view)
    _check_k(k, ids.shape[0])
    sel = alive & (ids >= lo) & (ids < hi)
    big = comp_width(view.domains)
    score = torch.where(sel, ids, big)
    # the selected ids are distinct, so the order of ties (unselected
    # positions, all ``big``) changes nothing that is returned
    got, pos = torch.topk(score, k, largest=False, sorted=True)
    valid = got < big
    keys = unlinearize_ids(torch.where(valid, got, 0), view.domains)
    payload = {c: _mask(valid, _flat_leaf(view, c)[pos], shp)
               for c, shp in view.ring.components.items()}
    return keys, payload, valid


# ---------------------------------------------------------------------- top-k
def top_k(view, k: int, component: str | None = None, index: tuple = ()):
    """Top-``k`` live keys by one scalar entry of a payload plane.

    ``component`` picks the ring component (default: the ring's first);
    ``index`` indexes into that component's payload shape (e.g. one entry of
    a degree-m ``Q`` matrix); scalar components need none.  Returns ``(keys
    [k, nk], values [k], valid [k])`` sorted descending, equal values in
    ascending position; dead keys (absent / zombied / zero) never place."""
    ring = view.ring
    comp = next(iter(ring.components)) if component is None else component
    shp = ring.components[comp]
    if len(index) != len(shp):
        raise ValueError(f"component {comp!r} has payload shape {shp}; index "
                         f"{index} must fully select one scalar entry")
    ids, alive = _position_ids_alive(view)
    _check_k(k, ids.shape[0])
    scores = _flat_leaf(view, comp)[(slice(None),) + tuple(index)]
    lowest = (torch.finfo(scores.dtype).min if scores.dtype.is_floating_point
              else torch.iinfo(scores.dtype).min)
    masked = torch.where(alive, scores, lowest)
    vals, pos = torch.sort(masked, descending=True, stable=True)
    vals, pos = vals[:k], pos[:k]
    valid = vals > lowest
    got = ids[pos] if isinstance(view, SparseRelation) else pos.to(torch.int32)
    keys = unlinearize_ids(torch.where(valid, got, 0), view.domains)
    return keys, torch.where(valid, vals, 0), valid
