"""View storage, dense part (PyTorch port of ``repro.core.storage``).

* :class:`ViewStorage` — the protocol every storage backend implements (the
  surface the delta engine, the contraction planner and the kernel dispatch
  assume).
* key-space shim — multi-column key linearization and the payload ↔ flat
  ``[S, d]`` plane conversion, the shared language of storage and the ⊎
  kernels.
* storage planner — this slice stores every view densely.  Hashed-COO
  sparse views (``SparseRelation``, the ``auto`` and ``sparse`` modes) are
  ROADMAP Queue 1 item 11 and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Protocol, runtime_checkable

import torch

from .relations import DenseRelation
from .rings import Payload, Ring

MODES = ("auto", "dense", "sparse")

_SPARSE_TODO = ("sparse view storage is not ported yet (ROADMAP Queue 1 "
                "item 11); build with storage='dense'")


# ---------------------------------------------------------------------------
# Key-space shim: linearized keys + flat payload planes
# ---------------------------------------------------------------------------
def comp_width(shp) -> int:
    """Element count of a (payload or key) shape tuple."""
    w = 1
    for s in shp:
        w *= int(s)
    return w


def linear_ids(keys: torch.Tensor, domains) -> torch.Tensor:
    """Row-major flat int32 segment ids for keys [B, k] over domains (D1..Dk).

    The ids are a sum of key columns times Python-int strides, in int32:
    no stride tensor is built from host data, so the call never copies
    from host memory (a blocking copy on the card, and illegal under CUDA
    graph capture)."""
    if keys.dim() != 2 or keys.shape[1] != len(domains):
        raise ValueError(f"keys {tuple(keys.shape)} vs domains {domains}")
    if keys.shape[1] == 0:
        return torch.zeros((keys.shape[0],), dtype=torch.int32,
                           device=keys.device)
    keys = keys.to(torch.int32)
    ids = keys[:, -1].to(torch.int32, copy=True)
    stride = 1
    for j in range(keys.shape[1] - 2, -1, -1):
        stride *= int(domains[j + 1])
        ids.add_(keys[:, j], alpha=stride)
    return ids


def unlinearize_ids(ids: torch.Tensor, domains) -> torch.Tensor:
    """Inverse of :func:`linear_ids`: flat ids [B] -> key columns [B, k].

    Negative (sentinel) ids decompose to garbage; callers mask them.
    """
    cols = []
    rem = ids.to(torch.int32)
    for d in reversed(domains):
        # floor semantics, as the reference's jnp ``%`` and ``//``
        cols.append(torch.remainder(rem, int(d)))
        rem = torch.div(rem, int(d), rounding_mode="floor")
    if not cols:
        return torch.zeros((ids.shape[0], 0), dtype=torch.int32,
                           device=ids.device)
    return torch.stack(cols[::-1], dim=1)


def _shared_plane(ring: Ring, payload: Payload, lead_shape, lead: int,
                  d: int):
    """The contiguous ``[lead, d]`` plane whose column slices the payload
    components are (the layout :func:`unflatten_payload` returns), or None."""
    plane = payload[next(iter(ring.components))]._base
    if (plane is None or tuple(plane.shape) != (lead, d)
            or not plane.is_contiguous()):
        return None
    off = 0
    for c, shp in ring.components.items():
        w = comp_width(shp)
        t = payload[c]
        want = plane[:, off:off + w].reshape((*lead_shape, *shp))
        if (t._base is not plane or t.data_ptr() != want.data_ptr()
                or t.shape != want.shape or t.stride() != want.stride()):
            return None
        off += w
    return plane


def flatten_payload(ring: Ring, payload: Payload, lead_shape) -> torch.Tensor:
    """Ring components as one contiguous ``[prod(lead), d_total]`` plane.

    Returns the components' own storage, not a copy, when they already are
    column slices of one such plane (views the engine owns) or when the ring
    has one contiguous component; a ⊎ kernel then updates them in place."""
    lead = comp_width(lead_shape)
    d = payload_width(ring)
    plane = _shared_plane(ring, payload, tuple(lead_shape), lead, d)
    if plane is not None:
        return plane
    planes = [payload[c].reshape(lead, comp_width(shp))
              for c, shp in ring.components.items()]
    return planes[0].contiguous() if len(planes) == 1 else torch.cat(planes, dim=1)


def unflatten_payload(ring: Ring, flat: torch.Tensor, lead_shape, dtype=None):
    """Inverse of :func:`flatten_payload`: views of the feature-axis slices."""
    out, off = {}, 0
    for c, shp in ring.components.items():
        w = comp_width(shp)
        plane = flat[:, off:off + w].reshape((*lead_shape, *shp))
        out[c] = plane if dtype is None else plane.to(dtype)
        off += w
    return out


def payload_width(ring: Ring) -> int:
    """Total feature-plane width of a ring's payload."""
    return sum(comp_width(shp) for shp in ring.components.values())


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


# ---------------------------------------------------------------------------
# The protocol
# ---------------------------------------------------------------------------
@runtime_checkable
class ViewStorage(Protocol):
    """What the engine assumes of a materialized view / base relation.
    Payload values are ring payload dicts; keys are dictionary-encoded
    int32."""

    schema: tuple[str, ...]
    ring: Ring

    @property
    def domains(self) -> tuple[int, ...]: ...
    def domain_of(self, var: str): ...
    def num_keys(self): ...
    def num_keys_sync(self) -> int: ...
    def gather(self, keys: torch.Tensor) -> Payload: ...
    def scatter_add(self, keys, payload, backend=None): ...
    def add(self, other): ...
    def marginalize(self, var: str, lift_rel=None): ...
    def contract(self, other, marg=(), out_order=None): ...
    def transpose(self, new_schema): ...
    def to_dense(self) -> DenseRelation: ...
    def nbytes(self) -> int: ...


def as_dense(rel) -> DenseRelation:
    """Coerce any storage to its dense materialization (dense: identity)."""
    return rel if isinstance(rel, DenseRelation) else rel.to_dense()


def view_nbytes(rel) -> int:
    """Device bytes held by a view under its actual storage."""
    return rel.nbytes()


def make_base_relation(schema, ring: Ring, payload: Payload) -> DenseRelation:
    """Storage-layer constructor for base relations (keeps app code agnostic
    of the storage backend)."""
    return DenseRelation(tuple(schema), ring, payload)


# ---------------------------------------------------------------------------
# Storage planner (dense only in this slice)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StorageSpec:
    """Planner decision for one view."""

    kind: str  # "dense"


def plan_storage(views: Mapping[str, ViewStorage], *,
                 mode: str | None = None,
                 overrides: Mapping[str, str] | None = None,
                 ) -> dict[str, StorageSpec]:
    """Pick a storage backend per materialized view.  ``mode`` None or
    ``"dense"`` stores every view densely; ``"auto"``, ``"sparse"`` and
    sparse overrides raise until sparse storage is ported."""
    mode = mode or "dense"
    if mode not in MODES:
        raise ValueError(f"unknown storage mode {mode!r}; one of {MODES}")
    if mode != "dense" or any(k != "dense" for k in (overrides or {}).values()):
        raise NotImplementedError(_SPARSE_TODO)
    return {name: StorageSpec("dense") for name in views}


def apply_storage_plan(views: Mapping[str, ViewStorage],
                       plan: Mapping[str, StorageSpec]):
    """Convert each view to its planned backend (dense: identity)."""
    for name, spec in plan.items():
        if spec.kind != "dense" or not isinstance(views[name], DenseRelation):
            raise NotImplementedError(_SPARSE_TODO)
    return dict(views)
