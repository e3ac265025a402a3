"""View storage (PyTorch port of ``repro.core.storage``).

* :class:`ViewStorage` — the protocol every storage backend implements (the
  surface the delta engine, the contraction planner and the kernel dispatch
  assume).
* key-space shim — multi-column key linearization and the payload ↔ flat
  ``[S, d]`` plane conversion, the shared language of storage and the ⊎
  kernels.
* :class:`SparseRelation` — hashed-COO backend: an open-addressed int32
  table of linearized keys beside a ``[C + 1, d]`` payload plane whose last
  row stays zero (the row a missed probe reads).  Slots are resolved by the
  hash kernels (``repro_torch.kernels.hash_table``: ``hash_probe`` and
  ``hash_insert``, one launch each and no host synchronise, so a trigger
  that writes a sparse view can be captured in a CUDA graph); a trigger's
  reads and claims take the delta's key matrix as it is (the keyed probe,
  ``hash_insert_targets_keys``: no stacked keys, no linear-id pass, no rank
  prepass), and the payload ⊎ runs through the ordinary scatter kernel
  dispatch on those slots.  Like every view the engine owns, a sparse
  view is updated in place: its table and plane keep their addresses.
* storage planner — picks dense or sparse per materialized view from the
  modeled ``domain product × fill``, honouring ``REPRO_TORCH_VIEW_STORAGE``
  and per-view overrides.

Capacities are fixed per table: the eager per-call path
(``IVMEngine.apply_update``) rehashes to 2× capacity when a sparse view
could cross the load-factor bound (:func:`grow_if_loaded`, one host
synchronise a touched view), and the stream executor grows tables between
capacity segments; an insert into a full table drops its row.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Protocol, Sequence, runtime_checkable

import torch
from torch.utils import _pytree as pytree

from ..kernels import hash_table
from .relations import DenseRelation, is_sharded
from .rings import Payload, Ring

ENV_VAR = "REPRO_TORCH_VIEW_STORAGE"
MODES = ("auto", "dense", "sparse")

#: open-addressing sentinel: a table slot holding EMPTY is free
EMPTY = hash_table.EMPTY

#: auto-planner thresholds: a view flips to sparse when its key-domain
#: product is at least MIN_SPARSE_DOMAIN and its fill is at most MAX_FILL
MIN_SPARSE_DOMAIN = 4096
MAX_FILL = 0.05

#: eager-path growth trigger: rehash to 2× when occupancy crosses this
LOAD_FACTOR = 0.7


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


def row_major_strides(domains) -> tuple[int, ...]:
    """The row-major stride of each key column over ``domains`` (the factor
    :func:`linear_ids` multiplies it by)."""
    strides, s = [], 1
    for d in reversed(tuple(domains)):
        strides.append(s)
        s *= int(d)
    return tuple(strides[::-1])


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
    """Coerce any storage to its dense materialization (dense: identity; a
    sharded slice: the whole view, a collective)."""
    return rel if type(rel) is DenseRelation else rel.to_dense()


def view_nbytes(rel) -> int:
    """Device bytes held by a view under its actual storage."""
    return rel.nbytes()


def make_base_relation(schema, ring: Ring, payload: Payload) -> DenseRelation:
    """Storage-layer constructor for base relations (keeps app code agnostic
    of the storage backend)."""
    return DenseRelation(tuple(schema), ring, payload)


# ---------------------------------------------------------------------------
# Open-addressed hash table primitives.  Probe and insert are the hash
# kernels on a CUDA tensor and their plain versions (the reference's
# lockstep loops) on a CPU tensor; rank and dedup have fixed shapes and no
# host synchronise on either.
# ---------------------------------------------------------------------------
def _hash_ids(ids: torch.Tensor, capacity: int) -> torch.Tensor:
    """Knuth multiplicative hash into [0, capacity); capacity power of 2."""
    return hash_table.hash_ids(ids, capacity)


def _find_slots(table: torch.Tensor, ids: torch.Tensor):
    """Probe each id's chain: returns (slot [B] int32, found [B]).

    ``slot`` is where the id lives (found) or the first free slot of its
    chain (not found).  Ids < 0 are sentinels: not probed, found = False."""
    return hash_table.hash_probe(table, ids.to(torch.int32).contiguous())


#: the serving read path's probe.  The reference lowers it as a per-row
#: loop beside the lockstep :func:`_find_slots` and keeps the two
#: bit-identical; here both are the one ``hash_probe`` kernel.
_probe_slots = _find_slots


def _insert_ids(table: torch.Tensor, ids: torch.Tensor):
    """Insert *distinct* ids (EMPTY = skip) into ``table``, in place.

    Contention for a free slot goes to the lowest row index; losers keep
    probing.  Returns (slot [B], placed [B]); rows that never place (the
    table is full) report placed = False and slot 0."""
    return hash_table.hash_insert(table, ids.to(torch.int32).contiguous())


def _rank_ids(ids: torch.Tensor):
    """Sort/rank key dedup: per-row rank into the distinct-id list, and the
    distinct ids themselves (EMPTY-padded).  Sentinel ids (< 0) collapse
    into one EMPTY rank.  :func:`_dedup_ids` sums a key's value rows by
    rank."""
    B = ids.shape[0]
    ids = ids.to(torch.int32)
    rank = torch.zeros((B,), dtype=torch.int32, device=ids.device)
    uniq = torch.full((B,), EMPTY, dtype=torch.int32, device=ids.device)
    if B == 0:
        return rank, uniq
    order = torch.argsort(ids, stable=True)
    sid = ids.index_select(0, order)
    first = torch.ones((B,), dtype=torch.bool, device=ids.device)
    first[1:] = sid[1:] != sid[:-1]
    rank_sorted = (torch.cumsum(first, 0) - 1).to(torch.int32)
    rank.scatter_(0, order, rank_sorted)
    uniq.scatter_(0, rank.long(), torch.where(ids < 0, EMPTY, ids))
    return rank, uniq


def _dedup_ids(ids: torch.Tensor, vals: torch.Tensor):
    """Distinct ids (EMPTY-padded) + per-id summed value rows, each id's
    rows added in ascending row order (``segment_ring_sum`` for float32
    rows: the kernel on the card)."""
    from ..kernels.segment_ring_sum import segment_ring_sum

    rank, uniq = _rank_ids(ids)
    B = ids.shape[0]
    if vals.dtype == torch.float32:
        return uniq, segment_ring_sum(vals.contiguous(), rank, B)
    sums = torch.zeros((B, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    return uniq, sums.index_add_(0, rank.long(), vals)


# ---------------------------------------------------------------------------
# SparseRelation: hashed-COO view storage
# ---------------------------------------------------------------------------
@dataclasses.dataclass(eq=False)
class SparseRelation:
    """Hashed-COO relation: ``table[c]`` holds the linearized key stored in
    slot ``c`` (or EMPTY) and row ``c`` of ``plane`` (``[C + 1, d]``) its
    ring value, the components as column slices (``payload``, leaves
    ``[C, *comp]``).  Row C of the plane stays zero: a gather at a missed
    probe reads it.  Invariant: free slots carry ring-zero payload.

    Deletions (negative multiplicities) drive payloads to ring zero but
    keep the key slot occupied — ``num_keys`` counts only non-zero keys,
    and :meth:`rehash` compacts zombies away.  The ⊎ methods write the
    table and plane in place and return the relation."""

    schema: tuple[str, ...]
    ring: Ring
    _domains: tuple[int, ...]
    table: torch.Tensor
    plane: torch.Tensor
    payload: Payload = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        C = self.capacity
        if tuple(self.plane.shape) != (C + 1, payload_width(self.ring)):
            raise ValueError(f"plane {tuple(self.plane.shape)} for capacity {C}")
        self.payload = unflatten_payload(self.ring, self.plane[:C], (C,))
        self._strides = row_major_strides(self._domains)

    # -- layout --------------------------------------------------------------
    @property
    def domains(self) -> tuple[int, ...]:
        return self._domains

    @property
    def device(self) -> torch.device:
        return self.table.device

    def domain_of(self, var: str) -> int:
        return self._domains[self.schema.index(var)]

    @property
    def capacity(self) -> int:
        return int(self.table.shape[0])

    @property
    def rows(self) -> torch.Tensor:
        """The ``[C, d]`` payload rows of the plane (no zero row)."""
        return self.plane[:self.capacity]

    def nbytes(self) -> int:
        """Table and plane bytes, the plane's zero row included."""
        return (self.table.numel() * self.table.element_size()
                + self.plane.numel() * self.plane.element_size())

    def owned(self) -> "SparseRelation":
        """A copy on new tensors."""
        return SparseRelation(self.schema, self.ring, self._domains,
                              self.table.clone(), self.plane.clone())

    # -- occupancy -----------------------------------------------------------
    def num_keys(self):
        """Keys with non-zero payload, as a device scalar (no host sync)."""
        return ((self.table >= 0) & ~self.ring.is_zero(self.payload)).sum()

    def num_keys_sync(self) -> int:
        return int(self.num_keys())

    def num_slots_used(self):
        """Occupied slots (including ring-zero zombies), device scalar."""
        return (self.table >= 0).sum()

    def num_slots_used_sync(self) -> int:
        return int(self.num_slots_used())

    # -- multi-device placement and the host oracle ------------------------
    def shard_axis(self) -> int | None:
        """The slot axis: a sharded table splits its payload rows by slot
        range (its key table stays whole on every rank,
        :class:`ShardedSparse`)."""
        return 0

    def shard_extent(self) -> int:
        return self.capacity

    def leaf_shardings(self, mesh, axis_name: str, shard: bool):
        """Placement per leaf (the reference's leaves: the key table, then
        the payload components): the payload rows split their slot axis
        over ``axis_name`` when ``shard``; the key table always replicates,
        because a probe, a claim and a rehash walk linear-probe chains
        across slot ranges."""
        from .collectives import Placement
        from .relations import axis0_leaf_shardings

        return [Placement.replicate(),
                axis0_leaf_shardings(dict(sorted(self.payload.items())),
                                     mesh, axis_name, shard)]

    def to_py(self, py_ring, to_payload=None):
        """This table on the host as a ``PyRelation`` (through its dense
        form; small relations only)."""
        return self.to_dense().to_py(py_ring, to_payload)

    # -- construction --------------------------------------------------------
    @classmethod
    def zeros(cls, schema, ring: Ring, domains, capacity: int = 64,
              device="cuda"):
        capacity = next_pow2(max(2, int(capacity)))
        return cls(tuple(schema), ring, tuple(int(d) for d in domains),
                   torch.full((capacity,), EMPTY, dtype=torch.int32,
                              device=device),
                   torch.zeros((capacity + 1, payload_width(ring)),
                               dtype=ring.dtype, device=device))

    @classmethod
    def from_coo(cls, schema, ring: Ring, domains, keys, payload,
                 capacity: int | None = None):
        if capacity is None:
            capacity = next_pow2(max(64, 2 * int(keys.shape[0])))
        rel = cls.zeros(schema, ring, domains, capacity, device=keys.device)
        return rel.scatter_add(keys, payload)

    @classmethod
    def from_dense(cls, dense: DenseRelation, capacity: int | None = None,
                   min_capacity: int = 64) -> "SparseRelation":
        """Sparsify a dense relation (reads the active key set on the host:
        one synchronise)."""
        ring = dense.ring
        nz = torch.nonzero(~ring.is_zero(dense.payload))  # row-major
        active = nz.shape[0]
        if capacity is None:
            capacity = max(min_capacity, next_pow2(max(2, 2 * active)))
        rel = cls.zeros(dense.schema, ring, dense.domains, capacity,
                        device=dense.device)
        if active == 0:
            return rel
        keys = nz.to(torch.int32).reshape(active, len(dense.schema))
        idx = tuple(nz[:, i] for i in range(nz.shape[1]))
        return rel.scatter_add(keys, {c: dense.payload[c][idx]
                                      for c in ring.components})

    # -- core ops ------------------------------------------------------------
    def _key_matrix(self, keys: torch.Tensor, cols):
        """(int32 key matrix with unit column stride, the view's columns in
        it): ``keys`` [B, k] in schema order when ``cols`` is None, else a
        delta's key matrix and the index of each view variable in it."""
        if cols is None:
            if keys.dim() != 2 or keys.shape[1] != len(self.schema):
                raise ValueError(f"keys {tuple(keys.shape)} do not match schema "
                                 f"{self.schema}")
            cols = range(len(self.schema))
        if keys.dtype is not torch.int32:
            keys = keys.to(torch.int32)
        if keys.dim() == 2 and keys.shape[1] > 1 and keys.stride(1) != 1:
            keys = keys.contiguous()
        return keys, tuple(cols)

    def _targets(self, keys: torch.Tensor, cols=None) -> torch.Tensor:
        """Claim slots for the view keys in ``keys`` (:meth:`_key_matrix`;
        duplicates share one slot): the target slot of every row, EMPTY
        where the table is full.  One ``hash_insert`` launch that reads the
        key columns itself."""
        keys, cols = self._key_matrix(keys, cols)
        return hash_table.hash_insert_targets_keys(self.table, keys, cols,
                                                   self._strides)

    def _local_slots(self, target: torch.Tensor) -> torch.Tensor:
        """The rows of :attr:`rows` that the claimed slots ``target`` write
        (the slots themselves: one table, one plane)."""
        return target

    def _scatter_lin(self, ids: torch.Tensor, flat_vals: torch.Tensor,
                     backend: str | None = None) -> "SparseRelation":
        """⊎ rows (linearized ids, EMPTY = drop; flat [B, d] values), in
        place: dedup → hash insert → one flat slot-scatter through the ring
        scatter kernel dispatch (the ``[S, d]`` plane with S = the table's
        capacity)."""
        from ..kernels import scatter_ops

        uniq, sums = _dedup_ids(ids, flat_vals.to(self.plane.dtype))
        slots, placed = _insert_ids(self.table, uniq)
        target = self._local_slots(torch.where(placed, slots, EMPTY))
        rows = self.rows
        if rows.dtype == torch.float32:
            scatter_ops.scatter_add_flat(rows, target, sums, backend=backend)
        else:  # count rings etc.: the exact plain path; EMPTY rows drop
            rows.index_add_(0, target.clamp(min=0).long(),
                            sums * (target >= 0)[:, None].to(sums.dtype))
        return self

    def scatter_add(self, keys: torch.Tensor, payload: Payload,
                    backend: str | None = None) -> "SparseRelation":
        """keys [B, k]; payload leaves [B, *comp] (protocol ⊎)."""
        if keys.dim() != 2 or keys.shape[1] != len(self.schema):
            raise ValueError(f"keys {tuple(keys.shape)} do not match schema "
                             f"{self.schema}")
        ids = linear_ids(keys, self._domains)
        flat = flatten_payload(self.ring, payload, (keys.shape[0],))
        return self._scatter_lin(ids, flat, backend=backend)

    def gather_mul_scatter(self, keys: torch.Tensor, src_plane: torch.Tensor,
                           in_ids: torch.Tensor, scale: torch.Tensor,
                           backend: str | None = None, cols=None) -> "SparseRelation":
        """``self ⊎ (scale[b] · src_plane[in_ids[b]])`` at ``keys``
        (:meth:`_key_matrix`) — the deferred sibling gather fused with the
        slot scatter (scalar rings): the target slots are claimed first,
        then one gather-⊗-⊎ runs over the payload plane, accumulating
        duplicate keys."""
        from ..kernels import ref, scatter_ops

        target = self._local_slots(self._targets(keys, cols))
        rows = self.rows
        in_ids = in_ids.to(torch.int32).contiguous()
        if rows.dtype == torch.float32 and src_plane.dtype == torch.float32:
            scatter_ops.gather_mul_scatter_flat(rows, target, src_plane, in_ids,
                                                scale, backend=backend)
        else:
            ref.gather_mul_scatter_ref(rows, target, src_plane, in_ids, scale)
        return self

    def fused_slot_targets(self, keys: torch.Tensor, cols=None):
        """(table, target [B]) for the fused chain: claim slots for the
        view keys in ``keys`` (:meth:`_key_matrix`) but do not dedup values
        (the fused kernel accumulates duplicates per tile).  Overflow rows
        map to EMPTY and drop."""
        return self.table, self._local_slots(self._targets(keys, cols))

    def replace_plane(self, table: torch.Tensor,
                      plane: torch.Tensor) -> "SparseRelation":
        """The relation holding ``table`` and the flat ``[C, d]`` payload
        rows ``plane`` (the fused-chain writeback): ``self`` when they are
        its own storage, else a new relation on them."""
        if table is self.table and plane.data_ptr() == self.plane.data_ptr():
            return self
        return SparseRelation(self.schema, self.ring, self._domains, table,
                              _with_zero_row(plane))

    def replace_payload(self, table: torch.Tensor,
                        payload: Payload) -> "SparseRelation":
        """A new relation from a key table and per-component payload
        leaves ``[C, *comp]``."""
        rows = flatten_payload(self.ring, payload, (table.shape[0],))
        return SparseRelation(self.schema, self.ring, self._domains, table,
                              _with_zero_row(rows))

    def _probe_keys(self, keys: torch.Tensor, cols):
        keys, cols = self._key_matrix(keys, cols)
        return hash_table.hash_probe_keys(self.table, keys, cols, self._strides)

    def lookup(self, keys: torch.Tensor, cols=None):
        """(slots [B], found [B]) for the view keys in ``keys``
        (:meth:`_key_matrix`) — the raw probe, one keyed ``hash_probe``
        launch."""
        slot, found, _ = self._probe_keys(keys, cols)
        return slot, found

    #: the serving read path's probe (:func:`_probe_slots`), which is
    #: :meth:`lookup` here
    probe = lookup

    def gather_rows(self, keys: torch.Tensor, cols=None) -> torch.Tensor:
        """The plane row each view key in ``keys`` (:meth:`_key_matrix`)
        reads: its slot where the table holds it, else the zero row C.  One
        keyed ``hash_probe`` launch."""
        return self._probe_keys(keys, cols)[2]

    def gather(self, keys: torch.Tensor, cols=None) -> Payload:
        """keys (:meth:`_key_matrix`) -> payload leaves [B, *comp]; absent
        keys read 0 (the plane's zero row C).  A deleted key keeps its slot
        but its payload is ring zero, so it reads exactly as an absent key
        does."""
        rows = self.gather_rows(keys, cols)
        return unflatten_payload(self.ring, self.plane.index_select(0, rows.long()),
                                 (rows.shape[0],))

    #: :meth:`gather` through :meth:`probe`, which is :meth:`gather` here
    gather_batched = gather

    def gather_plane(self) -> torch.Tensor:
        """The flat ``[C + 1, d]`` payload plane with its zero row C — the
        deferred-sibling-gather source (the plane itself, not a copy)."""
        return self.plane

    def key_columns(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(cols [C, k] clamped to valid ranges, occupied mask [C])."""
        occ = self.table >= 0
        return unlinearize_ids(self.table.clamp(min=0), self._domains), occ

    # -- ring algebra --------------------------------------------------------
    def add(self, other) -> "SparseRelation":
        """⊎ with another storage over the same schema."""
        if tuple(self.schema) != tuple(other.schema):
            raise ValueError(f"schemas differ: {self.schema} vs {other.schema}")
        if isinstance(other, SparseRelation):
            return self._scatter_lin(other.table, other.rows)
        return self.add_dense(as_dense(other))

    def add_dense(self, dense: DenseRelation) -> "SparseRelation":
        """⊎ a dense relation by enumerating its full key grid (meant for
        small dense deltas)."""
        S = comp_width(self._domains)
        ids = torch.arange(S, dtype=torch.int32, device=self.device)
        flat = flatten_payload(dense.ring, dense.payload, self._domains)
        return self._scatter_lin(ids, flat)

    def _rekeyed(self, schema, domains, ids, rows) -> "SparseRelation":
        out = SparseRelation.zeros(schema, self.ring, domains, self.capacity,
                                   device=self.device)
        return out._scatter_lin(ids, rows)

    def marginalize(self, var: str, lift_rel=None) -> "SparseRelation":
        """⊕_var with optional lifting, re-keyed into a fresh table."""
        i = self.schema.index(var)
        cols, occ = self.key_columns()
        payload = self.payload
        if lift_rel is not None:
            payload = self.ring.mul(payload, lift_rel.gather(cols[:, i:i + 1]))
        rem = torch.cat([cols[:, :i], cols[:, i + 1:]], dim=1)
        new_schema = tuple(v for v in self.schema if v != var)
        new_doms = tuple(d for j, d in enumerate(self._domains) if j != i)
        ids = torch.where(occ, linear_ids(rem, new_doms), EMPTY)
        return self._rekeyed(new_schema, new_doms, ids, flatten_payload(
            self.ring, payload, (self.capacity,)))

    def contract(self, other, marg: Sequence[str] = (),
                 out_order=None) -> "SparseRelation":
        """⊕_marg self ⊗ other via the dense contraction engine, re-keyed
        sparse (host-side sizing: not for trigger paths — the planner keeps
        contraction-fed views dense)."""
        from .contraction import contract_dense

        dense = contract_dense(self.to_dense(), as_dense(other), marg=marg,
                               out_order=out_order)
        return SparseRelation.from_dense(dense)

    def transpose(self, new_schema) -> "SparseRelation":
        perm = [self.schema.index(v) for v in new_schema]
        cols, occ = self.key_columns()
        new_doms = tuple(self._domains[p] for p in perm)
        # column by column: a list index would copy the list to the device
        cols = torch.stack([cols[:, p] for p in perm], dim=1)
        ids = torch.where(occ, linear_ids(cols, new_doms), EMPTY)
        return self._rekeyed(tuple(new_schema), new_doms, ids, self.rows)

    def rehash(self, capacity: int | None = None) -> "SparseRelation":
        """Rebuild into a fresh table (default: same capacity), dropping
        ring-zero zombie keys."""
        capacity = capacity or self.capacity
        live = (self.table >= 0) & ~self.ring.is_zero(self.payload)
        ids = torch.where(live, self.table, EMPTY)
        out = SparseRelation.zeros(self.schema, self.ring, self._domains,
                                   capacity, device=self.device)
        return out._scatter_lin(ids, self.rows)

    # -- conversion ----------------------------------------------------------
    def to_dense(self) -> DenseRelation:
        """The dense relation over the key domains (a new tensor; each key
        occupies one slot, so every element is one copy, exact)."""
        S = comp_width(self._domains)
        ids = torch.where(self.table >= 0, self.table, S).long()
        flat = torch.zeros((S + 1, self.plane.shape[1]), dtype=self.plane.dtype,
                           device=self.device)
        flat.index_add_(0, ids, self.rows)
        return DenseRelation(self.schema, self.ring, unflatten_payload(
            self.ring, flat[:S], self._domains))




@dataclasses.dataclass(eq=False)
class ShardedSparse(SparseRelation):
    """One rank's slice of a hashed-COO view split by slot range
    (``repro_torch.core.shard``): the whole int32 key table, replicated on
    every rank, beside the payload rows of slots ``[lo, hi)`` as one
    ``[rows + 1, d]`` plane whose last row stays zero.

    Linear probing crosses slot ranges, so every rank keeps the table and
    runs each probe, claim and rehash itself; a claim is deterministic
    (the lowest row wins), so every rank claims the same slots from the
    same rows, and a ⊎ then writes only the slots its rank owns
    (:meth:`_local_slots`).  A by-key read (:meth:`gather`) and anything
    that needs the whole view (:meth:`logical`: ``to_dense``, ``rehash``,
    ``marginalize``) run a collective, so every rank of the group must make
    them together.  :attr:`capacity` is the table's, so plans compile and
    cache as for the whole view."""

    shard: object = None  # collectives.ShardSlice over the slot axis

    def __post_init__(self):
        n = self.shard.rows
        if tuple(self.plane.shape) != (n + 1, payload_width(self.ring)):
            raise ValueError(f"plane {tuple(self.plane.shape)} for {n} local "
                             f"slots")
        self.payload = unflatten_payload(self.ring, self.plane[:n], (n,))
        self._strides = row_major_strides(self._domains)

    @classmethod
    def place(cls, rel: SparseRelation, grp) -> "ShardedSparse":
        """This rank's slice of the whole table ``rel`` over the group
        ``grp`` (new tensors)."""
        from .collectives import ShardSlice

        shard = ShardSlice(grp, rel.capacity)
        return cls(rel.schema, rel.ring, rel._domains, rel.table.clone(),
                   shard.take(rel.rows), shard=shard)

    @property
    def rows(self) -> torch.Tensor:
        """This rank's ``[rows, d]`` payload rows (no zero row)."""
        return self.plane[:self.shard.rows]

    def owned(self) -> "ShardedSparse":
        return ShardedSparse(self.schema, self.ring, self._domains,
                             self.table.clone(), self.plane.clone(),
                             shard=self.shard)

    def logical(self, dst: int | None = None) -> SparseRelation:
        """The whole table as a new :class:`SparseRelation` (a collective:
        every rank calls it; with ``dst`` only that rank gets the plane)."""
        rows = self.shard.gather(self.rows, dst=dst)
        return SparseRelation(self.schema, self.ring, self._domains,
                              self.table.clone(), _with_zero_row(rows))

    def _local_slots(self, target: torch.Tensor) -> torch.Tensor:
        """Claimed slots → this rank's rows; slots other ranks own → -1."""
        return self.shard.route(target)

    def num_keys(self):
        return self.logical().num_keys()

    def replace_plane(self, table: torch.Tensor,
                      plane: torch.Tensor) -> "ShardedSparse":
        if table is self.table and plane.data_ptr() == self.plane.data_ptr():
            return self
        return ShardedSparse(self.schema, self.ring, self._domains, table,
                             _with_zero_row(plane), shard=self.shard)

    def read_rows(self, keys: torch.Tensor, cols=None) -> torch.Tensor:
        """The ``[B, d]`` rows of the view keys in ``keys``
        (:meth:`_key_matrix`) on every rank: one keyed probe of the whole
        table, this rank's rows, then a collective over the batch (a
        missed key's row C is no rank's, so it reads zero)."""
        return self.shard.read(self.plane, self.gather_rows(keys, cols))

    def gather(self, keys: torch.Tensor, cols=None) -> Payload:
        return unflatten_payload(self.ring, self.read_rows(keys, cols),
                                 (keys.shape[0],))

    gather_batched = gather

    def gather_plane(self) -> torch.Tensor:
        raise TypeError("a sharded table's plane holds one rank's slots: "
                        "read it by key (read_rows) or whole (logical)")

    def add(self, other) -> "ShardedSparse":
        if is_sharded(other):
            other = other.logical()
        return super().add(other)

    def marginalize(self, var: str, lift_rel=None) -> SparseRelation:
        return self.logical().marginalize(var, lift_rel)

    def contract(self, other, marg: Sequence[str] = (),
                 out_order=None) -> SparseRelation:
        return self.logical().contract(other, marg=marg, out_order=out_order)

    def transpose(self, new_schema) -> SparseRelation:
        return self.logical().transpose(new_schema)

    def rehash(self, capacity: int | None = None) -> "ShardedSparse":
        """Rebuild into a fresh table: the plane rows are gathered, the
        whole table rehashed on every rank alike, and each rank keeps the
        rows of its slot range of the new capacity (rows move across
        ranks)."""
        return ShardedSparse.place(self.logical().rehash(capacity),
                                   self.shard.grp)

    def to_dense(self) -> DenseRelation:
        return self.logical().to_dense()


def _with_zero_row(rows: torch.Tensor) -> torch.Tensor:
    return torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])


def _sparse_unflatten(children, ctx) -> SparseRelation:
    schema, ring, domains = ctx
    table, payload = children
    rows = flatten_payload(ring, payload, (int(table.shape[0]),))
    return SparseRelation(schema, ring, domains, table, _with_zero_row(rows))


# flattens as the reference's SparseRelation: the key table, then the
# payload components ``[C, *comp]`` in sorted order (not the plane, whose
# zero row is no state); unflattening builds a new plane
pytree.register_pytree_node(
    SparseRelation,
    lambda r: ([r.table, dict(sorted(r.payload.items()))],
               (r.schema, r.ring, r._domains)),
    _sparse_unflatten)

# a slice flattens as its table and plane; saves and publishes take
# :meth:`ShardedSparse.logical` first, so this form never reaches a checkpoint
pytree.register_pytree_node(
    ShardedSparse,
    lambda r: ([r.table, r.plane], (r.schema, r.ring, r._domains, r.shard)),
    lambda children, ctx: ShardedSparse(ctx[0], ctx[1], ctx[2], children[0],
                                        children[1], shard=ctx[3]))


# ---------------------------------------------------------------------------
# Storage planner
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StorageSpec:
    """Planner decision for one view."""

    kind: str  # "dense" | "sparse"
    capacity: int = 0  # sparse only


def resolve_storage_mode(mode: str | None = None) -> str:
    """Explicit arg > ``REPRO_TORCH_VIEW_STORAGE`` > auto."""
    m = mode or os.environ.get(ENV_VAR) or "auto"
    if m not in MODES:
        raise ValueError(f"unknown storage mode {m!r}; one of {MODES}")
    return m


def plan_storage(
    views: Mapping[str, ViewStorage],
    *,
    tree=None,
    updatable: Sequence[str] = (),
    strategy: str = "fivm",
    mode: str | None = None,
    overrides: Mapping[str, str] | None = None,
    min_domain: int = MIN_SPARSE_DOMAIN,
    max_fill: float = MAX_FILL,
    headroom: float = 2.0,
    min_capacity: int = 64,
) -> dict[str, StorageSpec]:
    """Pick a storage backend per materialized view (one host synchronise
    a view, at build).

    ``auto`` chooses sparse when the key-domain product clears
    ``min_domain``, the measured fill is at most ``max_fill`` and the view
    is not in the plan's sparse-hostile set (``plan.storage_hostility``:
    its joins would densify it, or its ⊎ would arrive with dense axes).
    ``sparse`` forces every eligible view sparse; ``dense`` stores every
    view densely.  Per-view ``overrides`` (name -> "dense" | "sparse") win.
    Only ``fivm`` / ``dbt`` engines plan non-dense storage (1-IVM and
    reevaluation rebuild views wholesale), premarg ``W:`` views and
    scalar-keyed views stay dense.  A sparse view's capacity is
    ``next_pow2(max(min_capacity, active · headroom + 1))``, at most the
    domain product's power of two (such a table never overflows)."""
    mode = resolve_storage_mode(mode)
    overrides = dict(overrides or {})
    hostile: set[str] = set()
    if tree is not None and mode == "auto":
        from .plan import storage_hostility

        hostile = storage_hostility(tree, updatable)
    plan: dict[str, StorageSpec] = {}
    for name, v in views.items():
        kind = overrides.get(name)
        if kind is None:
            if (strategy not in ("fivm", "dbt") or name.startswith("W:")
                    or not v.schema or mode == "dense"):
                kind = "dense"
            elif mode == "sparse":
                kind = "sparse"
            else:  # auto: domain product × fill model
                S = comp_width(v.domains)
                fill = v.num_keys_sync() / max(S, 1)
                kind = ("sparse" if S >= min_domain and fill <= max_fill
                        and name not in hostile else "dense")
        if kind == "sparse":
            S = comp_width(v.domains)
            active = v.num_keys_sync()
            cap = next_pow2(max(min_capacity, int(active * headroom) + 1))
            plan[name] = StorageSpec("sparse", min(cap, next_pow2(S)))
        elif kind == "dense":
            plan[name] = StorageSpec("dense")
        else:
            raise ValueError(f"unknown storage kind {kind!r} for {name}")
    return plan


def apply_storage_plan(views: Mapping[str, ViewStorage],
                       plan: Mapping[str, StorageSpec]):
    """Convert each view to its planned backend (no-op where it matches)."""
    out = {}
    for name, v in views.items():
        spec = plan.get(name, StorageSpec("dense"))
        if spec.kind == "sparse" and isinstance(v, DenseRelation):
            out[name] = SparseRelation.from_dense(v, capacity=spec.capacity)
        elif spec.kind == "dense" and isinstance(v, SparseRelation):
            out[name] = v.to_dense().owned()
        else:
            out[name] = v
    return out


def grow_if_loaded(rel, budget: int = 0):
    """Eager-path growth: rehash a sparse view to 2× capacity (repeatedly)
    while adding ``budget`` more keys could cross the load-factor bound.
    The budget is clamped to the key-domain product, and a table covering
    the full domain stops growing.  Reads the occupancy on the host (one
    synchronise); never called on a trigger or graph path."""
    if not isinstance(rel, SparseRelation):
        return rel
    full = next_pow2(comp_width(rel.domains))
    budget = min(int(budget), comp_width(rel.domains))
    cap = rel.capacity
    used = rel.num_slots_used_sync()
    while cap < full and used + budget > LOAD_FACTOR * cap:
        cap *= 2
    if cap != rel.capacity:
        rel = rel.rehash(cap)  # also compacts ring-zero zombies
    return rel


def occupancy_report(views: Mapping[str, ViewStorage]) -> dict[str, dict]:
    """Occupancy of every sparse view (host synchronises): capacity, slots
    used (zombies included — what the load-factor bound sees) and live
    keys."""
    return {name: {"capacity": v.capacity,
                   "slots_used": v.num_slots_used_sync(),
                   "keys": v.num_keys_sync()}
            for name, v in views.items() if isinstance(v, SparseRelation)}


# ---------------------------------------------------------------------------
# Physical-layout export / import
# ---------------------------------------------------------------------------
def export_layout(rel) -> dict:
    """JSON-serializable physical layout of a view's storage: for a sparse
    view its table capacity, which drifts with growth and rarely matches a
    freshly built engine's."""
    if isinstance(rel, SparseRelation):
        return {"kind": "sparse", "capacity": rel.capacity}
    return {"kind": "dense"}


def layout_template(rel, layout: Mapping) -> "ViewStorage":
    """An all-zeros view with ``rel``'s logical definition (schema, ring,
    domains) in the physical layout ``layout``, on ``rel``'s device."""
    dev = rel.device
    if layout.get("kind") == "sparse":
        return SparseRelation.zeros(rel.schema, rel.ring, rel.domains,
                                    capacity=int(layout["capacity"]),
                                    device=dev)
    return DenseRelation.zeros(rel.schema, rel.ring, rel.domains, device=dev)
