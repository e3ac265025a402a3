"""Relation representations (PyTorch port of ``repro.core.relations``).

Every attribute's active domain is dictionary-encoded to ``0..D-1`` and a
relation over schema ``(X1..Xk)`` is a *dense ring tensor* of shape
``[D1..Dk, *payload_shape]``.  Updates arrive as COO batches (keys +
payloads).

  DenseRelation      device-resident materialized view / base relation
  COOUpdate          batch of (key tuple -> payload) update rows
  FactorizedUpdate   a delta as a product of factors over disjoint
                     variable groups (Sec. 5)
  PyRelation         host-side exact relation (dict of key tuple ->
                     payload) for the host engine and the relational
                     data ring

``DenseRelation`` is the dense implementation of the ``ViewStorage``
protocol (``repro_torch.core.storage``).  App code builds base relations
through ``storage.make_base_relation``.

Unlike the reference's immutable arrays, ⊎ here writes into the view it is
given (``scatter_add``): the engine owns every view and base relation it
updates (``IVMEngine.build`` copies them out of the caller's database).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .rings import Payload, PyRing, Ring


def axis0_leaf_shardings(tree, mesh, axis_name: str, shard: bool):
    """A ``collectives.Placement`` per tensor leaf of ``tree``: dim 0 split
    over ``axis_name`` when ``shard``, else replicated.  The one
    partitioning convention every storage backend shares (dense leading
    key axis, sparse slot axis), single-sourced so the backends cannot
    drift apart."""
    from .collectives import Placement

    place = (Placement.split(axis_name, getattr(mesh, "grp", None)) if shard
             else Placement.replicate())
    return pytree.tree_map(lambda _: place, tree)


def host_payload(payload: Payload) -> dict:
    """Copy a ring payload to host numpy (the one blocking device→host
    transfer point for reporting and tests)."""
    return {c: v.detach().cpu().numpy() for c, v in payload.items()}


@dataclasses.dataclass
class DenseRelation:
    """Dense dictionary-encoded relation: payload[comp] has shape
    ``[*domains(schema), *comp_shape]``."""

    schema: tuple[str, ...]
    ring: Ring
    payload: Payload

    @property
    def domains(self) -> tuple[int, ...]:
        comp, shp = next(iter(self.ring.components.items()))
        arr = self.payload[comp]
        nk = arr.dim() - len(shp)
        return tuple(arr.shape[:nk])

    @property
    def device(self) -> torch.device:
        return next(iter(self.payload.values())).device

    def domain_of(self, var: str) -> int:
        return self.domains[self.schema.index(var)]

    def num_keys(self) -> torch.Tensor:
        """Number of keys with non-zero payload, as a device scalar."""
        return (~self.ring.is_zero(self.payload)).sum()

    def num_keys_sync(self) -> int:
        """Host-synced :meth:`num_keys` (tests / reporting)."""
        return int(self.num_keys())

    def payload_sync(self) -> dict:
        """Host copy of the payload (see :func:`host_payload`)."""
        return host_payload(self.payload)

    def nbytes(self) -> int:
        return sum(arr.numel() * arr.element_size()
                   for arr in self.payload.values())

    def shard_axis(self) -> int | None:
        """Axis along which this storage's key space splits across ranks
        (the leading key axis: parent-var-first layout makes it the axis
        delta scatters index first); None for a scalar view."""
        return 0 if self.schema else None

    def shard_extent(self) -> int:
        """Size of the shard axis (0 when unshardable)."""
        return int(self.domains[0]) if self.schema else 0

    def leaf_shardings(self, mesh, axis_name: str, shard: bool):
        """A ``collectives.Placement`` per payload leaf (this relation's
        pytree leaves): the leading key axis split over ``axis_name`` when
        ``shard``, else replicated."""
        return axis0_leaf_shardings(dict(sorted(self.payload.items())), mesh,
                                    axis_name, shard and bool(self.schema))

    def owned(self) -> "DenseRelation":
        """A copy whose payload components are column slices of one new
        contiguous ``[S, d]`` plane — the layout the ⊎ kernels update in
        place without concatenating the components first."""
        from .storage import flatten_payload, unflatten_payload

        plane = flatten_payload(self.ring, self.payload, self.domains)
        return DenseRelation(self.schema, self.ring, unflatten_payload(
            self.ring, plane.clone(), self.domains))

    @classmethod
    def zeros(cls, schema, ring, domains, device="cuda"):
        return cls(tuple(schema), ring, ring.zeros(tuple(domains), device=device))

    @classmethod
    def from_coo(cls, schema, ring, domains, keys, payload):
        """Scatter-add a COO batch into a fresh dense relation on the keys'
        device."""
        rel = cls.zeros(schema, ring, domains, device=keys.device)
        return rel.scatter_add(keys, payload)

    def scatter_add(self, keys: torch.Tensor, payload: Payload,
                    backend: str | None = None) -> "DenseRelation":
        """keys: [B, k] int32; payload leaves: [B, *comp].

        ⊎ routes through the ring scatter dispatch layer
        (``repro_torch.kernels.scatter_ops``).  Accumulates into this
        relation's tensors where their layout allows; always use the
        returned relation."""
        k = len(self.schema)
        if keys.dim() != 2 or keys.shape[1] != k:
            raise ValueError(f"keys {tuple(keys.shape)} do not match schema "
                             f"{self.schema}")
        from ..kernels import scatter_ops

        new = scatter_ops.scatter_add_payload(
            self.payload, self.domains, keys, payload, self.ring,
            backend=backend)
        return DenseRelation(self.schema, self.ring, new)

    def gather(self, keys: torch.Tensor) -> Payload:
        """keys: [B, k] -> payload leaves [B, *comp]."""
        idx = tuple(keys[:, i].long() for i in range(len(self.schema)))
        return {comp: self.payload[comp][idx] for comp in self.ring.components}

    #: the batched-read surface shared with ``SparseRelation`` (the serving
    #: plane's point lookup): a dense view's gather is its batched read
    gather_batched = gather

    def add(self, other) -> "DenseRelation":
        assert self.schema == other.schema
        return DenseRelation(
            self.schema, self.ring, self.ring.add(self.payload, other.payload)
        )

    def marginalize(self, var: str, lift_rel=None) -> "DenseRelation":
        """⊕_var with optional lifting (ViewStorage protocol surface)."""
        from .contraction import marginalize_dense

        return marginalize_dense(self, var, lift_rel)

    def contract(self, other, marg: Sequence[str] = (),
                 out_order=None) -> "DenseRelation":
        """⊕_marg self ⊗ other (ViewStorage protocol surface)."""
        from .contraction import contract_dense

        return contract_dense(self, other, marg=marg, out_order=out_order)

    def to_dense(self) -> "DenseRelation":
        return self

    def transpose(self, new_schema: Sequence[str]) -> "DenseRelation":
        perm = [self.schema.index(v) for v in new_schema]
        nk = len(self.schema)
        new = {}
        for comp in self.ring.components:
            arr = self.payload[comp]
            new[comp] = arr.permute(perm + list(range(nk, arr.dim())))
        return DenseRelation(tuple(new_schema), self.ring, new)

    def to_py(self, py_ring: PyRing, to_payload=None) -> "PyRelation":
        """This relation on the host as a :class:`PyRelation` of its
        non-zero keys (small relations only).  One device-to-host copy
        (:meth:`payload_sync`); ``to_payload`` maps a key's ``{comp:
        array}`` to its host payload (default: the scalar of a
        one-component ring, else the tuple of components)."""
        comp0 = next(iter(self.ring.components))
        arrs = self.payload_sync()
        doms = arrs[comp0].shape[:len(self.schema)]
        out = PyRelation(self.schema, py_ring)
        for key in np.ndindex(*doms):
            p = {c: arrs[c][key] for c in arrs}
            if to_payload is not None:
                val = to_payload(p)
            elif len(arrs) == 1:
                x = p[comp0]
                val = x.item() if x.ndim == 0 else x
            else:
                val = tuple(p[c] for c in self.ring.components)
            if not py_ring.is_zero(val):
                out.data[key] = val
        return out


# A relation is a pytree node that flattens as the reference's does (its
# payload, components in sorted order): the checkpointer's leaves, and
# their checksums, are the same in both packages.
pytree.register_pytree_node(
    DenseRelation,
    lambda r: ([dict(sorted(r.payload.items()))], (r.schema, r.ring)),
    lambda children, ctx: DenseRelation(ctx[0], ctx[1], dict(children[0])))


@dataclasses.dataclass(eq=False)
class ShardedDense(DenseRelation):
    """One rank's slice of a dense view split along its leading key axis
    (``repro_torch.core.shard``): the rows of leading keys ``[lo, hi)`` as
    one ``[rows + 1, d]`` plane whose last row stays zero (the row a read
    of a key another rank owns takes), ``payload`` its components over the
    local domains.  :attr:`domains` and :meth:`domain_of` are the view's
    logical ones, so plans compile and cache as for the whole view.  ⊎
    routes each row to the rank that owns it; a by-key read and a whole-view
    read run a collective (``repro_torch.core.collectives``), so every
    rank of the group must make them together."""

    shard: Any = None  # collectives.ShardSlice
    plane: torch.Tensor | None = None

    @classmethod
    def place(cls, rel: DenseRelation, shard) -> "ShardedDense":
        """This rank's slice of the whole view ``rel`` (new tensors)."""
        from .storage import flatten_payload

        full = flatten_payload(rel.ring, rel.payload, rel.domains)
        return cls._on(rel.schema, rel.ring, rel.domains, shard,
                       shard.take(full))

    @classmethod
    def _on(cls, schema, ring, domains, shard, plane) -> "ShardedDense":
        from .storage import unflatten_payload

        local = (shard.per_rank, *domains[1:])
        payload = unflatten_payload(ring, plane[:shard.rows], local)
        return cls(tuple(schema), ring, payload, shard=shard, plane=plane)

    @property
    def domains(self) -> tuple[int, ...]:
        return (self.shard.extent, *self.local_domains[1:])

    @property
    def local_domains(self) -> tuple[int, ...]:
        return DenseRelation.domains.fget(self)

    @property
    def rows(self) -> torch.Tensor:
        """The ``[rows, d]`` local payload rows (no zero row)."""
        return self.plane[:self.shard.rows]

    def leaves(self) -> list:
        """The tensors that hold this slice's state (``plan.relation_leaves``)."""
        return [self.plane]

    def nbytes(self) -> int:
        """Bytes of this rank's payload rows."""
        return self.rows.numel() * self.rows.element_size()

    def owned(self) -> "ShardedDense":
        return ShardedDense._on(self.schema, self.ring, self.domains,
                                self.shard, self.plane.clone())

    def logical(self, dst: int | None = None) -> DenseRelation:
        """The whole view as a new :class:`DenseRelation` (a collective:
        every rank calls it; with ``dst`` only that rank gets the view)."""
        from .storage import unflatten_payload

        full = self.shard.gather(self.rows, dst=dst)
        return DenseRelation(self.schema, self.ring, unflatten_payload(
            self.ring, full, self.domains))

    def to_dense(self) -> DenseRelation:
        return self.logical()

    def assign(self, rel: DenseRelation) -> "ShardedDense":
        """Overwrite this slice, in place, with its rows of the whole view
        ``rel`` (a trigger that rebuilds the view wholesale)."""
        from .storage import flatten_payload

        full = flatten_payload(rel.ring, rel.payload, rel.domains)
        lo = self.shard.row_lo
        self.rows.copy_(full[lo:lo + self.shard.rows])
        return self

    def linear_rows(self, keys: torch.Tensor) -> torch.Tensor:
        """Global plane rows of the view keys ``keys`` [B, k]."""
        from .storage import linear_ids

        return linear_ids(keys, self.domains)

    def read_rows(self, keys: torch.Tensor) -> torch.Tensor:
        """The ``[B, d]`` rows of the view keys ``keys`` on every rank (a
        collective over the batch)."""
        return self.shard.read(self.plane, self.linear_rows(keys))

    def num_keys(self) -> torch.Tensor:
        return self.logical().num_keys()

    def payload_sync(self) -> dict:
        return self.logical().payload_sync()

    def scatter_add(self, keys: torch.Tensor, payload: Payload,
                    backend: str | None = None) -> "ShardedDense":
        """⊎ a COO batch: each row lands on the rank that owns its key."""
        from ..kernels import ref, scatter_ops
        from .storage import flatten_payload

        ids = self.shard.route(self.linear_rows(keys))
        vals = flatten_payload(self.ring, payload, (keys.shape[0],))
        if scatter_ops.kernelable(self.ring, payload):
            scatter_ops.scatter_add_flat(self.rows, ids, vals, backend=backend)
        else:
            ref.scatter_add_ref(self.rows, ids, vals.to(self.rows.dtype))
        return self

    def gather(self, keys: torch.Tensor) -> Payload:
        from .storage import unflatten_payload

        return unflatten_payload(self.ring, self.read_rows(keys),
                                 (keys.shape[0],))

    gather_batched = gather

    def add(self, other) -> "ShardedDense":
        """⊎ a whole relation over the same schema: this rank's rows of it."""
        from .storage import as_dense, flatten_payload

        other = as_dense(other)
        assert self.schema == other.schema
        full = flatten_payload(self.ring, other.payload, self.domains)
        lo = self.shard.row_lo
        self.rows.add_(full[lo:lo + self.shard.rows])
        return self

    def marginalize(self, var: str, lift_rel=None) -> DenseRelation:
        return self.logical().marginalize(var, lift_rel)

    def contract(self, other, marg: Sequence[str] = (),
                 out_order=None) -> DenseRelation:
        return self.logical().contract(other, marg=marg, out_order=out_order)

    def transpose(self, new_schema: Sequence[str]) -> DenseRelation:
        return self.logical().transpose(new_schema)

    def to_py(self, py_ring: PyRing, to_payload=None) -> "PyRelation":
        return self.logical().to_py(py_ring, to_payload)


# A slice flattens as its plane, with the slice as context; saves and
# publishes take :meth:`ShardedDense.logical` first, so this form never
# reaches a checkpoint.
pytree.register_pytree_node(
    ShardedDense,
    lambda r: ([r.plane], (r.schema, r.ring, r.domains, r.shard)),
    lambda children, ctx: ShardedDense._on(ctx[0], ctx[1], ctx[2], ctx[3],
                                           children[0]))


def is_sharded(rel) -> bool:
    """Whether ``rel`` is one rank's slice of a sharded view."""
    return getattr(rel, "shard", None) is not None and hasattr(rel, "logical")


@dataclasses.dataclass
class COOUpdate:
    """A batch of update rows: ``keys[b] -> payload[b]``.

    Duplicate keys are allowed (payloads add up); zero payload rows are
    padding (adding ring-0 is a no-op).
    """

    schema: tuple[str, ...]
    keys: torch.Tensor  # [B, k] int32
    payload: Payload  # leaves [B, *comp]

    @property
    def batch(self) -> int:
        return int(self.keys.shape[0])

    def pad_to(self, ring: Ring, batch: int) -> "COOUpdate":
        """This batch padded to ``batch`` rows: key 0 and a ring-zero
        payload, which ⊎ adds as an exact no-op."""
        b = self.batch
        if b == batch:
            return self
        if b > batch:
            raise ValueError(f"cannot pad a batch of {b} rows to {batch}")
        keys = torch.cat([self.keys,
                          self.keys.new_zeros((batch - b, self.keys.shape[1]))])
        pad = ring.zeros((batch - b,), device=self.keys.device)
        payload = {c: torch.cat([v, pad[c]]) for c, v in self.payload.items()}
        return COOUpdate(self.schema, keys, payload)


@dataclasses.dataclass
class FactorizedUpdate:
    """Sec. 5: a delta expressed as a product of factors over disjoint
    variable groups: ``δR = f_1 ⊗ ... ⊗ f_g`` where each factor is a
    DenseRelation (typically a vector over one variable).  A rank-r update
    is a *list* of these (sum of rank-1 terms)."""

    schema: tuple[str, ...]
    factors: tuple[DenseRelation, ...]

    def __post_init__(self):
        covered = [v for f in self.factors for v in f.schema]
        if sorted(covered) != sorted(set(covered)):
            raise ValueError(f"factor schemas must be disjoint: {covered}")
        if set(covered) != set(self.schema):
            raise ValueError(f"factors cover {covered}, not {self.schema}")

    def factor_for(self, var: str) -> DenseRelation:
        for f in self.factors:
            if var in f.schema:
                return f
        raise KeyError(var)

    def densify(self, ring: Ring) -> DenseRelation:
        """Materialize the product (tests / small cases only)."""
        from .contraction import contract_dense

        acc = self.factors[0]
        for f in self.factors[1:]:
            acc = contract_dense(acc, f, marg=())
        return acc.transpose(self.schema)


class PyRelation:
    """Host-side exact relation: dict[key tuple -> py payload]."""

    def __init__(self, schema: Sequence[str], ring: PyRing, data: dict | None = None):
        self.schema = tuple(schema)
        self.ring = ring
        self.data: dict[tuple, Any] = dict(data or {})

    def copy(self) -> "PyRelation":
        return PyRelation(self.schema, self.ring, dict(self.data))

    def __len__(self):
        return len(self.data)

    def insert(self, key: tuple, payload) -> None:
        cur = self.data.get(key, self.ring.zero())
        new = self.ring.add(cur, payload)
        if self.ring.is_zero(new):
            self.data.pop(key, None)
        else:
            self.data[key] = new

    def union(self, other: "PyRelation") -> "PyRelation":
        if self.schema != other.schema:
            raise ValueError(f"union of {self.schema} and {other.schema}")
        out = self.copy()
        for k, p in other.data.items():
            out.insert(k, p)
        return out

    def project_cols(self, vars: Sequence[str]) -> list[int]:
        return [self.schema.index(v) for v in vars]

    def join(self, other: "PyRelation") -> "PyRelation":
        """Natural join (⊗): payloads multiply."""
        shared = [v for v in self.schema if v in other.schema]
        out_schema = self.schema + tuple(v for v in other.schema if v not in self.schema)
        ring = self.ring
        out = PyRelation(out_schema, ring)
        my_cols = self.project_cols(shared)
        ot_cols = other.project_cols(shared)
        ot_rest = [i for i, v in enumerate(other.schema) if v not in self.schema]
        index: dict[tuple, list[tuple]] = {}
        for k in other.data:
            index.setdefault(tuple(k[i] for i in ot_cols), []).append(k)
        for ka, pa in self.data.items():
            probe = tuple(ka[i] for i in my_cols)
            for kb in index.get(probe, ()):  # matching other keys
                key = ka + tuple(kb[i] for i in ot_rest)
                out.insert(key, ring.mul(pa, other.data[kb]))
        return out

    def marginalize(self, var: str, lift=None) -> "PyRelation":
        """⊕_X with lifting function ``lift(value) -> payload`` (default 1)."""
        i = self.schema.index(var)
        out_schema = tuple(v for v in self.schema if v != var)
        out = PyRelation(out_schema, self.ring)
        for k, p in self.data.items():
            g = lift(k[i]) if lift is not None else self.ring.one()
            out.insert(k[:i] + k[i + 1:], self.ring.mul(p, g))
        return out

    def rename(self, mapping: Mapping[str, str]) -> "PyRelation":
        return PyRelation(
            tuple(mapping.get(v, v) for v in self.schema), self.ring, dict(self.data)
        )

    def reorder(self, schema: Sequence[str]) -> "PyRelation":
        """Permute key columns into the given schema order."""
        if tuple(schema) == self.schema:
            return self
        perm = [self.schema.index(v) for v in schema]
        return PyRelation(
            tuple(schema), self.ring,
            {tuple(k[i] for i in perm): p for k, p in self.data.items()},
        )

    def equals(self, other: "PyRelation", approx=False, rtol=1e-5, atol=1e-8) -> bool:
        if set(self.schema) != set(other.schema):
            return False
        perm = [other.schema.index(v) for v in self.schema]
        theirs = {}
        for k, p in other.data.items():
            theirs[tuple(k[i] for i in perm)] = p
        for k in set(self.data) | set(theirs):
            a = self.data.get(k, self.ring.zero())
            b = theirs.get(k, self.ring.zero())
            if approx:
                fa = np.concatenate([np.ravel(np.asarray(x, dtype=np.float64))
                                     for x in (a if isinstance(a, tuple) else (a,))])
                fb = np.concatenate([np.ravel(np.asarray(x, dtype=np.float64))
                                     for x in (b if isinstance(b, tuple) else (b,))])
                if not np.allclose(fa, fb, rtol=rtol, atol=atol):
                    return False
            elif isinstance(a, tuple):
                for x, y in zip(a, b):
                    if not np.allclose(np.asarray(x), np.asarray(y)):
                        return False
            elif a != b:
                return False
        return True

    def __repr__(self):
        return f"PyRelation({self.schema}, {self.data})"
