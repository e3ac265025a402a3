"""Ring-bilinear contraction engine (PyTorch port of ``repro.core.contraction``).

A view in F-IVM is a join of child views followed by marginalization of the
node's variable (Fig. 3).  Over dense dictionary-encoded relations this is a
tensor contraction in the ring:

    V[out] = ⊕_{marg} A[sch_A] ⊗ B[sch_B]

Every ring product used is bilinear in its payload components
(``Ring.mul_terms``), so the contraction decomposes into one
``torch.einsum`` per bilinear term.  This file also holds the batched-COO
delta algebra of incremental maintenance: a delta is COO over the variables
bound by the update and dense over variables contributed by materialized
sibling views.
"""
from __future__ import annotations

import dataclasses
import functools
import string
from typing import Sequence

import torch

from .relations import COOUpdate, DenseRelation, ShardedDense, is_sharded
from .rings import Payload, Ring

_KEY_LETTERS = string.ascii_lowercase
_PAY_LETTERS = string.ascii_uppercase


def _pay_map(subs: str) -> str:
    """Map MulTerm payload subscripts (i, j, k...) into the uppercase pool."""
    return "".join(_PAY_LETTERS[ord(c) - ord("i")] for c in subs)


# ---------------------------------------------------------------------------
# Contraction plans: every bilinear contraction site reduces to a fixed list
# of (comp_out, comp_a, comp_b, einsum_spec, coef) terms determined by the
# ring's mul_terms and the key-subscript strings, memoized per shape of call.
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _einsum_plan(mul_terms, a_key: str, b_key: str, o_key: str):
    return tuple(
        (
            t.comp_out,
            t.comp_a,
            t.comp_b,
            f"{a_key}{_pay_map(t.a_subs)},{b_key}{_pay_map(t.b_subs)}"
            f"->{o_key}{_pay_map(t.out_subs)}",
            t.coef,
        )
        for t in mul_terms
    )


def _apply_plan(plan, a_payload: Payload, b_payload: Payload) -> dict:
    out: dict[str, torch.Tensor] = {}
    for comp_out, comp_a, comp_b, spec, coef in plan:
        term = torch.einsum(spec, a_payload[comp_a], b_payload[comp_b])
        if coef != 1.0:
            term = term * coef
        out[comp_out] = out[comp_out] + term if comp_out in out else term
    return out


@functools.lru_cache(maxsize=None)
def _dense_plan(mul_terms, a_schema: tuple, b_schema: tuple, marg: tuple,
                out_order: tuple | None):
    """(out_schema, einsum plan) for contract_dense, keyed per
    (schema_a, schema_b, marg, ring bilinear structure)."""
    all_vars = list(a_schema) + [v for v in b_schema if v not in a_schema]
    for m in marg:
        if m not in all_vars:
            raise ValueError(f"cannot marginalize {m}: not in {all_vars}")
    out_schema = tuple(v for v in all_vars if v not in marg)
    if out_order is not None:
        if set(out_order) != set(out_schema):
            raise ValueError(f"out_order {out_order} vs schema {out_schema}")
        out_schema = tuple(out_order)
    letters = {v: _KEY_LETTERS[i] for i, v in enumerate(all_vars)}
    a_key = "".join(letters[v] for v in a_schema)
    b_key = "".join(letters[v] for v in b_schema)
    o_key = "".join(letters[v] for v in out_schema)
    return out_schema, _einsum_plan(mul_terms, a_key, b_key, o_key)


def contract_dense(
    a: DenseRelation,
    b: DenseRelation,
    marg: Sequence[str] = (),
    out_order: Sequence[str] | None = None,
) -> DenseRelation:
    """V = ⊕_{marg} a ⊗ b over dense relations (einsum per bilinear term)."""
    ring = a.ring
    if ring.mul_terms is None:
        raise ValueError(f"ring {ring.name} lacks bilinear terms")
    out_schema, plan = _dense_plan(
        tuple(ring.mul_terms), tuple(a.schema), tuple(b.schema), tuple(marg),
        None if out_order is None else tuple(out_order))
    out = _apply_plan(plan, a.payload, b.payload)
    doms = []
    for v in out_schema:
        src = a if v in a.schema else b
        doms.append(src.domain_of(v))
    for comp, shp in ring.components.items():
        if comp not in out:
            out[comp] = torch.zeros((*doms, *shp), dtype=ring.dtype,
                                    device=a.device)
    return DenseRelation(out_schema, ring, out)


def lift_relation(ring: Ring, var: str, domain_values: torch.Tensor,
                  lift_spec) -> DenseRelation:
    """Build the unary 'lift relation' L_X[x] = g_X(x) over the dictionary
    (on ``domain_values``' device).

    lift_spec: ("one",) | ("value",) | ("square",) | ("degree", j)
    """
    kind = lift_spec[0]
    if kind == "one":
        payload = ring.ones((domain_values.shape[0],),
                            device=domain_values.device)
    elif kind == "value":
        payload = ring.lift(domain_values)
    elif kind == "square":  # g(x) = x² (scalar-payload cofactor baselines)
        payload = ring.lift(domain_values * domain_values)
    elif kind == "degree":
        payload = ring.lift(domain_values, var_index=lift_spec[1])
    else:
        raise ValueError(lift_spec)
    return DenseRelation((var,), ring, payload)


def marginalize_dense(
    rel: DenseRelation, var: str, lift_rel: DenseRelation | None
) -> DenseRelation:
    """⊕_X rel with optional lifting (contract against the lift relation)."""
    if lift_rel is None:
        i = rel.schema.index(var)
        out_schema = tuple(v for v in rel.schema if v != var)
        # dtype kept: torch sums int32 into int64, the reference keeps int32
        out = {c: rel.payload[c].sum(dim=i, dtype=rel.payload[c].dtype)
               for c in rel.ring.components}
        return DenseRelation(out_schema, rel.ring, out)
    return contract_dense(rel, lift_rel, marg=(var,))


def _take_clip(plane: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``plane`` at ``ids`` clamped into range (``mode="clip"``)."""
    return plane.index_select(0, ids.clamp(0, plane.shape[0] - 1).long())


# ---------------------------------------------------------------------------
# Batched deltas: COO over update-bound vars × dense over sibling-contributed
# vars.  This is the device representation of a delta view (Sec. 4–5).
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class BatchedDelta:
    """payload leaves: [B, *domains(dense_schema), *comp_shape].

    ``pending_gather`` is a deferred sibling-view gather ``(src_plane
    [Sg, d], in_ids [B])``: for bilinear commutative rings, ``join_dense``
    against a view fully bound by the delta's COO vars is a per-row
    gather-multiply, so it stays symbolic — the source plane is the view's
    flattened ``[Sg, d]`` component plane (a sparse view resolves its hash
    slots at defer time and gathers from its plane with the zero row C that
    missed probes index) — and fuses with the eventual scatter in
    ``apply_to``.  Scalar rings take the gather-⊗-⊎ kernel;
    wider rings gather the plane once and run the ring's bilinear product
    row-wise before the scatter.  Non-commutative rings never defer, and
    any operation that needs the materialized payload forces it first
    (:meth:`_force`)."""

    coo_schema: tuple[str, ...]
    dense_schema: tuple[str, ...]
    keys: torch.Tensor  # [B, len(coo_schema)] int32
    ring: Ring
    payload: Payload
    dense_domains: tuple[int, ...] = ()
    pending_gather: tuple | None = None

    @property
    def batch(self) -> int:
        return int(self.keys.shape[0])

    def key_col(self, var: str) -> torch.Tensor:
        return self.keys[:, self.coo_schema.index(var)]

    def _cols(self, schema) -> list[int]:
        """The column of each variable of ``schema`` in :attr:`keys`."""
        return [self.coo_schema.index(v) for v in schema]

    @classmethod
    def from_coo(cls, ring: Ring, upd: COOUpdate) -> "BatchedDelta":
        return cls(
            coo_schema=tuple(upd.schema),
            dense_schema=(),
            keys=upd.keys,
            ring=ring,
            payload=upd.payload,
            dense_domains=(),
        )

    # -- deferred sibling gather --------------------------------------------
    def _is_scalar_ring(self) -> bool:
        comps = self.ring.components
        return len(comps) == 1 and next(iter(comps.values())) == ()

    def _defer_ok(self, view) -> bool:
        """A join against ``view`` can stay symbolic when the ring product
        is bilinear and commutative, the delta carries no dense axes, and
        every view var is COO-bound (the join is a pure per-row gather)."""
        ring = self.ring
        if self.pending_gather is not None or self.dense_schema:
            return False
        if ring.mul_terms is None or not ring.commutative:
            return False
        return bool(view.schema) and all(v in self.coo_schema
                                         for v in view.schema)

    def _gather_plan(self, view, src_plane=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """(src_plane [Sg, d], in_ids [B]) for a deferred gather of
        ``view`` at the delta's COO coordinates; ``src_plane``, when
        given, is the view's flattened plane computed ahead (a stream
        step's memo)."""
        from . import storage

        if is_sharded(view):
            # a sharded sibling: this rank's rows of the batch, then one
            # collective over the batch; the gather source is the batch
            cols = self._cols(view.schema)
            if isinstance(view, storage.SparseRelation):
                rows = view.read_rows(self.keys, cols)
            else:
                rows = view.read_rows(torch.stack(
                    [self.keys[:, c] for c in cols], dim=1))
            return rows, torch.arange(self.batch, dtype=torch.int32,
                                      device=rows.device)
        if isinstance(view, storage.SparseRelation):
            # one keyed probe launch on the delta's key matrix
            rows = view.gather_rows(self.keys, self._cols(view.schema))
            if src_plane is None:
                src_plane = view.gather_plane()  # [C + 1, d], zero row at C
            return src_plane, rows
        keys = torch.stack([self.key_col(v) for v in view.schema], dim=1)
        if src_plane is None:
            src_plane = storage.flatten_payload(self.ring, view.payload,
                                                view.domains)
        return src_plane, storage.linear_ids(keys, view.domains)

    def _force(self) -> "BatchedDelta":
        """Materialize a deferred sibling gather into the payload."""
        if self.pending_gather is None:
            return self
        from . import storage

        src_plane, ids = self.pending_gather
        g = _take_clip(src_plane, ids)  # [B, d]
        if self._is_scalar_ring():
            comp = next(iter(self.ring.components))
            payload = {comp: self.payload[comp] * g[:, 0]}
        else:
            gp = storage.unflatten_payload(self.ring, g, (self.batch,),
                                           dtype=self.ring.dtype)
            payload = _mul_broadcast(self.ring, self.payload, gp,
                                     self.dense_schema)
        return dataclasses.replace(self, payload=payload, pending_gather=None)

    # -- lift-and-marginalize one variable ---------------------------------
    def marginalize(self, var: str, lift_rel: DenseRelation | None) -> "BatchedDelta":
        if var in self.coo_schema:
            if (self.pending_gather is not None and self.batch > 1
                    and len(self.coo_schema) == 1):
                # batch collapse would sum rows: materialize the gather first
                return self._force().marginalize(var, lift_rel)
            i = self.coo_schema.index(var)
            payload = self.payload
            if lift_rel is not None:
                g = lift_rel.gather(self.keys[:, i : i + 1])  # [B, *comp]
                payload = _mul_broadcast(self.ring, payload, g, self.dense_schema)
            # column slices, not a list index: indexing with a Python list
            # copies the list to the device (a synchronising host copy)
            keys = torch.cat([self.keys[:, :i], self.keys[:, i + 1:]], dim=1)
            new_coo = tuple(v for v in self.coo_schema if v != var)
            if not new_coo and self.batch > 1:
                # batch collapse: with no COO vars left the rows are
                # indistinguishable — sum them into one row now
                payload = {c: p.sum(dim=0, keepdim=True, dtype=p.dtype)
                           for c, p in payload.items()}
                keys = keys[:1]
            return dataclasses.replace(
                self,
                coo_schema=new_coo,
                keys=keys,
                payload=payload,
            )
        # dense axis: contract against lift vector (or plain-sum)
        i = self.dense_schema.index(var)
        axis = 1 + i  # after batch
        if lift_rel is None:
            payload = {c: self.payload[c].sum(dim=axis,
                                              dtype=self.payload[c].dtype)
                       for c in self.ring.components}
        else:
            payload = _contract_axis(self.ring, self.payload, lift_rel.payload,
                                     axis, len(self.dense_schema))
        return dataclasses.replace(
            self,
            dense_schema=tuple(v for v in self.dense_schema if v != var),
            dense_domains=tuple(d for j, d in enumerate(self.dense_domains)
                                if j != i),
            payload=payload,
        )

    # -- join with a materialized sibling view ------------------------------
    def join_dense(self, view, src_plane=None) -> "BatchedDelta":
        """δ ⊗ V: coo-shared vars of V are gathered at the delta's coords;
        dense-shared vars align elementwise; fresh vars of V become new
        dense axes.  ``src_plane`` (V's flattened plane, computed ahead)
        serves a deferred gather.  A sparse ``view`` resolves to a gather
        (deferred where possible) and densifies only when the join would
        grow dense axes from it."""
        ring = self.ring
        if self._defer_ok(view):
            return dataclasses.replace(
                self, pending_gather=self._gather_plan(view, src_plane))
        if self.pending_gather is not None:
            return self._force().join_dense(view, src_plane)
        from .storage import SparseRelation

        if isinstance(view, SparseRelation):
            if view.schema and all(v in self.coo_schema for v in view.schema):
                # per-row gather-multiply (a second sibling after a forced
                # pending gather, or a delta carrying dense axes)
                g = view.gather(self.keys, self._cols(view.schema))
                payload = _mul_broadcast(ring, self.payload, g, self.dense_schema)
                return dataclasses.replace(self, payload=payload)
            view = view.to_dense()  # the join grows dense axes: materialize
        elif isinstance(view, ShardedDense):
            if all(v in self.coo_schema for v in view.schema):
                g = view.gather(torch.stack([self.key_col(v)
                                             for v in view.schema], dim=1))
                payload = _mul_broadcast(ring, self.payload, g, self.dense_schema)
                return dataclasses.replace(self, payload=payload)
            view = view.logical()  # the join reads the whole view
        shared_coo = [v for v in view.schema if v in self.coo_schema]

        # Gather view slices at coo coordinates -> leading batch axis.
        if shared_coo:
            idx_axes = [view.schema.index(v) for v in shared_coo]
            rest_axes = [i for i in range(len(view.schema)) if i not in idx_axes]
            v_payload = {}
            for comp in ring.components:
                arr = view.payload[comp]
                nk = len(view.schema)
                if len(idx_axes) == 1:
                    # gather along the shared axis, then move the batch axis
                    # to the front: touches O(B·|rest|) elements
                    ax = idx_axes[0]
                    g = arr.index_select(ax, self.key_col(shared_coo[0]).long())
                    v_payload[comp] = g.movedim(ax, 0)
                else:
                    perm = idx_axes + rest_axes + list(range(nk, arr.dim()))
                    arr = arr.permute(perm)
                    idx = tuple(self.key_col(v).long() for v in shared_coo)
                    v_payload[comp] = arr[idx]  # [B, rest..., comp]
            v_schema = [view.schema[i] for i in rest_axes]
            has_batch = True
        else:
            v_payload = view.payload
            v_schema = list(view.schema)
            has_batch = False

        # Multiply self.payload [B, D_dense..., comp] with v_payload
        # [B?, D_vrest..., comp], aligning shared dense axes and
        # broadcasting fresh ones: one einsum per bilinear term.
        out_dense = list(self.dense_schema) + [v for v in v_schema
                                               if v not in self.dense_schema]
        letters = {v: _KEY_LETTERS[i] for i, v in enumerate(out_dense)}
        a_key = "z" + "".join(letters[v] for v in self.dense_schema)
        b_key = ("z" if has_batch else "") + "".join(letters[v] for v in v_schema)
        o_key = "z" + "".join(letters[v] for v in out_dense)
        plan = _einsum_plan(tuple(ring.mul_terms), a_key, b_key, o_key)
        out = _apply_plan(plan, self.payload, v_payload)
        doms = dict(zip(self.dense_schema, self.dense_domains))
        for v in v_schema:
            doms.setdefault(v, view.domain_of(v))
        out_domains = tuple(doms[v] for v in out_dense)
        for comp, shp in ring.components.items():
            if comp not in out:
                out[comp] = torch.zeros((self.batch, *out_domains, *shp),
                                        dtype=ring.dtype, device=self.keys.device)
        return dataclasses.replace(
            self,
            dense_schema=tuple(out_dense),
            dense_domains=out_domains,
            payload=out,
        )

    # -- application ---------------------------------------------------------
    def apply_to(self, view, backend: str | None = None):
        """view ⊎ δ : scatter-add into the materialized view.

        Scatters route through the ring scatter dispatch layer
        (``repro_torch.kernels.scatter_ops``); a pending sibling gather
        fuses into one gather-⊗-⊎ kernel call (scalar rings) or one flat
        gather + row-wise ring product + scatter (bilinear rings).  The
        view's storage is updated in place where its layout allows; use the
        returned relation."""
        ring = self.ring
        if set(view.schema) != set(self.coo_schema) | set(self.dense_schema):
            raise ValueError(f"delta over {self.coo_schema}+{self.dense_schema} "
                             f"does not match view {view.schema}")
        from .storage import SparseRelation

        if isinstance(view, SparseRelation):
            return self._apply_sparse(view, backend)
        if isinstance(view, ShardedDense):
            return self._apply_sharded(view, backend)
        coo_axes = [view.schema.index(v) for v in self.coo_schema]
        dense_axes = [view.schema.index(v) for v in self.dense_schema]
        from ..kernels import scatter_ops

        if coo_axes and not dense_axes:
            # pure-COO delta: one flat scatter, each view axis indexed by
            # its own key column — no transpose of the materialized view
            keys = torch.stack([self.key_col(v) for v in view.schema], dim=1)
            if self.pending_gather is not None:
                src_plane, in_ids = self.pending_gather
                if self._is_scalar_ring():
                    comp = next(iter(ring.components))
                    new_payload = scatter_ops.gather_mul_scatter_payload(
                        view.payload, view.domains, keys, src_plane, in_ids,
                        self.payload[comp], ring, backend=backend)
                else:
                    new_payload = scatter_ops.gather_ringmul_scatter_payload(
                        view.payload, view.domains, keys, src_plane, in_ids,
                        self.payload, ring, backend=backend)
            else:
                new_payload = scatter_ops.scatter_add_payload(
                    view.payload, view.domains, keys, self.payload, ring,
                    backend=backend)
            return DenseRelation(view.schema, ring, new_payload)
        slf = self._force()
        if coo_axes:
            from .storage import comp_width

            coo_doms = tuple(view.domain_of(v) for v in slf.coo_schema)
            resolved = scatter_ops.resolve_backend(
                comp_width(coo_doms), slf.batch,
                sum(comp_width(view.payload[c].shape[1:])
                    for c in ring.components), backend,
                device=self.keys.device)
            if resolved != "torch" and scatter_ops.kernelable(
                    ring, view.payload, slf.payload):
                return slf._apply_mixed_kernel(view, coo_axes, dense_axes,
                                               resolved)
        return slf._apply_mixed_plain(view, coo_axes, dense_axes)

    def _apply_mixed_plain(self, view: DenseRelation, coo_axes, dense_axes
                           ) -> DenseRelation:
        """Mixed COO×dense application with plain torch (index_put_ /
        plain add)."""
        ring = self.ring
        nk = len(view.schema)
        new_payload = {}
        for comp in ring.components:
            arr = view.payload[comp]
            # move coo axes to the front
            perm = coo_axes + dense_axes + list(range(nk, arr.dim()))
            inv = [perm.index(i) for i in range(arr.dim())]
            arrp = arr.permute(perm)
            # delta payload: [B, *dense_domains(self order), *comp] — match
            # the view's dense axis order
            dp = self.payload[comp]
            d_perm = [0] + [1 + self.dense_schema.index(view.schema[i])
                            for i in dense_axes] \
                + list(range(1 + len(self.dense_schema), dp.dim()))
            dp = dp.permute(d_perm)
            if coo_axes:
                idx = tuple(self.key_col(v).long() for v in self.coo_schema)
                arrp = arrp.index_put_(idx, dp, accumulate=True)
            else:
                arrp = arrp + dp.sum(dim=0, dtype=dp.dtype)
            new_payload[comp] = arrp.permute(inv)
        return DenseRelation(view.schema, ring, new_payload)

    def _apply_mixed_kernel(self, view: DenseRelation, coo_axes, dense_axes,
                            backend: str) -> DenseRelation:
        """Mixed COO×dense application through the kernel dispatch: the coo
        axes linearize to segment ids; the dense axes and ring components
        flatten into one [S_coo, d] feature plane."""
        from ..kernels import scatter_ops
        from .storage import comp_width, linear_ids

        ring = self.ring
        nk = len(view.schema)
        coo_doms = tuple(view.domain_of(v) for v in self.coo_schema)
        S = comp_width(coo_doms)
        B = self.batch
        view_planes, val_planes, metas = [], [], []
        for comp in ring.components:
            arr = view.payload[comp]
            perm = coo_axes + dense_axes + list(range(nk, arr.dim()))
            inv = [perm.index(i) for i in range(arr.dim())]
            arrp = arr.permute(perm)
            dp = self.payload[comp]
            d_perm = [0] + [1 + self.dense_schema.index(view.schema[i])
                            for i in dense_axes] \
                + list(range(1 + len(self.dense_schema), dp.dim()))
            dp = dp.permute(d_perm)
            metas.append((comp, tuple(arrp.shape), inv))
            view_planes.append(arrp.reshape(S, -1))
            val_planes.append(dp.reshape(B, -1))
        flat_view = view_planes[0].contiguous() if len(view_planes) == 1 \
            else torch.cat(view_planes, dim=1)
        flat_vals = val_planes[0] if len(val_planes) == 1 else \
            torch.cat(val_planes, dim=1)
        ids = linear_ids(
            torch.stack([self.key_col(v) for v in self.coo_schema], dim=1),
            coo_doms)
        out = scatter_ops.scatter_add_flat(flat_view, ids, flat_vals,
                                           backend=backend)
        new_payload, off = {}, 0
        for comp, pshape, inv in metas:
            w = comp_width(pshape[len(coo_doms):])
            plane = out[:, off:off + w]
            new_payload[comp] = plane.reshape(pshape).permute(inv)
            off += w
        return DenseRelation(view.schema, ring, new_payload)

    def _apply_sharded(self, view: ShardedDense, backend: str | None):
        """⊎ into one rank's slice of a dense view split on its leading key
        axis, in place: a pure-COO delta's rows are routed (rows another
        rank owns get id -1, which every ⊎ kernel drops; the rest are
        offset to the local plane) and take the same flat kernels; a delta
        with dense axes is cut to this rank's keys first (rows another rank
        owns, or its dense lead axis outside the range) and applied to the
        local relation."""
        from ..kernels import ref, scatter_ops
        from .storage import flatten_payload

        ring = self.ring
        lead = view.schema[0]
        if self.coo_schema and not self.dense_schema:
            keys = torch.stack([self.key_col(v) for v in view.schema], dim=1)
            ids = view.shard.route(view.linear_rows(keys))
            rows = view.rows
            if (self.pending_gather is not None and self._is_scalar_ring()
                    and scatter_ops.kernelable(ring, self.payload)
                    and self.pending_gather[0].dtype == torch.float32):
                src_plane, in_ids = self.pending_gather
                comp = next(iter(ring.components))
                scatter_ops.gather_mul_scatter_flat(
                    rows, ids, src_plane, in_ids, self.payload[comp],
                    backend=backend)
                return view
            slf = self._force()
            vals = flatten_payload(ring, slf.payload, (slf.batch,))
            if scatter_ops.kernelable(ring, slf.payload):
                scatter_ops.scatter_add_flat(rows, ids, vals, backend=backend)
            else:
                ref.scatter_add_ref(rows, ids, vals.to(rows.dtype))
            return view
        slf = self._force()
        lo, n = view.shard.lo, view.shard.per_rank
        if lead in slf.coo_schema:
            i = slf.coo_schema.index(lead)
            k = slf.keys[:, i]
            own = (k >= lo) & (k < lo + n)
            keys = slf.keys.clone()
            keys[:, i] = torch.where(own, k - lo, 0)
            payload = {}
            for c, p in slf.payload.items():
                mask = own.reshape((-1,) + (1,) * (p.dim() - 1))
                payload[c] = torch.where(mask, p, torch.zeros_like(p))
            slf = dataclasses.replace(slf, keys=keys, payload=payload)
        else:
            j = slf.dense_schema.index(lead)
            slf = dataclasses.replace(
                slf, payload={c: p.narrow(1 + j, lo, n)
                              for c, p in slf.payload.items()},
                dense_domains=tuple(n if a == j else d for a, d
                                    in enumerate(slf.dense_domains)))
        local = DenseRelation(view.schema, ring, view.payload)
        out = slf.apply_to(local, backend=backend)
        for c in ring.components:
            if out.payload[c].data_ptr() != view.payload[c].data_ptr():
                view.payload[c].copy_(out.payload[c])
        return view

    def _apply_sparse(self, view, backend: str | None):
        """⊎ into a hashed-COO view: hash-slot resolution + the same flat
        kernel scatters, in place.  A mixed COO×dense delta enumerates its
        dense grid into COO rows first (built on the device from ``arange``:
        no host data)."""
        ring = self.ring
        if not view.schema:
            raise ValueError("scalar-keyed views are always dense")
        if not self.dense_schema:
            if self.pending_gather is not None and self._is_scalar_ring():
                # fused: claim slots (one insert launch on the delta's key
                # matrix), then one gather-⊗-⊎ over the plane
                src_plane, in_ids = self.pending_gather
                comp = next(iter(ring.components))
                return view.gather_mul_scatter(self.keys, src_plane, in_ids,
                                               self.payload[comp], backend=backend,
                                               cols=self._cols(view.schema))
            keys = torch.stack([self.key_col(v) for v in view.schema], dim=1)
            slf = self._force()  # non-scalar pending: gather, then scatter
            return view.scatter_add(keys, slf.payload, backend=backend)
        slf = self._force()
        B = slf.batch
        P = 1
        for d in slf.dense_domains:
            P *= int(d)
        dev = slf.keys.device
        grid = torch.stack(torch.meshgrid(
            *[torch.arange(int(d), dtype=torch.int32, device=dev)
              for d in slf.dense_domains], indexing="ij"), dim=-1).reshape(
                  P, len(slf.dense_schema))
        cols = []
        for v in view.schema:
            if v in slf.coo_schema:
                cols.append(slf.key_col(v)[:, None].expand(B, P).reshape(-1))
            else:
                cols.append(grid[:, slf.dense_schema.index(v)].repeat(B))
        keys = torch.stack(cols, dim=1)
        payload = {c: slf.payload[c].reshape(B * P, *shp)
                   for c, shp in ring.components.items()}
        return view.scatter_add(keys, payload, backend=backend)


def _mul_broadcast(ring: Ring, payload: Payload, g: Payload, dense_schema) -> Payload:
    """payload [B, D..., comp] * g [B, comp] elementwise in the ring."""
    nd = len(dense_schema)
    d_letters = _KEY_LETTERS[:nd]
    plan = _einsum_plan(tuple(ring.mul_terms), f"z{d_letters}", "z",
                        f"z{d_letters}")
    out = _apply_plan(plan, payload, g)
    ref = payload[next(iter(payload))]
    for comp, shp in ring.components.items():
        if comp not in out:
            out[comp] = torch.zeros((ref.shape[0], *ref.shape[1:1 + nd], *shp),
                                    dtype=ring.dtype, device=ref.device)
    return out


def _contract_axis(ring: Ring, payload: Payload, lift_payload: Payload,
                   axis: int, n_dense: int) -> Payload:
    """⊕ over one dense axis with lifting: einsum contraction of that axis."""
    d_letters = _KEY_LETTERS[:n_dense]
    m = d_letters[axis - 1]
    o_letters = d_letters.replace(m, "")
    plan = _einsum_plan(tuple(ring.mul_terms), f"z{d_letters}", m,
                        f"z{o_letters}")
    out = _apply_plan(plan, payload, lift_payload)
    ref = payload[next(iter(payload))]
    for comp, shp in ring.components.items():
        if comp not in out:
            dd = tuple(d for i, d in enumerate(ref.shape[1:1 + n_dense])
                       if i != axis - 1)
            out[comp] = torch.zeros((ref.shape[0], *dd, *shp),
                                    dtype=ring.dtype, device=ref.device)
    return out
