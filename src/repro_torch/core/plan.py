"""Trigger-plan IR: delta propagation as a compiled artifact (PyTorch port
of ``repro.core.plan``).

F-IVM maintenance reduces to a *fixed* hierarchy of view updates per
trigger.  This module makes the trigger an explicit object:

* a small typed IR (:class:`LeafDelta`, :class:`Gather`, :class:`Lift`,
  :class:`JoinContract`, :class:`Marginalize`, :class:`Emit`,
  :class:`ScatterAccum`, :class:`IndicatorBump`, :class:`BaseBump`,
  :class:`Reevaluate`), each op carrying schema, storage class and backend
  annotations;
* a compiler :func:`compile_trigger` that runs once per (relation,
  update signature, backend override) and is cached on the engine
  (:class:`PlanCache`);
* one planning pass: the densify cost model (:func:`should_densify`) and
  the scatter-backend resolution read the same symbolic path analysis;
* a plan-level fusion pass (:func:`fuse_trigger_ops`) that collapses
  Gather→Lift→(Marginalize)→Emit→ScatterAccum runs into :class:`FusedChain`
  ops, each one launch of the ``fused_chain`` kernel on the card
  (``repro_torch.kernels.ring_fused``), under the fusion switch
  (:func:`fusion_mode`, ``REPRO_TORCH_PLAN_FUSION``);
* an interpreter (:func:`execute_trigger`) that replays a plan with the
  delta-algebra calls of ``contraction.BatchedDelta``.

The symbolic state tracked during compilation mirrors ``BatchedDelta``
(COO schema, dense schema, effective batch incl. collapse, pending deferred
gather), so every runtime decision of the delta algebra is known at compile
time.  Each Gather / JoinContract / ScatterAccum carries the storage class
of its view (``dense`` or ``sparse``, the hashed-COO tables of
``repro_torch.core.storage``), and the plan cache keys plans by the storage
layout (kinds and table capacities), so a rehash recompiles.

Factorized updates (Sec. 5 Optimize) compile to their own op sequence
(:func:`_compile_factorized_ops`) and replay over a factor list
(:func:`run_factorized_ops`).  Two shapes of that replay, the ones a
rank-1 matrix-chain trigger reduces to, run the hand kernels of
``repro_torch.kernels.rank1_chain`` (:func:`factorized_route`); every
other shape runs the reference's einsums.

Indicator projections (Sec. 6) add a plan's second part, ``ind_ops``: for
every maintained ∃-projection over the updated relation, an
:class:`IndicatorBump` (the transition counts and δ∃) and the δ∃'s path to
the root.  It runs after the main part and reads the views the main part
has just updated, as the reference's does: δ(R·V) = δR·V + R′·δV.  It never
fuses.

Every compile miss of the plan cache runs the static plan verifier
(``repro_torch.analysis.verifier``) when ``REPRO_TORCH_PLAN_VERIFY`` resolves
to ``on`` (``auto``: under pytest and CI); a plan that fails it raises and is
not cached, and a cache hit verifies nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time
from typing import Any, Mapping, Sequence

import torch

from .contraction import BatchedDelta, contract_dense
from .materialize import views_on_path
from .query import Query
from .relations import (COOUpdate, DenseRelation, FactorizedUpdate,
                        ShardedDense, is_sharded)
from .rings import ScalarRing
from .storage import (SparseRelation, as_dense, flatten_payload, linear_ids,
                      payload_width, unflatten_payload)
from .view_tree import ViewNode, evaluate_view

#: indicator dense relations are referenced by this name prefix in op
#: ``view`` fields (the host oracle's ``∃<node>`` naming)
IND_PREFIX = "∃"

# ---------------------------------------------------------------------------
# The op vocabulary.  Frozen dataclasses: hashable (interning) and printable
# in a stable text form.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PlanOp:
    def label(self) -> str:  # pragma: no cover - overridden
        return type(self).__name__


@dataclasses.dataclass(frozen=True)
class LeafDelta(PlanOp):
    """Build the leaf delta: COO rows, one densified delta relation, or
    (batch 0) the factor list of a factorized update."""

    rel: str
    schema: tuple
    batch: int
    densify: bool

    def label(self):
        if self.densify:
            form = f"densified[{','.join(self.schema)}]"
        elif self.batch == 0:
            form = f"factors[{','.join(self.schema)}]"
        else:
            form = f"rows[{','.join(self.schema)}; B={self.batch}]"
        return f"Leaf {form}"


@dataclasses.dataclass(frozen=True)
class Gather(PlanOp):
    """Deferred sibling gather: the join stays symbolic (pending_gather)
    and fuses into the eventual scatter / a later forced materialize."""

    view: str
    vars: tuple
    storage: str  # "dense" | "sparse"
    forces: bool = False  # materializes a previously pending gather first

    def label(self):
        f = " !force" if self.forces else ""
        return f"Gather[{self.view} {self.storage}]{f}"


@dataclasses.dataclass(frozen=True)
class JoinContract(PlanOp):
    """Eager join with a materialized sibling (einsum per bilinear term)."""

    view: str
    vars: tuple
    storage: str
    grows: tuple = ()  # fresh dense axes grown by this join
    densifies: bool = False  # sparse sibling materializes to dense first
    gathers: bool = False  # fully-bound per-row gather-multiply path
    forces: bool = False

    def label(self):
        tags = []
        if self.densifies:
            tags.append("densify")
        if self.gathers:
            tags.append("gather")
        if self.grows:
            tags.append(f"+[{','.join(self.grows)}]")
        if self.forces:
            tags.append("!force")
        t = (" " + " ".join(tags)) if tags else ""
        return f"Join[{self.view} {self.storage}]{t}"


@dataclasses.dataclass(frozen=True)
class Lift(PlanOp):
    """Gather the lift relation g_var at the delta's keys (identity lifts
    compile to *no* Lift op)."""

    var: str
    spec: tuple

    def label(self):
        return f"Lift[{self.var} {'.'.join(str(s) for s in self.spec)}]"


@dataclasses.dataclass(frozen=True)
class Marginalize(PlanOp):
    var: str
    axis: str  # "coo" | "dense"
    collapses: bool = False  # batch collapse fires after this ⊕
    forces: bool = False

    def label(self):
        tags = []
        if self.collapses:
            tags.append("collapse")
        if self.forces:
            tags.append("!force")
        t = (" " + " ".join(tags)) if tags else ""
        return f"Marg[{self.var} {self.axis}]{t}"


@dataclasses.dataclass(frozen=True)
class Emit(PlanOp):
    """Record the current delta as this view's delta (PropagationResult)."""

    view: str

    def label(self):
        return f"Emit[{self.view}]"


@dataclasses.dataclass(frozen=True)
class ScatterAccum(PlanOp):
    """view ⊎ δ into the materialized view."""

    view: str
    storage: str
    backend: str | None = None  # scatter kernel backend (plan-time resolved)
    fused: bool = False  # a pending gather fuses into this scatter
    mixed: bool = False  # delta carries dense axes (mixed apply)

    def label(self):
        tags = [self.storage]
        if self.backend is not None:
            tags.append(self.backend)
        if self.fused:
            tags.append("fused")
        if self.mixed:
            tags.append("mixed")
        return f"Scatter[{self.view} {' '.join(tags)}]"


@dataclasses.dataclass(frozen=True)
class BaseBump(PlanOp):
    rel: str
    backend: str | None = None

    def label(self):
        b = f" {self.backend}" if self.backend is not None else ""
        return f"BaseBump[{self.rel}{b}]"


@dataclasses.dataclass(frozen=True)
class IndicatorBump(PlanOp):
    """Transition-count maintenance of ∃_proj rel; starts an indicator
    propagation section (the δ∃ becomes the current delta)."""

    node: str
    rel: str
    proj: tuple

    def label(self):
        return f"IndicatorBump[{IND_PREFIX}{self.node} ← {self.rel}]"


@dataclasses.dataclass(frozen=True)
class Reevaluate(PlanOp):
    """Evaluate the view tree bottom-up from stored base relations."""

    scope: str  # "root" (reeval) | "store" (1-IVM sibling recompute)

    def label(self):
        return f"Reevaluate[{self.scope}]"


@dataclasses.dataclass(frozen=True)
class FusedChain(PlanOp):
    """A Gather→Lift→(Marginalize)→Emit→ScatterAccum subsequence fused into
    one launch of the ``fused_chain`` kernel (``repro_torch.kernels.
    ring_fused``): every gathered payload row and lifted ring component
    meets the running product in shared memory, the ring product is one
    flat formula, and the terminal ⊎ dedups keys per tile before its
    atomics.  Legality is decided at plan time (:func:`fuse_trigger_ops`);
    ``reads``/``writes`` keep the chain transparent to the structural
    passes, ``smem_bytes`` is the kernel block's shared memory
    (``ring_fused.chain_smem_bytes``), and ``carries`` says whether a later
    op of the plan reads the chain's end delta (the kernel then writes the
    per-row product; otherwise the product never leaves the kernel)."""

    ops: tuple  # the fused op subsequence, in original plan order
    reads: tuple  # view names gathered inside the chain (lifts excluded)
    writes: tuple  # view names ⊎-written by the chain's terminal scatter
    smem_bytes: int
    spec: tuple  # fused ring spec, e.g. ("degree", 2) | ("scalar",)
    carries: bool = False

    def label(self):
        return (f"Fused[{len(self.ops)} ops → {','.join(self.writes)}"
                f" ring={'.'.join(str(s) for s in self.spec)}"
                f" smem={self.smem_bytes}B]")


def iter_flat_ops(ops):
    """Iterate an op sequence with FusedChain subsequences expanded — the
    view every structural pass that predates fusion sees."""
    for op in ops:
        if isinstance(op, FusedChain):
            yield from op.ops
        else:
            yield op


# ---------------------------------------------------------------------------
# TriggerPlan
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TriggerPlan:
    """A compiled maintenance trigger: the fixed op sequence for one
    (relation, update signature)."""

    rel: str
    kind: str  # "coo" | "factorized" | "first_order" | "reeval"
    strategy: str
    schema: tuple
    batch: int | None  # None for a factorized plan
    densify: bool
    ops: tuple  # main delta-path section
    ind_ops: tuple  # indicator sections (each led by an IndicatorBump)
    write_views: frozenset
    write_base: frozenset
    write_indicators: frozenset
    cost: int  # modeled element count of the chosen delta walk

    def write_sets(self):
        return self.write_views, self.write_base, self.write_indicators

    def read_views(self) -> frozenset:
        """View names this plan reads by key through sibling joins (inside
        fused chains too; indicator planes keep their ``∃`` prefix)."""
        return frozenset(op.view for op in iter_flat_ops(self.ops + self.ind_ops)
                         if isinstance(op, (Gather, JoinContract)))

    def pretty(self) -> str:
        """Stable text form (a fused chain's inner ops indented under it)."""
        b = "-" if self.batch is None else str(self.batch)
        head = (f"trigger {self.rel} kind={self.kind} strategy={self.strategy}"
                f" schema=[{','.join(self.schema)}] batch={b}"
                f" densify={'yes' if self.densify else 'no'}"
                f" cost={self.cost}")
        lines = [head]
        for op in self.ops:
            lines.append(f"  {op.label()}")
            if isinstance(op, FusedChain):
                lines.extend(f"    {inner.label()}" for inner in op.ops)
        for op in self.ind_ops:
            pad = "  " if isinstance(op, IndicatorBump) else "    "
            lines.append(f"{pad}{op.label()}")
        # the reference always prints indicators=[...]; the port prints it
        # only for a plan that bumps an indicator
        inds = (" indicators=[%s]" % ",".join(sorted(self.write_indicators))
                if self.write_indicators else "")
        lines.append("  writes: views=[%s] base=[%s]%s" % (
            ",".join(sorted(self.write_views)),
            ",".join(sorted(self.write_base)), inds))
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Plan-level fusion mode
# ---------------------------------------------------------------------------
FUSION_ENV_VAR = "REPRO_TORCH_PLAN_FUSION"

FUSION_MODES = ("on", "off", "auto")

_fusion_override: str | None = None


def _check_fusion_mode(mode: str | None) -> None:
    if mode is not None and mode not in FUSION_MODES:
        raise ValueError(f"unknown fusion mode {mode!r}; one of {FUSION_MODES}")


def set_fusion(mode: str | None) -> None:
    """Process-wide fusion-mode override (None restores env/auto)."""
    global _fusion_override
    _check_fusion_mode(mode)
    _fusion_override = mode


@contextlib.contextmanager
def use_fusion(mode: str | None):
    """Scoped fusion override (tests and fused-vs-unfused runs)."""
    global _fusion_override
    prev = _fusion_override
    set_fusion(mode)
    try:
        yield
    finally:
        _fusion_override = prev


def active_fusion_override() -> str | None:
    """The forced fusion mode (``use_fusion`` scope / ``set_fusion`` /
    ``REPRO_TORCH_PLAN_FUSION``), or None."""
    return _fusion_override or os.environ.get(FUSION_ENV_VAR) or None


def fusion_mode(device) -> str:
    """Resolved fusion mode for an engine on ``device``: override / env >
    ``auto``.  ``auto`` fuses on the card, where a chain is one kernel
    launch instead of one per op, and keeps the CPU on the op-by-op path
    (whose plan texts equal the reference's)."""
    mode = active_fusion_override() or "auto"
    _check_fusion_mode(mode)
    if mode != "auto":
        return mode
    return "on" if torch.device(device).type == "cuda" else "off"


# ---------------------------------------------------------------------------
# Unified cost model
# ---------------------------------------------------------------------------
def path_costs(path: Sequence[ViewNode], upd_schema: Sequence[str],
               batch: int, query: Query):
    """(cost_row, cost_dense, grew_dense): modeled element counts of the two
    delta representations along the path.

    * **Row (COO) propagation** streams ``[B, D_dense...]`` slices: each
      node costs ``B_eff · ∏ dense-axis domains`` where dense axes are the
      sibling/indicator variables the update doesn't bind, and ``B_eff`` drops to 1
      once the COO schema empties (batch collapse).
    * **Dense-delta propagation** materializes one relation over the
      delta's variable set: the leaf pays the full update-schema domain
      product, each node the domain product of the current delta schema.
    """
    B = batch
    bound = set(upd_schema)

    def extent(vars_):
        return _domain_extent(query, vars_)

    coo = set(upd_schema)
    row_dense: set[str] = set()
    dense_vars = set(upd_schema)
    cost_row = B
    cost_dense = extent(upd_schema)
    grew_dense = False
    child = path[0]
    for node in path[1:]:
        sib_schemas = [set(sib.schema) for sib in node.children
                       if sib is not child]
        if node.indicator is not None:
            sib_schemas.append(set(node.indicator[1]))
        for sch in sib_schemas:
            row_dense |= sch - bound
            dense_vars |= sch
        grew_dense = grew_dense or bool(row_dense)
        b_eff = B if coo else 1
        cost_row += b_eff * extent(row_dense)
        cost_dense += extent(dense_vars)
        for v in node.marg_vars:
            coo.discard(v)
            row_dense.discard(v)
            dense_vars.discard(v)
        child = node
    return cost_row, cost_dense, grew_dense


def should_densify(path: Sequence[ViewNode], upd_schema: Sequence[str],
                   batch: int, query: Query) -> bool:
    """Densify when the dense walk is strictly cheaper.  Updates that bind
    every sibling variable never grow dense axes, so the row walk wins
    regardless of batch size."""
    cost_row, cost_dense, grew_dense = path_costs(path, upd_schema, batch,
                                                  query)
    if not grew_dense:
        return False
    return cost_dense < cost_row


def storage_hostility(tree: ViewNode, updatable) -> set[str]:
    """Names of views whose delta interactions are not purely
    gather/scatter shaped — the storage planner's sparse-hostile set.

    Derived from the same symbolic path walk the trigger compiler uses: a
    sibling joined while some of its variables are not COO-bound forces a
    densify (or grows dense delta axes), and a view whose ⊎ arrives with
    dense axes takes the mixed (grid-enumerating) apply.  Sparse storage
    stays correct for these views, but the ``auto`` planner keeps them
    dense."""
    hostile: set[str] = set()
    for rel in updatable:
        path = views_on_path(tree, rel)
        child = path[0]
        coo = set(child.schema)
        dense: set[str] = set()
        for node in path[1:]:
            for sib in node.children:
                if sib is child:
                    continue
                sch = set(sib.schema)
                if not sch <= coo:
                    hostile.add(sib.name)
                    dense |= sch - coo
            if node.indicator is not None:
                dense |= set(node.indicator[1]) - coo
            if dense:
                hostile.add(f"W:{node.name}")
            for v in node.marg_vars:
                coo.discard(v)
                dense.discard(v)
            if dense:
                hostile.add(node.name)
            child = node
    return hostile


# ---------------------------------------------------------------------------
# Compile-time helpers
# ---------------------------------------------------------------------------
def _storage_kind(view) -> str:
    return "sparse" if isinstance(view, SparseRelation) else "dense"


def _domain_extent(query: Query, vars_) -> int:
    e = 1
    for v in vars_:
        e *= int(query.domains[v])
    return e


def _resolve_scatter_backend(num_segments: int, batch: int, width: int,
                             device) -> str:
    from ..kernels import scatter_ops

    return scatter_ops.resolve_backend(num_segments, batch, width, None,
                                       device=device)


@dataclasses.dataclass
class _SymDelta:
    """Compile-time mirror of ``BatchedDelta``'s state machine: the exact
    fields its join/marginalize/apply decisions read."""

    coo: tuple
    dense: tuple
    b: int
    pending: bool
    ring: Any

    def defer_ok(self, view_vars) -> bool:
        if self.pending or self.dense:
            return False
        if self.ring.mul_terms is None or not self.ring.commutative:
            return False
        return bool(view_vars) and all(v in self.coo for v in view_vars)


def _scatter_op(query: Query, name: str, view, st: _SymDelta,
                device) -> ScatterAccum:
    """Annotate a ⊎ site: storage class and the kernel backend the
    dispatch layer will resolve for its primary scatter (a sparse view's
    segments are its table slots)."""
    kind = _storage_kind(view)
    d = payload_width(st.ring)
    if kind == "sparse":
        backend = _resolve_scatter_backend(view.capacity, st.b, d, device)
        return ScatterAccum(name, kind, backend=backend, fused=st.pending,
                            mixed=bool(st.dense))
    if st.coo and not st.dense:
        S = 1
        for v in view.schema:
            S *= int(view.domain_of(v))
        backend = _resolve_scatter_backend(S, st.b, d, device)
        return ScatterAccum(name, kind, backend=backend, fused=st.pending)
    if st.coo:  # mixed COO×dense apply
        S = _domain_extent(query, st.coo)
        dd = d * _domain_extent(query, st.dense)
        backend = _resolve_scatter_backend(S, st.b, dd, device)
        return ScatterAccum(name, kind, backend=backend, mixed=True)
    # dense-axes-only delta: plain elementwise add, no scatter involved
    return ScatterAccum(name, kind, backend=None, mixed=bool(st.dense))


# ---------------------------------------------------------------------------
# The compiler
# ---------------------------------------------------------------------------
def _emit_join(ops: list, st: _SymDelta, name: str, view, view_vars,
               intern) -> None:
    """Emit the op for ``delta.join_dense(view)`` and advance the symbolic
    state, mirroring contraction.BatchedDelta.join_dense exactly."""
    kind = _storage_kind(view)
    if st.defer_ok(view_vars):
        ops.append(intern(Gather(name, tuple(view_vars), kind)))
        st.pending = True
        return
    forces = st.pending
    st.pending = False  # join_dense forces before any eager path
    if st.defer_ok(view_vars):  # re-dispatch after force (second sibling)
        ops.append(intern(Gather(name, tuple(view_vars), kind,
                                 forces=forces)))
        st.pending = True
        return
    fully_bound = bool(view_vars) and all(v in st.coo for v in view_vars)
    if kind == "sparse" and fully_bound:
        ops.append(intern(JoinContract(name, tuple(view_vars), kind,
                                       gathers=True, forces=forces)))
        return
    shared_coo = [v for v in view_vars if v in st.coo]
    v_rest = [v for v in view_vars if v not in shared_coo]
    grows = tuple(v for v in v_rest if v not in st.dense)
    st.dense = tuple(st.dense) + grows
    ops.append(intern(JoinContract(name, tuple(view_vars), kind, grows=grows,
                                   densifies=kind == "sparse",
                                   forces=forces)))


def _emit_marginalize(ops: list, st: _SymDelta, query: Query, var: str,
                      intern) -> None:
    """Emit Lift?/Marginalize for ``delta.marginalize(var, lift_or_none)``,
    mirroring the identity-lift skip and the batch-collapse rule."""
    if query.lift_spec(var) != ("one",):
        ops.append(intern(Lift(var, tuple(query.lift_spec(var)))))
    if var in st.coo:
        forces = st.pending and st.b > 1 and len(st.coo) == 1
        if forces:
            st.pending = False
        st.coo = tuple(v for v in st.coo if v != var)
        collapses = (not st.coo) and st.b > 1
        if collapses:
            st.b = 1
        ops.append(intern(Marginalize(var, "coo", collapses=collapses,
                                      forces=forces)))
    else:
        st.dense = tuple(v for v in st.dense if v != var)
        ops.append(intern(Marginalize(var, "dense")))


def _compile_path_ops(tree: ViewNode, query: Query, rel: str,
                      upd_schema, batch: int, views: Mapping,
                      ind_meta: Mapping[str, tuple], densify: bool,
                      intern, device, apply_views: bool = True):
    """Compile the leaf-to-root delta path into ops.  ``views`` maps the
    materialized view names to their storage objects; ``ind_meta`` maps
    indicator node names to ``(proj, dense plane)``.  ``apply_views=False``
    skips ScatterAccum ops (1-IVM applies only at the root)."""
    ring = query.ring
    path = views_on_path(tree, rel)
    ops: list = []
    if densify:
        st = _SymDelta(coo=(), dense=tuple(upd_schema), b=1, pending=False,
                       ring=ring)
    else:
        st = _SymDelta(coo=tuple(upd_schema), dense=(), b=batch,
                       pending=False, ring=ring)
    ops.append(intern(LeafDelta(rel, tuple(upd_schema), batch, densify)))
    write_views: set[str] = set()

    def scatter(name):
        if apply_views and name in views:
            ops.append(intern(_scatter_op(query, name, views[name], st,
                                          device)))
            write_views.add(name)

    leaf = path[0]
    ops.append(intern(Emit(leaf.name)))
    scatter(leaf.name)
    child = leaf
    for node in path[1:]:
        for sib in node.children:
            if sib is child:
                continue
            if sib.name not in views:
                raise ValueError(f"sibling {sib.name} of the delta path must "
                                 f"be materialized (μ guarantees this for "
                                 f"updatable {rel})")
            _emit_join(ops, st, sib.name, views[sib.name], sib.schema,
                       intern)
        if node.indicator is not None:
            if node.name not in ind_meta:
                raise ValueError(f"maintained indicator for {node.name} "
                                 f"required")
            proj, ind_view = ind_meta[node.name]
            _emit_join(ops, st, IND_PREFIX + node.name, ind_view, proj,
                       intern)
        scatter(f"W:{node.name}")
        for v in node.marg_vars:
            _emit_marginalize(ops, st, query, v, intern)
        ops.append(intern(Emit(node.name)))
        scatter(node.name)
        child = node
    return tuple(ops), write_views


def _require(views: Mapping, name: str) -> None:
    if name not in views:
        raise ValueError(f"{name} must be materialized")


def _compile_indicator_ops(tree: ViewNode, query: Query, rel: str,
                           batch: int, views: Mapping,
                           indicators: Mapping, intern, device):
    """Compile the indicator second pass (Sec. 6): for every maintained
    ∃-projection over ``rel``, count maintenance plus the δ∃ propagation
    path from the indicator node to the root."""
    ring = query.ring
    ops: list = []
    write_views: set[str] = set()
    write_inds: set[str] = set()

    def scatter(name, st):
        if name in views:
            ops.append(intern(_scatter_op(query, name, views[name], st,
                                          device)))
            write_views.add(name)

    for node_name, ind in indicators.items():
        if ind.rel_name != rel:
            continue
        write_inds.add(node_name)
        ops.append(intern(IndicatorBump(node_name, rel, tuple(ind.proj))))
        st = _SymDelta(coo=tuple(ind.proj), dense=(), b=batch,
                       pending=False, ring=ring)
        node = tree.find(node_name)
        for sib in node.children:
            _require(views, sib.name)
            _emit_join(ops, st, sib.name, views[sib.name], sib.schema,
                       intern)
        for v in node.marg_vars:
            _emit_marginalize(ops, st, query, v, intern)
        scatter(node.name, st)
        child = node
        for parent in path_to_root(tree, node_name)[1:]:
            for sib in parent.children:
                if sib is child:
                    continue
                _require(views, sib.name)
                _emit_join(ops, st, sib.name, views[sib.name], sib.schema,
                           intern)
            if parent.indicator is not None and parent.name != node_name:
                other = indicators[parent.name]
                _emit_join(ops, st, IND_PREFIX + parent.name, other.dense,
                           tuple(other.proj), intern)
            for v in parent.marg_vars:
                _emit_marginalize(ops, st, query, v, intern)
            scatter(parent.name, st)
            child = parent
    return tuple(ops), write_views, write_inds


def path_to_root(tree: ViewNode, name: str) -> list[ViewNode]:
    """Node-to-root spine (indicator propagation paths)."""
    path: list[ViewNode] = []

    def rec(node: ViewNode) -> bool:
        if node.name == name:
            path.append(node)
            return True
        for c in node.children:
            if rec(c):
                path.append(node)
                return True
        return False

    if not rec(tree):
        raise KeyError(f"view {name} not in tree")
    return path


def compile_trigger(engine, rel: str, upd_sig, intern=None,
                    views=None) -> TriggerPlan:
    """Compile the maintenance trigger for updates to ``rel``.

    ``upd_sig`` is ``("coo", schema, batch)`` or ``("factorized",
    schema)``.  The result is a pure metadata object: compiling never
    touches device state.
    """
    intern = intern or (lambda op: op)
    kind, schema = upd_sig[0], tuple(upd_sig[1])
    if kind not in ("coo", "factorized"):
        raise ValueError(f"unknown update kind {kind!r}")
    batch = upd_sig[2] if kind == "coo" else None
    query, tree, strategy = engine.query, engine.tree, engine.strategy
    views = engine.views if views is None else views
    root = tree.name

    if strategy == "reeval":
        ops = (intern(BaseBump(rel, active_backend_override())),
               intern(Reevaluate("root")))
        return TriggerPlan(
            rel=rel, kind="reeval", strategy=strategy, schema=schema,
            batch=batch, densify=False, ops=ops, ind_ops=(),
            write_views=frozenset({root}), write_base=frozenset({rel}),
            write_indicators=frozenset(), cost=0)

    path = views_on_path(tree, rel)

    if strategy == "fivm_1":
        # 1-IVM: recompute sibling views from base, run the delta path over
        # the recomputed store (all views present), apply only at the root.
        if kind == "factorized":
            # the full densified delta is the point of the comparison
            batch = _domain_extent(query, schema)
        densify = should_densify(path, schema, batch, query)
        cost_row, cost_dense, _ = path_costs(path, schema, batch, query)
        store_views = {n.name: views.get(n.name, _DenseProxy(n, query))
                       for n in tree.walk()}
        path_ops, _ = _compile_path_ops(
            tree, query, rel, schema, batch, store_views, {}, densify,
            intern, engine.device, apply_views=False)
        ops = (intern(Reevaluate("store")),) + path_ops + (
            _scatter_op(query, root, views[root],
                        _SymDelta(coo=(), dense=(), b=1, pending=False,
                                  ring=query.ring), engine.device),
            intern(BaseBump(rel, active_backend_override())))
        return TriggerPlan(
            rel=rel, kind="first_order", strategy=strategy, schema=schema,
            batch=batch, densify=densify, ops=ops, ind_ops=(),
            write_views=frozenset({root}), write_base=frozenset({rel}),
            write_indicators=frozenset(),
            cost=cost_dense if densify else cost_row)

    # fivm / dbt: higher-order propagation along the delta tree
    indicators = engine.indicators
    ind_meta = {name: (tuple(ind.proj), ind.dense)
                for name, ind in indicators.items()}
    if kind == "factorized":
        densify, cost = False, 0
        ops, write_views = _compile_factorized_ops(tree, query, rel, schema,
                                                   views, ind_meta, intern)
    else:
        densify = should_densify(path, schema, batch, query)
        cost_row, cost_dense, _ = path_costs(path, schema, batch, query)
        cost = cost_dense if densify else cost_row
        ops, write_views = _compile_path_ops(
            tree, query, rel, schema, batch, views, ind_meta, densify,
            intern, engine.device)
    # views update in place: a main section that read a view it had
    # already written would see the new payload where the reference's
    # functional replay reads the old one.  Sibling joins are off the delta
    # path, so this never holds; keep it an invariant.  (The indicator
    # sections read the updated views on purpose, as the reference's do.)
    main_reads = frozenset(op.view for op in iter_flat_ops(ops)
                           if isinstance(op, (Gather, JoinContract)))
    if main_reads & write_views:
        raise AssertionError(f"trigger for {rel} reads views it writes: "
                             f"{sorted(main_reads & write_views)}")
    ind_ops, ind_write_views, write_inds = _compile_indicator_ops(
        tree, query, rel, batch or 1, views, indicators, intern,
        engine.device)
    if ind_ops and kind == "factorized":
        raise ValueError("indicator maintenance needs COO updates")
    return TriggerPlan(
        rel=rel, kind=kind, strategy=strategy, schema=schema, batch=batch,
        densify=densify, ops=ops, ind_ops=ind_ops,
        write_views=frozenset(write_views | ind_write_views),
        write_base=frozenset({rel}) & frozenset(engine.base),
        write_indicators=frozenset(write_inds), cost=cost)


def _compile_factorized_ops(tree: ViewNode, query: Query, rel: str,
                            upd_schema, views: Mapping, ind_meta, intern):
    """Sec. 5 Optimize: the same path, interpreted over a factor list.
    Joins absorb into touching factors, marginalization always contracts
    against the lift relation (no identity skip), application is the
    outer-product accumulate."""
    path = views_on_path(tree, rel)
    ops: list = []
    write_views: set[str] = set()

    def scatter(name):
        ops.append(intern(ScatterAccum(name, _storage_kind(views[name]),
                                       backend=None)))
        write_views.add(name)

    leaf = path[0]
    ops.append(intern(LeafDelta(rel, tuple(upd_schema), 0, False)))
    ops.append(intern(Emit(leaf.name)))
    if leaf.name in views:
        scatter(leaf.name)
    child = leaf
    for node in path[1:]:
        for sib in node.children:
            if sib is child:
                continue
            if sib.name not in views:
                raise ValueError(f"sibling {sib.name} of the delta path must "
                                 f"be materialized (μ guarantees this for "
                                 f"updatable {rel})")
            kind = _storage_kind(views[sib.name])
            ops.append(intern(JoinContract(sib.name, tuple(sib.schema), kind,
                                           densifies=kind == "sparse")))
        if node.indicator is not None:
            proj, _ind = ind_meta[node.name]
            ops.append(intern(JoinContract(IND_PREFIX + node.name, proj,
                                           "dense")))
        if f"W:{node.name}" in views:
            scatter(f"W:{node.name}")
        for v in node.marg_vars:
            ops.append(intern(Lift(v, tuple(query.lift_spec(v)))))
            ops.append(intern(Marginalize(v, "factor")))
        ops.append(intern(Emit(node.name)))
        if node.name in views:
            scatter(node.name)
        child = node
    return tuple(ops), write_views


def active_backend_override() -> str | None:
    """The forced scatter backend (``use_backend`` / env), if any: part of
    the plan-cache key, so an override change never replays a stale plan."""
    from ..kernels import scatter_ops

    return scatter_ops.active_override()


class _DenseProxy:
    """Compile-time stand-in for a 1-IVM recomputed store view (always
    dense: ``evaluate_view`` materializes densely)."""

    def __init__(self, node: ViewNode, query: Query):
        self.schema = tuple(node.schema)
        self._query = query

    def domain_of(self, var: str) -> int:
        return int(self._query.domains[var])


# ---------------------------------------------------------------------------
# The plan-level fusion pass
# ---------------------------------------------------------------------------
def _try_fuse_chain(ops, start: int, coo: tuple, views: Mapping,
                    written, spec, width: int):
    """Try to grow a fused chain from ``ops[start]`` to the first terminal
    ScatterAccum.  Returns ``(FusedChain, coo_after)`` or None when an op on
    the way is outside the fused vocabulary or the chain is outside the
    kernel's H100 model (more than ``MAX_SOURCES`` sources, or a block's
    shared memory above ``SMEM_PER_BLOCK``).  Source planes stay in device
    memory, so their rows are not bounded."""
    from ..kernels import ring_fused

    cur = list(coo)
    reads: list[str] = []
    n_src = 0
    collapsed = False
    for j in range(start, len(ops)):
        op = ops[j]
        if isinstance(op, Gather):
            # views this plan already wrote stay unfused (read-after-write
            # inside one trigger must see the op-by-op ordering)
            if collapsed or op.view.startswith(IND_PREFIX) \
                    or op.view in written or op.view not in views:
                return None
            reads.append(op.view)
            n_src += 1
        elif isinstance(op, Lift):
            if collapsed:
                return None
            n_src += 1
        elif isinstance(op, Marginalize):
            # only COO marginalization stays a key-column drop (+ lift
            # source) inside the chain; dense-axis contraction falls back
            if op.axis != "coo" or op.var not in cur:
                return None
            cur.remove(op.var)
            collapsed = collapsed or op.collapses
        elif isinstance(op, Emit):
            pass
        elif isinstance(op, ScatterAccum):
            # terminal ⊎: a dense scatter fits the kernel; a mixed
            # (dense-axes) apply does not.  A chain with no gather/lift
            # source is just a scatter: no fusion win.
            if op.mixed or op.view.startswith(IND_PREFIX) or n_src == 0 \
                    or n_src > ring_fused.MAX_SOURCES:
                return None
            smem = ring_fused.chain_smem_bytes(width)
            if smem > ring_fused.SMEM_PER_BLOCK:
                return None
            chain = FusedChain(ops=tuple(ops[start:j + 1]), reads=tuple(reads),
                               writes=(op.view,), smem_bytes=smem, spec=spec,
                               carries=j + 1 < len(ops))
            return chain, tuple(cur)
        else:  # LeafDelta / JoinContract / BaseBump / ... : not fusable
            return None
    return None


def fuse_trigger_ops(plan: TriggerPlan, query: Query,
                     views: Mapping) -> TriggerPlan:
    """The plan-level fusion pass: collapse maximal
    Gather→Lift→(Marginalize)→Emit→ScatterAccum subsequences of a COO
    trigger plan into :class:`FusedChain` ops.

    Legality is decided here, at plan time, by the reference's rules:
    commutative-bilinear float32 ring (``ring_fused.fused_ring_spec``),
    pure-COO delta state at the chain boundary (no dense axes, no carried
    pending gather), a terminal non-mixed scatter, and no gather of a view
    the plan already wrote or of an indicator plane; only the size bound is
    the H100 model of :func:`_try_fuse_chain`.  Everything else stays op by
    op.  First-order and reevaluation plans, densified deltas and indicator
    sections (they read views updated in place mid-trigger) never fuse."""
    if plan.kind != "coo" or plan.densify:
        return plan
    from ..kernels import ring_fused

    spec = ring_fused.fused_ring_spec(query.ring)
    if spec is None:
        return plan
    width = payload_width(query.ring)
    ops = list(plan.ops)
    out: list = []
    # symbolic mirror of the runtime delta state at each op boundary:
    # chains start only where the delta is pure-COO with no pending gather
    coo: tuple = ()
    pending = False
    dense = False
    written: set[str] = set()
    i = 0
    while i < len(ops):
        fused = None
        if not pending and not dense and coo:
            fused = _try_fuse_chain(ops, i, coo, views, written, spec, width)
        if fused is not None:
            chain, coo = fused
            out.append(chain)
            written.add(chain.writes[0])
            pending = False
            i += len(chain.ops)
            continue
        op = ops[i]
        if isinstance(op, LeafDelta):
            coo = () if op.densify else tuple(op.schema)
            dense = bool(op.densify)
            pending = False
        elif isinstance(op, Gather):
            pending = True
        elif isinstance(op, JoinContract):
            pending = False
            dense = dense or bool(op.grows) or op.densifies
        elif isinstance(op, Marginalize):
            if op.forces:
                pending = False
            if op.axis == "coo":
                coo = tuple(v for v in coo if v != op.var)
        elif isinstance(op, ScatterAccum):
            written.add(op.view)
        out.append(op)
        i += 1
    if not any(isinstance(op, FusedChain) for op in out):
        return plan
    return dataclasses.replace(plan, ops=tuple(out))


# ---------------------------------------------------------------------------
# The plan cache
# ---------------------------------------------------------------------------
def storage_signature(views: Mapping) -> tuple:
    """Hashable storage-layout fingerprint of ``views``: a plan is valid
    only for the (backend kind, capacity) layout it was compiled against,
    so a rehash between stream segments recompiles."""
    return tuple((name, "s", views[name].capacity)
                 if isinstance(views[name], SparseRelation) else (name, "d", 0)
                 for name in sorted(views))


class PlanCache:
    """Per-engine trigger-plan cache with op interning.

    Keys: (rel, update signature, storage layout, scatter-backend override,
    fusion mode).
    ``hits`` / ``miss_new`` / ``miss_invalidated`` / ``compile_seconds`` /
    ``verify_seconds`` are the cache telemetry: ``miss_new`` counts first
    compiles of a (rel, signature) trigger, ``miss_invalidated`` recompiles
    forced by a layout, override or fusion-mode change, ``verify_seconds``
    the static verification of the compiled plans (compile misses only)."""

    def __init__(self):
        self.plans: dict = {}
        self.hits = 0
        self.miss_new = 0
        self.miss_invalidated = 0
        self.compile_seconds = 0.0
        self.verify_seconds = 0.0
        self._interned: dict = {}
        self._write_sets: dict = {}
        self._seen: set = set()

    @property
    def misses(self) -> int:
        return self.miss_new + self.miss_invalidated

    def intern(self, op: PlanOp) -> PlanOp:
        return self._interned.setdefault(op, op)

    def lookup_sig(self, engine, rel: str, upd_sig,
                   views=None) -> TriggerPlan:
        views = engine.views if views is None else views
        fusion = fusion_mode(engine.device)
        key = (rel, upd_sig, storage_signature(views),
               active_backend_override(), fusion)
        plan = self.plans.get(key)
        if plan is not None:
            self.hits += 1
            return plan
        trigger = (rel, upd_sig)
        if trigger in self._seen:
            self.miss_invalidated += 1
        else:
            self.miss_new += 1
            self._seen.add(trigger)
        t0 = time.perf_counter()
        plan = compile_trigger(engine, rel, upd_sig, intern=self.intern,
                               views=views)
        if fusion == "on":
            plan = fuse_trigger_ops(plan, engine.query, views)
        self.compile_seconds += time.perf_counter() - t0
        # static verification rides the compile miss only: a verified plan
        # is cached as verified, so a hit (and every graph replay) pays
        # nothing; a plan that fails raises here and is never cached
        from ..analysis import verifier

        if verifier.verify_mode() == "on":
            t1 = time.perf_counter()
            verifier.check_plan(engine, plan, views=views)
            self.verify_seconds += time.perf_counter() - t1
        self.plans[key] = plan
        return plan

    def lookup(self, engine, rel: str, upd) -> TriggerPlan:
        if isinstance(upd, FactorizedUpdate):
            sig = ("factorized", tuple(upd.schema))
        else:
            sig = ("coo", tuple(upd.schema), upd.batch)
        return self.lookup_sig(engine, rel, sig)

    def write_sets(self, engine, rel: str):
        """``(write_views, write_base, write_indicators)`` of any trigger
        for ``rel``, COO or
        factorized (independent of the batch size; a factorized plan walks
        the same path, so the COO plan's sets serve both), memoized under
        the plan cache's environment key (backend override, fusion mode),
        so a fusion flip re-derives them from a fresh plan."""
        key = (rel, active_backend_override(), fusion_mode(engine.device))
        if key not in self._write_sets:
            sig = ("coo", tuple(engine.query.relations[rel]), 1)
            self._write_sets[key] = self.lookup_sig(engine, rel, sig).write_sets()
        return self._write_sets[key]

    def stats(self) -> dict:
        total = self.hits + self.misses
        n = len(self.plans)
        return dict(
            plans=n,
            hits=self.hits,
            misses=self.misses,
            miss_new=self.miss_new,
            miss_invalidated=self.miss_invalidated,
            hit_rate=round(self.hits / total, 4) if total else 0.0,
            compile_ms_total=round(1e3 * self.compile_seconds, 3),
            compile_ms_per_plan=round(1e3 * self.compile_seconds / n, 3)
            if n else 0.0,
            #: static verification; cache hits never re-verify
            verify_ms_total=round(1e3 * self.verify_seconds, 3),
            interned_ops=len(self._interned),
        )


# ---------------------------------------------------------------------------
# Interpreters
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PropagationResult:
    """Deltas per affected view name (leaf-to-root order) + updated views.

    A delta emitted inside a fused chain is a zero-argument callable that
    materializes it on demand (no ``fivm``/``dbt`` trigger reads them);
    :meth:`delta` resolves either form."""

    deltas: dict
    updated: dict

    def delta(self, name: str) -> BatchedDelta:
        d = self.deltas[name]
        return d() if callable(d) else d


def _resolve_view(name: str, views: Mapping, ind_dense: Mapping):
    if name.startswith(IND_PREFIX):
        return ind_dense[name[len(IND_PREFIX):]]
    return views[name]


def run_coo_ops(ops, views: Mapping, query: Query, upd: COOUpdate,
                ind_dense: Mapping | None = None,
                memo: Mapping | None = None) -> PropagationResult:
    """Replay a compiled COO path section: exactly the delta-algebra calls
    of the interpretive walk; backend hints thread into the scatters, and
    memoized sibling planes (``memo``, :func:`build_prep_memo`)
    short-circuit the prepare step.  ``ind_dense`` maps indicator node
    names to their 0/1 planes (the ``∃<node>`` views of the plan)."""
    ind_dense = ind_dense or {}
    ring = query.ring
    deltas: dict = {}
    updated: dict = {}
    delta = None
    pending_lift = None
    for op in ops:
        if isinstance(op, LeafDelta):
            delta = (densified_delta(query, op.rel, upd) if op.densify
                     else BatchedDelta.from_coo(ring, upd))
        elif isinstance(op, Gather):
            plane = memo.get(("plane", op.view)) if memo else None
            delta = delta.join_dense(_resolve_view(op.view, views, ind_dense),
                                     src_plane=plane)
        elif isinstance(op, JoinContract):
            view = _resolve_view(op.view, views, ind_dense)
            if op.densifies and memo:
                view = memo.get(("dense", op.view), view)
            delta = delta.join_dense(view)
        elif isinstance(op, Lift):
            pending_lift = query.lift_rel(op.var, upd.keys.device)
        elif isinstance(op, Marginalize):
            delta = delta.marginalize(op.var, pending_lift)
            pending_lift = None
        elif isinstance(op, Emit):
            deltas[op.view] = delta
        elif isinstance(op, ScatterAccum):
            updated[op.view] = delta.apply_to(views[op.view],
                                              backend=op.backend)
        elif isinstance(op, FusedChain):
            delta = _run_fused_chain(op, delta, views, query, memo, deltas,
                                     updated)
        else:  # pragma: no cover
            raise TypeError(op)
    return PropagationResult(deltas, updated)


def _chain_delta(ring, product, keys, coo, collapsed) -> BatchedDelta:
    """A chain's delta from its per-row product ``[B, d]``: batch collapse
    sums the rows (in torch) into one."""
    if collapsed:
        product = product.sum(dim=0, keepdim=True)
        keys = keys[:1]
    return BatchedDelta(
        coo_schema=tuple(coo), dense_schema=(), keys=keys, ring=ring,
        payload=unflatten_payload(ring, product, (keys.shape[0],)),
        dense_domains=())


def _run_fused_chain(chain: FusedChain, delta: BatchedDelta, views: Mapping,
                     query: Query, memo, deltas: dict, updated: dict):
    """Interpret a :class:`FusedChain`.

    Gather and lift sources accumulate as flat ``(plane [Sg, d], ids [B])``
    pairs (a sparse view's plane with its zero row C, which a missed probe
    reads); the terminal ScatterAccum runs the whole product and ⊎ as one
    ``ring_fused.fused_apply`` (one ``fused_chain`` launch on the card, the
    plain version on the CPU), in place into the view's owned plane (a
    sparse view's slots claimed first by ``fused_slot_targets``).  When
    ``chain.carries``, the kernel also writes the per-row product and the
    chain's end delta is returned for the ops after it; otherwise it
    returns None.  Emits inside the chain are recorded lazily.  Plan-time
    legality (:func:`fuse_trigger_ops`) guarantees the entry state:
    pure-COO delta, no pending gather, fused-ring payload."""
    from ..kernels import ring_fused

    ring = query.ring
    spec = chain.spec
    if delta.pending_gather is not None or delta.dense_schema:
        raise AssertionError("fused chain entered with non-pure-COO delta")
    coo = list(delta.coo_schema)
    keys = delta.keys
    B = delta.batch
    dev = keys.device
    vals = flatten_payload(ring, delta.payload, (B,))
    sources: list = []
    lift_rel = None
    collapsed = False
    carried = None

    def view_keys(schema):
        return torch.stack([keys[:, coo.index(v)] for v in schema], dim=1)

    def lazy(srcs, k, cols, coll):
        return _chain_delta(ring, ring_fused.chain_product(vals, srcs, spec),
                            k, cols, coll)

    for op in chain.ops:
        if isinstance(op, Gather):
            view = views[op.view]
            plane = memo.get(("plane", op.view)) if memo else None
            if is_sharded(view):
                # this rank's rows of the batch, completed by one
                # collective: the source is the gathered batch itself
                if isinstance(view, SparseRelation):
                    plane = view.read_rows(keys, [coo.index(v)
                                                  for v in view.schema])
                else:
                    plane = view.read_rows(view_keys(view.schema))
                ids = torch.arange(plane.shape[0], dtype=torch.int32,
                                   device=dev)
            elif isinstance(view, SparseRelation):
                # one keyed probe launch: the delta's key columns in, the
                # plane row (a missed key reads the zero row C) out
                ids = view.gather_rows(keys, [coo.index(v) for v in view.schema])
                if plane is None:
                    plane = view.gather_plane()
            else:
                if plane is None:
                    plane = flatten_payload(ring, view.payload, view.domains)
                ids = linear_ids(view_keys(view.schema), view.domains)
            sources.append((plane, ids))
        elif isinstance(op, Lift):
            lift_rel = query.lift_rel(op.var, dev)
        elif isinstance(op, Marginalize):
            i = coo.index(op.var)
            if lift_rel is not None:
                dom = lift_rel.domains[0]
                sources.append((flatten_payload(ring, lift_rel.payload, (dom,)),
                                keys[:, i].contiguous()))
                lift_rel = None
            keys = torch.cat([keys[:, :i], keys[:, i + 1:]], dim=1)
            coo.pop(i)
            collapsed = collapsed or op.collapses
        elif isinstance(op, Emit):
            deltas[op.view] = functools.partial(lazy, tuple(sources), keys,
                                                tuple(coo), collapsed)
        elif isinstance(op, ScatterAccum):
            view = views[op.view]
            product = (torch.empty_like(vals) if chain.carries else None)
            if isinstance(view, SparseRelation):
                table, ids = view.fused_slot_targets(
                    keys, [coo.index(v) for v in view.schema])
                out = ring_fused.fused_apply(view.rows, ids, vals, sources,
                                             spec, backend=op.backend,
                                             product_out=product)
                updated[op.view] = view.replace_plane(table, out)
            elif isinstance(view, ShardedDense):
                # rows another rank owns get id -1 and drop in the kernel
                ids = view.shard.route(view.linear_rows(view_keys(view.schema)))
                out = ring_fused.fused_apply(view.rows, ids, vals, sources,
                                             spec, backend=op.backend,
                                             product_out=product)
                if out.data_ptr() != view.rows.data_ptr():
                    view.rows.copy_(out)
                updated[op.view] = view
            else:
                if view.schema:
                    ids = linear_ids(view_keys(view.schema), view.domains)
                else:  # collapsed-to-scalar view: every row hits slot 0
                    ids = torch.zeros((B,), dtype=torch.int32, device=dev)
                plane = flatten_payload(ring, view.payload, view.domains)
                out = ring_fused.fused_apply(plane, ids, vals, sources, spec,
                                             backend=op.backend,
                                             product_out=product)
                updated[op.view] = DenseRelation(
                    view.schema, ring,
                    unflatten_payload(ring, out, view.domains))
            if product is not None:
                carried = _chain_delta(ring, product, keys, coo, collapsed)
        else:  # pragma: no cover
            raise TypeError(op)
    return carried


def factorized_route(op, factors, view, query: Query, following=()) -> str:
    """Where one op of a factorized plan runs: ``"matvec"``, ``"outer"`` or
    ``"plain"``.  A pure function of the op, the ops after it, the factor
    list and the view, so the CPU tests check it; the two kernel routes are
    the O(p²) shapes a rank-1 matrix-chain trigger reduces to (Example
    7.1), over a dense 2-D view of a float32 scalar ring:

    * ``"matvec"``: a JoinContract that exactly one factor touches, a
      1-D f[x], followed by Lift(x, one) and Marginalize(x).  Σ_x f[x] V[x,
      y] is one ``rank1_chain.matvec`` (the [x, y] product is never
      built).
    * ``"outer"``: a ScatterAccum of exactly two 1-D factors covering the
      view: V + u vᵀ is one ``rank1_chain.outer_accumulate``.

    Everything else (a non-identity lift, a scalar factor, more factors, a
    multi-component ring, another dtype, a sparse view) is ``"plain"``:
    the reference's einsums."""
    ring = query.ring
    if not (isinstance(ring, ScalarRing) and ring.dtype == torch.float32
            and type(view) is DenseRelation and len(view.schema) == 2):
        return "plain"  # (a sharded slice takes the plain route: whole reads)

    def vector(f):
        return len(f.schema) == 1 and f.payload["v"].dtype == torch.float32

    if isinstance(op, ScatterAccum):
        if (len(factors) == 2 and all(vector(f) for f in factors)
                and {f.schema[0] for f in factors} == set(view.schema)):
            return "outer"
        return "plain"
    if isinstance(op, JoinContract):
        touching = [f for f in factors if set(f.schema) & set(view.schema)]
        if len(touching) != 1 or not vector(touching[0]):
            return "plain"
        x = touching[0].schema[0]
        if (len(following) >= 2 and isinstance(following[0], Lift)
                and following[0].var == x and following[0].spec == ("one",)
                and isinstance(following[1], Marginalize)
                and following[1].var == x):
            return "matvec"
    return "plain"


def _matvec_join(factors: list, view: DenseRelation) -> None:
    """The ``"matvec"`` route: replace the one factor f[x] touching
    ``view`` by g[y] = Σ_x f[x] V[x, y], appended as absorb-then-marginalize
    appends it.  V is read in place: as A when x is its second axis, as
    the transpose of a row-major matrix (the kernel's cols layout) when
    x is its first."""
    from ..kernels import rank1_chain

    f = next(f for f in factors if set(f.schema) & set(view.schema))
    x = f.schema[0]
    y = next(v for v in view.schema if v != x)
    V = view.payload["v"]
    if not (V.is_contiguous() or V.T.is_contiguous()):
        V = V.contiguous()
    A = V if view.schema[1] == x else V.T
    g = rank1_chain.matvec(A, f.payload["v"].contiguous())
    factors.remove(f)
    factors.append(DenseRelation((y,), view.ring, {"v": g}))


def _outer_scatter(view: DenseRelation, factors: list) -> DenseRelation:
    """The ``"outer"`` route: V + u vᵀ with u over the view's first
    variable and v over its second, into a new tensor."""
    from ..kernels import rank1_chain

    by_var = {f.schema[0]: f.payload["v"].contiguous() for f in factors}
    u, v = (by_var[var] for var in view.schema)
    out = rank1_chain.outer_accumulate(view.payload["v"].contiguous(), u, v)
    return DenseRelation(view.schema, view.ring, {"v": out})


def run_factorized_ops(ops, views: Mapping, query: Query,
                       upd: FactorizedUpdate,
                       ind_dense: Mapping | None = None) -> PropagationResult:
    """Replay a compiled factorized (Sec. 5 Optimize) path section over a
    factor list: joins absorb, marginalization touches only the factor
    containing the variable, application is the outer-product ⊎.  Each
    join (with the marginalization after it) and each ⊎ runs where
    :func:`factorized_route` sends it; the kernel wrappers run their plain
    versions on CPU tensors."""
    ring = query.ring
    factors: list[DenseRelation] = list(upd.factors)
    deltas: dict = {}
    updated: dict = {}
    i = 0
    while i < len(ops):
        op = ops[i]
        if isinstance(op, LeafDelta):
            pass  # the factor list IS the leaf delta
        elif isinstance(op, JoinContract):
            view = _resolve_view(op.view, views, ind_dense or {})
            if factorized_route(op, factors, view, query,
                                ops[i + 1:i + 3]) == "matvec":
                _matvec_join(factors, view)
                i += 3  # the Lift and Marginalize ran inside the matvec
                continue
            absorb_factor(factors, view, ring)
        elif isinstance(op, Lift):
            pass  # factorized marginalization always contracts the lift
        elif isinstance(op, Marginalize):
            marginalize_factor(factors, op.var, query)
        elif isinstance(op, Emit):
            deltas[op.view] = FactorizedUpdate(
                tuple(v for f in factors for v in f.schema), tuple(factors))
        elif isinstance(op, ScatterAccum):
            view = views[op.view]
            if factorized_route(op, factors, view, query) == "outer":
                updated[op.view] = _outer_scatter(view, factors)
            else:
                updated[op.view] = apply_factorized(view, factors, ring)
        else:  # pragma: no cover
            raise TypeError(op)
        i += 1
    return PropagationResult(deltas, updated)


def run_indicator_ops(ops, views: dict, indicators: dict, query: Query,
                      upd: COOUpdate, old_payload) -> None:
    """Replay indicator sections in place: each IndicatorBump computes the
    transition-count delta δ∃ (from ``old_payload``, the updated
    relation's payload at the batch keys before the update) and the ops
    after it propagate δ∃ to the root, reading (and writing) the views the
    main section already updated."""
    ring = query.ring
    delta = None
    pending_lift = None
    for op in ops:
        if isinstance(op, IndicatorBump):
            if not isinstance(upd, COOUpdate):
                raise TypeError("indicator maintenance needs COO updates")
            if old_payload is None:
                raise ValueError("indicator relations must be stored")
            new_state, dind = indicators[op.node].delta_for_update(
                query, upd, old_payload)
            indicators[op.node] = new_state
            delta = BatchedDelta.from_coo(ring, dind)
        elif isinstance(op, (Gather, JoinContract)):
            ind_dense = {n: st.dense for n, st in indicators.items()}
            delta = delta.join_dense(_resolve_view(op.view, views, ind_dense))
        elif isinstance(op, Lift):
            pending_lift = query.lift_rel(op.var, upd.keys.device)
        elif isinstance(op, Marginalize):
            delta = delta.marginalize(op.var, pending_lift)
            pending_lift = None
        elif isinstance(op, ScatterAccum):
            views[op.view] = delta.apply_to(views[op.view],
                                            backend=op.backend)
        else:  # pragma: no cover
            raise TypeError(op)


def reevaluate_store(engine, base) -> dict:
    """The ``Reevaluate`` op: evaluate the view tree bottom-up from ``base``
    relations, returning every node's view (and the premarg ``W:`` views
    when the engine maintains them)."""
    store: dict = {}
    premarg = any(name.startswith("W:") for name in engine.views)
    evaluate_view(engine.tree, base, engine.query, store=store,
                  premarg=premarg)
    return store


def _keep_placement(old, new):
    """``new`` in ``old``'s placement: a view rebuilt wholesale (reeval's
    root) stays one rank's slice where ``old`` was one."""
    if isinstance(old, ShardedDense) and type(new) is DenseRelation:
        return old.assign(new)
    return new


def execute_trigger(engine, plan: TriggerPlan, views, base, indicators, upd,
                    memo: Mapping | None = None):
    """Run a compiled trigger: the one execution entry of eager
    ``apply_update`` and of every stream-executor dispatch mode.  Returns
    new ``(views, base, indicators)``.  View, base and indicator tensors are
    updated in place where their layout allows, so the state passed in
    must not be used again.  ``memo`` carries a stream step's shared
    sibling planes (:func:`build_prep_memo`).

    The order is the reference's: the main section (with the old ∃
    planes), the base ⊎, then the indicator sections.  The base ⊎ writes
    in place where the reference makes a new relation, so the updated
    relation's payload at the batch keys, which the indicator sections
    need from before the update, is gathered first."""
    query = engine.query
    views = dict(views)
    base = dict(base)
    indicators = dict(indicators)

    if plan.kind == "reeval":
        base[plan.rel] = engine._bump_base(base[plan.rel], upd)
        store = reevaluate_store(engine, base)
        root = engine.tree.name
        views[root] = _keep_placement(views[root], store[root])
        return views, base, indicators

    if plan.kind == "first_order":
        if isinstance(upd, FactorizedUpdate):
            upd = densify_update_to_coo(query, upd)
        store = reevaluate_store(engine, base)
        from .indicators import indicator_of

        ind_dense = {name: indicator_of(base[st.rel_name], st.proj, query)
                     for name, st in indicators.items()}
        path_ops = tuple(op for op in plan.ops
                         if not isinstance(op, (Reevaluate, BaseBump,
                                                ScatterAccum)))
        res = run_coo_ops(path_ops, store, query, upd, ind_dense)
        root = engine.tree.name
        views[root] = res.deltas[root].apply_to(views[root])
        base[plan.rel] = engine._bump_base(base[plan.rel], upd)
        return views, base, indicators

    # fivm / dbt
    old_payload = None
    if plan.ind_ops and plan.rel in base:
        old_payload = base[plan.rel].gather(upd.keys)
    ind_dense = {name: st.dense for name, st in indicators.items()}
    if plan.kind == "factorized":
        res = run_factorized_ops(plan.ops, views, query, upd, ind_dense)
    else:
        res = run_coo_ops(plan.ops, views, query, upd, ind_dense, memo=memo)
    views.update(res.updated)
    if plan.write_base:
        base[plan.rel] = engine._bump_base(base[plan.rel], upd)
    if plan.ind_ops:
        run_indicator_ops(plan.ind_ops, views, indicators, query, upd,
                          old_payload)
    return views, base, indicators


# ---------------------------------------------------------------------------
# Delta-construction helpers
# ---------------------------------------------------------------------------
def densified_delta(query: Query, rel: str, upd: COOUpdate) -> BatchedDelta:
    """Scatter the COO batch into a dense delta relation over the update
    schema, carried as a BatchedDelta with batch=1 and no COO vars."""
    ring = query.ring
    doms = tuple(query.domains[v] for v in upd.schema)
    dense = DenseRelation.from_coo(upd.schema, ring, doms, upd.keys,
                                   upd.payload)
    payload = {c: dense.payload[c][None] for c in ring.components}
    return BatchedDelta(
        coo_schema=(),
        dense_schema=tuple(upd.schema),
        keys=torch.zeros((1, 0), dtype=torch.int32, device=upd.keys.device),
        ring=ring,
        payload=payload,
        dense_domains=doms,
    )


def densify_update_to_coo(query: Query, upd: FactorizedUpdate) -> COOUpdate:
    """1-IVM takes the full (densified) delta — that is the point of the
    comparison in Sec. 8.3: one row a key of the update's domain grid, in
    row-major order."""
    ring = query.ring
    dense = upd.densify(ring)
    doms = dense.domains
    b = _domain_extent(query, dense.schema)
    grids = torch.meshgrid(*[torch.arange(d, dtype=torch.int32,
                                          device=dense.device) for d in doms],
                           indexing="ij")
    keys = torch.stack([g.reshape(-1) for g in grids], dim=1)
    payload = {c: dense.payload[c].reshape((b, *ring.components[c]))
               for c in ring.components}
    return COOUpdate(dense.schema, keys, payload)


def absorb_factor(factors: list, view, ring) -> None:
    """Join a materialized sibling view into the factor list.  Factors
    whose variables intersect the view's schema merge first; disjoint
    factors stay independent (this is what preserves the factorized
    complexity).  Sparse siblings materialize first (the planner keeps
    factor-joined views dense)."""
    view = as_dense(view)
    touching = [f for f in factors if set(f.schema) & set(view.schema)]
    if not touching:
        factors.append(view)  # cartesian sibling: keep as its own factor
        return
    for f in touching:
        factors.remove(f)
    acc = touching[0]
    for f in touching[1:]:
        acc = contract_dense(acc, f, marg=())
    factors.append(contract_dense(acc, view, marg=()))


def marginalize_factor(factors: list, var: str, query: Query) -> None:
    """⊕_var of the one factor holding ``var``, against its lift relation."""
    for i, f in enumerate(factors):
        if var in f.schema:
            factors[i] = contract_dense(f, query.lift_rel(var, f.device),
                                        marg=(var,))
            return
    raise KeyError(f"variable {var} not found in any factor")


def apply_factorized(view, factors: list, ring):
    """view ⊎ (⊗ factors): outer-product accumulate.  Cost is the size of
    the materialized view (O(p²) for matrix views), not of any larger
    product.  Scalar factors (fully-marginalized groups, e.g. ⊕_E δS_E in
    Example 5.2) scale the product.  A sparse view absorbs the product by
    per-factor active-key enumeration + slot scatter
    (:func:`apply_factorized_sparse`)."""
    covered = {v for f in factors for v in f.schema}
    if covered != set(view.schema):
        raise ValueError(f"factors cover {sorted(covered)}, the view is "
                         f"{view.schema}")
    if isinstance(view, SparseRelation):
        return apply_factorized_sparse(view, factors, ring)
    acc = factors[0]
    for f in factors[1:]:
        acc = contract_dense(acc, f, marg=())
    return view.add(acc.transpose(view.schema))


def apply_factorized_sparse(view: SparseRelation, factors: list, ring):
    """Lower a factor product onto a hashed-COO view without densifying:
    enumerate each keyed factor's *active* (non-ring-zero) keys on the host
    (one synchronise a factor: the eager path only), form the cartesian
    product of active rows, compute each row's payload as the ordered ring
    product of its factor values (the dense outer product's multiply order:
    bit-identical) and ⊎ the rows into the table (``SparseRelation.
    scatter_add``, in place).  Inserts ∏ active_i keys, never the full
    domain product; a ring-zero factor inserts nothing."""
    dev = view.device
    keyed = [f for f in factors if f.schema]
    actives = []
    for f in keyed:
        nz = torch.nonzero(~ring.is_zero(f.payload))  # row-major, as argwhere
        if nz.shape[0] == 0:
            return view  # a ring-zero factor annihilates the product
        actives.append(nz.to(torch.int32))
    counts = [a.shape[0] for a in actives]
    B = 1
    for c in counts:
        B *= c
    grids = (torch.meshgrid(*[torch.arange(c, device=dev) for c in counts],
                            indexing="ij") if counts else [])
    rows = [g.reshape(-1) for g in grids]
    # per-row payload: factor values multiplied in factor-list order (the
    # order of the dense path's contract_dense chain)
    payload = None
    ki = 0
    for f in factors:
        if f.schema:
            idx = tuple(actives[ki][:, j][rows[ki]].long()
                        for j in range(len(f.schema)))
            vals = {c: f.payload[c][idx] for c in ring.components}
            ki += 1
        else:
            vals = {c: f.payload[c].expand((B, *shp))
                    for c, shp in ring.components.items()}
        payload = vals if payload is None else ring.mul(payload, vals)
    # key columns in the view's schema order
    cols = []
    for v in view.schema:
        for ki, f in enumerate(keyed):
            if v in f.schema:
                cols.append(actives[ki][:, f.schema.index(v)][rows[ki]])
                break
    keys = (torch.stack(cols, dim=1) if cols
            else torch.zeros((B, 0), dtype=torch.int32, device=dev))
    return view.scatter_add(keys, payload)


# ---------------------------------------------------------------------------
# Write-set → state-leaf mask, and plan-level CSE across a stream step
# ---------------------------------------------------------------------------
def relation_leaves(rel) -> list:
    """The tensors that hold a relation's state: a dense relation's payload
    components by name; a sparse view's key table, then its payload plane
    (both written in place by a trigger that ⊎s into it); an indicator's
    counts, then its plane's components."""
    if isinstance(rel, SparseRelation):
        return [rel.table, rel.plane]
    if hasattr(rel, "leaves"):  # an IndicatorState
        return rel.leaves()
    return [rel.payload[c] for c in sorted(rel.payload)]


def state_leaves(state) -> list:
    """The state tensors of a ``(views, base, indicators)`` state in a
    fixed order: views, then base relations, then indicators, each by
    name, each entry's leaves in :func:`relation_leaves` order."""
    return [leaf for part in state for name in sorted(part)
            for leaf in relation_leaves(part[name])]


def state_write_mask(state, write_views, write_base,
                     write_indicators=frozenset()) -> tuple:
    """Per-state-leaf mask (:func:`state_leaves` order): True iff the leaf
    belongs to an entry some plan's write set names.  The plans are the
    authority on what a trigger may replace."""
    names = (write_views, write_base, write_indicators)
    return tuple(name in names[i]
                 for i, part in enumerate(state)
                 for name in sorted(part)
                 for _ in relation_leaves(part[name]))


def read_sets(plans: Sequence[TriggerPlan]) -> frozenset:
    """Union of :meth:`TriggerPlan.read_views` across plans."""
    out: set = set()
    for p in plans:
        out |= p.read_views()
    return frozenset(out)


def collective_placement(plans: Sequence[TriggerPlan],
                         shardable) -> dict:
    """Decide, per view named by any plan, how it participates in a
    sharded carry — the plan-time collective pass consumed by
    ``repro_torch.core.shard.plan_shards``.

    ``shardable`` maps view names to whether their storage layout *can*
    split along its key/slot axis (leading extent divisible by the mesh).
    The placement derives entirely from the compiled plans' op graph:

    * ``"scatter"``  — written via ScatterAccum and never read by key:
      the ⊎ routes each row to the shard owning its key/slot range; no
      read collective ever materializes the full axis.
    * ``"all_gather"`` — written *and* read by key (a sibling gather at
      arbitrary delta keys): the view shards for its writes, and each
      read gathers the rows its rank owns, then one collective over the
      batch completes it (``repro_torch.core.collectives``).
    * ``"replicate"`` — read-only views, layouts that cannot split, and
      indicator planes: reads stay local, writes (if any) broadcast.
    """
    write_v: set = set()
    for p in plans:
        write_v |= set(p.write_views)
    read_v = read_sets(plans)
    placement: dict = {}
    for name in sorted(write_v | set(read_v)):
        if not shardable.get(name, False) or name not in write_v:
            placement[name] = "replicate"
        elif name in read_v:
            placement[name] = "all_gather"
        else:
            placement[name] = "scatter"
    return placement


def shared_prep_ops(plans: Sequence[TriggerPlan]) -> tuple:
    """Sibling-view prepare steps shared by >= 2 plans of one stream step
    whose source view no plan of the step writes: their gather planes
    (``("plane", view)``) and the densified forms of sparse siblings
    (``("dense", view)``) are computed once a step instead of once a
    position.  Only ``fivm``/``dbt`` COO plans gather from state views;
    fused chains count through their inner gathers (the memo keys are the
    same)."""
    plans = [p for p in plans if p.kind == "coo"]
    write_union: set[str] = set()
    for p in plans:
        write_union |= set(p.write_views)
    counts: dict = {}
    for p in plans:
        keys = set()
        for op in iter_flat_ops(p.ops):
            if getattr(op, "view", "").startswith(IND_PREFIX):
                continue  # indicator planes change within a step
            if isinstance(op, Gather):
                keys.add(("plane", op.view))
            elif isinstance(op, JoinContract) and op.densifies:
                keys.add(("dense", op.view))
        for key in keys:
            counts[key] = counts.get(key, 0) + 1
    return tuple(sorted(k for k, n in counts.items()
                        if n >= 2 and k[1] not in write_union))


def build_prep_memo(shared: tuple, views: Mapping) -> dict:
    """Materialize the shared prepare steps against the current views."""
    memo: dict = {}
    for form, name in shared:
        v = views[name]
        if form == "plane" and is_sharded(v):
            continue  # read by key per position: a collective over the batch
        if form == "dense":
            memo[(form, name)] = as_dense(v)
        elif isinstance(v, SparseRelation):
            memo[(form, name)] = v.gather_plane()
        else:
            memo[(form, name)] = flatten_payload(v.ring, v.payload, v.domains)
    return memo
