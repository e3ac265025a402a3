"""The IVM engine: triggers + maintenance strategies (Sec. 4, Sec. 8;
PyTorch port of ``repro.core.ivm``).

Strategies:
  * ``fivm``    — F-IVM: one view tree, μ-chosen materialization, factorized
                  delta propagation (the paper's contribution).
  * ``fivm_1``  — first-order F-IVM: only the root is materialized; deltas
                  recompute sibling subtrees from base relations on the fly.
  * ``dbt``     — DBToaster-like fully-recursive higher-order IVM: every
                  view in the tree is materialized regardless of μ.
  * ``reeval``  — full recomputation from stored base relations per update.

``repro_torch.core.plan.compile_trigger`` compiles each (relation, update
signature) into a cached :class:`TriggerPlan` and the engine replays it
eagerly.  Under plan fusion (``plan.fusion_mode(engine.device)``: ``auto``
is on for an engine on the card) COO plans of ``fivm``/``dbt`` run their
Gather→Lift→⊎ chains as ``FusedChain`` ops, one kernel launch each;
first-order, reevaluation and factorized plans stay unfused (a factorized
update's rank-1 joins and ⊎s take the ``rank1_chain`` kernels instead,
``plan.factorized_route``).  The engine owns its
state: views and base relations are copied out of the caller's database at
build and updated in place afterwards.  View storage is planned per view at
build (``storage``: ``auto`` by default, see
``repro_torch.core.storage.plan_storage``): large low-fill views are kept as
hashed-COO tables, which the eager path grows before a batch that could
fill them.  ``use_indicators`` adds the ∃-projections of Sec. 6 to a cyclic
query's tree and maintains them (``core/indicators.py``); ``premarg``
maintains the pre-marginalization ``W:`` views, the factorized result
representation of Sec. 7.3.  The state is ``(views, base, indicators)``.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from ..device import resolve_device
from . import plan as plan_mod
from . import storage as storage_mod
from .indicators import IndicatorState, add_indicators
from .materialize import choose_materialized
from .query import Query
from .relations import COOUpdate, DenseRelation, FactorizedUpdate
from .variable_orders import VariableOrder, heuristic_order
from .view_tree import ViewNode, build_view_tree, evaluate_view

STRATEGIES = ("fivm", "fivm_1", "dbt", "reeval")


@dataclasses.dataclass
class IVMEngine:
    query: Query
    tree: ViewNode
    materialized_names: set[str]
    views: dict
    base: dict[str, DenseRelation]
    indicators: dict[str, IndicatorState]  # keyed by node name carrying it
    strategy: str
    updatable: tuple[str, ...]
    device: torch.device
    store_base: bool
    #: per-view storage decisions (repro_torch.core.storage.plan_storage)
    storage_plan: dict = dataclasses.field(default_factory=dict)
    #: compiled trigger plans, keyed per (relation, update signature,
    #: backend override, fusion mode)
    plans: plan_mod.PlanCache = dataclasses.field(
        default_factory=plan_mod.PlanCache)

    # ------------------------------------------------------------------ build
    @classmethod
    def build(
        cls,
        query: Query,
        database: Mapping[str, DenseRelation],
        updatable: tuple[str, ...] | None = None,
        var_order: VariableOrder | None = None,
        strategy: str = "fivm",
        use_indicators: bool = False,
        fuse_chains: bool = True,
        premarg: bool = False,
        storage: str | None = None,
        storage_overrides: Mapping[str, str] | None = None,
        storage_opts: Mapping | None = None,
        store_base: bool | None = None,
        device="cuda",
    ) -> "IVMEngine":
        """Build an engine on ``device`` (the database moves there if it
        is elsewhere).  ``storage`` selects the view-storage mode
        (``"auto" | "dense" | "sparse"``; default: ``REPRO_TORCH_VIEW_STORAGE``,
        else ``auto``, where the planner picks dense or sparse per view from
        the domain product × fill model).  ``storage_overrides`` forces a
        backend per view name; ``storage_opts`` are extra
        :func:`repro_torch.core.storage.plan_storage` keywords (headroom,
        thresholds, capacities).

        ``use_indicators`` annotates the tree with ∃-projections (Sec. 6;
        ``fivm``, ``dbt`` and ``reeval``): each indicator's relation is
        stored as a base relation, and where that relation is updatable the
        indicator node's children and the relation's leaf are
        materialized.  ``premarg`` also maintains every pre-marginalization
        view ``W:<node>`` (Sec. 7.3).  ``store_base=True`` stores every base
        relation even under ``fivm`` / ``dbt`` (default: only where
        maintenance reads it back).

        The caller's database is never written: every materialized view and
        stored base relation is the engine's own copy (views alias the
        database relations they are evaluated from, and triggers update
        views in place)."""
        dev = resolve_device(device)
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}; one of {STRATEGIES}")
        updatable = tuple(updatable if updatable is not None else query.relations)
        vo = var_order or heuristic_order(query)
        tree = build_view_tree(query, vo, fuse_chains=fuse_chains)
        if use_indicators:
            if strategy == "fivm_1":
                raise ValueError("1-IVM has no intermediate views; indicator "
                                 "projections do not apply")
            tree = add_indicators(tree, query)

        if strategy == "fivm":
            mat = choose_materialized(tree, updatable)
        elif strategy == "dbt":
            mat = {n.name for n in tree.walk()}
        else:  # fivm_1, reeval
            mat = {tree.name} | {n.name for n in tree.walk() if n.is_leaf}

        database = {r: DenseRelation(rel.schema, rel.ring,
                                     {c: v.to(dev) for c, v in rel.payload.items()})
                    for r, rel in database.items()}
        store_base = strategy in ("fivm_1", "reeval") or bool(store_base)
        # indicator-bearing nodes need their base relation stored and all
        # children materialized when the indicator's relation is updatable
        indicators: dict[str, IndicatorState] = {}
        for n in tree.walk():
            if n.indicator is not None:
                r, proj = n.indicator
                indicators[n.name] = IndicatorState.init(r, database[r], proj,
                                                         query)
                if r in updatable:
                    mat |= {c.name for c in n.children}
                    mat |= {ln.name for ln in tree.walk()
                            if ln.is_leaf and ln.relation == r}
        store: dict[str, DenseRelation] = {}
        evaluate_view(tree, database, query, store=store, premarg=premarg)
        if premarg:
            # the factorized result representation: every pre-marginalization
            # view is part of the maintained output (Sec. 7.3)
            mat |= {k for k in store if k.startswith("W:")}
        views = {name: store[name].owned() for name in mat}
        plan = storage_mod.plan_storage(
            views, tree=tree, updatable=updatable, strategy=strategy,
            mode=storage, overrides=storage_overrides,
            **dict(storage_opts or {}))
        views = storage_mod.apply_storage_plan(views, plan)
        # base relations are stored only where maintenance reads them back:
        # 1-IVM and reevaluation recompute from base, and indicator
        # transition counting needs the relation before each update
        need_base = set(query.relations) if store_base else {
            n.indicator[0] for n in tree.walk() if n.indicator is not None}
        base = {r: rel.owned() for r, rel in database.items()
                if r in need_base}
        return cls(
            query=query,
            tree=tree,
            materialized_names=mat,
            views=views,
            base=base,
            indicators=indicators,
            strategy=strategy,
            updatable=updatable,
            device=dev,
            store_base=store_base,
            storage_plan=plan,
        )

    # ---------------------------------------------------------------- result
    def result(self) -> DenseRelation:
        """The root view, densely materialized (a sparse root densifies)."""
        return storage_mod.as_dense(self.views[self.tree.name])

    def result_storage(self):
        """The root view under its planned storage backend."""
        return self.views[self.tree.name]

    def num_materialized(self) -> int:
        return len(self.materialized_names)

    def memory_bytes(self) -> int:
        """View-state bytes under the actual storage backends (a sparse view
        counts its key table and payload plane, not the dense extent), and
        each indicator's counts and plane."""
        total = sum(storage_mod.view_nbytes(v) for v in self.views.values())
        for ind in self.indicators.values():
            total += ind.counts.numel() * ind.counts.element_size()
            total += storage_mod.view_nbytes(ind.dense)
        return total

    # ----------------------------------------------------------------- plans
    def trigger_plan(self, rel: str, upd) -> plan_mod.TriggerPlan:
        """The cached maintenance plan for an update like ``upd``."""
        return self.plans.lookup(self, rel, upd)

    def precompile(self, batch: int = 1) -> dict[str, plan_mod.TriggerPlan]:
        """Compile (and cache) the COO trigger plan of every updatable
        relation at the given batch size; returns them by relation."""
        return {
            rel: self.plans.lookup_sig(
                self, rel, ("coo", tuple(self.query.relations[rel]), batch))
            for rel in self.updatable
        }

    # ---------------------------------------------------------------- update
    def apply_update(self, rel: str, upd: COOUpdate | FactorizedUpdate) -> None:
        """Eager (per-call) update of the engine's state.  Sparse views in
        the trigger's write set first rehash to 2× capacity (repeatedly)
        when this batch could cross the load-factor bound: growth reads
        each such view's occupancy on the host (one synchronise a touched
        sparse view), so it lives only here — the trigger itself, and the
        stream executor's graphs, keep capacities fixed."""
        if rel not in self.updatable:
            raise ValueError(f"{rel} not declared updatable")
        if any(isinstance(v, storage_mod.SparseRelation)
               for v in self.views.values()):
            touched, _, _ = self.plans.write_sets(self, rel)
            self.views = {
                name: (storage_mod.grow_if_loaded(
                           v, self._insert_budget(v, rel, upd))
                       if name in touched else v)
                for name, v in self.views.items()
            }
        self.views, self.base, self.indicators = self.functional_update(
            self.views, self.base, self.indicators, rel, upd)

    def _insert_budget(self, view, rel: str, upd) -> int:
        """Worst-case distinct keys one update can insert into ``view``:
        B rows × the domain product of view variables the update does not
        bind (a mixed COO×dense apply enumerates that grid).  A factorized
        update enumerates the cartesian product of its factors' *active*
        key sets (the sparse lowering never touches the full grid), so its
        budget is that product: each factor's non-zero count (one host read
        a factor) times the domain of each view variable the update does
        not bind.
        ``grow_if_loaded`` clamps it to the view's domain product."""
        if not isinstance(view, storage_mod.SparseRelation):
            return 0
        if isinstance(upd, FactorizedUpdate):
            ring = self.query.ring
            budget, seen = 1, set()
            for v in view.schema:
                if v in upd.schema:
                    f = upd.factor_for(v)
                    if id(f) in seen:
                        continue
                    seen.add(id(f))
                    budget *= int((~ring.is_zero(f.payload)).sum())
                else:
                    budget *= int(self.query.domains[v])
            return budget
        extra = 1
        for v in view.schema:
            if v not in upd.schema:
                extra *= int(self.query.domains[v])
        return upd.batch * extra

    def trigger_body(self, rel: str, plan: plan_mod.TriggerPlan | None = None):
        """The maintenance trigger for updates to ``rel`` as the stream
        executor replays it: ``body(state, upd, memo=None) -> state`` with
        ``state = (views, base, indicators)``, its output checked by
        :func:`canonical_state`.  ``plan`` pins the compiled trigger plan
        (the executor embeds one a schedule position); without it the
        engine's plan cache resolves it per update signature.  ``memo``
        carries a stream step's shared sibling planes."""

        def body(state, upd, memo=None):
            views, base, indicators = state
            return canonical_state(self.functional_update(
                views, base, indicators, rel, upd, plan=plan, memo=memo))

        return body

    def make_trigger(self, rel: str):
        """The maintenance trigger for updates to ``rel``:
        ``trigger(state, upd) -> state`` with ``state = (views, base,
        indicators)``.  It runs eagerly (there is no compilation step) and
        consumes the state it is given, like :meth:`functional_update`."""

        def trigger(state, upd):
            views, base, indicators = state
            return self.functional_update(views, base, indicators, rel, upd)

        return trigger

    @property
    def state(self):
        return (self.views, self.base, self.indicators)

    def canonical_state(self):
        """The engine state, its leaves' dtypes checked
        (:func:`canonical_state`)."""
        return canonical_state(self.state)

    def set_state(self, state) -> None:
        self.views, self.base, self.indicators = state

    def functional_update(self, views, base, indicators, rel: str, upd,
                          plan: plan_mod.TriggerPlan | None = None,
                          memo=None):
        """Returns new ``(views, base, indicators)`` after ``upd``: replays
        ``plan``, by default the cached :class:`TriggerPlan` for ``(rel,
        upd signature)``.  Tensors of the state are updated in place where
        their layout allows, so the state passed in must not be used
        again."""
        if rel not in self.updatable:
            raise ValueError(f"{rel} not declared updatable")
        if plan is None:
            plan = self.plans.lookup(self, rel, upd)
        return plan_mod.execute_trigger(self, plan, views, base, indicators,
                                        upd, memo=memo)

    def shard_state(self, shard_plan) -> None:
        """Place the canonical state under a :class:`repro_torch.core.shard.
        ShardPlan`: each sharded view becomes this rank's slice of it (the
        rows of its leading keys, or the payload rows of its slot range),
        the rest stays whole.  The sharded analogue of
        :meth:`canonical_state`; every rank of the plan's group calls it."""
        self.set_state(shard_plan.place(self.canonical_state()))

    def _bump_base(self, rel: DenseRelation, upd) -> DenseRelation:
        """Base-relation ⊎: a COO batch through the ring scatter dispatch
        layer, a factorized update as its densified product."""
        if isinstance(upd, FactorizedUpdate):
            dense = upd.densify(self.query.ring).transpose(rel.schema)
            return rel.add(dense)
        return rel.scatter_add(upd.keys, upd.payload)


def canonical_state(state):
    """Check that every leaf of a ``(views, base, indicators)`` state has
    its dtype (its ring's; an indicator's counts int32), and return the
    state unchanged.  The reference strips JAX weak types here so that one
    scan carry serves every trigger; torch has none, and the stream
    executor needs only that a trigger keeps each leaf's dtype, since it
    copies a replaced leaf back into the state's own storage."""
    views, base, indicators = state
    rels = [(n, r) for part in (views, base) for n, r in part.items()]
    for name, ind in indicators.items():
        if ind.counts.dtype != torch.int32:
            raise TypeError(f"∃{name} counts are {ind.counts.dtype}, not int32")
        rels.append((f"∃{name}", ind.dense))
    for name, rel in rels:
        for c, leaf in rel.payload.items():
            if leaf.dtype != rel.ring.dtype:
                raise TypeError(f"{name}.{c} is {leaf.dtype}, its ring "
                                f"{rel.ring.name} is {rel.ring.dtype}")
    return state
