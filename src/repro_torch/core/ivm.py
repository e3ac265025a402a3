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
fill them.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from ..device import resolve_device
from . import plan as plan_mod
from . import storage as storage_mod
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
    strategy: str
    updatable: tuple[str, ...]
    device: torch.device
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
        storage: str | None = None,
        storage_overrides: Mapping[str, str] | None = None,
        storage_opts: Mapping | None = None,
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

        The caller's database is never written: every materialized view and
        stored base relation is the engine's own copy (views alias the
        database relations they are evaluated from, and triggers update
        views in place)."""
        dev = resolve_device(device)
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}; one of {STRATEGIES}")
        if use_indicators:
            raise NotImplementedError(
                "indicator projections are not ported yet (ROADMAP Queue 1 "
                "item 5, core/indicators.py)")
        updatable = tuple(updatable if updatable is not None else query.relations)
        vo = var_order or heuristic_order(query)
        tree = build_view_tree(query, vo, fuse_chains=fuse_chains)

        if strategy == "fivm":
            mat = choose_materialized(tree, updatable)
        elif strategy == "dbt":
            mat = {n.name for n in tree.walk()}
        else:  # fivm_1, reeval
            mat = {tree.name} | {n.name for n in tree.walk() if n.is_leaf}

        database = {r: DenseRelation(rel.schema, rel.ring,
                                     {c: v.to(dev) for c, v in rel.payload.items()})
                    for r, rel in database.items()}
        store: dict[str, DenseRelation] = {}
        evaluate_view(tree, database, query, store=store)
        views = {name: store[name].owned() for name in mat}
        plan = storage_mod.plan_storage(
            views, tree=tree, updatable=updatable, strategy=strategy,
            mode=storage, overrides=storage_overrides,
            **dict(storage_opts or {}))
        views = storage_mod.apply_storage_plan(views, plan)
        # base relations are stored only where maintenance reads them back:
        # 1-IVM and reevaluation recompute from base
        base = {r: rel.owned() for r, rel in database.items()
                if strategy in ("fivm_1", "reeval")}
        return cls(
            query=query,
            tree=tree,
            materialized_names=mat,
            views=views,
            base=base,
            strategy=strategy,
            updatable=updatable,
            device=dev,
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
        counts its key table and payload plane, not the dense extent)."""
        return sum(storage_mod.view_nbytes(v) for v in self.views.values())

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
            touched, _ = self.plans.write_sets(self, rel)
            self.views = {
                name: (storage_mod.grow_if_loaded(
                           v, self._insert_budget(v, rel, upd))
                       if name in touched else v)
                for name, v in self.views.items()
            }
        self.views, self.base = self.functional_update(
            self.views, self.base, rel, upd)

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
        ``state = (views, base)``, its output checked by
        :func:`canonical_state`.  ``plan`` pins the compiled trigger plan
        (the executor embeds one a schedule position); without it the
        engine's plan cache resolves it per update signature.  ``memo``
        carries a stream step's shared sibling planes."""

        def body(state, upd, memo=None):
            views, base = state
            return canonical_state(self.functional_update(
                views, base, rel, upd, plan=plan, memo=memo))

        return body

    def make_trigger(self, rel: str):
        """The maintenance trigger for updates to ``rel``:
        ``trigger(state, upd) -> state`` with ``state = (views, base)``.
        It runs eagerly (there is no compilation step) and consumes the
        state it is given, like :meth:`functional_update`."""

        def trigger(state, upd):
            views, base = state
            return self.functional_update(views, base, rel, upd)

        return trigger

    @property
    def state(self):
        return (self.views, self.base)

    def set_state(self, state) -> None:
        self.views, self.base = state

    def functional_update(self, views, base, rel: str, upd,
                          plan: plan_mod.TriggerPlan | None = None,
                          memo=None):
        """Returns new ``(views, base)`` after ``upd``: replays ``plan``, by
        default the cached :class:`TriggerPlan` for ``(rel, upd
        signature)``.  Tensors of ``views`` and ``base`` are updated in
        place where their layout allows, so the state passed in must not
        be used again."""
        if rel not in self.updatable:
            raise ValueError(f"{rel} not declared updatable")
        if plan is None:
            plan = self.plans.lookup(self, rel, upd)
        return plan_mod.execute_trigger(self, plan, views, base, upd,
                                        memo=memo)

    def shard_state(self, shard_plan) -> None:
        """Sharded placement is not ported yet."""
        raise NotImplementedError("sharding is not ported yet (ROADMAP "
                                  "Queue 1 item 14)")

    def _bump_base(self, rel: DenseRelation, upd) -> DenseRelation:
        """Base-relation ⊎: a COO batch through the ring scatter dispatch
        layer, a factorized update as its densified product."""
        if isinstance(upd, FactorizedUpdate):
            dense = upd.densify(self.query.ring).transpose(rel.schema)
            return rel.add(dense)
        return rel.scatter_add(upd.keys, upd.payload)


def canonical_state(state):
    """Check that every leaf of a ``(views, base)`` state has its ring's
    dtype, and return the state unchanged.  The reference strips JAX weak
    types here so that one scan carry serves every trigger; torch has none,
    and the stream executor needs only that a trigger keeps each leaf's
    dtype, since it copies a replaced leaf back into the state's own
    storage."""
    for part in state:
        for name, rel in part.items():
            for c, leaf in rel.payload.items():
                if leaf.dtype != rel.ring.dtype:
                    raise TypeError(f"{name}.{c} is {leaf.dtype}, its ring "
                                    f"{rel.ring.name} is {rel.ring.dtype}")
    return state
