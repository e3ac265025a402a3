"""Delta propagation (Sec. 4; PyTorch port of ``repro.core.delta``).

For an update δR, the delta tree replaces the views on the leaf-to-root path
with delta views (Fig. 4):

    δ(V1 ⊎ V2) = δV1 ⊎ δV2
    δ(V1 ⊗ V2) = (δV1 ⊗ V2) ⊎ (V1 ⊗ δV2) ⊎ (δV1 ⊗ δV2)
    δ(⊕_X V)   = ⊕_X δV

Only one child changes per path node, so the product rule degenerates to
δV ⊗ (materialized siblings).  Deltas are carried as BatchedDelta (COO over
update-bound variables × dense over sibling-contributed ones) or, when the
update is factorizable, as a product of per-group factors that marginalize
independently (the paper's Optimize; Example 5.2 / 7.1).  This module
is a thin plan interpreter: ``IVMEngine`` fetches plans from its cache; the
functions here compile ad hoc (tests / exploratory use).
"""
from __future__ import annotations

from typing import Mapping

from . import plan as plan_mod
from .plan import PropagationResult
from .query import Query
from .relations import COOUpdate, DenseRelation, FactorizedUpdate
from .view_tree import ViewNode

__all__ = ["PropagationResult", "propagate_coo", "propagate_factorized"]


class _PathEngine:
    """Minimal engine facade for compiling a standalone path plan."""

    def __init__(self, tree, query, views, device, indicators=None):
        self.tree = tree
        self.query = query
        self.views = views
        self.strategy = "fivm"
        self.base = {}
        self.device = device
        self.indicators = {}
        for node in tree.walk():
            if node.indicator is not None and indicators \
                    and node.name in indicators:
                self.indicators[node.name] = _IndMeta(
                    tuple(node.indicator[1]), indicators[node.name])


class _IndMeta:
    def __init__(self, proj, dense):
        self.proj = proj
        self.dense = dense
        self.rel_name = None  # never matches: path-only compilation


def propagate_coo(
    tree: ViewNode,
    materialized: Mapping[str, object],
    query: Query,
    rel: str,
    upd: COOUpdate,
    indicators: Mapping[str, DenseRelation] | None = None,
) -> PropagationResult:
    """Propagate a COO batch update along the delta tree, updating every
    materialized view on the path (in place where the layout allows: the
    views passed in must not be used again; use ``result.updated``).
    ``indicators`` maps node names to maintained ∃-projection planes
    (Sec. 6)."""
    eng = _PathEngine(tree, query, materialized, upd.keys.device, indicators)
    plan = plan_mod.compile_trigger(eng, rel,
                                    ("coo", tuple(upd.schema), upd.batch))
    return plan_mod.run_coo_ops(plan.ops, materialized, query, upd,
                                dict(indicators or {}))


def propagate_factorized(
    tree: ViewNode,
    materialized: Mapping[str, DenseRelation],
    query: Query,
    rel: str,
    upd: FactorizedUpdate,
    indicators: Mapping[str, DenseRelation] | None = None,
) -> PropagationResult:
    """Sec. 5 Optimize: keep the delta as a product of factors over disjoint
    variable groups; marginalization and sibling joins touch only the factor
    containing the variable, so a rank-1 update to a p×p 'relation' costs
    O(p²) instead of O(p³) (Example 7.1).  Dense views come back new; a
    sparse view is written in place (use ``result.updated``)."""
    eng = _PathEngine(tree, query, materialized, upd.factors[0].device,
                      indicators)
    plan = plan_mod.compile_trigger(eng, rel,
                                    ("factorized", tuple(upd.schema)))
    return plan_mod.run_factorized_ops(plan.ops, materialized, query, upd,
                                       dict(indicators or {}))
