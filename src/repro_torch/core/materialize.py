"""μ(τ, U): which views to materialize (Fig. 5; PyTorch port of
``repro.core.materialize``).

The root is always materialized (it is the query result).  Every other view
V_i is materialized iff it has a sibling V_j defined over an updatable
relation — those are exactly the views the delta propagation joins with on
some leaf-to-root path.
"""
from __future__ import annotations

from typing import Iterable

from .view_tree import ViewNode


def choose_materialized(tree: ViewNode, updatable: Iterable[str]) -> set[str]:
    upd = set(updatable)
    chosen: set[str] = {tree.name}

    def rec(node: ViewNode) -> None:
        ch = node.children
        for i, vi in enumerate(ch):
            if any(j != i and (vj.rels & upd) for j, vj in enumerate(ch)):
                chosen.add(vi.name)
        for c in ch:
            rec(c)

    rec(tree)
    return chosen


def gather_scatter_profile(tree: ViewNode, updatable: Iterable[str]
                           ) -> set[str]:
    """Names of views whose delta interactions are *not* purely
    gather/scatter shaped — the storage planner's sparse-hostile set,
    derived from the trigger compiler's own path walk
    (``repro_torch.core.plan.storage_hostility``)."""
    from .plan import storage_hostility

    return storage_hostility(tree, updatable)


def views_on_path(tree: ViewNode, rel: str) -> list[ViewNode]:
    """Leaf-to-root list of views affected by an update to ``rel``
    (the delta tree's spine, Fig. 4)."""
    path: list[ViewNode] = []

    def rec(node: ViewNode) -> bool:
        if node.is_leaf:
            if node.relation == rel:
                path.append(node)
                return True
            return False
        hit = False
        for c in node.children:
            if rec(c):
                hit = True
        if hit:
            path.append(node)
        return hit

    if not rec(tree):
        raise KeyError(f"relation {rel} not in tree")
    return path
