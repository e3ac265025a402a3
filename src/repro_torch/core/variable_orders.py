"""Variable orders (Def. 3.1) and a heuristic constructor (PyTorch port of
``repro.core.variable_orders``; pure Python).

A variable order ω = (F, dep) is a rooted forest with one node per query
variable; every relation's variables lie on one root-to-leaf path; dep(X)
is the set of ancestors of X that co-occur (in some relation) with a
variable in X's subtree.  Free variables should sit above bound ones.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from .query import Query


@dataclasses.dataclass
class VONode:
    var: str
    children: list["VONode"] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class VariableOrder:
    roots: list[VONode]

    # -- structure helpers ---------------------------------------------------
    def nodes(self) -> list[VONode]:
        out: list[VONode] = []

        def rec(n: VONode):
            out.append(n)
            for c in n.children:
                rec(c)

        for r in self.roots:
            rec(r)
        return out

    def parent_map(self) -> dict[str, str | None]:
        pm: dict[str, str | None] = {}

        def rec(n: VONode, parent: str | None):
            pm[n.var] = parent
            for c in n.children:
                rec(c, n.var)

        for r in self.roots:
            rec(r, None)
        return pm

    def ancestors(self, var: str) -> list[str]:
        pm = self.parent_map()
        out = []
        cur = pm[var]
        while cur is not None:
            out.append(cur)
            cur = pm[cur]
        return out

    def subtree_vars(self, var: str) -> set[str]:
        node = self._find(var)
        out: set[str] = set()

        def rec(n: VONode):
            out.add(n.var)
            for c in n.children:
                rec(c)

        rec(node)
        return out

    def _find(self, var: str) -> VONode:
        for n in self.nodes():
            if n.var == var:
                return n
        raise KeyError(var)

    # -- Def. 3.1 ------------------------------------------------------------
    def dep(self, var: str, query: Query) -> set[str]:
        anc = set(self.ancestors(var))
        sub = self.subtree_vars(var)
        return {
            y
            for y in anc
            if any(y in sch and (sub & set(sch)) for sch in query.relations.values())
        }

    def validate(self, query: Query) -> None:
        """Each relation's variables must lie on one root-to-leaf path."""
        vars_seen = {n.var for n in self.nodes()}
        if vars_seen != set(query.all_vars):
            raise ValueError(f"order covers {sorted(vars_seen)}, query has "
                             f"{sorted(query.all_vars)}")
        pm = self.parent_map()
        depth: dict[str, int] = {}
        for v in vars_seen:
            d, cur = 0, pm[v]
            while cur is not None:
                d, cur = d + 1, pm[cur]
            depth[v] = d
        for r, sch in query.relations.items():
            # the deepest var's ancestor chain must contain all others
            lowest = max(sch, key=lambda v: depth[v])
            chain = set(self.ancestors(lowest)) | {lowest}
            if not set(sch) <= chain:
                raise ValueError(f"relation {r}: {sch} not on one path")

    def lowest_var(self, rel_schema: Sequence[str]) -> str:
        pm = self.parent_map()
        depth: dict[str, int] = {}
        for v in rel_schema:
            d, cur = 0, pm[v]
            while cur is not None:
                d, cur = d + 1, pm[cur]
            depth[v] = d
        return max(rel_schema, key=lambda v: depth[v])


def chain(vars: Sequence[str], branches: dict[str, list] | None = None) -> VariableOrder:
    """Convenience: linear chain v0 - v1 - ... with optional branch lists.

    ``branches[v]`` is a list of chains hanging under v (each a list of vars).
    """
    branches = branches or {}

    def make_chain(vs: Sequence[str]) -> VONode:
        head = VONode(vs[0])
        cur = head
        for v in vs[1:]:
            nxt = VONode(v)
            cur.children.append(nxt)
            cur = nxt
        return head

    head = make_chain(vars)
    # attach branches
    def attach(n: VONode):
        for sub in branches.get(n.var, []):
            n.children.append(make_chain(sub))
        for c in n.children:
            attach(c)

    attach(head)
    return VariableOrder([head])


def heuristic_order(query: Query) -> VariableOrder:
    """Greedy min-fill/min-degree style elimination ordering.

    Bound variables are eliminated first (deepest); free variables last so
    they end up on top (as the paper prefers).  The forest is built by making
    each eliminated variable a child of the *next-eliminated* variable it
    interacts with (via the contracted hypergraph).
    """
    hyperedges = [set(sch) for sch in query.relations.values()]
    free = set(query.free_vars)
    remaining = set(query.all_vars)
    order: list[str] = []  # elimination order: first = deepest
    edges = [set(e) for e in hyperedges]

    def neighbors(v: str) -> set[str]:
        out: set[str] = set()
        for e in edges:
            if v in e:
                out |= e
        out.discard(v)
        return out

    while remaining:
        candidates = [v for v in remaining if v not in free] or list(remaining)
        v = min(candidates, key=lambda u: (len(neighbors(u) & remaining), u))
        order.append(v)
        # contract: merge all edges containing v
        merged = neighbors(v) & remaining - {v}
        edges = [e for e in edges if v not in e]
        if merged:
            edges.append(merged)
        remaining.discard(v)

    # build forest: parent(v) = first var after v in elimination order that
    # is a neighbor of v in the original-closure sense
    nodes = {v: VONode(v) for v in order}
    # recompute neighborhoods with progressive contraction for parent links
    edges = [set(e) for e in hyperedges]
    parents: dict[str, str | None] = {}
    for i, v in enumerate(order):
        nbrs: set[str] = set()
        for e in edges:
            if v in e:
                nbrs |= e
        nbrs.discard(v)
        later = [u for u in order[i + 1 :] if u in nbrs]
        parents[v] = later[0] if later else None
        merged = {u for u in nbrs if u in order[i + 1 :]}
        edges = [e for e in edges if v not in e]
        if merged:
            edges.append(merged)
    roots = []
    for v in order:
        p = parents[v]
        if p is None:
            roots.append(nodes[v])
        else:
            nodes[p].children.append(nodes[v])
    vo = VariableOrder(roots)
    vo.validate(query)
    return vo
