"""Host-side exact F-IVM engine over PyRelation (PyTorch port of
``repro.core.py_engine``: pure Python, no tensors).

Two roles:
  1. Exact oracle for the device engine in tests — same view trees, same
     delta rules, python dict execution.
  2. The execution substrate for the *relational data ring* F[ℤ]
     (Sec. 7.3), whose dynamic-size payloads do not map to dense tensors:
     listing payloads, factorized payloads, and constant-delay-style
     enumeration.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

from .materialize import views_on_path
from .relations import PyRelation
from .rings import PyRing
from .view_tree import ViewNode

Lift = Callable[[object], object]  # value -> payload


@dataclasses.dataclass
class PyEngineSpec:
    ring: PyRing
    lifts: Mapping[str, Lift]  # per-variable lifting functions

    def lift(self, var: str):
        return self.lifts.get(var, lambda _v: self.ring.one())


def py_evaluate(
    node: ViewNode,
    db: Mapping[str, PyRelation],
    spec: PyEngineSpec,
    store: dict[str, PyRelation] | None = None,
) -> PyRelation:
    if node.is_leaf:
        out = db[node.relation]
    else:
        acc: PyRelation | None = None
        for c in node.children:
            cv = py_evaluate(c, db, spec, store)
            acc = cv if acc is None else acc.join(cv)
        if node.indicator is not None:
            rel, proj = node.indicator
            acc = acc.join(py_indicator(db[rel], proj, spec.ring))
        assert acc is not None
        for v in node.marg_vars:
            acc = acc.marginalize(v, spec.lift(v))
        out = acc
    if store is not None:
        store[node.name] = out
    return out


def py_indicator(rel: PyRelation, proj: tuple[str, ...], ring: PyRing) -> PyRelation:
    cols = rel.project_cols(proj)
    out = PyRelation(proj, ring)
    seen = set()
    for k in rel.data:
        pk = tuple(k[i] for i in cols)
        if pk not in seen:
            seen.add(pk)
            out.data[pk] = ring.one()
    return out


def py_propagate(
    tree: ViewNode,
    views: Mapping[str, PyRelation],
    spec: PyEngineSpec,
    rel: str,
    delta: PyRelation,
) -> dict[str, PyRelation]:
    """Leaf-to-root delta propagation; returns new versions of every
    materialized view on the path (mirror of delta.propagate_coo)."""
    path = views_on_path(tree, rel)
    updated: dict[str, PyRelation] = {}
    leaf = path[0]
    d = delta
    if leaf.name in views:
        updated[leaf.name] = views[leaf.name].union(d)
    child = leaf
    for node in path[1:]:
        for sib in node.children:
            if sib is child:
                continue
            d = d.join(views[sib.name])
        if node.indicator is not None:
            d = d.join(views[f"∃{node.name}"])
        for v in node.marg_vars:
            d = d.marginalize(v, spec.lift(v))
        if node.name in views:
            updated[node.name] = views[node.name].union(d.reorder(views[node.name].schema))
        child = node
    return updated


class PyIVM:
    """Convenience wrapper: materialize-all host IVM (exact oracle)."""

    def __init__(self, tree: ViewNode, db: Mapping[str, PyRelation], spec: PyEngineSpec):
        self.tree = tree
        self.spec = spec
        self.views: dict[str, PyRelation] = {}
        py_evaluate(tree, db, spec, store=self.views)
        # store base relations under their leaf names & indicators
        for n in tree.walk():
            if n.indicator is not None:
                r, proj = n.indicator
                self.views[f"∃{n.name}"] = py_indicator(db[r], proj, spec.ring)
        self._db = {k: v.copy() for k, v in db.items()}

    def result(self) -> PyRelation:
        return self.views[self.tree.name]

    def apply_update(self, rel: str, delta: PyRelation) -> None:
        updated = py_propagate(self.tree, self.views, self.spec, rel, delta)
        self.views.update(updated)
        old = self._db[rel]
        new = old.union(delta)
        self._db[rel] = new
        # maintain indicators (recompute δ∃ exactly; host oracle can afford it)
        for n in self.tree.walk():
            if n.indicator is not None and n.indicator[0] == rel:
                old_ind = self.views[f"∃{n.name}"]
                new_ind = py_indicator(new, n.indicator[1], self.spec.ring)
                d = new_ind.union(
                    PyRelation(old_ind.schema, self.spec.ring,
                               {k: self.spec.ring.neg(p) for k, p in old_ind.data.items()})
                )
                self.views[f"∃{n.name}"] = new_ind
                if d.data:
                    self._propagate_indicator(n, d)

    def _propagate_indicator(self, node: ViewNode, d: PyRelation) -> None:
        for sib in node.children:
            d = d.join(self.views[sib.name])
        for v in node.marg_vars:
            d = d.marginalize(v, self.spec.lift(v))
        if node.name in self.views:
            self.views[node.name] = self.views[node.name].union(d.reorder(self.views[node.name].schema))
        # upward
        path: list[ViewNode] = []

        def rec(n: ViewNode) -> bool:
            if n is node:
                path.append(n)
                return True
            for c in n.children:
                if rec(c):
                    path.append(n)
                    return True
            return False

        rec(self.tree)
        child = node
        for parent in path[1:]:
            for sib in parent.children:
                if sib is child:
                    continue
                d = d.join(self.views[sib.name])
            if parent.indicator is not None and parent is not node:
                d = d.join(self.views[f"∃{parent.name}"])
            for v in parent.marg_vars:
                d = d.marginalize(v, self.spec.lift(v))
            if parent.name in self.views:
                self.views[parent.name] = self.views[parent.name].union(d.reorder(self.views[parent.name].schema))
            child = parent
