"""View trees (Sec. 3, Fig. 3) and their dense evaluation (PyTorch port of
``repro.core.view_tree``).

τ(ω, F): at each variable X of the variable order we define a view over the
views of X's children (relations are leaves placed under their lowest
variable).  Bound variables are marginalized (with lifting) at their node;
free variables are retained.  The schema of V@X is
``dep(X) ∪ free(subtree(X)) ∪ ({X} if X free)``.

Long chains of single-child bound variables can be *fused* into one view
that marginalizes several variables at once (Sec. 3, last paragraph).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

from .contraction import contract_dense
from .query import Query
from .relations import DenseRelation
from .variable_orders import VariableOrder, VONode


@dataclasses.dataclass
class ViewNode:
    name: str
    schema: tuple[str, ...]
    children: list["ViewNode"]
    marg_vars: tuple[str, ...]  # variables marginalized at this node
    rels: frozenset[str]  # relations under this subtree
    relation: str | None = None  # set for leaf nodes
    at_var: str | None = None
    indicator: tuple[str, tuple[str, ...]] | None = None  # (rel, proj schema), Sec. 6

    @property
    def is_leaf(self) -> bool:
        return self.relation is not None

    def walk(self) -> Iterable["ViewNode"]:
        yield self
        for c in self.children:
            yield from c.walk()

    def find(self, name: str) -> "ViewNode":
        for n in self.walk():
            if n.name == name:
                return n
        raise KeyError(name)

    def pretty(self, depth: int = 0) -> str:
        pad = "  " * depth
        if self.is_leaf:
            s = f"{pad}{self.name}[{','.join(self.schema)}]"
        else:
            m = f" ⊕{','.join(self.marg_vars)}" if self.marg_vars else ""
            s = f"{pad}{self.name}[{','.join(self.schema)}]{m}"
        return "\n".join([s] + [c.pretty(depth + 1) for c in self.children])


def build_view_tree(query: Query, vo: VariableOrder, fuse_chains: bool = True) -> ViewNode:
    """Fig. 3: τ(ω, F) with relations under their lowest variables."""
    vo.validate(query)
    free = set(query.free_vars)

    placement: dict[str, list[str]] = {}
    for r, sch in query.relations.items():
        placement.setdefault(vo.lowest_var(sch), []).append(r)

    counter = [0]

    def rel_leaf(r: str) -> ViewNode:
        return ViewNode(
            name=r,
            schema=tuple(query.relations[r]),
            children=[],
            marg_vars=(),
            rels=frozenset([r]),
            relation=r,
        )

    def rec(n: VONode, parent_var: str | None = None) -> ViewNode:
        children = [rec(c, n.var) for c in n.children]
        children += [rel_leaf(r) for r in placement.get(n.var, [])]
        if not children:
            raise ValueError(f"variable {n.var} has no relations below it")
        sub = vo.subtree_vars(n.var)
        dep = vo.dep(n.var, query)
        ordered = _ordered(query, dep | (free & sub))
        # layout: the parent node joins this view on parent_var (gathering
        # B slices during delta propagation) — storing that variable as the
        # leading axis makes those slices contiguous
        if parent_var in ordered:
            ordered = [parent_var] + [v for v in ordered if v != parent_var]
        schema = tuple(ordered)
        rels = frozenset().union(*[c.rels for c in children])
        bound = n.var not in free
        name = f"V{counter[0]}@{n.var}"
        counter[0] += 1
        return ViewNode(
            name=name,
            schema=schema,
            children=children,
            marg_vars=(n.var,) if bound else (),
            rels=rels,
            at_var=n.var,
        )

    roots = [rec(r, None) for r in vo.roots]
    if len(roots) == 1:
        tree = roots[0]
    else:  # disconnected query: cross-product join at a synthetic root
        schema = tuple(v for r in roots for v in r.schema)
        tree = ViewNode(
            name="V_root",
            schema=schema,
            children=roots,
            marg_vars=(),
            rels=frozenset().union(*[r.rels for r in roots]),
        )
    tree = _dedupe_identical(tree)
    if fuse_chains:
        tree = _fuse_chains(tree)
    return tree


def _ordered(query: Query, vars: set[str]) -> list[str]:
    return [v for v in query.all_vars if v in vars]


def _dedupe_identical(node: ViewNode) -> ViewNode:
    """Collapse a parent whose single child has the identical schema and no
    marginalization difference (free-variable chains; Sec. 4 end)."""
    node.children = [_dedupe_identical(c) for c in node.children]
    if (
        len(node.children) == 1
        and not node.is_leaf
        and not node.marg_vars
        and set(node.children[0].schema) == set(node.schema)
        and not node.children[0].is_leaf
    ):
        child = node.children[0]
        child.name = node.name
        return child
    return node


def _fuse_chains(node: ViewNode) -> ViewNode:
    """Fuse chains of single-child marginalization views into one view."""
    node.children = [_fuse_chains(c) for c in node.children]
    while (
        len(node.children) == 1
        and not node.children[0].is_leaf
        and len(node.children[0].children) == 1
        and node.marg_vars
        and node.children[0].marg_vars
    ):
        child = node.children[0]
        node.marg_vars = node.marg_vars + child.marg_vars
        node.children = child.children
    return node


# ---------------------------------------------------------------------------
# Dense evaluation (non-incremental; Sec. 3)
# ---------------------------------------------------------------------------
def evaluate_view(
    node: ViewNode,
    db: Mapping[str, DenseRelation],
    query: Query,
    store: dict[str, DenseRelation] | None = None,
    premarg: bool = False,
) -> DenseRelation:
    """Evaluate bottom-up on the database's device.  If ``store`` is given,
    record every view in it (a leaf's entry is the database relation
    itself).  A node with an indicator (Sec. 6) joins ∃_proj of its
    relation, recomputed from ``db``.

    With ``premarg=True`` also store, for each non-leaf view with a
    marginalized variable, the pre-marginalization join ``W:<name>`` over
    ``schema + marg_vars`` (in that order) — the device form of the
    factorized result representation (Sec. 7.3).  A ``W:`` view is the
    full product, so such a node joins and then sums, as the reference
    does.

    Otherwise the reference's order (join every child and the indicator,
    then sum out each variable against its lift) is changed so that no
    join forms its full product: each summed variable's lift multiplies
    into the last operand (child, or the indicator after the children)
    that holds the variable, and the variable is summed inside the join
    with that operand (or the first join, if only the first operand holds
    it).  So an indicator whose projection holds the variable joins before
    its sum, and one that does not joins after it.  The same sum in
    another order: exact on integer-valued data below 2**24.  Without it
    a chain of p × p matrices would form p³ values, and the triangle
    query's view at C (S(B,C) ⊗ T(C,A) ⊗ ∃R(A,B), summed over C) n³."""
    if node.is_leaf:
        out = db[node.relation]
        if not isinstance(out, DenseRelation):  # a sparse leaf densifies
            out = out.to_dense()
    else:
        operands = [evaluate_view(c, db, query, store, premarg)
                    for c in node.children]
        if node.indicator is not None:
            from .indicators import indicator_of

            rel, proj = node.indicator
            operands.append(indicator_of(db[rel], proj, query))
        keep_product = premarg and store is not None and node.marg_vars
        if keep_product or len(operands) == 1:
            acc = operands[0]
            for o in operands[1:]:
                acc = contract_dense(acc, o, marg=())
            if keep_product:
                # canonical layout (schema first, then the marginalized
                # vars): consumers of the factorized representation index
                # W's key axes in node.schema order
                store[f"W:{node.name}"] = acc.transpose(
                    node.schema + tuple(node.marg_vars))
            for v in node.marg_vars:
                acc = contract_dense(acc, query.lift_rel(v, acc.device),
                                     marg=(v,))
        else:
            # the join at which each variable is summed
            sum_at: dict[int, list[str]] = {}
            for v in node.marg_vars:
                last = max(i for i, o in enumerate(operands) if v in o.schema)
                if query.lift_spec(v) != ("one",):
                    operands[last] = contract_dense(
                        operands[last], query.lift_rel(v, operands[last].device),
                        marg=())
                sum_at.setdefault(max(last, 1), []).append(v)
            acc = operands[0]
            for i, o in enumerate(operands[1:], start=1):
                acc = contract_dense(acc, o, marg=tuple(sum_at.get(i, ())))
        out = acc.transpose(node.schema)
    if store is not None:
        store[node.name] = out
    return out
