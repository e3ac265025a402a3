"""Factorized representation of conjunctive query results (Sec. 7.3;
PyTorch port of ``repro.core.apps.conjunctive``).

Payloads live in the relational data ring F[ℤ] (Def. 7.4): relations over ℤ
with union as + and join as ×.  A conjunctive query is encoded as a count
query where free variables lift to singleton relations {(x) → 1} and bound
variables lift to 1 = {() → 1}.

Two representations (Example 7.5/7.6, Fig. 2d/e):

* LISTING — the root payload is the full query result.  Dynamic payload
  sizes keep this on the host engine (PyIVM + PyRelationalRing).

* FACTORIZED — each view V@X stores, per key, the union of X-values with
  multiplicities.  Device formulation: the distribution at V@X is the
  *pre-marginalization* count tensor W@X over schema ∪ {X}; the hierarchy
  {W@X} linked by view keys IS the factorized representation, is dense
  (so it runs on the card: its ⊎ are the ``scatter_add`` kernel's), and is
  maintained incrementally by the same delta propagation (apply the delta
  before the final ⊕_X).  Reconstruction = `enumerate_factorized`
  descending the tree.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from ...device import resolve_device
from ..py_engine import PyEngineSpec, PyIVM
from ..query import Query
from ..relations import PyRelation
from ..rings import PyRelationalRing, count_ring, sum_ring
from ..storage import as_dense, make_base_relation
from ..variable_orders import VariableOrder
from ..view_tree import ViewNode, build_view_tree


# ---------------------------------------------------------------------------
# Listing representation (host; Example 7.5)
# ---------------------------------------------------------------------------
def make_listing_engine(
    relations: Mapping[str, tuple[str, ...]],
    cq_free: Sequence[str],
    db: Mapping[str, PyRelation],
    var_order: VariableOrder,
    domains: Mapping[str, int],
) -> tuple[PyIVM, ViewNode]:
    # tagged ring: payload values carry their variable so join order during
    # delta propagation cannot permute listing columns (see rings.py)
    ring = PyRelationalRing(tagged=True)
    free = set(cq_free)
    all_vars = {u for sch in relations.values() for u in sch}
    lifts = {
        v: ((lambda x, v=v: {((v, x),): 1}) if v in free
            else (lambda x: {(): 1}))
        for v in all_vars
    }
    spec = PyEngineSpec(ring=ring, lifts=lifts)
    q = Query(relations=relations, free_vars=(), ring=sum_ring(), domains=domains)
    tree = build_view_tree(q, var_order, fuse_chains=False)
    eng = PyIVM(tree, db, spec)
    return eng, tree


def listing_result(eng: PyIVM, cq_free: Sequence[str], tree: ViewNode) -> dict[tuple, int]:
    """Root payload (empty key) as {tuple over ``cq_free`` order -> mult}.

    With the tagged ring, payload entries are (var, value) pairs; this
    projects them back to plain value tuples in ``cq_free`` order.
    """
    root = eng.result()
    payload = root.data.get((), {})
    out: dict[tuple, int] = {}
    for t, mult in payload.items():
        if t and isinstance(t[0], tuple):
            d = dict(t)
            key = tuple(d[v] for v in cq_free)
        else:
            key = t
        out[key] = out.get(key, 0) + mult
    return out


def listing_payload_order(tree: ViewNode, cq_free: Sequence[str]) -> tuple[str, ...]:
    """Order in which CQ-free variable values are concatenated into payload
    tuples by the relational ring (join = tuple concatenation)."""
    free = set(cq_free)
    order: list[str] = []

    def rec(node: ViewNode) -> None:
        if node.is_leaf:
            return
        for c in node.children:
            rec(c)
        for v in node.marg_vars:
            if v in free and v not in order:
                order.append(v)

    rec(tree)
    return tuple(order)


# ---------------------------------------------------------------------------
# Factorized representation (device; Example 7.6)
# ---------------------------------------------------------------------------
def make_factorized_engine(
    relations: Mapping[str, tuple[str, ...]],
    db_mult: Mapping[str, object],
    var_order: VariableOrder,
    domains: Mapping[str, int],
    updatable: tuple[str, ...] | None = None,
    device="cuda",
    **build_kwargs,
):
    """Count-ring engine on ``device`` that additionally maintains the
    pre-marginalization views W@X (the factorized representation).  See
    ``IVMEngine.build(premarg=True)``.  ``db_mult`` holds each relation's
    multiplicities (numpy arrays or tensors); ``build_kwargs`` pass through
    to :meth:`IVMEngine.build`.
    """
    from ..ivm import IVMEngine

    dev = resolve_device(device)
    ring = count_ring(torch.float32)
    q = Query(relations=relations, free_vars=(), ring=ring, domains=domains)
    def mult(x) -> torch.Tensor:
        t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
        return t.to(device=dev, dtype=torch.float32)

    db = {name: make_base_relation(tuple(sch), ring, {"v": mult(db_mult[name])})
          for name, sch in relations.items()}
    eng = IVMEngine.build(
        q, db, updatable=updatable, var_order=var_order, strategy="fivm",
        fuse_chains=False, premarg=True, device=dev, **build_kwargs,
    )
    return eng, q


def factorized_payloads_from_engine(eng) -> dict[str, dict[tuple, dict]]:
    """Convert maintained W views into {view: {key: {value: mult}}} (host;
    one device-to-host copy a W view)."""
    out: dict[str, dict[tuple, dict]] = {}
    for node in eng.tree.walk():
        wname = f"W:{node.name}"
        if wname not in eng.views:
            continue
        W = as_dense(eng.views[wname])
        arr = W.payload_sync()["v"]
        var_axis = W.schema.index(node.marg_vars[0])
        key_axes = [i for i in range(len(W.schema)) if i != var_axis]
        view: dict[tuple, dict] = {}
        nz = np.argwhere(arr != 0)
        for coord in nz:
            key = tuple(int(coord[i]) for i in key_axes)
            val = int(coord[var_axis])
            view.setdefault(key, {})[val] = float(arr[tuple(coord)])
        out[node.name] = view
    return out


def enumerate_factorized(
    tree: ViewNode,
    payloads: Mapping[str, Mapping[tuple, Mapping]],
    cq_free: Sequence[str],
) -> set[tuple]:
    """Enumerate the distinct result tuples over ``cq_free`` (in that order)
    by descending the view tree and choosing values for each marginalized
    variable from the stored distributions (Example 7.6)."""
    out: set[tuple] = set()

    def rec(node: ViewNode, ctx: dict[str, int]) -> list[dict[str, int]]:
        if node.is_leaf:
            return [dict(ctx)]
        if len(node.marg_vars) != 1:
            raise ValueError("build factorized trees with fuse_chains=False")
        var = node.marg_vars[0]
        key = tuple(ctx[v] for v in node.schema)
        dist = payloads.get(node.name, {}).get(key, {})
        results: list[dict[str, int]] = []
        for val in dist:
            bound = dict(ctx, **{var: val})
            partial = [bound]
            for c in node.children:
                nxt: list[dict[str, int]] = []
                for b in partial:
                    nxt.extend(rec(c, b))
                partial = nxt
            results.extend(partial)
        return results

    for binding in rec(tree, {}):
        out.add(tuple(binding[v] for v in cq_free))
    return out


# ---------------------------------------------------------------------------
# Size accounting (Fig. 13)
# ---------------------------------------------------------------------------
def factorized_cells(payloads: Mapping[str, Mapping[tuple, Mapping]]) -> int:
    return sum(len(dist) for view in payloads.values() for dist in view.values())


def listing_cells(result: Mapping[tuple, int], arity: int) -> int:
    return len(result) * max(arity, 1)
