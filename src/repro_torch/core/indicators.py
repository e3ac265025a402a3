"""Indicator projections for cyclic queries (Sec. 6, Fig. 7; PyTorch port of
``repro.core.indicators``).

``∃_A R`` projects the non-zero keys of R onto A with payload 1.  Adding
such indicators to a view can close a cycle of relations and shrink the
view (triangle query: O(N²) → O(N) view, O(N^{3/2}) bulk maintenance).

The Fig. 7 algorithm walks the tree bottom-up; at each view it considers
relations that share variables with the view but do not occur under it, and
keeps those that are *in a cycle* with the view's children — determined by
GYO reduction (Fagin et al. variant): the residual hyperedges after
ear-removal are exactly the cyclic core.

Maintenance (Example 6.2): a count per projected key tracks how many tuples
of R project onto it; δ(∃R) is ±1 exactly when a count crosses 0↔1.  The
counts are int32 over the projection's domains and are updated in place, as
is the 0/1 plane (through ``DenseRelation.scatter_add``, the ⊎ kernel on the
card).  Nothing here reads a value on the host, so an update that bumps an
indicator is captured in a CUDA graph like any other.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils import _pytree as pytree

from .query import Query
from .relations import COOUpdate, DenseRelation
from .storage import linear_ids
from .view_tree import ViewNode


# ---------------------------------------------------------------------------
# GYO reduction
# ---------------------------------------------------------------------------
def gyo_residual(edges: list[frozenset[str]]) -> list[frozenset[str]]:
    """Run GYO ear removal; return the residual (cyclic core) hyperedges."""
    work = [set(e) for e in edges]
    changed = True
    while changed and work:
        changed = False
        for i, e in enumerate(work):
            others = [w for j, w in enumerate(work) if j != i]
            if not others:
                work = []
                changed = True
                break
            shared = e & set().union(*others)
            # isolated vertices of e can always be removed
            if shared != e:
                work[i] = shared
                changed = True
                e = shared
            if any(e <= w for w in others):
                work.pop(i)
                changed = True
                break
        work = [e for e in work if e]
    return [frozenset(e) for e in work]


def is_acyclic(edges: list[frozenset[str]]) -> bool:
    return not gyo_residual(edges)


# ---------------------------------------------------------------------------
# Fig. 7: annotate a view tree with indicator projections
# ---------------------------------------------------------------------------
def add_indicators(tree: ViewNode, query: Query) -> ViewNode:
    """Annotate ``tree`` in place (and return it): a view whose children
    close a cycle with a relation outside its subtree gets that relation's
    projection onto the children's variables as ``node.indicator``."""

    def rec(node: ViewNode) -> None:
        for c in node.children:
            rec(c)
        if node.is_leaf or len(node.children) < 2:
            return
        join_vars = set().union(*[set(c.schema) for c in node.children])
        inds = [
            r
            for r, sch in query.relations.items()
            if r not in node.rels and (set(sch) & join_vars)
        ]
        for r in inds:
            proj = tuple(v for v in query.relations[r] if v in join_vars)
            edges = [frozenset(c.schema) for c in node.children] + [frozenset(proj)]
            if frozenset(proj) in gyo_residual(edges):
                node.indicator = (r, proj)
                node.rels = node.rels | {r}
                break  # one indicator per view suffices for our workloads

    rec(tree)
    return tree


# ---------------------------------------------------------------------------
# Indicator state & maintenance
# ---------------------------------------------------------------------------
def _nonzero_over(rel: DenseRelation, proj, query: Query):
    """(non-zero mask of ``rel``, the axes outside ``proj``, ``rel``'s
    variables in ``proj`` in ``rel``'s order)."""
    nz = ~query.ring.is_zero(rel.payload)  # bool over rel.domains
    axes = tuple(i for i, v in enumerate(rel.schema) if v not in proj)
    order = tuple(v for v in rel.schema if v in proj)
    return nz, axes, order


def indicator_of(rel: DenseRelation, proj: tuple[str, ...], query: Query) -> DenseRelation:
    """∃_proj rel as a dense 0/1 relation in the query ring (recompute)."""
    ring = query.ring
    nz, axes, order = _nonzero_over(rel, proj, query)
    mask = nz.sum(dim=axes) > 0 if axes else nz
    out = ring.ones(tuple(mask.shape), device=mask.device)
    out = {c: torch.where(mask.reshape(tuple(mask.shape)
                                       + (1,) * (x.dim() - mask.dim())),
                          x, torch.zeros_like(x))
           for c, x in out.items()}
    dr = DenseRelation(order, ring, out)
    return dr.transpose(proj) if order != tuple(proj) else dr


@dataclasses.dataclass
class IndicatorState:
    """Maintained ∃_proj R: per-key tuple counts + the 0/1 dense relation.

    ``counts`` (int32, contiguous, over the projection's domains in
    ``proj`` order) and ``dense`` (one owned ``[S, d]`` plane) are the
    state the stream executor carries; both are updated in place."""

    rel_name: str
    proj: tuple[str, ...]
    counts: torch.Tensor  # int32 over proj domains
    dense: DenseRelation  # 0/1 in the query ring

    @classmethod
    def init(cls, rel_name: str, rel: DenseRelation, proj: tuple[str, ...],
             query: Query) -> "IndicatorState":
        nz, axes, order = _nonzero_over(rel, proj, query)
        counts = (nz.sum(dim=axes, dtype=torch.int32) if axes
                  else nz.to(torch.int32))
        if order != tuple(proj):
            counts = counts.permute([order.index(v) for v in proj])
        dense = indicator_of(rel, proj, query).owned()
        return cls(rel_name, tuple(proj), counts.contiguous(), dense)

    def owned(self) -> "IndicatorState":
        """A copy with counts and plane of its own."""
        return dataclasses.replace(self, counts=self.counts.clone(),
                                   dense=self.dense.owned())

    def leaves(self) -> list:
        """The state tensors: the counts, then the plane's components."""
        return [self.counts] + [self.dense.payload[c]
                                for c in sorted(self.dense.payload)]

    def delta_for_update(
        self, query: Query, upd: COOUpdate, old_payload
    ) -> tuple["IndicatorState", COOUpdate]:
        """Apply δR; return (new state, δ∃ as COO over proj with ±1 payloads).

        ``old_payload`` is R's payload at ``upd.keys`` before the update.
        (The reference takes the old relation and gathers it here; the
        port updates base relations in place, so its caller gathers before
        the base ⊎.)  The counts and the plane are updated in place.

        Counting (Example 6.2): a key's count changes when a tuple's payload
        transitions 0 -> non-0 (insert) or non-0 -> 0 (delete).

        NOTE: the batch must not contain duplicate keys (the transition test
        reads the pre-update state once per row).
        """
        ring = query.ring
        cols = [upd.schema.index(v) for v in self.proj]
        if cols == list(range(upd.keys.shape[1])):
            proj_keys = upd.keys
        else:  # column by column: a list index would copy from the host
            proj_keys = torch.stack([upd.keys[:, c] for c in cols], dim=1)
        new_payload = ring.add(old_payload, upd.payload)
        was_nz = ~ring.is_zero(old_payload)
        now_nz = ~ring.is_zero(new_payload)
        dcount = now_nz.to(torch.int32) - was_nz.to(torch.int32)  # [B]
        # one flat int32 ⊎ on the linearized key plane and two flat gathers
        # (the counts stay int32: an exact add in any order)
        ids = linear_ids(proj_keys, tuple(self.counts.shape)).long()
        counts_flat = self.counts.view(-1)
        was_pos = counts_flat[ids] > 0
        counts_flat.index_add_(0, ids, dcount)
        now_pos = counts_flat[ids] > 0
        dt = ring.dtype
        dval = now_pos.to(dt) - was_pos.to(dt)  # [B] ∈ {-1, 0, 1}
        # a row can only flip ∃ if it changed its own tuple's zero-ness; this
        # gate is a no-op for legal (duplicate-free) batches and makes
        # ring-zero padding rows (stream executor bucketing) exact no-ops
        # even when a real row in the batch flips the padded key's count
        dval = dval * (dcount != 0).to(dt)
        one = ring.ones((upd.keys.shape[0],), device=upd.keys.device)
        payload = ring.scale(one, dval)
        dense = self.dense.scatter_add(proj_keys, payload)
        state = dataclasses.replace(self, dense=dense)
        return state, COOUpdate(self.proj, proj_keys, payload)


# flattens as the reference's IndicatorState: the counts, then the plane
pytree.register_pytree_node(
    IndicatorState,
    lambda s: ([s.counts, s.dense], (s.rel_name, s.proj)),
    lambda children, ctx: IndicatorState(ctx[0], ctx[1], children[0], children[1]))
