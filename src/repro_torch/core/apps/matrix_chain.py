"""Incremental matrix chain multiplication (Sec. 7.1; generalizes LINVIEW;
PyTorch port of ``repro.core.apps.matrix_chain``).

A matrix A_i of size p_i × p_{i+1} is a relation A_i[X_i, X_{i+1}] over the
scalar ring whose dense payload *is* the matrix.  The chain product is the
query

    A[X_1, X_{n+1}] = ⊕_{X_2} … ⊕_{X_n} ⊗_i A_i[X_i, X_{i+1}]

evaluated over a (balanced) variable order; joins+marginalizations are
matrix products.  A rank-1 update δA_k = u vᵀ is a FactorizedUpdate (u over
X_k, v over X_{k+1}); the Optimize rule propagates it as matrix-VECTOR
products in O(p²) instead of O(p³) (Example 7.1), which on the card are
the ``matvec`` and ``outer_accumulate`` kernels (``plan.factorized_route``);
rank-r updates are sums of r rank-1 updates.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..ivm import IVMEngine
from ..query import Query
from ..relations import DenseRelation, FactorizedUpdate
from ..rings import ScalarRing, sum_ring
from ..storage import make_base_relation
from ..variable_orders import VariableOrder, VONode


def chain_query(dims: Sequence[int], dtype=torch.float32) -> Query:
    """dims = [p_1, ..., p_{n+1}] for n matrices."""
    n = len(dims) - 1
    relations = {f"A{i+1}": (f"X{i+1}", f"X{i+2}") for i in range(n)}
    domains = {f"X{i+1}": dims[i] for i in range(n + 1)}
    return Query(
        relations=relations,
        free_vars=("X1", f"X{n+1}"),
        ring=sum_ring(dtype),
        domains=domains,
        lifts={},  # inner-index lifts are g(x) = 1
    )


def balanced_order(n: int) -> VariableOrder:
    """Variable order of minimal depth: free endpoints on top, inner indices
    in a balanced binary recursion (Example 7.1 uses X1-X5-X3-{X2,X4})."""

    def rec(lo: int, hi: int) -> VONode | None:
        # inner variables X_lo..X_hi (1-based matrix indices between them)
        if lo > hi:
            return None
        mid = (lo + hi) // 2
        node = VONode(f"X{mid}")
        left = rec(lo, mid - 1)
        right = rec(mid + 1, hi)
        node.children = [c for c in (left, right) if c is not None]
        return node

    top = VONode("X1")
    second = VONode(f"X{n+1}")
    top.children = [second]
    inner = rec(2, n)
    if inner is not None:
        second.children = [inner]
    return VariableOrder([top])


def matrices_to_db(ring: ScalarRing, mats: Sequence) -> dict[str, DenseRelation]:
    """``{A_i: relation}``; tensors stay on their device, numpy arrays land
    on the CPU (``IVMEngine.build`` moves the database to its device)."""
    return {
        f"A{i+1}": make_base_relation((f"X{i+1}", f"X{i+2}"), ring,
                                      {"v": torch.as_tensor(m)})
        for i, m in enumerate(mats)
    }


def build_chain_engine(
    mats: Sequence,
    updatable: tuple[str, ...] | None = None,
    strategy: str = "fivm",
    device="cuda",
    **build_kwargs,
) -> IVMEngine:
    """The chain engine over ``mats`` (tensors or numpy arrays) on
    ``device``.  ``build_kwargs`` pass through to :meth:`IVMEngine.build`
    (storage mode / overrides: a sparse chain engine applies rank-1
    updates through the per-factor active-key lowering)."""
    mats = [torch.as_tensor(m) for m in mats]
    dims = [mats[0].shape[0]] + [m.shape[1] for m in mats]
    q = chain_query(dims, dtype=mats[0].dtype)
    vo = balanced_order(len(mats))
    db = matrices_to_db(q.ring, mats)
    return IVMEngine.build(q, db, updatable=updatable, var_order=vo,
                           strategy=strategy, device=device, **build_kwargs)


def rank1_update(k: int, u: torch.Tensor, v: torch.Tensor,
                 ring: ScalarRing) -> FactorizedUpdate:
    """δA_k = u vᵀ as a factorized update over (X_k, X_{k+1}), on u's
    device (v moves there), in the ring's dtype."""
    u = torch.as_tensor(u)
    v = torch.as_tensor(v).to(u.device)
    return FactorizedUpdate(
        (f"X{k}", f"X{k+1}"),
        (
            make_base_relation((f"X{k}",), ring, {"v": u.to(ring.dtype)}),
            make_base_relation((f"X{k+1}",), ring, {"v": v.to(ring.dtype)}),
        ),
    )


def row_update(k: int, row: int, new_minus_old: torch.Tensor, p: int,
               ring: ScalarRing) -> FactorizedUpdate:
    """Change one row of A_k: δA_k = e_row ⊗ (Δrow)."""
    new_minus_old = torch.as_tensor(new_minus_old)
    u = torch.zeros((p,), dtype=new_minus_old.dtype,
                    device=new_minus_old.device)
    u[row] = 1.0
    return rank1_update(k, u, new_minus_old, ring)


def decompose_rank_r(delta: torch.Tensor, r: int) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Low-rank decomposition of an arbitrary update matrix via SVD
    (Sec. 5: 'an arbitrary update matrix can be decomposed into a sum of
    rank-1 matrices ... using low-rank tensor decomposition methods').
    Singular vectors are unique only up to sign, so compare the terms by
    their sum, not one by one."""
    U, S, Vt = torch.linalg.svd(torch.as_tensor(delta), full_matrices=False)
    return [(U[:, i] * S[i], Vt[i, :]) for i in range(min(r, S.shape[0]))]


def result_matrix(engine: IVMEngine) -> torch.Tensor:
    """The chain product A[X_1, X_{n+1}] as a matrix."""
    res = engine.result()
    n = len(engine.query.relations)
    return res.transpose(("X1", f"X{n+1}")).payload["v"]
