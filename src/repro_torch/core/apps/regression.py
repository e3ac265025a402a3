"""Linear regression over joins from maintained cofactors (Sec. 7.2;
PyTorch port of ``repro.core.apps.regression``).

The cofactor triple (c, s, Q) over the join of the database relations is
maintained incrementally with the degree-m matrix ring; the model is then
solved on the maintained statistics in O(m²)–O(m³), independent of the
data size.

Conventions (paper footnote 1): variables X_1..X_m are indexed by the
query's ``all_vars`` order; we learn f(features) ≈ label by fixing
θ_label := −1, with an explicit bias term handled via the count c and
sums s.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from ..ivm import IVMEngine
from ..query import Query
from ..relations import DenseRelation
from ..rings import DegreeMRing
from ..storage import make_base_relation
from ..variable_orders import VariableOrder


def cofactor_query(
    relations: Mapping[str, tuple[str, ...]],
    domains: Mapping[str, int],
    domain_values: Mapping[str, object] | None = None,
    free_vars: tuple[str, ...] = (),
    dtype=torch.float32,
) -> Query:
    """Degree-m query computing (c, s, Q) over the natural join (Ex. 7.3)."""
    all_vars: list[str] = []
    for sch in relations.values():
        for v in sch:
            if v not in all_vars:
                all_vars.append(v)
    ring = DegreeMRing(len(all_vars), dtype=dtype)
    lifts = {v: ("degree", i) for i, v in enumerate(all_vars) if v not in free_vars}
    return Query(
        relations=relations,
        free_vars=free_vars,
        ring=ring,
        domains=domains,
        lifts=lifts,
        domain_values=domain_values or {},
    )


def relation_from_multiplicities(
    schema: tuple[str, ...], ring: DegreeMRing, mult: torch.Tensor
) -> DenseRelation:
    """Base relations map tuples to multiplicity · 1 (identity payload), on
    ``mult``'s device."""
    payload = ring.ones(tuple(mult.shape), device=mult.device)
    payload["c"] = mult.to(ring.dtype)
    return make_base_relation(schema, ring, payload)


def build_cofactor_engine(
    relations: Mapping[str, tuple[str, ...]],
    domains: Mapping[str, int],
    multiplicities: Mapping[str, torch.Tensor],
    var_order: VariableOrder | None = None,
    domain_values: Mapping[str, object] | None = None,
    device="cuda",
    **build_kwargs,
) -> IVMEngine:
    """Degree-m cofactor engine over multiplicity tables as one call.
    ``build_kwargs`` pass through to :meth:`IVMEngine.build`."""
    q = cofactor_query(relations, domains, domain_values=domain_values)
    db = {
        name: relation_from_multiplicities(tuple(sch), q.ring,
                                           multiplicities[name])
        for name, sch in relations.items()
    }
    return IVMEngine.build(q, db, var_order=var_order, device=device,
                           **build_kwargs)


# ---------------------------------------------------------------------------
# Learning on top of the maintained triple
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CofactorStats:
    """(c, s, Q) with an explicit homogeneous (bias) coordinate.

    Σ = [[c, sᵀ], [s, Q]]  is the (m+1)×(m+1) moment matrix of the design
    matrix extended with a constant-1 column.
    """

    c: torch.Tensor  # scalar
    s: torch.Tensor  # [m]
    Q: torch.Tensor  # [m, m]

    @property
    def m(self) -> int:
        return self.s.shape[-1]

    def sigma(self) -> torch.Tensor:
        top = torch.cat([self.c.reshape(1), self.s])[None, :]
        bot = torch.cat([self.s[:, None], self.Q], dim=1)
        return torch.cat([top, bot], dim=0)


def gradient(stats: CofactorStats, theta: torch.Tensor) -> torch.Tensor:
    """∇(½‖Mθ‖²)/c = Σθ / c  over the homogeneous coordinates."""
    return stats.sigma() @ theta / torch.clamp(stats.c, min=1.0)


def learn_linear_model(
    stats: CofactorStats,
    label: int,
    features: Sequence[int],
    lr: float = 0.1,
    steps: int = 500,
) -> torch.Tensor:
    """Batch GD on the maintained statistics (paper: θ := θ − α MᵀM θ).

    ``label``/``features`` index the query variables (0-based).  Returns the
    homogeneous parameter vector θ over [bias, *all m variables] with
    θ_label = −1 fixed and non-feature coordinates zero.  Each step is one
    (m+1)² matrix-vector product on the stats' device; Σ and the count
    clamp are formed once (the reference's scan recomputes them a step,
    the same values)."""
    m = stats.m
    sigma = stats.sigma()
    keep = np.zeros(m + 1, np.float32)
    keep[[0] + [1 + f for f in features]] = 1.0  # bias + features
    mask = torch.from_numpy(keep).to(device=sigma.device, dtype=sigma.dtype)
    theta = torch.zeros(m + 1, dtype=sigma.dtype, device=sigma.device)
    theta[1 + label] = -1.0
    denom = torch.clamp(stats.c, min=1.0)
    for _ in range(steps):
        theta = theta - lr * (sigma @ theta / denom * mask)
    return theta


def solve_linear_model(
    stats: CofactorStats, label: int, features: Sequence[int], ridge: float = 1e-6
) -> torch.Tensor:
    """Closed-form normal-equations solve over [bias, *features]; returns θ
    over [bias, *all m variables] with θ_label = −1."""
    sigma = stats.sigma()
    idx = torch.as_tensor(np.array([0] + [1 + f for f in features]),
                          device=sigma.device)
    A = sigma[idx][:, idx] + ridge * torch.eye(len(idx), dtype=sigma.dtype,
                                               device=sigma.device)
    b = sigma[idx, 1 + label]
    w = torch.linalg.solve(A, b)
    theta = torch.zeros(stats.m + 1, dtype=sigma.dtype, device=sigma.device)
    theta[idx] = w
    theta[1 + label] = -1.0
    return theta


def stats_of_result(result: DenseRelation) -> CofactorStats:
    """Extract the triple from a scalar-keyed root view."""
    p = result.payload
    m = p["s"].numel()
    return CofactorStats(c=p["c"].reshape(()), s=p["s"].reshape(-1),
                         Q=p["Q"].reshape(m, m))
