"""Streaming feature statistics in the degree-m ring (port of
``repro.data.stats``).

Maintains the compound aggregate (c, s, Q) — count, per-feature sums and
the cofactor matrix — over a stream of feature rows, one batch at a time,
as in §7.2 of the paper.  It drives input normalization (running mean and
variance from c and s), correlations from Q, a drift monitor and ridge
regression on any subset of the features.  Deletions are negative weights
(the ring's additive inverse).

Each batch goes through ``kernels.ops.cofactor_update``: the CUDA kernel
for a state on the card, the plain version for a state on the CPU.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from ..kernels import ops


@dataclasses.dataclass
class RunningCofactor:
    """(c, s, Q) over m features, tensors on one device."""

    c: torch.Tensor  # 0-d
    s: torch.Tensor  # [m]
    Q: torch.Tensor  # [m, m]

    @classmethod
    def init(cls, m: int, dtype=torch.float32, device="cuda") -> "RunningCofactor":
        dev = resolve_device(device)
        return cls(torch.zeros((), dtype=dtype, device=dev),
                   torch.zeros((m,), dtype=dtype, device=dev),
                   torch.zeros((m, m), dtype=dtype, device=dev))

    def update(self, x, weights=None) -> "RunningCofactor":
        """A new state with the rows x [B, m] added, each with its weight
        (+1 insert, -1 delete; default all +1)."""
        x = torch.as_tensor(x, device=self.c.device)
        w = (weights if weights is not None
             else torch.ones(x.shape[0], dtype=x.dtype, device=x.device))
        c, s, Q = ops.cofactor_update(x, w)
        return RunningCofactor(self.c + c[0], self.s + s, self.Q + Q)

    # -- derived statistics -------------------------------------------------
    def mean(self) -> torch.Tensor:
        return self.s / self.c.clamp(min=1.0)

    def variance(self) -> torch.Tensor:
        mu = self.mean()
        return torch.diagonal(self.Q) / self.c.clamp(min=1.0) - mu * mu

    def covariance(self) -> torch.Tensor:
        mu = self.mean()
        return self.Q / self.c.clamp(min=1.0) - torch.outer(mu, mu)

    def correlation(self) -> torch.Tensor:
        cov = self.covariance()
        sd = torch.sqrt(torch.diagonal(cov).clamp(min=1e-12))
        return cov / torch.outer(sd, sd)

    def normalizer(self):
        """(mean, std) for input normalization of the training stream."""
        return self.mean(), torch.sqrt(self.variance().clamp(min=1e-12))

    def drift_score(self, other: "RunningCofactor") -> torch.Tensor:
        """Correlation-structure drift against a baseline window: the
        Frobenius distance of the two correlation matrices."""
        return torch.linalg.norm(self.correlation() - other.correlation())


def solve_ridge(stats: RunningCofactor, label_idx: int, feature_idx,
                reg: float = 1e-3) -> torch.Tensor:
    """Closed-form ridge regression of feature ``label_idx`` on
    ``feature_idx`` from the one maintained Q (§8.4: any subset of the
    variables): solve (Q[f, f] + reg·I) θ = Q[f, label]."""
    f = torch.as_tensor(feature_idx, dtype=torch.long, device=stats.Q.device)
    eye = torch.eye(f.shape[0], dtype=stats.Q.dtype, device=stats.Q.device)
    A = stats.Q[f][:, f] + reg * eye
    return torch.linalg.solve(A, stats.Q[f, label_idx])
