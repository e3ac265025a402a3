"""Query specification (Sec. 2; PyTorch port of ``repro.core.query``).

    Q[X_1..X_f] = ⊕_{X_{f+1}} ... ⊕_{X_m}  ⊗_{i∈[n]} R_i[S_i]

A query names its relations (with schemas), its free variables, the ring,
and a per-variable lifting spec.  Attribute domains are dictionary-encoded:
``domains[v]`` is the active-domain size and ``domain_values[v]`` optionally
maps dictionary ids back to numeric values (needed by value liftings).  A
query holds no device: lift relations are built on the device that asks.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from .contraction import lift_relation
from .relations import DenseRelation
from .rings import Ring

LiftSpec = tuple  # ("one",) | ("value",) | ("degree", j)


@dataclasses.dataclass
class Query:
    relations: Mapping[str, tuple[str, ...]]  # name -> schema
    free_vars: tuple[str, ...]
    ring: Ring
    domains: Mapping[str, int]
    lifts: Mapping[str, LiftSpec] = dataclasses.field(default_factory=dict)
    domain_values: Mapping[str, object] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self._lift_cache: dict[tuple, DenseRelation] = {}

    @property
    def all_vars(self) -> tuple[str, ...]:
        seen: list[str] = []
        for sch in self.relations.values():
            for v in sch:
                if v not in seen:
                    seen.append(v)
        return tuple(seen)

    def lift_spec(self, var: str) -> LiftSpec:
        return self.lifts.get(var, ("one",))

    def values_of(self, var: str, device) -> torch.Tensor:
        if var in self.domain_values:
            return torch.as_tensor(self.domain_values[var], device=device)
        return torch.arange(self.domains[var], dtype=self.ring.dtype,
                            device=device)

    def lift_rel(self, var: str, device) -> DenseRelation:
        """The lift relation g_var over var's dictionary, on ``device``."""
        key = (var, str(torch.device(device)))
        if key not in self._lift_cache:
            # owned: one [D, d] plane, which a fused chain gathers from
            # without concatenating the components
            self._lift_cache[key] = lift_relation(
                self.ring, var, self.values_of(var, device), self.lift_spec(var)
            ).owned()
        return self._lift_cache[key]
