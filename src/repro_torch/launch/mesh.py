"""Mesh descriptions for the trainer (port of ``repro.launch.mesh``).

The port trains on one card: ``make_smoke_mesh`` is a one-rank mesh with
the production axis names ("data", "model"), which ``dp_axes``, ``dp_size``
and ``tp_size`` read as the reference's functions read a ``jax`` mesh.  The
production meshes (16 × 16 and 2 × 16 × 16 ranks) wait for item 20's
``launch/`` part, on ``core/shard.py``'s groups.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class TrainMesh:
    """Axis names and the ranks along each."""

    axis_names: tuple
    shape: dict


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(
        "the production training meshes are not ported yet (ROADMAP Queue 1 "
        "item 20, the launch/ part)")


def make_smoke_mesh() -> TrainMesh:
    """One rank, with the production axis names."""
    return TrainMesh(("data", "model"), {"data": 1, "model": 1})


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh (pod folds into DP)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def dp_size(mesh) -> int:
    return int(math.prod(mesh.shape[a] for a in dp_axes(mesh)))


def tp_size(mesh) -> int:
    return int(mesh.shape.get("model", 1))
