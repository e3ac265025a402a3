"""Carry databases, updates and engine state across the numpy boundary.

The port and the reference meet in numpy: a test makes its inputs with
numpy (or reads them out of the reference with ``np.asarray``) and builds
both engines from the same arrays.

``db_np`` is ``{relation: (schema, {component: np.ndarray})}``.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.relations import COOUpdate, DenseRelation, host_payload
from .device import resolve_device


def database_from_numpy(db_np: Mapping, ring, device="cuda") -> dict:
    """``{relation: DenseRelation}`` on ``device`` from numpy arrays."""
    dev = resolve_device(device)
    return {
        name: DenseRelation(tuple(schema), ring, {
            c: torch.tensor(np.asarray(arr), device=dev).to(ring.dtype)
            for c, arr in comps.items()})
        for name, (schema, comps) in db_np.items()
    }


def update_from_numpy(schema, keys, payload: Mapping, ring,
                      device="cuda") -> COOUpdate:
    """A ``COOUpdate`` on ``device``: keys [B, k] become int32, payload
    components the ring's dtype."""
    dev = resolve_device(device)
    return COOUpdate(
        tuple(schema),
        torch.tensor(np.asarray(keys).astype(np.int32), device=dev),
        {c: torch.tensor(np.asarray(v), device=dev).to(ring.dtype)
         for c, v in payload.items()})


def state_to_numpy(engine) -> dict:
    """``{"views": {name: {comp: array}}, "base": {...}}`` on the host."""
    return {
        "views": {n: host_payload(v.payload) for n, v in engine.views.items()},
        "base": {n: host_payload(v.payload) for n, v in engine.base.items()},
    }
