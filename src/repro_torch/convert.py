"""Carry databases, updates and engine state across the numpy boundary.

The port and the reference meet in numpy: a test makes its inputs with
numpy (or reads them out of the reference with ``np.asarray``) and builds
both engines from the same arrays.

``db_np`` is ``{relation: (schema, {component: np.ndarray})}``.  An LM's
parameters are the reference's pytree on both sides: nested dicts, block
parameters stacked over layer periods (``"layers"/"sub0"/"attn"/"wq"`` is
[n_periods, d, H, hd]).  They, and the rest of a training state (optimizer
states, compression states), cross leaf for leaf with ``tree_from_numpy``
/ ``tree_to_numpy``.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.relations import (COOUpdate, DenseRelation, FactorizedUpdate,
                             host_payload)
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


def factorized_update_from_numpy(schema, factors, ring,
                                 device="cuda") -> FactorizedUpdate:
    """A ``FactorizedUpdate`` on ``device`` from ``factors``, a sequence of
    ``(schema, {component: np.ndarray})`` pairs (or relations whose
    payloads numpy can read, such as the reference's), each component in
    the ring's dtype."""
    dev = resolve_device(device)
    out = []
    for f in factors:
        f_schema, comps = (f if isinstance(f, tuple)
                           else (f.schema, f.payload))
        out.append(DenseRelation(tuple(f_schema), ring, {
            c: torch.tensor(np.asarray(v), device=dev).to(ring.dtype)
            for c, v in comps.items()}))
    return FactorizedUpdate(tuple(schema), tuple(out))


def state_to_numpy(engine) -> dict:
    """``{"views": {name: {comp: array}}, "base": {...}, "indicators":
    {node: {"counts": array, "dense": {comp: array}}}}`` on the host."""
    return {
        "views": {n: host_payload(v.payload) for n, v in engine.views.items()},
        "base": {n: host_payload(v.payload) for n, v in engine.base.items()},
        "indicators": {n: {"counts": ind.counts.cpu().numpy(),
                           "dense": host_payload(ind.dense.payload)}
                       for n, ind in engine.indicators.items()},
    }


def indicator_from_numpy(rel_name: str, proj, counts, dense: Mapping, ring,
                         device="cuda"):
    """A ``core.indicators.IndicatorState`` on ``device`` from numpy: the
    int32 ``counts`` over ``proj`` and the 0/1 plane's ``{comp: array}``
    (the reference's ``IndicatorState`` read out with ``np.asarray``)."""
    from .core.indicators import IndicatorState

    dev = resolve_device(device)
    plane = DenseRelation(tuple(proj), ring, {
        c: torch.tensor(np.asarray(arr), device=dev).to(ring.dtype)
        for c, arr in dense.items()}).owned()
    counts = torch.tensor(np.asarray(counts), device=dev).to(torch.int32)
    return IndicatorState(rel_name, tuple(proj), counts.contiguous(), plane)


def running_cofactor_from_numpy(c, s, Q, device="cuda"):
    """A ``data.stats.RunningCofactor`` on ``device`` from numpy (c, s, Q),
    each keeping its dtype (c may be 0-d or of shape [1])."""
    from .data.stats import RunningCofactor

    dev = resolve_device(device)
    return RunningCofactor(torch.tensor(np.asarray(c), device=dev).reshape(()),
                           torch.tensor(np.asarray(s), device=dev),
                           torch.tensor(np.asarray(Q), device=dev))


def running_cofactor_to_numpy(stats) -> tuple:
    """(c, s, Q) of a ``RunningCofactor`` as numpy arrays on the host."""
    return tuple(t.detach().cpu().numpy() for t in (stats.c, stats.s, stats.Q))


def _tensor_from_numpy(arr, device) -> torch.Tensor:
    """A tensor on ``device`` with the array's dtype; bfloat16 arrays (which
    numpy holds as an extension dtype) go through float32, exactly."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.tensor(arr, device=device)


def tree_from_numpy(tree, device="cuda"):
    """A training-state tree on ``device`` from the reference's tree with
    numpy (or array-like) leaves, as ``jax.tree.map(np.asarray, ...)``
    gives it: parameters in the reference's layout, an optimizer's state
    (sgd, adamw, adafactor: an adafactor slot, the reference's
    ``_FactoredSlot``, becomes ``optim.optimizers.FactoredSlot``) or a
    compression state (None for a leaf that is not compressed).  Dict keys
    come out sorted, as ``jax.tree.flatten`` visits them; each leaf keeps
    its dtype (bfloat16 through float32, exactly)."""
    from .optim.optimizers import FactoredSlot

    dev = resolve_device(device)

    def conv(x):
        if x is None:
            return None
        if isinstance(x, Mapping):
            return {k: conv(x[k]) for k in sorted(x)}
        if isinstance(x, tuple) and getattr(x, "_fields", None) == ("vr", "vc"):
            return FactoredSlot(conv(x.vr), conv(x.vc))
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return _tensor_from_numpy(x, dev)

    return conv(tree)


def tree_to_numpy(tree):
    """``tree_from_numpy``'s inverse: numpy leaves on the host (bfloat16 as
    float32, exactly), ``FactoredSlot``s of numpy arrays, None kept."""
    def conv(x):
        if x is None:
            return None
        if isinstance(x, Mapping):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(conv(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        t = x.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return conv(tree)
