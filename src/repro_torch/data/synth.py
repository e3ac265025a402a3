"""Synthetic databases and update streams for the port's benchmarks.

Copies of the retailer snowflake and housing star definitions and of
``synth_db`` / ``synth_low_fill_db`` / ``update_stream`` from
``benchmarks/common.py``: the same numpy calls in the same order, so one
seed gives the same arrays as the reference.  Tensors are made on
``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.relations import COOUpdate, DenseRelation
from ..core.variable_orders import chain
from ..device import resolve_device

# ---------------------------------------------------------------------------
# Retailer-like snowflake (scaled-down dictionary domains)
# ---------------------------------------------------------------------------
RETAILER_RELATIONS = {
    "Inventory": ("locn", "dateid", "ksn", "units"),
    "Item": ("ksn", "cat", "price"),
    "Weather": ("locn", "dateid", "temp"),
    "Location": ("locn", "zip", "rgn"),
    "Census": ("zip", "pop"),
}
RETAILER_DOMS = dict(locn=24, dateid=24, ksn=32, units=8, cat=6, price=8,
                     temp=8, zip=12, rgn=4, pop=8)
RETAILER_DOMS_BIG = dict(locn=96, dateid=96, ksn=128, units=8, cat=6, price=8,
                         temp=8, zip=32, rgn=4, pop=8)


def retailer_vo():
    """Paper Sec. 8.1: join variables ordered locn { dateid { ksn }, zip };
    each relation's own variables hang below its lowest join variable."""
    return chain(
        ["locn", "dateid", "ksn"],
        {"locn": [["zip"]],
         "zip": [["rgn"], ["pop"]],
         "dateid": [["temp"]],
         "ksn": [["units"], ["cat", "price"]]},
    )


# ---------------------------------------------------------------------------
# Housing-like star schema (join on postcode)
# ---------------------------------------------------------------------------
HOUSING_RELATIONS = {
    "House": ("pc", "h1", "h2"),
    "Shop": ("pc", "s1"),
    "Institution": ("pc", "i1"),
    "Restaurant": ("pc", "r1"),
    "Demographics": ("pc", "d1"),
    "Transport": ("pc", "t1"),
}
HOUSING_DOMS = dict(pc=4096, h1=8, h2=8, s1=8, i1=8, r1=8, d1=8, t1=8)
#: the reference's sparse-view scale: 65,536 postcodes, of which a low-fill
#: database (:func:`synth_low_fill_db`) makes a few hundred active
HOUSING_DOMS_BIG = dict(pc=65536, h1=8, h2=8, s1=8, i1=8, r1=8, d1=8, t1=8)


def housing_vo():
    return chain(["pc"], {"pc": [["h1", "h2"], ["s1"], ["i1"], ["r1"],
                                 ["d1"], ["t1"]]})


#: the triangle query of Sec. 6 / Fig. 11 (``benchmarks/bench_triangle.py``)
TRIANGLE_RELATIONS = {"R": ("A", "B"), "S": ("B", "C"), "T": ("C", "A")}


def triangle_vo():
    return chain(["A", "B", "C"])


# ---------------------------------------------------------------------------
# Database + update-stream synthesis
# ---------------------------------------------------------------------------
def synth_db(relations, doms, ring, rng, density=0.3, scale=1.0,
             device="cuda"):
    """0/1 multiplicity tables per relation (in ``c`` for the degree-m
    ring), drawn from ``rng``."""
    dev = resolve_device(device)
    db = {}
    for name, sch in relations.items():
        shape = tuple(doms[v] for v in sch)
        mult = (rng.random(size=shape) < density * scale).astype(np.float32)
        if set(ring.components) == {"v"}:
            db[name] = DenseRelation(tuple(sch), ring,
                                     {"v": torch.as_tensor(mult, device=dev)})
        else:  # degree-m ring: multiplicity in c
            payload = ring.ones(shape, device=dev)
            payload["c"] = torch.as_tensor(mult, device=dev)
            db[name] = DenseRelation(tuple(sch), ring, payload)
    return db


def _relation(sch, ring, mult: np.ndarray, dev) -> DenseRelation:
    """0/1 multiplicities as a base relation: ``v`` for a scalar ring, the
    multiplicity in ``c`` of the ring's one otherwise (degree-m rings)."""
    if set(ring.components) == {"v"}:
        return DenseRelation(tuple(sch), ring,
                             {"v": torch.as_tensor(mult, device=dev)})
    payload = ring.ones(mult.shape, device=dev)
    payload["c"] = torch.as_tensor(mult, device=dev)
    return DenseRelation(tuple(sch), ring, payload)


def synth_low_fill_db(relations, doms, ring, rng, wide_var: str,
                      n_active: int, rows_per_key: int = 8, device="cuda"):
    """Database whose ``wide_var`` dictionary is mostly inactive: every
    relation's rows land on a shared pool of ``n_active`` values, so views
    keyed on ``wide_var`` have fill ``n_active / D`` (the housing
    ``pc = 65,536`` sparse-view scenario).  Returns ``(db, active values)``
    (numpy)."""
    dev = resolve_device(device)
    active = np.sort(rng.choice(doms[wide_var], size=n_active, replace=False))
    db = {}
    for name, sch in relations.items():
        shape = tuple(doms[v] for v in sch)
        mult = np.zeros(shape, np.float32)
        n_rows = n_active * rows_per_key
        cols = [rng.choice(active, size=n_rows) if v == wide_var
                else rng.integers(0, doms[v], size=n_rows) for v in sch]
        np.add.at(mult, tuple(cols), 1.0)
        mult = np.minimum(mult, 1.0)  # 0/1 multiplicities
        db[name] = _relation(sch, ring, mult, dev)
    return db, active


def update_stream(relations, doms, ring, rng, batch: int, n_batches: int,
                  key_pools=None, device="cuda"):
    """Round-robin batched inserts/deletes over all relations (Sec. 8.1).

    ``key_pools`` optionally maps a variable to the array of values its
    update keys are drawn from.  Returns ``[(relation, COOUpdate), ...]``."""
    dev = resolve_device(device)
    names = list(relations)
    out = []
    for i in range(n_batches):
        rel = names[i % len(names)]
        sch = relations[rel]
        keys = np.stack(
            [rng.choice(key_pools[v], size=batch)
             if key_pools and v in key_pools
             else rng.integers(0, doms[v], size=batch) for v in sch],
            axis=1).astype(np.int32)
        vals = rng.choice([-1.0, 1.0, 1.0, 1.0], size=batch).astype(np.float32)
        if set(ring.components) == {"v"}:
            payload = {"v": torch.as_tensor(vals, device=dev)}
        else:
            payload = {**ring.zeros((batch,), device=dev),
                       "c": torch.as_tensor(vals, device=dev)}
        out.append((rel, COOUpdate(tuple(sch), torch.as_tensor(keys, device=dev),
                                   payload)))
    return out


def distinct_key_stream(relations, doms, ring, rng, batches, device="cuda"):
    """Round-robin batches like :func:`update_stream` (payload c ∈ {−1, +1,
    +1, +1}), of the sizes ``batches`` lists, each batch's keys drawn
    without replacement from its relation's key grid: indicator
    maintenance reads each row's old payload once, so its batches must
    not repeat a key.  Returns ``[(relation, COOUpdate), ...]``."""
    dev = resolve_device(device)
    names = list(relations)
    out = []
    for i, batch in enumerate(batches):
        rel = names[i % len(names)]
        sch = relations[rel]
        shape = tuple(doms[v] for v in sch)
        flat = rng.choice(int(np.prod(shape)), size=batch, replace=False)
        keys = np.stack(np.unravel_index(flat, shape), axis=1).astype(np.int32)
        vals = rng.choice([-1.0, 1.0, 1.0, 1.0], size=batch).astype(np.float32)
        if set(ring.components) == {"v"}:
            payload = {"v": torch.as_tensor(vals, device=dev)}
        else:
            payload = {**ring.zeros((batch,), device=dev),
                       "c": torch.as_tensor(vals, device=dev)}
        out.append((rel, COOUpdate(tuple(sch), torch.as_tensor(keys, device=dev),
                                   payload)))
    return out
