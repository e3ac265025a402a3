"""Optimizers (port of ``repro.optim.optimizers``): pure functions on tensor
trees, not ``torch.optim``.

A parameter tree is nested dicts (and lists) of tensors, the reference's
pytree layout; every state tree mirrors it, so that the reference's step
arithmetic holds leaf for leaf: each leaf is upcast to float32, updated and
cast back to its dtype (a bf16 parameter takes one rounding a step), and
moments stay float32.  ``update`` returns new trees and leaves its inputs
as they were.  The step counter is a 0-d int32 tensor on the parameters'
device and the schedules read it there, so an update never waits on the
device.

  * ``sgd``: plain or with momentum (float32 ``mu``).
  * ``adamw``: float32 moments, b2 0.95, the gradient clipped to global
    norm 1.0 first, weight decay on every leaf.
  * ``adafactor``: factored second moments (row and column statistics) for
    leaves whose last two dims are both >= ``min_dim_size_to_factor``, a
    full float32 slot otherwise; the update is clipped by its RMS.
    ``block_leading_axis`` runs the update slice by slice over the leading
    axis of a stacked leaf (each slice clipped by its own RMS, as the
    reference's ``lax.scan`` does).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, NamedTuple

import torch
from torch.utils import _pytree as pytree

Params = Any
State = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """(init, update) pair. ``update`` returns (new_params, new_state)."""

    init: Callable[[Params], State]
    update: Callable[..., tuple]
    name: str = "optimizer"


def zip_map(fn, tree, *others):
    """``fn(leaf, *other_leaves)`` over the leaves of ``tree`` (dicts, lists
    and tuples of tensors); each tree of ``others`` mirrors ``tree`` down to
    its leaves, where it may hold anything (a slot, a dict, None)."""
    if isinstance(tree, Mapping):
        return {k: zip_map(fn, tree[k], *(o[k] for o in others)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(zip_map(fn, *parts) for parts in zip(tree, *others))
    return fn(tree, *others)


def unzip(tree, outs, n: int) -> list:
    """The ``n`` trees of ``outs`` (a ``zip_map`` over ``tree`` whose leaves
    are n-tuples)."""
    return [zip_map(lambda _, o, i=i: o[i], tree, outs) for i in range(n)]


def _device(params) -> torch.device:
    return pytree.tree_leaves(params)[0].device


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_device(params))


def _lr_fn(lr):
    if callable(lr):
        return lr
    return lambda step: torch.full((), lr, dtype=torch.float32, device=step.device)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in pytree.tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return pytree.tree_map(lambda g: g * scale.to(g.dtype), tree), norm


# ---------------------------------------------------------------------------
# SGD (momentum optional)
# ---------------------------------------------------------------------------
def sgd(lr, momentum: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        if momentum == 0.0:
            return {"step": _step0(params)}
        return {"mu": pytree.tree_map(
                    lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params),
                "step": _step0(params)}

    def update(params, state, grads, _step=None):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        if momentum == 0.0:
            new = zip_map(lambda p, g: (p.to(torch.float32) - lr_t * g.to(torch.float32)
                                        ).to(p.dtype), params, grads)
            return new, {"step": step}
        mu = zip_map(lambda m, g: momentum * m + g.to(torch.float32), state["mu"], grads)
        new = zip_map(lambda p, m: (p.to(torch.float32) - lr_t * m).to(p.dtype), params, mu)
        return new, {"mu": mu, "step": step}

    return Optimizer(init, update, name="sgd")


# ---------------------------------------------------------------------------
# AdamW: float32 moments
# ---------------------------------------------------------------------------
def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm: float | None = 1.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return {"m": pytree.tree_map(zeros, params), "step": _step0(params),
                "v": pytree.tree_map(zeros, params)}

    def update(params, state, grads, _step=None):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        step = state["step"] + 1
        lr_t = lr_fn(step)
        c1 = 1.0 - b1 ** step.to(torch.float32)
        c2 = 1.0 - b2 ** step.to(torch.float32)

        def upd(p, g, m, v):
            g = g.to(torch.float32)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mh = m / c1
            vh = v / c2
            step_ = mh / (torch.sqrt(vh) + eps) + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr_t * step_).to(p.dtype), m, v

        new_p, m, v = unzip(params, zip_map(upd, params, grads, state["m"], state["v"]), 3)
        return new_p, {"m": m, "step": step, "v": v}

    return Optimizer(init, update, name="adamw")


# ---------------------------------------------------------------------------
# Adafactor: factored second moments (Shazeer & Stern 2018)
# ---------------------------------------------------------------------------
class FactoredSlot(NamedTuple):
    vr: torch.Tensor  # row statistics  [..., r]
    vc: torch.Tensor  # col statistics  [..., c]


def adafactor(lr, decay: float = 0.8, eps: float = 1e-30, clip_threshold: float = 1.0,
              weight_decay: float = 0.0, min_dim_size_to_factor: int = 128,
              block_leading_axis: bool = False) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def _factored(p) -> bool:
        return (p.dim() >= 2 and p.shape[-1] >= min_dim_size_to_factor
                and p.shape[-2] >= min_dim_size_to_factor)

    def init(params):
        def slot(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p):
                return FactoredSlot(vr=torch.zeros(p.shape[:-1], **f32),
                                    vc=torch.zeros(p.shape[:-2] + p.shape[-1:], **f32))
            return torch.zeros(p.shape, **f32)

        return {"step": _step0(params), "v": pytree.tree_map(slot, params)}

    def update(params, state, grads, _step=None):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        beta = 1.0 - step.to(torch.float32) ** (-decay)

        def upd(p, g, v):
            g = g.to(torch.float32)
            g2 = g * g + eps
            if isinstance(v, FactoredSlot):
                vr = beta * v.vr + (1 - beta) * g2.mean(dim=-1)
                vc = beta * v.vc + (1 - beta) * g2.mean(dim=-2)
                # rank-1 reconstruction of the second moment
                denom = vr.mean(dim=-1, keepdim=True)
                r = (vr / torch.clamp(denom, min=eps))[..., :, None]
                c = vc[..., None, :]
                u = g * torch.rsqrt(torch.clamp(r * c, min=eps))
                new_v = FactoredSlot(vr=vr, vc=vc)
            else:
                vf = beta * v + (1 - beta) * g2
                u = g * torch.rsqrt(torch.clamp(vf, min=eps))
                new_v = vf
            rms_u = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            pf = p.to(torch.float32)
            if weight_decay:
                u = u + weight_decay * pf
            return (pf - lr_t * u).to(p.dtype), new_v

        def upd_leaf(p, g, v):
            if block_leading_axis and p.dim() >= 3 and p.shape[0] > 4:
                parts = [upd(p[i], g[i], FactoredSlot(v.vr[i], v.vc[i])
                             if isinstance(v, FactoredSlot) else v[i])
                         for i in range(p.shape[0])]
                new_v = [s for _, s in parts]
                return torch.stack([q for q, _ in parts]), (
                    FactoredSlot(torch.stack([s.vr for s in new_v]),
                                 torch.stack([s.vc for s in new_v]))
                    if isinstance(v, FactoredSlot) else torch.stack(new_v))
            return upd(p, g, v)

        new_p, new_v = unzip(params, zip_map(upd_leaf, params, grads, state["v"]), 2)
        return new_p, {"step": step, "v": new_v}

    return Optimizer(init, update, name="adafactor")


def make_optimizer(name: str, lr, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    if name == "sgd":
        return sgd(lr, **kw)
    raise ValueError(name)
