"""Rank-r gradient compression with error feedback, PowerSGD-style (port of
``repro.runtime.compression``).

The paper's factorizable updates applied to data-parallel gradient sync:
instead of all-reducing a dense [n, m] gradient, each worker would reduce
the factors of a rank-r decomposition G ≈ P Qᵀ (n·r + m·r values instead of
n·m).  Error feedback keeps the compression unbiased over time: the
residual G − P Qᵀ is added to the next step's gradient before compressing.

This module is the compression operator and a wrapper that turns any
``optim.Optimizer`` into one that updates from compressed gradients.  The
state of a leaf that is compressed (2-D, at least ``min_size`` values) is
``{"err": float32 [n, m], "q": float32 [m, r]}``; any other leaf's is None.
The initial Q is drawn from an explicit ``torch.Generator`` (default seed
17 on the leaves' device), then orthonormalized; ``convert`` carries the
reference's Q across for tests.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils import _pytree as pytree

from ..optim.optimizers import Optimizer, unzip, zip_map


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    rank: int = 4
    min_size: int = 4096          # don't compress small tensors
    power_iters: int = 1


def _orthonormalize(m: torch.Tensor) -> torch.Tensor:
    q, _ = torch.linalg.qr(m)
    return q


def _compressed(p, cfg: CompressionConfig) -> bool:
    return p.dim() == 2 and p.numel() >= cfg.min_size


def compress_decompress(g: torch.Tensor, err: torch.Tensor, q_prev: torch.Tensor,
                        cfg: CompressionConfig):
    """One PowerSGD round on a single [n, m] gradient: (g_hat in g's dtype,
    the new error feedback, the new Q)."""
    gf = g.to(torch.float32) + err
    q = q_prev
    for _ in range(cfg.power_iters):
        p = _orthonormalize(gf @ q)     # [n, r]   (all-reduced in DP sync)
        q = gf.T @ p                    # [m, r]   (all-reduced in DP sync)
    g_hat = p @ q.T
    return g_hat.to(g.dtype), gf - g_hat, q


def init_compression_state(params, cfg: CompressionConfig,
                           generator: torch.Generator | None = None):
    """The state tree of ``params``: each compressed leaf's zero error and
    an orthonormalized standard-normal Q [m, rank], drawn from
    ``generator`` in the tree's leaf order."""
    if generator is None:
        leaves = pytree.tree_leaves(params)
        generator = torch.Generator(device=leaves[0].device).manual_seed(17)

    def slot(p):
        if not _compressed(p, cfg):
            return None
        q = torch.randn((p.shape[1], cfg.rank), generator=generator, dtype=torch.float32,
                        device=generator.device).to(p.device)
        return {"err": torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                "q": _orthonormalize(q)}

    return zip_map(slot, params)


def compress_grads(grads, state, cfg: CompressionConfig):
    """Rank-r compression with error feedback, leaf by leaf; a leaf whose
    state is None passes through untouched."""
    def leaf(g, s):
        if s is None:
            return g, None
        gh, err, q = compress_decompress(g, s["err"], s["q"], cfg)
        return gh, {"err": err, "q": q}

    return tuple(unzip(grads, zip_map(leaf, grads, state), 2))


def compression_ratio(params, cfg: CompressionConfig) -> float:
    """Synced values with compression / without."""
    dense = comp = 0
    for p in pytree.tree_leaves(params):
        dense += p.numel()
        comp += (p.shape[0] + p.shape[1]) * cfg.rank if _compressed(p, cfg) else p.numel()
    return comp / max(dense, 1)


def compressed_optimizer(base: Optimizer, params, cfg: CompressionConfig,
                         generator: torch.Generator | None = None) -> Optimizer:
    """``base`` updating from compressed gradients; the compression state
    (error feedback and the power-iteration Q) rides in the optimizer
    state as ``{"base", "comp"}``."""

    def init(p):
        return {"base": base.init(p), "comp": init_compression_state(p, cfg, generator)}

    def update(p, state, grads, step=None):
        grads_c, comp = compress_grads(grads, state["comp"], cfg)
        new_p, new_base = base.update(p, state["base"], grads_c, step)
        return new_p, {"base": new_base, "comp": comp}

    return Optimizer(init, update, name=f"{base.name}+powersgd{cfg.rank}")
