"""Model-layer primitives and the parameter-spec machinery (port of
``repro.models.layers``).

Every parameter is declared as a ``P`` spec leaf: shape, logical axes and
init kind.  The spec tree fixes the init scales (``init_from_spec``, drawn
from an explicit ``torch.Generator`` on the target device) and the
parameter count.  The reference maps logical axes to a device mesh; the
port runs on one card, so it has no sharding constraints (the reference's
``shd`` is the identity here and is dropped).

The numeric primitives compute as the reference does: ``rms_norm``, the
SiLU of ``swiglu`` and ``apply_rope`` work in float32 and cast back to the
activation dtype; RoPE rotates interleaved pairs (``x[..., ::2]``,
``x[..., 1::2]``) with angles in float32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch
from torch import nn


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class P:
    """Parameter spec: shape, logical axes (one name per dim), init kind."""

    shape: tuple
    axes: tuple
    init: str = "normal"   # normal | zeros | ones | embed | small
    scale: float | None = None

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def iter_specs(tree, path: tuple = ()):
    """(path, leaf) pairs of a spec or tensor tree, keys in sorted order (the
    order in which ``jax.tree.flatten`` visits the reference's dicts)."""
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            yield from iter_specs(tree[key], path + (key,))
    else:
        yield path, tree


def map_tree(fn, tree):
    """The tree with every leaf replaced by ``fn(leaf)``."""
    if isinstance(tree, Mapping):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_scale(spec: P) -> float:
    """The reference's scale of a normal draw: 1/√fan_in with fan_in the
    product of all but the last dim of the (stacked) shape, so a stacked
    layer axis counts; 1.0 for "embed" and 0.01 for "small" unless the spec
    sets its own."""
    if spec.scale is not None:
        return spec.scale
    fan_in = spec.shape[0] if len(spec.shape) >= 1 else 1
    if len(spec.shape) >= 2:
        fan_in = math.prod(spec.shape[:-1])
    return {"normal": 1.0 / math.sqrt(max(fan_in, 1)), "embed": 1.0,
            "small": 0.01}[spec.init]


def init_from_spec(spec_tree, generator: torch.Generator, dtype=torch.float32):
    """A tensor tree from a spec tree, on the generator's device: each
    normal leaf is a float32 standard-normal draw times its scale, cast to
    ``dtype``; leaves are drawn in sorted-key order."""
    dev = generator.device

    def leaf(spec: P) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=dev)
        x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return x.mul_(init_scale(spec)).to(dtype)

    vals = {path: leaf(spec) for path, spec in iter_specs(spec_tree)}

    def build(tree, path=()):
        if isinstance(tree, Mapping):
            return {k: build(v, path + (k,)) for k, v in tree.items()}
        return vals[path]

    return build(spec_tree)


def count_params(spec_tree) -> int:
    return int(sum(math.prod(s.shape) for _, s in iter_specs(spec_tree)))


def stack_specs(spec_tree, n: int, axis_name: str = "layers"):
    """Prefix every spec in the tree with a stacked leading dim."""
    return map_tree(lambda s: P((n, *s.shape), (axis_name, *s.axes), s.init,
                                s.scale), spec_tree)


class Params(nn.Module):
    """A parameter tree as a module: tensors become frozen parameters, dicts
    sub-modules and lists ``nn.ModuleList``s.  ``p["wq"]`` and ``"mlp" in p``
    read as they do on the reference's dict pytree."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for name, val in tree.items():
            if isinstance(val, Mapping):
                self.add_module(name, Params(val))
            elif isinstance(val, (list, tuple)):
                self.add_module(name, nn.ModuleList(Params(v) for v in val))
            else:
                self.register_parameter(name, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def tree(self) -> dict:
        """The tensors as a nested dict (lists for module lists)."""
        out: dict = {n: p.data for n, p in self._parameters.items()}
        for n, m in self._modules.items():
            out[n] = ([sub.tree() for sub in m] if isinstance(m, nn.ModuleList)
                      else m.tree())
        return out


# ---------------------------------------------------------------------------
# Numeric primitives
# ---------------------------------------------------------------------------
def rms_norm(x, gamma, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(dt)


def swiglu(x, w_gate, w_up, w_down):
    g = x @ w_gate
    u = x @ w_up
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return h @ w_down


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: [..., T, n_heads?, head_dim]; positions broadcastable to [..., T]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)              # [hd/2]
    angles = positions.float()[..., None] * freqs               # [..., T, hd/2]
    # broadcast over any head axis between T and head_dim
    for _ in range(x.dim() - angles.dim()):
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., ::2].float(), x[..., 1::2].float()
    xr1 = x1 * cos - x2 * sin
    xr2 = x1 * sin + x2 * cos
    return torch.stack([xr1, xr2], dim=-1).reshape(x.shape).to(x.dtype)


def causal_mask(q_len: int, kv_len: int, q_offset: int = 0, device=None):
    """[q_len, kv_len] boolean mask (True = attend)."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    return k_pos <= q_pos
