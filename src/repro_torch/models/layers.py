"""Model-layer primitives and the parameter-spec machinery (port of
``repro.models.layers``).

Every parameter is declared as a ``P`` spec leaf: shape, logical axes and
init kind.  The spec tree fixes the init scales (``init_from_spec``, drawn
from an explicit ``torch.Generator`` on the target device) and the
parameter count.  The reference maps logical axes to a device mesh; the
port runs on one card, so it has no sharding constraints (the reference's
``shd`` is the identity here and is dropped).

The numeric primitives compute as the reference does: ``rms_norm``, the
SiLU of ``swiglu`` and ``apply_rope`` work in float32 (float64 inputs, which
the reference never sees, stay float64: the float64 oracles of
``chip_smoke.py``) and cast back to the activation dtype; RoPE rotates
interleaved pairs (``x[..., ::2]``, ``x[..., 1::2]``) with angles in
float32.  ``softmax_cross_entropy`` is the padded-vocab cross entropy of
the training loss.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch


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


def sort_tree(tree):
    """The tree with every dict's keys in sorted order, so that
    ``torch.utils._pytree`` (which keeps insertion order) flattens it in
    the order ``jax.tree.flatten`` visits the reference's."""
    if isinstance(tree, Mapping):
        return {k: sort_tree(tree[k]) for k in sorted(tree)}
    return tree


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


#: the most elements one float32 draw of ``init_from_spec`` takes (a
#: leading-axis slice of a leaf larger than this is drawn alone)
INIT_DRAW_ELEMS = 1 << 27


def init_from_spec(spec_tree, generator: torch.Generator, dtype=torch.float32):
    """A tensor tree from a spec tree, on the generator's device: each
    normal leaf is float32 standard-normal draws times its scale, cast to
    ``dtype``; leaves are drawn in sorted-key order, each in blocks of
    leading-axis slices (at most INIT_DRAW_ELEMS elements a block, or one
    slice), written into the leaf in ``dtype``: no float32 copy of a whole
    leaf exists (a stacked expert leaf of a full MoE config is 8.9 G
    elements)."""
    dev = generator.device

    def leaf(spec: P) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=dev)
        out = torch.empty(spec.shape, dtype=dtype, device=dev)
        flat = out.view(-1, *spec.shape[1:])
        rows = max(1, INIT_DRAW_ELEMS // math.prod(spec.shape[1:]))
        for lo in range(0, flat.shape[0], rows):
            part = flat[lo:lo + rows]
            # unnamed, so that it is freed before the next block's draw
            part.copy_(torch.randn(part.shape, generator=generator, dtype=torch.float32,
                                   device=dev).mul_(init_scale(spec)))
        return out

    vals = {path: leaf(spec) for path, spec in iter_specs(spec_tree)}
    return _tree_of(spec_tree, vals)


def _tree_of(tree, vals: dict, path: tuple = ()):
    """``tree`` with each leaf replaced by ``vals[its path]`` (a function of
    the module, not a recursive closure: a closure's cycle would keep the
    leaves alive after the caller drops them, until the collector runs)."""
    if isinstance(tree, Mapping):
        return {k: _tree_of(v, vals, path + (k,)) for k, v in tree.items()}
    return vals[path]


def count_params(spec_tree) -> int:
    return int(sum(math.prod(s.shape) for _, s in iter_specs(spec_tree)))


def stack_specs(spec_tree, n: int, axis_name: str = "layers"):
    """Prefix every spec in the tree with a stacked leading dim."""
    return map_tree(lambda s: P((n, *s.shape), (axis_name, *s.axes), s.init,
                                s.scale), spec_tree)


# ---------------------------------------------------------------------------
# Numeric primitives
# ---------------------------------------------------------------------------
def at_least_f32(x):
    """x in float32, or as it is when its dtype is wider (float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rms_norm(x, gamma, eps: float = 1e-5):
    dt = x.dtype
    xf = at_least_f32(x)
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * at_least_f32(gamma)).to(dt)


def swiglu(x, w_gate, w_up, w_down):
    g = x @ w_gate
    u = x @ w_up
    h = torch.nn.functional.silu(at_least_f32(g)).to(x.dtype) * u
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
    x1, x2 = at_least_f32(x[..., ::2]), at_least_f32(x[..., 1::2])
    xr1 = x1 * cos - x2 * sin
    xr2 = x1 * sin + x2 * cos
    return torch.stack([xr1, xr2], dim=-1).reshape(x.shape).to(x.dtype)


def causal_mask(q_len: int, kv_len: int, q_offset: int = 0, device=None):
    """[q_len, kv_len] boolean mask (True = attend)."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    return k_pos <= q_pos


def prefix_lm_mask(q_len: int, kv_len: int, prefix_len: int, device=None):
    """[q_len, kv_len] boolean mask: the first ``prefix_len`` positions
    attend to each other both ways, the rest is causal."""
    q_pos = torch.arange(q_len, device=device)[:, None]
    k_pos = torch.arange(kv_len, device=device)[None, :]
    return causal_mask(q_len, kv_len, device=device) | ((q_pos < prefix_len)
                                                        & (k_pos < prefix_len))


# ---------------------------------------------------------------------------
# Cross entropy (padded-vocab aware)
# ---------------------------------------------------------------------------
def softmax_cross_entropy(logits, labels, vocab_size: int):
    """logits [..., Vp] (taken in float32); labels int [...] -> the
    per-position loss logsumexp − logit[label].  Columns ``>= vocab_size``
    are padding: set to -1e30 before the logsumexp.  A negative label (a
    masked position, which the caller weighs 0) reads column 0."""
    vp = logits.shape[-1]
    logits = at_least_f32(logits)
    if vp > vocab_size:
        pad = torch.arange(vp, device=logits.device) >= vocab_size
        logits = torch.where(pad, -1e30, logits)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long().clamp(min=0)[..., None])[..., 0]
    return lse - ll
