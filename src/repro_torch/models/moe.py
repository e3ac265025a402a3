"""Mixture-of-Experts MLP with sort-based capacity dispatch (port of
``repro.models.moe``).

The token axis is split into ``dispatch_groups(T)`` groups of t tokens, all
computed in one batch (the reference's ``vmap``).  Each group gets a
capacity of C slots an expert, ``max(int(t·k/E·cf), 1)`` rounded up to a
multiple of 8.  The step is split in two:

* ``moe_route`` — the float32 router and its softmax, top-k (descending,
  ties to the lower expert, as ``jax.lax.top_k``), the renormalized weights,
  the stable sort of each group's (token, expert) slots by expert, each
  slot's position within its expert and ``keep = pos < C``.  It returns a
  ``Routing``: index maps between the token-major slots and the rows of the
  expert buffers, and the weights.
* ``moe_dispatch`` — the routed experts on a ``Routing``: tokens gathered
  into [E, G·C, d] buffers (dropped slots nowhere), one batched SwiGLU
  product a weight over all groups, the outputs gathered back to the
  slots, weighted by ``keep·p`` in the activation dtype and added per
  token in ascending expert order (the order of the reference's
  sequential scatter-add).

``moe_apply`` composes them and adds the shared experts.  The dispatch has
no accumulating scatter, forward or backward: a token's k copies are an
expand (backward: a sum over k), and every move between slots and buffer
rows is a gather by a partial bijection whose backward is the gather by
its inverse (``_Rows``).  Two calls are therefore bitwise equal on the card.

A token-major slot of token i is i·k + r, r its r-th expert in ascending
order.  Sorting a group's slots by expert is stable in the reference over
its top-k order; each token holds an expert once, so both orders sort to
(expert, token), and the slots and their positions are the reference's.
"""
from __future__ import annotations

import dataclasses

import torch

from .layers import P, at_least_f32, swiglu


def moe_specs(cfg) -> dict:
    m = cfg.moe
    d, f = cfg.d_model, m.d_expert_ff
    s = {
        "router": P((d, m.n_experts), ("embed", "experts"), init="small"),
        "w_gate": P((m.n_experts, d, f), ("experts", "embed", "expert_ff")),
        "w_up": P((m.n_experts, d, f), ("experts", "embed", "expert_ff")),
        "w_down": P((m.n_experts, f, d), ("experts", "expert_ff", "embed")),
    }
    if m.n_shared:
        fs = m.d_expert_ff * m.n_shared
        s["ws_gate"] = P((d, fs), ("embed", "mlp"))
        s["ws_up"] = P((d, fs), ("embed", "mlp"))
        s["ws_down"] = P((fs, d), ("mlp", "embed"))
    return s


def dispatch_groups(T: int, target: int = 16) -> int:
    """Largest group count ≤ target dividing T (production shapes hit 16)."""
    g = min(target, T)
    while T % g:
        g -= 1
    return g


def capacity(t: int, k: int, n_experts: int, capacity_factor: float) -> int:
    """Slots an expert in a group of t tokens, in the reference's Python
    arithmetic: ``max(int(t·k/E·cf), 1)`` padded to a multiple of 8."""
    c = max(int(t * k / n_experts * capacity_factor), 1)
    return -(-c // 8) * 8


@dataclasses.dataclass
class Routing:
    """One call's routing of T tokens, G groups of t, capacity C.

    ``experts`` [T, k]: each token's top-k experts, ascending (the
    token-major slot order); ``weights`` [T, k]: their renormalized
    probabilities (float32, or float64 for float64 inputs); ``src``
    [E·G·C]: the token-major slot each buffer row takes, T·k for none;
    ``dst`` [T·k]: the buffer row of each token-major slot, E·G·C where it
    dropped.  The buffer row of expert e, group g, position c is
    (e·G + g)·C + c."""

    groups: int
    capacity: int
    experts: torch.Tensor
    weights: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor

    @property
    def kept(self) -> torch.Tensor:
        """[T, k]: True where the token-major slot holds a buffer row (the
        reference's ``keep``, in token-major order)."""
        return (self.dst < self.src.numel()).view(self.experts.shape)


def router_probs(router, x):
    """Softmax of ``x @ router`` in float32 (float64 inputs stay float64)."""
    return torch.softmax(at_least_f32(x) @ at_least_f32(router), dim=-1)


def top_k(probs, k: int):
    """(values, indices) of the k largest along the last axis, descending,
    a tie going to the lower index (``jax.lax.top_k``'s order; a stable
    descending sort keeps equal values in index order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route_weights(probs, experts):
    """[T, k] probabilities at ``experts`` over their sum.  The selection is
    a one-hot product (each sum has one nonzero term, exact), so neither it
    nor its gradient accumulates through an index."""
    sel = torch.nn.functional.one_hot(experts, probs.shape[-1]).to(probs.dtype)
    p = (sel * probs[:, None, :]).sum(-1)
    return p / p.sum(-1, keepdim=True)


def moe_route(cfg, router, x) -> Routing:
    """The routing of x [T, d] (see the module docstring)."""
    m = cfg.moe
    T = x.shape[0]
    E, k = m.n_experts, m.top_k
    G = dispatch_groups(T)
    t = T // G
    C = capacity(t, k, E, m.capacity_factor)
    dev = x.device

    probs = router_probs(router, x)                                 # [T, E]
    experts = top_k(probs, k)[1].sort(dim=-1).values
    weights = route_weights(probs, experts)

    flat_e = experts.reshape(G, t * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)              # [G, t·k]
    sorted_e = flat_e.gather(1, order)
    start = torch.searchsorted(
        sorted_e, torch.arange(E, device=dev).expand(G, E).contiguous(), side="left")
    pos = torch.arange(t * k, device=dev) - start.gather(1, sorted_e)
    keep = pos < C

    n_rows = E * G * C
    groups = torch.arange(G, device=dev)[:, None]
    row = torch.where(keep, (sorted_e * G + groups) * C + pos, n_rows).reshape(-1)
    slot = (groups * (t * k) + order).reshape(-1)                   # token-major
    dst = torch.empty(T * k, dtype=torch.long, device=dev).scatter_(0, slot, row)
    # each kept slot writes its own row; every dropped slot writes the
    # extra last entry, which is cut off
    src = torch.full((n_rows + 1,), T * k, dtype=torch.long, device=dev).scatter_(
        0, row, slot)[:n_rows]
    return Routing(groups=G, capacity=C, experts=experts, weights=weights, src=src, dst=dst)


def _take_rows(x, idx):
    """x[idx] by rows, a zero row where idx == len(x)."""
    n = x.shape[0]
    out = x.index_select(0, idx.clamp(max=n - 1))
    return out.masked_fill_((idx == n)[:, None], 0)


class _Rows(torch.autograd.Function):
    """``_take_rows(x, fwd)`` for maps ``fwd``, ``bwd`` that are inverse
    partial bijections (x's row j is out's row bwd[j], or no row's): the
    gradient is the gather of the output's by ``bwd``, with no sum."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.save_for_backward(bwd)
        return _take_rows(x, fwd)

    @staticmethod
    def backward(ctx, grad):
        (bwd,) = ctx.saved_tensors
        return _take_rows(grad, bwd), None, None


def moe_dispatch(cfg, p, x, routing: Routing):
    """The routed experts of x [T, d] on ``routing``: [T, d] in x's dtype."""
    m = cfg.moe
    T, d = x.shape
    E, k = m.n_experts, m.top_k
    rows = routing.groups * routing.capacity
    slots = x[:, None, :].expand(T, k, d).reshape(T * k, d)
    buf = _Rows.apply(slots, routing.src, routing.dst).view(E, rows, d)
    g = torch.bmm(buf, p["w_gate"])
    u = torch.bmm(buf, p["w_up"])
    h = torch.nn.functional.silu(at_least_f32(g)).to(x.dtype) * u
    out = torch.bmm(h, p["w_down"]).view(E * rows, d)
    y = _Rows.apply(out, routing.dst, routing.src)
    w = (routing.weights * routing.kept).to(x.dtype)
    return combine((y * w.view(T * k, 1)).view(T, k, d))


def combine(y):
    """[T, k, d] weighted slots (token-major, ascending expert) -> [T, d]:
    each token's slots added one at a time in ascending expert order, each
    add rounded to y's dtype: the reference's scatter-add into zeros in its
    sorted-slot order (a sum in another order rounds otherwise in bf16)."""
    acc = y[:, 0]
    for r in range(1, y.shape[1]):
        acc = acc + y[:, r]
    return acc


def moe_apply(cfg, p, x):
    """x [T, d] -> [T, d] (callers flatten batch×seq): the routed experts,
    then the shared (always-on) experts added."""
    y = moe_dispatch(cfg, p, x, moe_route(cfg, p["router"], x))
    if cfg.moe.n_shared:
        y = y + swiglu(x, p["ws_gate"], p["ws_up"], p["ws_down"])
    return y


def moe_load_balance_loss(cfg, p, x):
    """Auxiliary load-balancing loss (Switch-style f·P); the reference
    calls it nowhere, and neither does the port."""
    m = cfg.moe
    probs = router_probs(p["router"], x)
    _, top_e = top_k(probs, m.top_k)
    ind = torch.nn.functional.one_hot(top_e, m.n_experts).to(probs.dtype).sum(1)
    f = ind.mean(0)            # fraction routed per expert
    pmean = probs.mean(0)      # mean router prob per expert
    return m.n_experts * (f * pmean).sum()
