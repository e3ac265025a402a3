"""Decoder-only language model, serving entry points (port of
``repro.models.lm`` for the dense GQA family).

The parameters are a ``layers.Params`` module: ``embed`` [Vp, d], ``layers``
(an ``nn.ModuleList``, one block per layer), ``final_norm`` and, for untied
configs, ``lm_head``.  The reference stacks each block parameter over its
layer periods for ``lax.scan``; ``params_from_tree`` / ``params_to_tree``
convert between that stacked tree and the module.  The backbone is a plain
loop over the layers (serving runs no backward pass, so there is no remat).

Entry points:
  * ``lm_prefill`` — forward over a prompt: last-position logits over the
    padded vocab and the decode cache, each layer's K/V padded to
    ``cache_len``.
  * ``lm_decode``  — one token against the cache at position ``pos``; the
    cache is updated in place.
The training loss (``lm_loss``) is not ported yet (ROADMAP Queue 1 item 20).
"""
from __future__ import annotations

import torch

from .blocks import apply_block, block_init_cache, block_specs, decode_block
from .layers import P, Params, init_from_spec, map_tree, rms_norm, stack_specs


# ---------------------------------------------------------------------------
# Param specs and the parameter module
# ---------------------------------------------------------------------------
def lm_specs(cfg) -> dict:
    d = cfg.d_model
    period = {f"sub{i}": block_specs(cfg, kind, i)
              for i, kind in enumerate(cfg.layer_pattern)}
    specs: dict = {
        "embed": P((cfg.padded_vocab, d), ("vocab", "embed"), init="embed",
                   scale=0.02),
        "layers": stack_specs(period, cfg.n_periods),
        "final_norm": P((d,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P((d, cfg.padded_vocab), ("embed", "vocab"))
    return specs


def params_from_tree(cfg, tree) -> Params:
    """The parameter module from a tree in the reference's layout (block
    parameters stacked over periods under ``layers/sub<i>``); layer
    ``p·len(pattern) + i`` is period p, sub-block i.  The layers' tensors
    are views into the stacked ones."""
    pattern = cfg.layer_pattern
    layers = [map_tree(lambda a, p=p: a[p], tree["layers"][f"sub{i}"])
              for p in range(cfg.n_periods) for i in range(len(pattern))]
    return Params({**{k: v for k, v in tree.items() if k != "layers"},
                   "layers": layers})


def params_to_tree(cfg, params: Params) -> dict:
    """The reference's layout of ``params``: block parameters stacked over
    periods under ``layers/sub<i>``."""
    tree = params.tree()
    n = len(cfg.layer_pattern)
    per_layer = tree.pop("layers")

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    tree["layers"] = {f"sub{i}": stack(per_layer[i::n]) for i in range(n)}
    return tree


def lm_init(cfg, generator: torch.Generator, dtype=None) -> Params:
    """Parameters drawn from ``generator`` on its device, at the reference's
    init scales (fan-in over the stacked shape), in ``dtype`` (default the
    config's ``param_dtype``)."""
    dtype = dtype or getattr(torch, cfg.param_dtype)
    return params_from_tree(cfg, init_from_spec(lm_specs(cfg), generator, dtype))


# ---------------------------------------------------------------------------
# Backbone
# ---------------------------------------------------------------------------
def _layer_kinds(cfg):
    pattern = cfg.layer_pattern
    return [(i, kind) for _ in range(cfg.n_periods) for i, kind in enumerate(pattern)]


def lm_backbone(cfg, params, x, positions, *, collect_cache=False):
    """x [B,S,d] -> (h [B,S,d], caches or None); caches are
    ``{"sub<i>": {"k", "v"}}`` with the layer's K/V stacked over periods."""
    per_sub: dict = {}
    h = x
    for bp, (i, kind) in zip(params["layers"], _layer_kinds(cfg)):
        h, st = apply_block(cfg, kind, bp, h, positions, return_kv=collect_cache)
        if collect_cache:
            per_sub.setdefault(f"sub{i}", []).append(st)
    if not collect_cache:
        return h, None
    caches = {sub: {c: torch.stack([st[c] for st in sts]) for c in sts[0]}
              for sub, sts in per_sub.items()}
    return h, caches


def _act_dtype(cfg):
    return getattr(torch, cfg.act_dtype)


def _embed(cfg, params, tokens):
    return params["embed"][tokens].to(_act_dtype(cfg))


def _logits(cfg, params, h):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w.to(h.dtype)


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------
def lm_init_cache(cfg, batch: int, seq: int, dtype, device="cuda") -> dict:
    """Zero caches ``{"sub<i>": {"k", "v"}}``, each [n_periods, B, KV, seq, hd]."""
    out = {}
    for i, kind in enumerate(cfg.layer_pattern):
        st = block_init_cache(cfg, kind, batch, seq, dtype, device)
        out[f"sub{i}"] = {c: t.expand(cfg.n_periods, *t.shape).clone()
                          for c, t in st.items()}
    return out


def place(dst, src):
    """``src`` cast to ``dst``'s dtype and fitted to its shape along the one
    axis where they differ: a shorter prompt pads the future slots at the
    end; a longer one keeps the last entries (a ring buffer's)."""
    src = src.to(dst.dtype)
    if src.shape == dst.shape:
        return src
    for ax, (d, s) in enumerate(zip(dst.shape, src.shape)):
        if d > s:
            out = torch.zeros_like(dst)
            out.narrow(ax, 0, s).copy_(src)
            return out
        if d < s:
            return src.narrow(ax, s - d, d)
    return src


def lm_prefill(cfg, params, batch, cache_len: int | None = None):
    """Forward over a prompt; returns (last-position logits [B, Vp], cache).
    ``batch["tokens"]`` [B, S] (numpy or a tensor) goes to the parameters'
    device."""
    dev = params["embed"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    x = _embed(cfg, params, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=dev)[None, :]
    h, caches = lm_backbone(cfg, params, x, positions, collect_cache=True)
    h = rms_norm(h[:, -1], params["final_norm"], cfg.rms_eps)
    logits = _logits(cfg, params, h[:, None])[:, 0]
    full = lm_init_cache(cfg, B, cache_len or S, x.dtype, dev)
    for sub, st in caches.items():
        full[sub] = {c: place(full[sub][c], t) for c, t in st.items()}
    return logits, full


def lm_decode(cfg, params, token, pos: int, cache):
    """token [B] (numpy or a tensor); pos an int; cache from
    ``lm_init_cache``/``lm_prefill``, written in place.  Returns (logits
    [B, Vp], cache)."""
    dev = params["embed"].device
    h = _embed(cfg, params, torch.as_tensor(token, device=dev).long())
    n = len(cfg.layer_pattern)
    for idx, (bp, (i, kind)) in enumerate(zip(params["layers"], _layer_kinds(cfg))):
        # views of period idx // n: the slot write lands in ``cache``
        layer_cache = {c: t[idx // n] for c, t in cache[f"sub{i}"].items()}
        h, _ = decode_block(cfg, kind, bp, h, int(pos), state=layer_cache)
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    logits = _logits(cfg, params, h[:, None])[:, 0]
    return logits, cache
