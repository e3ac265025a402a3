"""Decoder-only language model (port of ``repro.models.lm``: the attention
decoders, GQA or MLA, dense or MoE; the SSM models (mLSTM and sLSTM
blocks); the hybrids (Mamba blocks beside GQA layers); the VLM, whose stub
vision front-end's patch embeddings times ``vision_proj`` go in front of
the text as a prefix that attends to itself both ways): the training loss
and the serving entry points.

The parameters are the reference's tree (``lm_init``): nested dicts, each
block parameter stacked over the layer periods under ``layers/sub<i>``,
keys in sorted order (the order in which ``jax.tree.flatten`` visits the
reference's tree), so optimizer states, checkpoints and the carriers of
``convert`` match it leaf for leaf.  The backbone is a loop over the
layers; ``layer_params`` splits the stacked leaves along the periods with
``unbind`` (views, whose backward is one stack a leaf).  A stateful layer
(Mamba, mLSTM, sLSTM) starts from the zero states of
``_full_init_states``, stacked over periods as the reference's.

Entry points:
  * ``lm_loss``    — the masked mean cross entropy of a (tokens, labels)
    batch (a VLM's: over the text positions after its ``patches``) over the
    padded vocab (labels < 0 masked), plus the MTP head's
    loss when the config has one; the backbone runs under ``cfg.remat``
    (``"full"``: each period is recomputed in the backward pass,
    ``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``,
    with the period's initial SSM states among its inputs).
  * ``lm_prefill`` — forward over a prompt: last-position logits over the
    padded vocab and the decode cache: each attention layer's entries
    (GQA's K/V, MLA's latent and rope key) fitted along their sequence
    axis to the cache (``place``), each SSM layer's final state; a VLM's
    cache holds its P patch positions before the T text positions, so its
    first decode position is P + T.
  * ``lm_decode``  — one token against the cache at position ``pos``; the
    cache is updated in place (a hybrid's attention layers as ring buffers
    of ``cfg.sliding_window`` slots).
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.utils.checkpoint

from .attention import unported
from .blocks import SSM_KINDS, apply_block, block_init_cache, block_specs, decode_block
from .layers import (P, init_from_spec, rms_norm, softmax_cross_entropy, sort_tree,
                     stack_specs)


# ---------------------------------------------------------------------------
# Param specs and init
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
    if cfg.frontend == "vision":
        specs["vision_proj"] = P((d, d), ("embed", "embed2"))
    if cfg.mtp:
        specs["mtp"] = {
            "proj": P((2 * d, d), ("inner", "embed")),
            "block": block_specs(cfg, "attn", 0),
            "norm": P((d,), ("embed",), init="ones"),
        }
    return specs


def lm_init(cfg, generator: torch.Generator, dtype=None) -> dict:
    """Parameters in the reference's layout (keys sorted), drawn from
    ``generator`` on its device at the reference's init scales (fan-in
    over the stacked shape), in ``dtype`` (default the config's
    ``param_dtype``)."""
    dtype = dtype or getattr(torch, cfg.param_dtype)
    return sort_tree(init_from_spec(lm_specs(cfg), generator, dtype))


# ---------------------------------------------------------------------------
# Backbone
# ---------------------------------------------------------------------------
def _layer_kinds(cfg):
    pattern = cfg.layer_pattern
    return [(i, kind) for _ in range(cfg.n_periods) for i, kind in enumerate(pattern)]


def unbind_layers(tree, n: int) -> list:
    """A tree whose leaves are stacked over ``n`` layers along their first
    axis, as ``n`` trees of that layer's leaves (views, whose backward is
    one stack a leaf)."""
    if isinstance(tree, Mapping):
        parts = {k: unbind_layers(v, n) for k, v in tree.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    return tree.unbind(0)


def layer_params(cfg, params) -> list:
    """One block's parameters a layer, in layer order: the tree's stacked
    leaves unbound along the periods (views); layer ``p·len(pattern) + i``
    is period p, sub-block i."""
    layers = params["layers"]
    subs = [unbind_layers(layers[f"sub{i}"], cfg.n_periods)
            for i in range(len(cfg.layer_pattern))]
    return [subs[i][n] for n in range(cfg.n_periods) for i in range(len(subs))]


def _stateful(kind: str) -> bool:
    return kind in SSM_KINDS


def _period_states(states, p: int):
    """Period ``p``'s initial states ``{"sub<i>": state}`` of
    ``_full_init_states`` (None: zeros in every block)."""
    if states is None:
        return {}
    return {sub: {c: t[p] for c, t in st.items()} for sub, st in states.items()}


def _full_init_states(cfg, batch: int, dtype, device):
    """Zero initial states for the stateful blocks, stacked over periods
    (expanded views, read only), as the reference's; None when no block of
    the pattern is stateful."""
    pattern = cfg.layer_pattern
    if not any(_stateful(k) for k in pattern):
        return None
    per = {}
    for i, kind in enumerate(pattern):
        if _stateful(kind):
            st = block_init_cache(cfg, kind, batch, 0, dtype, device)
            per[f"sub{i}"] = {c: t.expand(cfg.n_periods, *t.shape) for c, t in st.items()}
    return per


def lm_backbone(cfg, params, x, positions, *, prefix_len=None, collect_cache=False,
                init_states=None):
    """x [B,S,d] -> (h [B,S,d], caches or None); caches are
    ``{"sub<i>": entries}`` with each layer's cache entries (GQA ``{"k",
    "v"}``, MLA ``{"c_kv", "k_rope"}``, an SSM block's final state)
    stacked over periods.  ``init_states`` (``_full_init_states``) are the
    SSM blocks' initial states; ``prefix_len`` goes to every block."""
    per_sub: dict = {}
    h = x
    n = len(cfg.layer_pattern)
    states = [_period_states(init_states, p) for p in range(cfg.n_periods)]
    for idx, (bp, (i, kind)) in enumerate(zip(layer_params(cfg, params),
                                              _layer_kinds(cfg))):
        h, st = apply_block(cfg, kind, bp, h, positions, prefix_len=prefix_len,
                            state=states[idx // n].get(f"sub{i}"),
                            return_kv=collect_cache)
        if collect_cache:
            per_sub.setdefault(f"sub{i}", []).append(st)
    if not collect_cache:
        return h, None
    caches = {sub: {c: torch.stack([st[c] for st in sts]) for c in sts[0]}
              for sub, sts in per_sub.items()}
    return h, caches


def _train_backbone(cfg, params, x, positions, init_states=None, prefix_len=None):
    """x [B,S,d] -> h [B,S,d] under ``cfg.remat``: ``"full"`` runs each
    period inside ``torch.utils.checkpoint`` (non-reentrant), which keeps
    only the period's inputs (h and its blocks' initial SSM states) and
    recomputes its activations in the backward pass; ``"none"`` is the
    plain loop.  ``prefix_len`` goes to every block."""
    if cfg.remat not in ("full", "none"):
        raise unported(f"remat={cfg.remat!r} (selective checkpointing)")
    layers = layer_params(cfg, params)
    n = len(cfg.layer_pattern)

    def period(h, states, p, prefix):
        for i, kind in enumerate(cfg.layer_pattern):
            h, _ = apply_block(cfg, kind, layers[p * n + i], h, positions,
                               prefix_len=prefix, state=states.get(f"sub{i}"))
        return h

    h = x
    for p in range(cfg.n_periods):
        states = _period_states(init_states, p)
        if cfg.remat == "full":
            h = torch.utils.checkpoint.checkpoint(period, h, states, p, prefix_len,
                                                  use_reentrant=False,
                                                  preserve_rng_state=False)
        else:
            h = period(h, states, p, prefix_len)
    return h


def _act_dtype(cfg):
    return getattr(torch, cfg.act_dtype)


def _embed(cfg, params, tokens):
    return params["embed"][tokens].to(_act_dtype(cfg))


def _logits(cfg, params, h):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w.to(h.dtype)


def _with_prefix(cfg, params, batch, x):
    """(x, prefix_len): a VLM's ``batch["patches"]`` [B, P, d] (numpy or a
    tensor) cast to x's dtype, times ``vision_proj``, in front of the text
    embeddings x [B, T, d], and P; other configs' x and None."""
    if cfg.frontend != "vision":
        return x, None
    patches = torch.as_tensor(batch["patches"], device=x.device).to(x.dtype)
    patches = patches @ params["vision_proj"]
    return torch.cat([patches, x], dim=1), patches.shape[1]


def _masked_mean(ce, labels):
    mask = (labels >= 0).to(torch.float32)
    return (ce * mask).sum() / mask.sum().clamp(min=1.0), mask.sum()


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------
def lm_loss(cfg, params, batch):
    """batch: tokens, labels [B, S] (numpy or tensors, moved to the
    parameters' device), and a VLM's patches [B, P, d] (the prefix: the
    loss is over the S text positions); labels < 0 are masked.  Returns
    (loss, metrics): a 0-d float32 loss (the mean cross entropy over
    unmasked positions, plus 0.3 × the MTP loss when ``cfg.mtp``) and
    ``{"loss", "tokens"}`` (and ``"mtp_loss"``) as device tensors."""
    dev = params["embed"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    labels = torch.as_tensor(batch["labels"], device=dev).long()
    x, prefix_len = _with_prefix(cfg, params, batch, _embed(cfg, params, tokens))
    positions = torch.arange(x.shape[1], device=dev)[None, :]
    states = _full_init_states(cfg, x.shape[0], x.dtype, dev)
    h = _train_backbone(cfg, params, x, positions, states, prefix_len)
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    if prefix_len:
        h = h[:, prefix_len:]
    ce = softmax_cross_entropy(_logits(cfg, params, h), labels, cfg.vocab_size)
    loss, tokens_n = _masked_mean(ce, labels)
    metrics = {"loss": loss, "tokens": tokens_n}
    if cfg.mtp:  # multi-token prediction: predict t+2 from (h_t, emb_{t+1})
        mp = params["mtp"]
        emb_next = _embed(cfg, params, tokens)[:, 1:]
        h_in = torch.cat([rms_norm(h[:, :-1], mp["norm"], cfg.rms_eps), emb_next],
                         dim=-1) @ mp["proj"]
        pos2 = torch.arange(h_in.shape[1], device=dev)[None, :]
        h2, _ = apply_block(cfg, "attn", mp["block"], h_in, pos2)
        labels2 = labels[:, 1:]
        ce2 = softmax_cross_entropy(_logits(cfg, params, h2), labels2, cfg.vocab_size)
        mtp_loss, _ = _masked_mean(ce2, labels2)
        loss = loss + 0.3 * mtp_loss
        metrics["mtp_loss"] = mtp_loss
        metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------
def lm_init_cache(cfg, batch: int, seq: int, dtype, device="cuda") -> dict:
    """Zero caches ``{"sub<i>": entries}`` stacked over periods: GQA ``{"k",
    "v"}``, each [n_periods, B, KV, seq, hd] (a hybrid's: min(seq,
    sliding_window) slots); MLA ``{"c_kv", "k_rope"}``, [n_periods, B, seq,
    kv_lora_rank] and [n_periods, B, seq, rope] (the sequence axis second,
    not third); an SSM kind's initial state (``models/ssm.py``)."""
    out = {}
    for i, kind in enumerate(cfg.layer_pattern):
        st = block_init_cache(cfg, kind, batch, seq, dtype, device)
        out[f"sub{i}"] = {c: t.expand(cfg.n_periods, *t.shape).clone()
                          for c, t in st.items()}
    return out


def place(dst, src):
    """``src`` cast to ``dst``'s dtype and fitted to its shape along the one
    axis where they differ (the sequence axis, wherever the cache keeps it:
    GQA's K/V and MLA's entries differ there): a shorter prompt pads the
    future slots at the end; a longer one keeps the last entries (a ring
    buffer's)."""
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
    ``batch["tokens"]`` [B, T] (numpy or a tensor) goes to the parameters'
    device; a VLM's ``batch["patches"]`` [B, P, d] go in front of it, so
    the sequence (and the default ``cache_len``) is P + T."""
    dev = params["embed"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    x, prefix_len = _with_prefix(cfg, params, batch, _embed(cfg, params, tokens))
    B, S, _ = x.shape
    positions = torch.arange(S, device=dev)[None, :]
    states = _full_init_states(cfg, B, x.dtype, dev)
    h, caches = lm_backbone(cfg, params, x, positions, prefix_len=prefix_len,
                            collect_cache=True, init_states=states)
    h = rms_norm(h[:, -1], params["final_norm"], cfg.rms_eps)
    logits = _logits(cfg, params, h[:, None])[:, 0]
    full = lm_init_cache(cfg, B, cache_len or S, x.dtype, dev)
    for sub, st in caches.items():
        full[sub] = {c: place(full[sub][c], t) for c, t in st.items()}
    return logits, full


def lm_decode(cfg, params, token, pos: int, cache):
    """token [B] (numpy or a tensor); pos an int; cache from
    ``lm_init_cache``/``lm_prefill``, written in place.  A hybrid's
    attention layers decode with ``cfg.sliding_window`` (ring buffers).
    Returns (logits [B, Vp], cache)."""
    dev = params["embed"].device
    h = _embed(cfg, params, torch.as_tensor(token, device=dev).long())
    n = len(cfg.layer_pattern)
    window = cfg.sliding_window if cfg.family == "hybrid" else None
    for idx, (bp, (i, kind)) in enumerate(zip(layer_params(cfg, params),
                                              _layer_kinds(cfg))):
        # views of period idx // n: the slot write lands in ``cache``
        layer_cache = {c: t[idx // n] for c, t in cache[f"sub{i}"].items()}
        h, st = decode_block(cfg, kind, bp, h, int(pos), state=layer_cache,
                             window=window if kind == "attn" else None)
        if _stateful(kind):
            # the new state into the cache in place, cast to its dtype: the
            # mLSTM's conv state comes back in the activation dtype (bf16
            # values, which the float32 cache holds exactly)
            for c, t in st.items():
                layer_cache[c].copy_(t)
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    logits = _logits(cfg, params, h[:, None])[:, 0]
    return logits, cache
