"""Encoder-decoder model, seamless-m4t (port of ``repro.models.encdec``): a
bidirectional encoder over stub frame embeddings and a causal decoder with
cross-attention.

The audio front-end (w2v-BERT conformer) is a stub, as in the reference:
a batch carries precomputed frame embeddings ``frames`` [B, F, d_model]
(``data/lm_data.py``, ``registry.batch_spec``).  Both transformer stacks
and the serving cache are real.

The parameters are the reference's tree (``encdec_init``, keys sorted):
``embed``, ``frame_proj``, the encoder layers ``enc_layers`` and the
decoder layers ``dec_layers`` (each leaf stacked over its layers),
``enc_norm``, ``final_norm``, ``lm_head``.  Layers run as ``lm.py`` runs
them: a loop over the stacked leaves unbound a layer
(``lm.unbind_layers``); with a gradient asked for and ``cfg.remat`` not
``"none"`` each layer goes through ``torch.utils.checkpoint``
(non-reentrant), as the reference's ``jax.checkpoint`` of its scan body.

Attention: an encoder layer is ``gqa_forward(..., causal=False)`` with
rope over the frame positions; a decoder layer's self-attention is the
causal ``gqa_forward`` and its cross-attention (no rope) is
``flash_attention(q, k, v, causal=False)`` of the text's queries against
the F encoder frames, a query length other than the key length.  On CUDA
tensors every one is a hand-written flash kernel launch
(``models.attention.flash_attention``).  The decode step's
cross-attention is ``decode_attention`` against the cached frame keys,
every frame attended.

Entry points:
  * ``encdec_loss``    — the masked mean cross entropy of a (frames,
    tokens, labels) batch over the padded vocab, labels < 0 masked.
  * ``encdec_prefill`` — encoder over the frames, decoder over the prompt:
    last-position logits and the decode cache ``{"k", "v"}`` [L, B, KV,
    cache_len, hd] (zero past the prompt) and ``{"xk", "xv"}`` [L, B, KV,
    F, hd] (the cross-attention's keys and values of every frame), in the
    activations' dtype.
  * ``encdec_decode``  — one token at ``pos`` against the cache, whose
    self-attention entries are written in place.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from . import attention as attn
from .blocks import mlp_specs
from .layers import (P, init_from_spec, rms_norm, softmax_cross_entropy, sort_tree,
                     stack_specs, swiglu)
from .lm import _masked_mean, unbind_layers


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------
def _enc_layer_specs(cfg) -> dict:
    d = cfg.d_model
    return {
        "ln1": P((d,), ("embed",), init="ones"),
        "attn": attn.gqa_specs(cfg),
        "ln2": P((d,), ("embed",), init="ones"),
        "mlp": mlp_specs(cfg),
    }


def _dec_layer_specs(cfg) -> dict:
    d = cfg.d_model
    return {
        "ln1": P((d,), ("embed",), init="ones"),
        "self": attn.gqa_specs(cfg),
        "ln_x": P((d,), ("embed",), init="ones"),
        "cross": attn.gqa_specs(cfg),
        "ln2": P((d,), ("embed",), init="ones"),
        "mlp": mlp_specs(cfg),
    }


def encdec_specs(cfg) -> dict:
    d = cfg.d_model
    return {
        "embed": P((cfg.padded_vocab, d), ("vocab", "embed"), init="embed",
                   scale=0.02),
        "frame_proj": P((d, d), ("embed", "embed2")),
        "enc_layers": stack_specs(_enc_layer_specs(cfg), cfg.n_enc_layers),
        "dec_layers": stack_specs(_dec_layer_specs(cfg), cfg.n_layers),
        "enc_norm": P((d,), ("embed",), init="ones"),
        "final_norm": P((d,), ("embed",), init="ones"),
        "lm_head": P((d, cfg.padded_vocab), ("embed", "vocab")),
    }


def encdec_init(cfg, generator: torch.Generator, dtype=None) -> dict:
    """Parameters in the reference's layout (keys sorted), drawn from
    ``generator`` on its device at the reference's init scales, in
    ``dtype`` (default the config's ``param_dtype``), as ``lm.lm_init``."""
    dtype = dtype or getattr(torch, cfg.param_dtype)
    return sort_tree(init_from_spec(encdec_specs(cfg), generator, dtype))


# ---------------------------------------------------------------------------
# Cross attention (full sequence, and one step against the cached frames)
# ---------------------------------------------------------------------------
def _cross_kv(cfg, p, enc_out):
    """enc_out [B, F, d] -> the frames' keys and values [B, KV, F, hd]."""
    k = torch.einsum("bfd,dhk->bhfk", enc_out, p["wk"])
    v = torch.einsum("bfd,dhk->bhfk", enc_out, p["wv"])
    return k, v


def _cross_forward(cfg, p, x, k, v):
    """x [B, S, d] attending every frame's keys and values k, v [B, KV, F,
    hd] (``_cross_kv``) -> [B, S, d]; the reference takes enc_out and makes
    k, v itself, so that its prefill makes them twice."""
    q = torch.einsum("bsd,dhk->bhsk", x, p["wq"])
    out = attn.flash_attention(q, k, v, causal=False)
    return torch.einsum("bhsk,hkd->bsd", out, p["wo"])


def _cross_decode(cfg, p, x, k, v):
    """x [B, d], one token, against the cached frames k, v [B, KV, F, hd]."""
    q = torch.einsum("bd,dhk->bhk", x, p["wq"])
    out = attn.decode_attention(q, k, v, k.shape[2] - 1)
    return torch.einsum("bhk,hkd->bd", out, p["wo"])


# ---------------------------------------------------------------------------
# Encoder / decoder stacks
# ---------------------------------------------------------------------------
def _layer(cfg, fn, *args):
    """``fn(*args)``, through ``torch.utils.checkpoint`` when a gradient is
    asked for and ``cfg.remat`` is not ``"none"``."""
    if cfg.remat != "none" and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                                 preserve_rng_state=False)
    return fn(*args)


def _mlp(cfg, bp, h):
    m = rms_norm(h, bp["ln2"], cfg.rms_eps)
    return h + swiglu(m, bp["mlp"]["w_gate"], bp["mlp"]["w_up"], bp["mlp"]["w_down"])


def encode(cfg, params, frames):
    """frames [B, F, d] (cast to ``act_dtype``) -> the encoder's output [B,
    F, d], bidirectional attention with rope over the frame positions."""
    x = frames.to(getattr(torch, cfg.act_dtype)) @ params["frame_proj"]
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def body(h, bp):
        a = rms_norm(h, bp["ln1"], cfg.rms_eps)
        h = h + attn.gqa_forward(cfg, bp["attn"], a, positions, causal=False)
        return _mlp(cfg, bp, h)

    for bp in unbind_layers(params["enc_layers"], cfg.n_enc_layers):
        x = _layer(cfg, body, x, bp)
    return rms_norm(x, params["enc_norm"], cfg.rms_eps)


def decode_stack(cfg, params, tokens, enc_out, *, collect_cache=False):
    """tokens [B, S] against enc_out [B, F, d] -> (h [B, S, d] after the
    final norm, caches or None); with ``collect_cache`` the caches are
    ``{"k", "v"}`` [L, B, KV, S, hd] (self-attention, after rope) and
    ``{"xk", "xv"}`` [L, B, KV, F, hd] (cross-attention)."""
    x = params["embed"][tokens].to(enc_out.dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def body(h, bp):
        a = rms_norm(h, bp["ln1"], cfg.rms_eps)
        out = attn.gqa_forward(cfg, bp["self"], a, positions, causal=True,
                               return_kv=collect_cache)
        y, kv = out if collect_cache else (out, None)
        h = h + y
        c = rms_norm(h, bp["ln_x"], cfg.rms_eps)
        xk, xv = _cross_kv(cfg, bp["cross"], enc_out)
        h = _mlp(cfg, bp, h + _cross_forward(cfg, bp["cross"], c, xk, xv))
        if not collect_cache:
            return h, None
        return h, {"k": kv[0], "v": kv[1], "xk": xk, "xv": xv}

    caches = []
    for bp in unbind_layers(params["dec_layers"], cfg.n_layers):
        x, cache = _layer(cfg, body, x, bp)
        caches.append(cache)
    h = rms_norm(x, params["final_norm"], cfg.rms_eps)
    if not collect_cache:
        return h, None
    return h, {c: torch.stack([cache[c] for cache in caches]) for c in caches[0]}


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def _inputs(params, batch, *names):
    dev = params["embed"].device
    return [torch.as_tensor(batch[n], device=dev) for n in names]


def encdec_loss(cfg, params, batch):
    """batch: frames [B, F, d], tokens and labels [B, S] (numpy or tensors,
    moved to the parameters' device); labels < 0 are masked.  Returns
    (loss, {"loss", "tokens"}): the mean cross entropy over the unmasked
    positions (their count floored at 1), 0-d float32 device tensors."""
    frames, tokens, labels = _inputs(params, batch, "frames", "tokens", "labels")
    h, _ = decode_stack(cfg, params, tokens.long(), encode(cfg, params, frames))
    logits = h @ params["lm_head"].to(h.dtype)
    labels = labels.long()
    loss, n = _masked_mean(softmax_cross_entropy(logits, labels, cfg.vocab_size), labels)
    return loss, {"loss": loss, "tokens": n}


def encdec_init_cache(cfg, batch: int, seq: int, dtype, device="cuda") -> dict:
    """Zero caches: ``{"k", "v"}`` [L, B, KV, seq, hd] and ``{"xk", "xv"}``
    [L, B, KV, F, hd], L the decoder's layers, F the frames."""
    KV, hd, F, L = cfg.n_kv_heads, cfg.head_dim, cfg.n_frontend_tokens, cfg.n_layers

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {"k": z(L, batch, KV, seq, hd), "v": z(L, batch, KV, seq, hd),
            "xk": z(L, batch, KV, F, hd), "xv": z(L, batch, KV, F, hd)}


def encdec_prefill(cfg, params, batch, cache_len: int | None = None):
    """Encode the frames and run the decoder over the prompt ``tokens`` [B,
    S]; returns (last-position logits [B, Vp], cache), the self-attention
    entries zero-padded to ``cache_len`` (default S)."""
    frames, tokens = _inputs(params, batch, "frames", "tokens")
    enc_out = encode(cfg, params, frames)
    h, caches = decode_stack(cfg, params, tokens.long(), enc_out, collect_cache=True)
    logits = h[:, -1] @ params["lm_head"].to(h.dtype)
    S = tokens.shape[1]
    pad = (0, 0, 0, (cache_len or S) - S)  # the sequence axis, at the end
    return logits, {"k": torch.nn.functional.pad(caches["k"], pad),
                    "v": torch.nn.functional.pad(caches["v"], pad),
                    "xk": caches["xk"], "xv": caches["xv"]}


def encdec_decode(cfg, params, token, pos: int, cache):
    """token [B] (numpy or a tensor) at position ``pos`` (an int) against the
    cache of ``encdec_prefill``, whose self-attention entries are written in
    place at slot ``pos``.  Returns (logits [B, Vp], cache)."""
    token = torch.as_tensor(token, device=params["embed"].device).long()
    h = params["embed"][token].to(getattr(torch, cfg.act_dtype))
    pos = int(pos)
    for n, bp in enumerate(unbind_layers(params["dec_layers"], cfg.n_layers)):
        a = rms_norm(h, bp["ln1"], cfg.rms_eps)
        # views of layer n: the slot write lands in ``cache``
        y, _ = attn.gqa_decode(cfg, bp["self"], a, {"k": cache["k"][n], "v": cache["v"][n]},
                               pos)
        h = h + y
        c = rms_norm(h, bp["ln_x"], cfg.rms_eps)
        h = _mlp(cfg, bp, h + _cross_decode(cfg, bp["cross"], c, cache["xk"][n],
                                            cache["xv"][n]))
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    return h @ params["lm_head"].to(h.dtype), cache
