"""Transformer-block composition (port of ``repro.models.blocks``): a
mixer (attention, GQA or deepseek-v3's MLA; Mamba; mLSTM; sLSTM) + MLP
(dense SwiGLU, or the MoE MLP on the layers ``cfg.is_moe_layer`` names),
pre-norm residual.

* An attention or Mamba block is ``{"ln1", mixer, "ln2", "mlp" | "moe"}``
  (no MLP where the config has none); an mLSTM or sLSTM block is its mixer
  alone, ``{kind: specs}``, which carries its own norms and projections.
* A layer's decode state: GQA ``{"k", "v"}`` [B, KV, S, hd] (a hybrid's
  attention layer holds min(S, sliding_window) slots, a ring buffer), MLA
  ``{"c_kv" [B, S, r], "k_rope" [B, S, rope]}``, and the SSM kinds'
  states of ``models/ssm.py``.  Attention caches are written in place; an
  SSM block returns its new state.
"""
from __future__ import annotations

from . import attention as attn
from . import moe as moe_mod
from . import ssm
from .layers import P, rms_norm, swiglu

#: the SSM mixer kinds
SSM_KINDS = ("mamba", "mlstm", "slstm")


def _check_attention(cfg) -> None:
    if cfg.attn_kind not in ("gqa", "mla"):
        raise attn.unported(f"{cfg.attn_kind} attention")


def mlp_specs(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": P((d, f), ("embed", "mlp")),
        "w_up": P((d, f), ("embed", "mlp")),
        "w_down": P((f, d), ("mlp", "embed")),
    }


def block_specs(cfg, kind: str, idx_in_period: int) -> dict:
    """Spec tree for one layer of the given kind."""
    d = cfg.d_model
    if kind in ("mlstm", "slstm"):
        return {kind: (ssm.mlstm_specs(cfg) if kind == "mlstm" else ssm.slstm_specs(cfg))}
    s: dict = {"ln1": P((d,), ("embed",), init="ones")}
    if kind == "attn":
        _check_attention(cfg)
        s["attn"] = attn.mla_specs(cfg) if cfg.attn_kind == "mla" else attn.gqa_specs(cfg)
    elif kind == "mamba":
        s["mamba"] = ssm.mamba_specs(cfg)
    else:
        raise ValueError(kind)
    if cfg.d_ff or cfg.moe is not None:
        s["ln2"] = P((d,), ("embed",), init="ones")
        if cfg.is_moe_layer(idx_in_period):
            s["moe"] = moe_mod.moe_specs(cfg)
        else:
            s["mlp"] = mlp_specs(cfg)
    return s


def apply_mlp_part(cfg, bp, x):
    """Post-mixer MLP/MoE with pre-norm residual.  x [B,S,d] (or [B,d]);
    the MoE MLP takes the tokens flattened to [B·S, d]."""
    if "mlp" not in bp and "moe" not in bp:
        return x
    h = rms_norm(x, bp["ln2"], cfg.rms_eps)
    if "moe" in bp:
        y = moe_mod.moe_apply(cfg, bp["moe"], h.reshape(-1, h.shape[-1])).view(h.shape)
    else:
        y = swiglu(h, bp["mlp"]["w_gate"], bp["mlp"]["w_up"], bp["mlp"]["w_down"])
    return x + y


def apply_block(cfg, kind: str, bp, x, positions, *, prefix_len=None, state=None,
                return_kv=False):
    """Full-sequence (causal) application from ``state`` (an SSM block's;
    None: zeros); ``prefix_len`` (a VLM's patch prefix) goes to GQA's
    attention, as the reference's (its MLA takes none).  Returns (x, new
    state): an attention layer's cache entries (``{"k", "v"}`` or
    ``{"c_kv", "k_rope"}``) with ``return_kv``, else None; an SSM block's
    final state always."""
    if kind == "attn":
        _check_attention(cfg)
        h = rms_norm(x, bp["ln1"], cfg.rms_eps)
        mla = cfg.attn_kind == "mla"
        if mla:
            out = attn.mla_forward(cfg, bp["attn"], h, positions, return_kv=return_kv)
        else:
            out = attn.gqa_forward(cfg, bp["attn"], h, positions, prefix_len=prefix_len,
                                   return_kv=return_kv)
        new_state = None
        if return_kv:
            y, (a, b) = out
            new_state = {"c_kv": a, "k_rope": b} if mla else {"k": a, "v": b}
        else:
            y = out
    elif kind in SSM_KINDS:
        h = rms_norm(x, bp["ln1"], cfg.rms_eps) if kind == "mamba" else x
        y, new_state = getattr(ssm, f"{kind}_forward")(cfg, bp[kind], h, state)
    else:
        raise ValueError(kind)
    return apply_mlp_part(cfg, bp, x + y), new_state


def decode_block(cfg, kind: str, bp, x, pos: int, *, window=None, state):
    """One-token decode.  x [B,d]; returns (x, state).  An attention
    layer's cache (``state``) is written in place (``window``: a ring
    buffer, GQA only); an SSM block returns a new state."""
    if kind == "attn":
        _check_attention(cfg)
        h = rms_norm(x, bp["ln1"], cfg.rms_eps)
        if cfg.attn_kind == "mla":
            y, state = attn.mla_decode(cfg, bp["attn"], h, state, pos)
        else:
            y, state = attn.gqa_decode(cfg, bp["attn"], h, state, pos, window=window)
    elif kind in SSM_KINDS:
        h = rms_norm(x, bp["ln1"], cfg.rms_eps) if kind == "mamba" else x
        y, state = getattr(ssm, f"{kind}_decode")(cfg, bp[kind], h, state)
    else:
        raise ValueError(kind)
    return apply_mlp_part(cfg, bp, x + y), state


def block_init_cache(cfg, kind: str, batch: int, seq: int, dtype, device="cuda"):
    """A layer's zero decode state: a GQA cache of ``seq`` slots (a
    hybrid's of min(seq, sliding_window)), an MLA cache, or an SSM kind's
    initial state (``seq`` unused)."""
    if kind == "attn":
        _check_attention(cfg)
        if cfg.attn_kind == "mla":
            return attn.mla_init_cache(cfg, batch, seq, dtype, device)
        w = cfg.sliding_window
        s = min(seq, w) if (w is not None and cfg.family == "hybrid") else seq
        return attn.gqa_init_cache(cfg, batch, s, dtype, device)
    if kind == "mamba":
        return ssm.mamba_init_state(cfg, batch, dtype, device)
    if kind == "mlstm":
        return ssm.mlstm_init_state(cfg, batch, dtype, device)
    if kind == "slstm":
        return ssm.slstm_init_state(cfg, batch, dtype, device)
    raise ValueError(kind)
