"""Transformer-block composition (port of ``repro.models.blocks``) for the
attention blocks: attention mixer (GQA, or deepseek-v3's MLA) + MLP (dense
SwiGLU, or the MoE MLP on the layers ``cfg.is_moe_layer`` names), pre-norm
residual.  A GQA layer's cache is ``{"k", "v"}`` [B, KV, S, hd], an MLA
layer's ``{"c_kv" [B, S, r], "k_rope" [B, S, rope]}``.

Mamba, mLSTM and sLSTM blocks raise ``NotImplementedError`` (ROADMAP Queue
1 item 20).
"""
from __future__ import annotations

from . import attention as attn
from . import moe as moe_mod
from .layers import P, rms_norm, swiglu


def _check_kind(cfg, kind: str) -> None:
    if kind != "attn":
        raise attn.unported(f"the {kind} block")
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
    _check_kind(cfg, kind)
    d = cfg.d_model
    s: dict = {"ln1": P((d,), ("embed",), init="ones"),
               "attn": attn.mla_specs(cfg) if cfg.attn_kind == "mla" else attn.gqa_specs(cfg)}
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


def apply_block(cfg, kind: str, bp, x, positions, *, return_kv=False):
    """Full-sequence (causal) application.  Returns (x, the layer's cache
    entries (``{"k", "v"}`` or ``{"c_kv", "k_rope"}``) or None)."""
    _check_kind(cfg, kind)
    h = rms_norm(x, bp["ln1"], cfg.rms_eps)
    mla = cfg.attn_kind == "mla"
    forward = attn.mla_forward if mla else attn.gqa_forward
    out = forward(cfg, bp["attn"], h, positions, return_kv=return_kv)
    new_state = None
    if return_kv:
        y, (a, b) = out
        new_state = {"c_kv": a, "k_rope": b} if mla else {"k": a, "v": b}
    else:
        y = out
    return apply_mlp_part(cfg, bp, x + y), new_state


def decode_block(cfg, kind: str, bp, x, pos: int, *, state):
    """One-token decode.  x [B,d]; ``state`` (the layer's cache) is written
    in place; returns (x, state)."""
    _check_kind(cfg, kind)
    h = rms_norm(x, bp["ln1"], cfg.rms_eps)
    decode = attn.mla_decode if cfg.attn_kind == "mla" else attn.gqa_decode
    y, state = decode(cfg, bp["attn"], h, state, pos)
    return apply_mlp_part(cfg, bp, x + y), state


def block_init_cache(cfg, kind: str, batch: int, seq: int, dtype, device="cuda"):
    _check_kind(cfg, kind)
    init = attn.mla_init_cache if cfg.attn_kind == "mla" else attn.gqa_init_cache
    return init(cfg, batch, seq, dtype, device)
