"""Attention: GQA and deepseek-v3's MLA (port of ``repro.models.attention``).

* ``flash_attention`` is the counterpart of the reference's
  ``flash_attention_jnp``.  On CUDA tensors it launches a hand-written
  kernel (at head dim 64 or 128 ``kernels/csrc/flash_attention_wgmma.cu``
  for bf16 and ``kernels/csrc/flash_attention_tf32.cu`` for float32,
  ``kernels/csrc/flash_attention.cu`` otherwise), and nothing else.  On CPU
  tensors it runs the plain versions of the reference's two branches: plain
  masked attention for short or unaligned sequences, and the chunked online
  softmax over (block_q, block_k) tiles above 4096²/16 scores.  When a
  gradient is asked for (grad mode on and an input that requires grad), the
  CUDA path is ``kernels.flash_attention.FlashAttentionFn``: the same
  forward launch, with the hand-written backward kernels that
  ``kernels.flash_attention.bwd_variant`` names
  (at head dims (64, 64), (128, 128) and MLA's (192, 128)
  ``kernels/csrc/flash_attention_bwd_wgmma.cu`` for bf16 and
  ``kernels/csrc/flash_attention_bwd_tf32.cu`` for float32,
  ``kernels/csrc/flash_attention_bwd.cu`` otherwise); autograd
  differentiates the CPU branches as they are.
* ``decode_attention`` is one query token against the cache, plain torch as
  in the reference.
* ``gqa_forward`` / ``gqa_decode`` are the full-sequence and one-token
  modules; ``gqa_forward(..., causal=False)`` is an encoder's
  bidirectional layer (``models/encdec.py``).  The decode cache is updated in place (a copy into the slot),
  where the reference returns a new cache and donates the old buffer.
  With ``window`` (a hybrid's attention layers in decode) the cache is a
  ring buffer: position ``pos`` goes to slot ``pos % S`` and every slot
  below min(pos + 1, S) is attended.
* ``mla_forward`` / ``mla_decode`` are deepseek-v3's multi-head latent
  attention.  The prefill runs the flash kernel with q and k of
  ``qk_nope + qk_rope`` columns (192) and v of ``v_head_dim`` (128), scale
  1/√192; it caches the compressed kv-latent (``kv_lora_rank``, 512) and
  the shared rope key (64) a token, ``{"c_kv": [B, S, r], "k_rope": [B,
  S, rope]}``.  The decode is the absorbed form: W_uk folded into the
  query, attention against the latent cache directly, plain products as
  in the reference (no Pallas kernel there either).  A gradient through
  MLA's attention takes the backward kernels at (192, 128) (and (16, 8),
  the reduced config's) on the card, and autograd of the plain branch on
  the CPU, as the reference's ``jax.grad``.

q-head h reads kv-head h // G (G = H / Hkv) on every path.
``flash_attention(..., prefix_len=P)`` is paligemma-3b's prefix-LM mask
(the P patch positions attend to each other both ways, the rest is
causal): the flash kernels take it on the card, both CPU branches as the
reference's do (``layers.prefix_lm_mask`` in the plain branch, the tiles'
``(q < P) & (k < P)`` in the chunked one); a prefix with ``causal=False``
or T ≠ Tk raises ``ValueError``.  A window in ``flash_attention`` raises
``NotImplementedError`` (ROADMAP Queue 1 item 20): no entry point of the
reference passes one to a prefill.
"""
from __future__ import annotations

import torch

from ..kernels import flash_attention as _flash
from ..kernels._cuda import on_card
from ..kernels import ref as _ref
from .layers import P, apply_rope, at_least_f32, causal_mask, prefix_lm_mask, rms_norm

NEG_INF = -1e30
UNPORTED = "ROADMAP Queue 1 item 20"


#: the reference's flash_attention_jnp tiles (its chunked CPU branch)
BLOCK_Q, BLOCK_K = 1024, 2048


def unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({UNPORTED})")


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------
def gqa_specs(cfg) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {
        "wq": P((d, H, hd), ("embed", "heads", "head_dim")),
        "wk": P((d, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wv": P((d, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wo": P((H, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = P((H, hd), ("heads", "head_dim"), init="zeros")
        s["bk"] = P((KV, hd), ("kv_heads", "head_dim"), init="zeros")
        s["bv"] = P((KV, hd), ("kv_heads", "head_dim"), init="zeros")
    return s


def mla_specs(cfg) -> dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_dq": P((d, m.q_lora_rank), ("embed", "q_lora")),
        "q_norm": P((m.q_lora_rank,), ("q_lora",), init="ones"),
        "w_uq": P((m.q_lora_rank, H, qk), ("q_lora", "heads", "head_dim")),
        "w_dkv": P((d, m.kv_lora_rank), ("embed", "kv_lora")),
        "kv_norm": P((m.kv_lora_rank,), ("kv_lora",), init="ones"),
        "w_kr": P((d, m.qk_rope_head_dim), ("embed", "head_dim")),
        "w_ukv": P((m.kv_lora_rank, H, m.qk_nope_head_dim + m.v_head_dim),
                   ("kv_lora", "heads", "head_dim")),
        "wo": P((H, m.v_head_dim, d), ("heads", "head_dim", "embed")),
    }


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------
def _plain_attention(q, k, v, mask, scale):
    """q [B,G,Hkv,S,D], k/v [B,1,Hkv,Sk,D]; mask [S,Sk].  Scores and softmax
    in float32; the probabilities are rounded to v's dtype for the PV
    product, as the reference does."""
    s = torch.einsum("bghsd,bghtd->bghst", q.float(), k.float()) * scale
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bghst,bghtd->bghsd", p.to(v.dtype), v)


def _chunked_attention(qg, kg, vg, causal, scale, block_q, block_k, out_dtype,
                       prefix_len=0):
    """Online softmax over (block_q, block_k) tiles: qg [B,G,Hkv,S,D],
    kg/vg [B,1,Hkv,Sk,D] -> [B,G,Hkv,S,Dv]; S and Sk are block multiples.
    With ``prefix_len`` P a tile's causal mask also lets positions below P
    see each other, as the reference's ``mask |= (q < P) & (k < P)``."""
    S, Sk = qg.shape[3], kg.shape[3]
    outs = []
    for qi in range(S // block_q):
        qblk = qg[:, :, :, qi * block_q:(qi + 1) * block_q]
        m = torch.full(qblk.shape[:4], NEG_INF, dtype=torch.float32, device=qg.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((*qblk.shape[:4], vg.shape[-1]), dtype=torch.float32,
                          device=qg.device)
        for kj in range(Sk // block_k):
            kblk = kg[:, :, :, kj * block_k:(kj + 1) * block_k]
            vblk = vg[:, :, :, kj * block_k:(kj + 1) * block_k]
            s = torch.einsum("bghsd,bghtd->bghst", qblk.float(), kblk.float()) * scale
            if causal:
                q_pos = qi * block_q + torch.arange(block_q, device=qg.device)[:, None]
                k_pos = kj * block_k + torch.arange(block_k, device=qg.device)[None, :]
                mask = (k_pos <= q_pos) | ((q_pos < prefix_len) & (k_pos < prefix_len))
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bghst,bghtd->bghsd", p.to(vblk.dtype), vblk).float()
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(out_dtype))
    return torch.cat(outs, dim=3)


def flash_attention(q, k, v, *, causal=True, prefix_len=None, window=None):
    """Causal (or full) attention; q [B, H, S, D], k [B, Hkv, Sk, D], v [B,
    Hkv, Sk, Dv] with H % Hkv == 0 -> [B, H, S, Dv] in q's dtype (Dv ≠ D:
    MLA).

    CUDA tensors: the hand-written flash kernel (any S; scores, softmax and
    accumulator in float32, as the Pallas kernel), through
    ``FlashAttentionFn`` when a gradient is asked for.  CPU tensors: the
    reference's plain masked branch, or its chunked branch when S·Sk exceeds
    4096²/16 and S, Sk are multiples of BLOCK_Q, BLOCK_K.  ``prefix_len``
    (causal, S == Sk): the prefix-LM mask on every branch."""
    if window is not None:
        raise unported("sliding-window attention")
    B, H, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    prefix = _ref.check_prefix(causal, S, Sk, prefix_len)
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    if on_card(q):
        if grad:
            return _flash.FlashAttentionFn.apply(q, k, v, causal, prefix_len)
        return _flash.flash_attention(q, k, v, causal=causal, prefix_len=prefix_len)
    Dv = v.shape[-1]
    G = H // Hkv
    scale = 1.0 / (D ** 0.5)
    qg = q.reshape(B, Hkv, G, S, D).transpose(1, 2)   # [B,G,Hkv,S,D]
    kg, vg = k[:, None], v[:, None]                    # [B,1,Hkv,Sk,D]
    if S * Sk <= 4096 * 4096 // 16 or S % BLOCK_Q or Sk % BLOCK_K:
        if prefix_len is not None:
            mask = prefix_lm_mask(S, Sk, prefix, device=q.device)
        elif causal:
            mask = causal_mask(S, Sk, device=q.device)
        else:
            mask = torch.ones((S, Sk), dtype=torch.bool, device=q.device)
        out = _plain_attention(qg, kg, vg, mask, scale)
    else:
        out = _chunked_attention(qg, kg, vg, causal, scale, BLOCK_Q, BLOCK_K,
                                 q.dtype, prefix)
    return out.transpose(1, 2).reshape(B, H, S, Dv)


def decode_attention(q, k_cache, v_cache, pos: int, *, window=None):
    """One-step decode: q [B,H,D] against cache [B,Hkv,S,D]; entries at
    indices > pos are masked, or with ``window`` (a ring buffer of S slots)
    those at indices >= min(pos + 1, S).  Scores and softmax in float32;
    the probabilities are rounded to the cache dtype for the PV product,
    which accumulates in float32; the output has the cache dtype."""
    B, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, D)  # q-head h -> kv-head h // G
    s = torch.einsum("bhgd,bhtd->bhgt", qg.float(), k_cache.float()) / (D ** 0.5)
    idx = torch.arange(S, device=q.device)
    valid = idx <= pos if window is None else idx < min(pos + 1, S)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgt,bhtd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, H, D).to(v_cache.dtype)


# ---------------------------------------------------------------------------
# GQA module
# ---------------------------------------------------------------------------
def _qkv(cfg, p, x):
    """Projections of x [..., d] -> q [..., H, hd], k/v [..., KV, hd]."""
    q = torch.einsum("...d,dhk->...hk", x, p["wq"])
    k = torch.einsum("...d,dhk->...hk", x, p["wk"])
    v = torch.einsum("...d,dhk->...hk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def gqa_forward(cfg, p, x, positions, *, causal=True, prefix_len=None,
                return_kv=False):
    """x [B,S,d] -> [B,S,d] (and the layer's k, v [B,KV,S,hd] with
    ``return_kv``).  Full-sequence (prefill), causal unless ``causal`` is
    False (an encoder layer); ``prefix_len`` (a VLM's patch prefix) makes it
    the prefix-LM mask."""
    q, k, v = _qkv(cfg, p, x)                      # [B,S,heads,hd]
    q = apply_rope(q, positions, cfg.rope_theta).transpose(1, 2)
    k = apply_rope(k, positions, cfg.rope_theta).transpose(1, 2)
    v = v.transpose(1, 2)
    out = flash_attention(q, k, v, causal=causal, prefix_len=prefix_len)  # [B,H,S,hd]
    y = torch.einsum("bhsk,hkd->bsd", out, p["wo"])
    if return_kv:
        return y, (k, v)
    return y


def gqa_init_cache(cfg, batch: int, seq: int, dtype, device="cuda"):
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    shape = (batch, KV, seq, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_decode(cfg, p, x, cache, pos: int, *, window=None):
    """x [B,d], one token at ``pos``; cache {"k","v"} [B,KV,S,hd] is written
    in place at slot ``pos`` (with ``window``: ``pos % S``).  Returns (y
    [B,d], cache)."""
    q, k, v = _qkv(cfg, p, x)                      # [B,heads,hd]
    # built on the device: a tensor of host data would be a blocking copy
    posv = torch.arange(pos, pos + 1, device=x.device)
    q = apply_rope(q[:, None], posv, cfg.rope_theta)[:, 0]
    k = apply_rope(k[:, None], posv, cfg.rope_theta)[:, 0]
    slot = pos % cache["k"].shape[2] if window is not None else pos
    cache["k"][:, :, slot] = k.to(cache["k"].dtype)
    cache["v"][:, :, slot] = v.to(cache["v"].dtype)
    out = decode_attention(q, cache["k"], cache["v"], pos, window=window)
    y = torch.einsum("bhk,hkd->bd", out, p["wo"])
    return y, cache


# ---------------------------------------------------------------------------
# MLA module (deepseek-v3)
# ---------------------------------------------------------------------------
def _mla_q(cfg, p, x, positions):
    """x [B,S,d] -> (q_nope [B,S,H,nope], q_rope [B,S,H,rope])."""
    m = cfg.mla
    ql = rms_norm(x @ p["w_dq"], p["q_norm"], cfg.rms_eps)
    q = torch.einsum("bsr,rhk->bshk", ql, p["w_uq"])
    qn, qr = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return qn, apply_rope(qr, positions, cfg.rope_theta)


def mla_forward(cfg, p, x, positions, *, return_kv=False):
    """x [B,S,d] -> [B,S,d] (and the layer's cache entries c_kv [B,S,r] and
    k_rope [B,S,rope] with ``return_kv``).  Full-sequence, causal
    (prefill): q and k of nope + rope columns, v of v_head_dim, through
    ``flash_attention``."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    qn, qr = _mla_q(cfg, p, x, positions)
    c_kv = rms_norm(x @ p["w_dkv"], p["kv_norm"], cfg.rms_eps)        # [B,S,r]
    kr = apply_rope((x @ p["w_kr"])[:, :, None, :], positions, cfg.rope_theta)
    kv = torch.einsum("bsr,rhk->bshk", c_kv, p["w_ukv"])
    kn, v = kv[..., :m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]
    q = torch.cat([qn, qr], dim=-1).transpose(1, 2)                   # [B,H,S,qk]
    k = torch.cat([kn, kr.expand(B, S, H, m.qk_rope_head_dim)], dim=-1).transpose(1, 2)
    out = flash_attention(q, k, v.transpose(1, 2))                    # [B,H,S,v]
    y = torch.einsum("bhsk,hkd->bsd", out, p["wo"])
    if return_kv:
        return y, (c_kv, kr[:, :, 0, :])
    return y


def mla_init_cache(cfg, batch: int, seq: int, dtype, device="cuda"):
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, seq, m.kv_lora_rank), dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, seq, m.qk_rope_head_dim), dtype=dtype,
                                  device=device)}


def mla_decode(cfg, p, x, cache, pos: int):
    """Absorbed-form MLA decode: x [B,d], one token at ``pos``; the cache
    {"c_kv" [B,S,r], "k_rope" [B,S,rope]} is written in place at slot
    ``pos`` and attended directly (W_uk folded into the query, W_uv applied
    to the attended latent).  Scores and softmax in float32 (float64 stays
    float64), the probabilities rounded to the cache dtype, as the
    reference.  Returns (y [B,d], cache)."""
    m = cfg.mla
    # built on the device: a tensor of host data would be a blocking copy
    posv = torch.arange(pos, pos + 1, device=x.device)
    qn, qr = _mla_q(cfg, p, x[:, None, :], posv)
    qn, qr = qn[:, 0], qr[:, 0]                                       # [B,H,nope/rope]
    c_new = rms_norm(x @ p["w_dkv"], p["kv_norm"], cfg.rms_eps)       # [B,r]
    kr_new = apply_rope((x @ p["w_kr"])[:, None, :], posv, cfg.rope_theta)[:, 0]
    c_cache, kr_cache = cache["c_kv"], cache["k_rope"]
    c_cache[:, pos] = c_new.to(c_cache.dtype)
    kr_cache[:, pos] = kr_new.to(kr_cache.dtype)
    w_uk = p["w_ukv"][..., :m.qk_nope_head_dim]                       # [r,H,nope]
    w_uv = p["w_ukv"][..., m.qk_nope_head_dim:]                       # [r,H,v]
    q_abs = torch.einsum("bhn,rhn->bhr", qn, w_uk)                    # absorbed query
    s = torch.einsum("bhr,bsr->bhs", at_least_f32(q_abs), at_least_f32(c_cache))
    s = s + torch.einsum("bhr,bsr->bhs", at_least_f32(qr), at_least_f32(kr_cache))
    s = s / ((m.qk_nope_head_dim + m.qk_rope_head_dim) ** 0.5)
    S = c_cache.shape[1]
    s = torch.where(torch.arange(S, device=x.device) <= pos, s, NEG_INF)
    attn = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", attn.to(c_cache.dtype), c_cache)
    v = torch.einsum("bhr,rhv->bhv", ctx, w_uv)
    y = torch.einsum("bhv,hvd->bd", v, p["wo"])
    return y, cache
