"""Grouped-query attention (port of the GQA part of ``repro.models.attention``).

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
  (``kernels/csrc/flash_attention_bwd_wgmma.cu`` for bf16 at head dim 64 or
  128, ``kernels/csrc/flash_attention_bwd.cu`` otherwise); autograd
  differentiates the CPU branches as they are.
* ``decode_attention`` is one query token against the cache, plain torch as
  in the reference.
* ``gqa_forward`` / ``gqa_decode`` are the full-sequence and one-token
  modules.  The decode cache is updated in place (a copy into the slot),
  where the reference returns a new cache and donates the old buffer.

q-head h reads kv-head h // G (G = H / Hkv) on every path.  Sliding windows,
prefix-LM masks and MLA raise ``NotImplementedError`` (ROADMAP Queue 1
item 20).
"""
from __future__ import annotations

import torch

from ..kernels import flash_attention as _flash
from ..kernels._cuda import on_card
from .layers import P, apply_rope, causal_mask

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


def _chunked_attention(qg, kg, vg, causal, scale, block_q, block_k, out_dtype):
    """Online softmax over (block_q, block_k) tiles: qg [B,G,Hkv,S,D],
    kg/vg [B,1,Hkv,Sk,D] -> [B,G,Hkv,S,Dv]; S and Sk are block multiples."""
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
                s = torch.where(k_pos <= q_pos, s, NEG_INF)
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
    """Causal (or full) attention; q [B, H, S, D], k/v [B, Hkv, Sk, D] with
    H % Hkv == 0 -> [B, H, S, D] in q's dtype.

    CUDA tensors: the hand-written flash kernel (any S; scores, softmax and
    accumulator in float32, as the Pallas kernel), through
    ``FlashAttentionFn`` when a gradient is asked for.  CPU tensors: the
    reference's plain masked branch, or its chunked branch when S·Sk exceeds
    4096²/16 and S, Sk are multiples of BLOCK_Q, BLOCK_K."""
    if prefix_len is not None:
        raise unported("prefix-LM attention")
    if window is not None:
        raise unported("sliding-window attention")
    if on_card(q):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return _flash.FlashAttentionFn.apply(q, k, v, causal)
        return _flash.flash_attention(q, k, v, causal=causal)
    B, H, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // Hkv
    scale = 1.0 / (D ** 0.5)
    qg = q.reshape(B, Hkv, G, S, D).transpose(1, 2)   # [B,G,Hkv,S,D]
    kg, vg = k[:, None], v[:, None]                    # [B,1,Hkv,Sk,D]
    if S * Sk <= 4096 * 4096 // 16 or S % BLOCK_Q or Sk % BLOCK_K:
        mask = (causal_mask(S, Sk, device=q.device) if causal
                else torch.ones((S, Sk), dtype=torch.bool, device=q.device))
        out = _plain_attention(qg, kg, vg, mask, scale)
    else:
        out = _chunked_attention(qg, kg, vg, causal, scale, BLOCK_Q, BLOCK_K,
                                 q.dtype)
    return out.transpose(1, 2).reshape(B, H, S, Dv)


def decode_attention(q, k_cache, v_cache, pos: int, *, window=None):
    """One-step decode: q [B,H,D] against cache [B,Hkv,S,D]; entries at
    indices > pos are masked.  Scores and softmax in float32; the
    probabilities are rounded to the cache dtype for the PV product, which
    accumulates in float32; the output has the cache dtype."""
    if window is not None:
        raise unported("ring-buffer (windowed) decode")
    B, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, D)  # q-head h -> kv-head h // G
    s = torch.einsum("bhgd,bhtd->bhgt", qg.float(), k_cache.float()) / (D ** 0.5)
    valid = torch.arange(S, device=q.device) <= pos
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


def gqa_forward(cfg, p, x, positions, *, return_kv=False):
    """x [B,S,d] -> [B,S,d] (and the layer's k, v [B,KV,S,hd] with
    ``return_kv``).  Full-sequence, causal (prefill)."""
    q, k, v = _qkv(cfg, p, x)                      # [B,S,heads,hd]
    q = apply_rope(q, positions, cfg.rope_theta).transpose(1, 2)
    k = apply_rope(k, positions, cfg.rope_theta).transpose(1, 2)
    v = v.transpose(1, 2)
    out = flash_attention(q, k, v)                 # [B,H,S,hd]
    y = torch.einsum("bhsk,hkd->bsd", out, p["wo"])
    if return_kv:
        return y, (k, v)
    return y


def gqa_init_cache(cfg, batch: int, seq: int, dtype, device="cuda"):
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    shape = (batch, KV, seq, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_decode(cfg, p, x, cache, pos: int):
    """x [B,d], one token at ``pos``; cache {"k","v"} [B,KV,S,hd] is written
    in place at slot ``pos``.  Returns (y [B,d], cache)."""
    q, k, v = _qkv(cfg, p, x)                      # [B,heads,hd]
    # built on the device: a tensor of host data would be a blocking copy
    posv = torch.arange(pos, pos + 1, device=x.device)
    q = apply_rope(q[:, None], posv, cfg.rope_theta)[:, 0]
    k = apply_rope(k[:, None], posv, cfg.rope_theta)[:, 0]
    cache["k"][:, :, pos] = k.to(cache["k"].dtype)
    cache["v"][:, :, pos] = v.to(cache["v"].dtype)
    out = decode_attention(q, cache["k"], cache["v"], pos)
    y = torch.einsum("bhk,hkd->bd", out, p["wo"])
    return y, cache

