"""State-space and recurrent blocks: Mamba (jamba) and xLSTM (mLSTM +
sLSTM) (port of ``repro.models.ssm``).

Plain functions on tensors, in the reference's forms:

* Mamba's selective scan runs chunk by chunk (the reference's chunk rule:
  L = min(chunk, S), halved until it divides S), carrying the SSM state
  h [B, di, N] from chunk to chunk.  Inside a chunk the linear recurrence
  h_t = a_t·h_{t-1} + b_t is a log-depth scan (Hillis–Steele doubling with
  the reference's ``combine``), where the reference takes
  ``lax.associative_scan``: the same function, its products and sums
  associated in another order.  ``mamba_forward`` builds the decay a and
  the input term b [B, L, di, N] (float32) one chunk at a time; the
  reference builds them whole, [B, S, di, N].
* mLSTM uses the stabilized chunkwise-parallel form: intra-chunk decay
  matrices and the inter-chunk (C, n, m) state carry, a loop over chunks.
  ``mlstm_cell_sequential`` is the step-by-step form.
* sLSTM has a true hidden-to-hidden recurrence (block-diagonal R): a loop
  over time, a handful of small kernels a step (ROADMAP Queue 2 holds its
  scan kernel).

Spec trees and decode states have the reference's names, shapes and
dtypes: every state is float32 but Mamba's conv state, which has the
activation dtype.  (Float64 inputs, which the reference never sees, keep
float64 states: ``at_least_f32``.)  Each kind has ``*_specs``,
``*_forward`` (full sequence, returns the final state), ``*_decode`` (one
step) and ``*_init_state``.  No Pallas kernel backs any of it in the
reference either.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import P, at_least_f32, rms_norm

NEG_INF = -1e30


def _state_dtype(dtype) -> torch.dtype:
    """float32, or float64 for float64 activations (see ``at_least_f32``)."""
    return torch.promote_types(dtype, torch.float32)


def _chunk_len(S: int, chunk: int) -> int:
    """The reference's chunk rule: min(chunk, S), halved until it divides S."""
    L = min(chunk, S)
    while S % L:
        L //= 2
    return L


def _causal_conv1d(x, w, b):
    """Depthwise causal conv: x [B,S,C], w [K,C], b [C]."""
    K, S = w.shape[0], x.shape[1]
    out = torch.zeros_like(x)
    for i in range(K):
        shifted = F.pad(x, (0, 0, i, 0))[:, :S]
        out = out + shifted * w[K - 1 - i]
    return out + b


def _conv1d_step(x_new, conv_state, w, b):
    """x_new [B,C]; conv_state [B,K-1,C] (previous inputs, oldest first)."""
    window = torch.cat([conv_state, x_new[:, None, :]], dim=1)       # [B,K,C]
    y = torch.einsum("bkc,kc->bc", window, w) + b
    return y, window[:, 1:]


# ===========================================================================
# Mamba (S6)
# ===========================================================================
def mamba_dims(cfg):
    di = cfg.ssm.expand * cfg.d_model
    dt_rank = -(-cfg.d_model // 16)
    return di, dt_rank, cfg.ssm.d_state


def mamba_specs(cfg) -> dict:
    d = cfg.d_model
    di, dt_rank, N = mamba_dims(cfg)
    K = cfg.ssm.d_conv
    return {
        "in_proj": P((d, 2 * di), ("embed", "inner")),
        "conv_w": P((K, di), (None, "inner")),
        "conv_b": P((di,), ("inner",), init="zeros"),
        "x_proj": P((di, dt_rank + 2 * N), ("inner", None)),
        "dt_w": P((dt_rank, di), (None, "inner")),
        "dt_b": P((di,), ("inner",), init="ones"),
        "A_log": P((di, N), ("inner", None), init="ones"),
        "D": P((di,), ("inner",), init="ones"),
        "out_proj": P((di, d), ("inner", "embed")),
    }


def _scan_chunk(a, b, Cp, h):
    """One chunk of h_t = a_t·h_{t-1} + b_t from h: a/b [B,L,di,N], Cp
    [B,L,N], h [B,di,N] -> (h_L, y [B,L,di]) with y_t = C_t·h_t.  The scan
    doubles its reach each round: after the round of reach r, element t
    holds the composition of elements t-2r+1 … t (the reference's
    ``combine(c1, c2) = (a2·a1, a2·b1 + b2)``, c1 the earlier)."""
    L = a.shape[1]
    r = 1
    while r < L:
        b = torch.cat([b[:, :r], torch.addcmul(b[:, r:], a[:, r:], b[:, :-r])], dim=1)
        a = torch.cat([a[:, :r], a[:, r:] * a[:, :-r]], dim=1)
        r *= 2
    hs = a * h[:, None] + b
    return hs[:, -1], torch.einsum("bldn,bln->bld", hs, Cp)


def _mamba_scan(a, b, Cp, h0, chunk: int):
    """h_t = a_t·h_{t-1} + b_t chunk by chunk, emitting y_t = C_t·h_t.

    a/b [B,S,di,N]; Cp [B,S,N]; h0 [B,di,N].  Returns (h_last, y [B,S,di])."""
    S = a.shape[1]
    L = _chunk_len(S, chunk)
    h, ys = h0, []
    for lo in range(0, S, L):
        h, y = _scan_chunk(a[:, lo:lo + L], b[:, lo:lo + L], Cp[:, lo:lo + L], h)
        ys.append(y)
    return h, torch.cat(ys, dim=1)


def mamba_forward(cfg, p, x, state=None):
    """x [B,S,d] -> (y [B,S,d], state).  The scan's decay a = exp(dt·A) and
    input term b = dt·x·B [B,L,di,N] are built one chunk at a time."""
    B, S, d = x.shape
    di, dt_rank, N = mamba_dims(cfg)
    if state is None:
        state = mamba_init_state(cfg, B, x.dtype, x.device)
    xz = x @ p["in_proj"]
    xm, z = xz[..., :di], xz[..., di:]
    # causal depthwise conv (prepend carried conv state)
    K = cfg.ssm.d_conv
    xm_ext = torch.cat([state["conv"].to(xm.dtype), xm], dim=1)
    xm_c = _causal_conv1d(xm_ext, p["conv_w"], p["conv_b"])[:, K - 1:]
    new_conv = xm_ext[:, -(K - 1):] if K > 1 else state["conv"]
    xm_c = F.silu(at_least_f32(xm_c)).to(x.dtype)

    dt_in, Bp, Cp = (xm_c @ p["x_proj"]).split([dt_rank, N, N], dim=-1)
    dt = F.softplus(at_least_f32(dt_in @ p["dt_w"]) + at_least_f32(p["dt_b"]))  # [B,S,di]
    A = -torch.exp(at_least_f32(p["A_log"]))                                   # [di,N]
    xf, Bf, Cf = at_least_f32(xm_c), at_least_f32(Bp), at_least_f32(Cp)
    L = _chunk_len(S, cfg.ssm.chunk)
    h, ys = state["h"], []
    for lo in range(0, S, L):
        dtc = dt[:, lo:lo + L]
        a = torch.exp(dtc[..., None] * A)                                     # [B,L,di,N]
        bterm = (dtc * xf[:, lo:lo + L])[..., None] * Bf[:, lo:lo + L, None, :]
        h, y = _scan_chunk(a, bterm, Cf[:, lo:lo + L], h)
        ys.append(y)
        del a, bterm
    y = torch.cat(ys, dim=1) + at_least_f32(p["D"]) * xf
    y = (y * F.silu(at_least_f32(z))).to(x.dtype)
    out = y @ p["out_proj"]
    return out, {"h": h, "conv": new_conv.to(state["conv"].dtype)}


def mamba_decode(cfg, p, x, state):
    """x [B,d] one step; returns (y [B,d], new state).  The new conv state
    has the activation dtype, as the reference's."""
    di, dt_rank, N = mamba_dims(cfg)
    xz = x @ p["in_proj"]
    xm, z = xz[..., :di], xz[..., di:]
    xm_c, new_conv = _conv1d_step(xm, state["conv"].to(xm.dtype), p["conv_w"], p["conv_b"])
    xm_c = F.silu(at_least_f32(xm_c)).to(x.dtype)
    dt_in, Bp, Cp = (xm_c @ p["x_proj"]).split([dt_rank, N, N], dim=-1)
    dt = F.softplus(at_least_f32(dt_in @ p["dt_w"]) + at_least_f32(p["dt_b"]))  # [B,di]
    A = -torch.exp(at_least_f32(p["A_log"]))
    a = torch.exp(dt[..., None] * A)                                           # [B,di,N]
    b = (dt * at_least_f32(xm_c))[..., None] * at_least_f32(Bp)[:, None, :]
    h = a * state["h"] + b
    y = torch.einsum("bdn,bn->bd", h, at_least_f32(Cp))
    y = y + at_least_f32(p["D"]) * at_least_f32(xm_c)
    y = (y * F.silu(at_least_f32(z))).to(x.dtype)
    return y @ p["out_proj"], {"h": h, "conv": new_conv}


def mamba_init_state(cfg, batch: int, dtype, device="cuda"):
    """h [B,di,N] float32 and the conv state [B,K-1,di] in ``dtype``."""
    di, _, N = mamba_dims(cfg)
    return {
        "h": torch.zeros((batch, di, N), dtype=_state_dtype(dtype), device=device),
        "conv": torch.zeros((batch, cfg.ssm.d_conv - 1, di), dtype=dtype, device=device),
    }


# ===========================================================================
# mLSTM (xLSTM) — matrix memory with exponential gating
# ===========================================================================
def mlstm_dims(cfg):
    di = 2 * cfg.d_model
    H = cfg.n_heads
    dh = di // H
    return di, H, dh


def mlstm_specs(cfg) -> dict:
    d = cfg.d_model
    di, H, dh = mlstm_dims(cfg)
    K = 4  # short conv on the q/k path (xLSTM block)
    return {
        "norm": P((d,), ("embed",), init="ones"),
        "w_up": P((d, 2 * di), ("embed", "inner")),
        "conv_w": P((K, di), (None, "inner")),
        "conv_b": P((di,), ("inner",), init="zeros"),
        "wq": P((di, di), ("inner", "inner2")),
        "wk": P((di, di), ("inner", "inner2")),
        "wv": P((di, di), ("inner", "inner2")),
        "w_i": P((di, H), ("inner", "heads"), init="small"),
        "b_i": P((H,), ("heads",), init="zeros"),
        "w_f": P((di, H), ("inner", "heads"), init="small"),
        "b_f": P((H,), ("heads",), init="ones"),
        "gn": P((di,), ("inner",), init="ones"),
        "w_down": P((di, d), ("inner", "embed")),
    }


def _mlstm_chunk(q, k, v, logi, logf, state):
    """One chunk of stabilized chunkwise mLSTM.

    q/k/v [B,H,L,dh]; logi/logf [B,H,L]; state (C [B,H,dh,dh], n [B,H,dh],
    m [B,H]).  Returns (h [B,H,L,dh], new_state)."""
    L, dh = q.shape[2], q.shape[3]
    C0, n0, m0 = state
    Fc = torch.cumsum(logf, dim=-1)                            # [B,H,L] inclusive
    # decay matrix D[t,j] = F_t - F_j + logi_j for j<=t
    Dm = Fc[..., :, None] - Fc[..., None, :] + logi[..., None, :]
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    Dm = torch.where(tri, Dm, NEG_INF)
    # stabilizer: max over intra contributions and the carried state
    m_t = torch.maximum(Dm.amax(dim=-1), Fc + m0[..., None])   # [B,H,L]
    d_intra = torch.exp(Dm - m_t[..., None])                   # [B,H,L,L]
    d_inter = torch.exp(Fc + m0[..., None] - m_t)              # [B,H,L]

    qk = torch.einsum("bhld,bhjd->bhlj", q, k) / (dh ** 0.5)
    w = qk * d_intra
    num = torch.einsum("bhlj,bhjd->bhld", w, v)
    num = num + d_inter[..., None] * torch.einsum("bhld,bhde->bhle", q, C0)
    # denominator: n_t · q_t with the same stabilization
    den = w.sum(dim=-1) + d_inter * torch.einsum("bhd,bhld->bhl", n0, q)
    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]

    # chunk-end state
    last = Fc[..., -1:] - Fc + logi                            # [B,H,L]
    mL = torch.maximum(Fc[..., -1] + m0, last.amax(dim=-1))
    scale_old = torch.exp(Fc[..., -1] + m0 - mL)               # [B,H]
    w_j = torch.exp(last - mL[..., None])                      # [B,H,L]
    ks = k / (dh ** 0.5)
    C_new = scale_old[..., None, None] * C0 + torch.einsum("bhl,bhld,bhle->bhde", w_j, ks, v)
    n_new = scale_old[..., None] * n0 + torch.einsum("bhl,bhld->bhd", w_j, ks)
    return h, (C_new, n_new, mL)


def mlstm_cell(q, k, v, logi, logf, state, chunk: int):
    """Full-sequence chunkwise mLSTM.  q/k/v [B,H,S,dh]."""
    S = q.shape[2]
    L = _chunk_len(S, chunk)
    hs = []
    for lo in range(0, S, L):
        h, state = _mlstm_chunk(q[:, :, lo:lo + L], k[:, :, lo:lo + L], v[:, :, lo:lo + L],
                                logi[..., lo:lo + L], logf[..., lo:lo + L], state)
        hs.append(h)
    return torch.cat(hs, dim=2), state


def mlstm_cell_sequential(q, k, v, logi, logf, state):
    """Step-by-step oracle for tests (identical math, a loop over time)."""
    dh = q.shape[-1]
    C, n, m = state
    hs = []
    for t in range(q.shape[2]):
        qt, kt, vt, it, ft = q[:, :, t], k[:, :, t], v[:, :, t], logi[..., t], logf[..., t]
        m_new = torch.maximum(ft + m, it)
        ip = torch.exp(it - m_new)
        fp = torch.exp(ft + m - m_new)
        kn = kt / (dh ** 0.5)
        C = fp[..., None, None] * C + ip[..., None, None] * kn[..., :, None] * vt[..., None, :]
        n = fp[..., None] * n + ip[..., None] * kn
        num = torch.einsum("bhde,bhd->bhe", C, qt)
        den = torch.maximum(torch.einsum("bhd,bhd->bh", n, qt).abs(), torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=2), (C, n, m)


def mlstm_forward(cfg, p, x, state=None):
    """x [B,S,d] -> (y [B,S,d], state); the conv state is float32 in and
    out, taken to the activation dtype for the conv."""
    B, S, d = x.shape
    di, H, dh = mlstm_dims(cfg)
    if state is None:
        state = mlstm_init_state(cfg, B, x.dtype, x.device)
    xi = rms_norm(x, p["norm"], cfg.rms_eps)
    up = xi @ p["w_up"]
    xm, z = up[..., :di], up[..., di:]
    K = p["conv_w"].shape[0]
    xm_ext = torch.cat([state["conv"].to(xm.dtype), xm], dim=1)
    xc = _causal_conv1d(xm_ext, p["conv_w"], p["conv_b"])[:, K - 1:]
    new_conv = xm_ext[:, -(K - 1):]
    xc = F.silu(at_least_f32(xc)).to(x.dtype)

    def heads(t):
        return at_least_f32(t.reshape(B, S, H, dh).transpose(1, 2))

    q, k, v = heads(xc @ p["wq"]), heads(xc @ p["wk"]), heads(xm @ p["wv"])
    logi = at_least_f32(xc @ p["w_i"] + p["b_i"]).transpose(1, 2)
    logf = F.logsigmoid(at_least_f32(xc @ p["w_f"] + p["b_f"])).transpose(1, 2)
    h, (C, n, m) = mlstm_cell(q, k, v, logi, logf, (state["C"], state["n"], state["m"]),
                              cfg.ssm.chunk if cfg.ssm else 256)
    h = h.transpose(1, 2).reshape(B, S, di)
    h = rms_norm(h.to(x.dtype), p["gn"], cfg.rms_eps)
    h = h * F.silu(at_least_f32(z)).to(x.dtype)
    out = h @ p["w_down"]
    return out, {"C": C, "n": n, "m": m, "conv": new_conv.to(state["conv"].dtype)}


def mlstm_decode(cfg, p, x, state):
    """x [B,d] one step; returns (y [B,d], new state).  The new conv state
    has the activation dtype, as the reference's."""
    di, H, dh = mlstm_dims(cfg)
    B = x.shape[0]
    xi = rms_norm(x, p["norm"], cfg.rms_eps)
    up = xi @ p["w_up"]
    xm, z = up[..., :di], up[..., di:]
    xc, new_conv = _conv1d_step(xm, state["conv"].to(xm.dtype), p["conv_w"], p["conv_b"])
    xc = F.silu(at_least_f32(xc)).to(x.dtype)
    q = at_least_f32((xc @ p["wq"]).reshape(B, H, dh))
    k = at_least_f32((xc @ p["wk"]).reshape(B, H, dh)) / (dh ** 0.5)
    v = at_least_f32((xm @ p["wv"]).reshape(B, H, dh))
    logi = at_least_f32(xc @ p["w_i"] + p["b_i"])
    logf = F.logsigmoid(at_least_f32(xc @ p["w_f"] + p["b_f"]))
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(logf + m, logi)
    ip = torch.exp(logi - m_new)
    fp = torch.exp(logf + m - m_new)
    # rank-1 factorizable update (paper Sec. 5): C += i · k vᵀ
    C = fp[..., None, None] * C + ip[..., None, None] * k[..., :, None] * v[..., None, :]
    n = fp[..., None] * n + ip[..., None] * k
    num = torch.einsum("bhde,bhd->bhe", C, q)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n, q).abs(), torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, di)
    h = rms_norm(h.to(x.dtype), p["gn"], cfg.rms_eps)
    h = h * F.silu(at_least_f32(z)).to(x.dtype)
    return h @ p["w_down"], {"C": C, "n": n, "m": m_new, "conv": new_conv}


def mlstm_init_state(cfg, batch: int, dtype=torch.float32, device="cuda"):
    """C [B,H,dh,dh], n [B,H,dh], m [B,H] (−1e30) and the conv state
    [B,3,di], all float32 whatever the activation ``dtype``."""
    di, H, dh = mlstm_dims(cfg)
    sd = _state_dtype(dtype)
    return {
        "C": torch.zeros((batch, H, dh, dh), dtype=sd, device=device),
        "n": torch.zeros((batch, H, dh), dtype=sd, device=device),
        "m": torch.full((batch, H), NEG_INF, dtype=sd, device=device),
        "conv": torch.zeros((batch, 3, di), dtype=sd, device=device),
    }


# ===========================================================================
# sLSTM — scalar memory, true recurrence (sequential)
# ===========================================================================
def slstm_dims(cfg):
    H = cfg.n_heads
    dh = cfg.d_model // H
    return H, dh


def slstm_specs(cfg) -> dict:
    d = cfg.d_model
    H, dh = slstm_dims(cfg)
    return {
        "norm": P((d,), ("embed",), init="ones"),
        "W": P((d, 4 * d), ("embed", "inner")),
        "b": P((4 * d,), ("inner",), init="zeros"),
        "R": P((H, dh, 4 * dh), (None, "state_dim", None), init="small"),
        "gn": P((d,), ("embed",), init="ones"),
        "w_out": P((d, d), ("embed", "embed2")),
    }


def _slstm_step(cfg, p, st, xw):
    """xw [B, 4*d] (input projection of this step); st (c, n, h, m), each
    [B,H,dh].  The recurrence is a batched product over heads: h [H,B,dh]
    times R [H,dh,4·dh], with R taken to the state's dtype (the
    reference's einsum promotes a bf16 R to float32)."""
    H, dh = slstm_dims(cfg)
    c, n, h, m = st
    B = xw.shape[0]
    R = p["R"].to(torch.promote_types(p["R"].dtype, h.dtype))
    rec = torch.bmm(h.transpose(0, 1), R).transpose(0, 1)     # [B,H,4*dh]
    gates = xw.reshape(B, H, 4 * dh) + rec
    zr, ir, fr, orr = gates.chunk(4, dim=-1)                  # [B,H,dh] each
    z = torch.tanh(at_least_f32(zr))
    o = torch.sigmoid(at_least_f32(orr))
    logi = at_least_f32(ir)
    logf = F.logsigmoid(at_least_f32(fr))
    m_new = torch.maximum(logf + m, logi)
    ip = torch.exp(logi - m_new)
    fp = torch.exp(logf + m - m_new)
    c = fp * c + ip * z
    n = fp * n + ip
    h_new = o * c / torch.clamp(n, min=1e-6)
    return (c, n, h_new, m_new)


def slstm_forward(cfg, p, x, state=None):
    """x [B,S,d] -> (y [B,S,d], state): the input projection for all steps
    at once, then ``_slstm_step`` a step (R cast once, outside the loop)."""
    B, S, d = x.shape
    if state is None:
        state = slstm_init_state(cfg, B, x.dtype, x.device)
    xi = rms_norm(x, p["norm"], cfg.rms_eps)
    xw = xi @ p["W"] + p["b"]                                 # [B,S,4d]
    st = (state["c"], state["n"], state["h"], state["m"])
    pr = {"R": p["R"].to(torch.promote_types(p["R"].dtype, st[2].dtype))}
    hs = []
    for t in range(S):
        st = _slstm_step(cfg, pr, st, xw[:, t])
        hs.append(st[2])
    h = torch.stack(hs, dim=1).reshape(B, S, d)               # [B,S,H,dh]->[B,S,d]
    h = rms_norm(h.to(x.dtype), p["gn"], cfg.rms_eps)
    out = h @ p["w_out"]
    return out, {"c": st[0], "n": st[1], "h": st[2], "m": st[3]}


def slstm_decode(cfg, p, x, state):
    xi = rms_norm(x, p["norm"], cfg.rms_eps)
    xw = xi @ p["W"] + p["b"]
    st = _slstm_step(cfg, p, (state["c"], state["n"], state["h"], state["m"]), xw)
    h = st[2].reshape(x.shape[0], -1)
    h = rms_norm(h.to(x.dtype), p["gn"], cfg.rms_eps)
    return h @ p["w_out"], {"c": st[0], "n": st[1], "h": st[2], "m": st[3]}


def slstm_init_state(cfg, batch: int, dtype=torch.float32, device="cuda"):
    """c, n, h zeros and m −1e30, each [B,H,dh] float32."""
    H, dh = slstm_dims(cfg)
    sd = _state_dtype(dtype)

    def zeros():
        return torch.zeros((batch, H, dh), dtype=sd, device=device)

    return {"c": zeros(), "n": zeros(), "h": zeros(),
            "m": torch.full((batch, H, dh), NEG_INF, dtype=sd, device=device)}
