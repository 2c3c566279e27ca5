"""Mamba-2 SSD (state-space duality) mixer — arXiv:2405.21060.

Chunked SSD algorithm: within-chunk attention-like dual form + inter-chunk
recurrence over chunk states (sequential in the number of chunks only).
Decode is the pure recurrent form with a (B, H, P, N) state and a conv
ring buffer.

Port of the JAX package's ``models/ssd.py``, with its casts: dt, the decay
and the state are f32 whatever the activations' dtype; ``ssd_spec`` and
``ssd_cache_spec`` give JAX's partition specs.

Shapes: d_inner = expand·d_model, H = d_inner/headdim heads, P = headdim,
N = ssm_state, G = ssm_groups (B/C shared across H/G heads per group).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import make_dense
from repro_torch.models.rglru import causal_conv, softplus
from repro_torch.models.shardctx import P


def init_ssd(gen: torch.Generator, cfg: ArchConfig, dtype):
    d = cfg.d_model
    di = cfg.d_inner
    h = cfg.ssm_nheads
    g, n = cfg.ssm_groups, cfg.ssm_state
    conv_ch = di + 2 * g * n
    dev = gen.device
    f32 = torch.float32
    proj_out = 2 * di + 2 * g * n + h        # [z, x, B, C, dt]
    return {
        "in_proj": make_dense(gen, (d, proj_out), dtype),
        "conv_w": make_dense(gen, (cfg.ssm_conv, conv_ch), dtype, scale=0.2),
        "conv_b": torch.zeros(conv_ch, dtype=dtype, device=dev),
        "a_log": torch.zeros(h, dtype=f32, device=dev),
        "dt_bias": torch.zeros(h, dtype=f32, device=dev),
        "d_skip": torch.ones(h, dtype=f32, device=dev),
        "out_proj": make_dense(gen, (di, d), dtype),
        "norm_scale": torch.ones(di, dtype=dtype, device=dev),
    }


def ssd_spec(cfg: ArchConfig):
    return {"in_proj": P(None, "model"), "conv_w": P(None, "model"),
            "conv_b": P("model"), "a_log": P("model"), "dt_bias": P("model"),
            "d_skip": P("model"), "out_proj": P("model", None),
            "norm_scale": P("model")}


def _split_proj(p, cfg: ArchConfig, u):
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_nheads
    zxbcdt = u @ p["in_proj"]
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * g * n]
    dt = zxbcdt[..., -h:]
    return z, xbc, dt


def _causal_conv(p, xbc):
    """Depthwise causal conv1d, width K: y_t = sum_k w_k x_{t-K+1+k}."""
    return F.silu(causal_conv(xbc, p["conv_w"]) + p["conv_b"])


def _gated_norm(p, y, z, eps=1e-6):
    y = y * F.silu(z)
    yf = y.to(torch.float32)
    ms = yf.square().mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(ms + eps)
            * p["norm_scale"].to(torch.float32)).to(y.dtype)


def ssd_forward(p, cfg: ArchConfig, u):
    """Training/prefill: (B, L, D) -> ((B, L, D), cache) with the decode
    cache at the last token: the final ssm state (f32) and the conv
    window, the last K-1 projected conv inputs (``ssd_decode``'s cache)."""
    bsz, L0, _ = u.shape
    di, g, n, h, hp = (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state,
                       cfg.ssm_nheads, cfg.ssm_headdim)
    q = cfg.ssm_chunk
    f32 = torch.float32
    # pad ragged tails; padded steps get dt=0 (decay 1, contribution 0) so
    # the final state equals the state at the last real token.
    L = -(-L0 // q) * q
    pad = L - L0
    if pad:
        u = F.pad(u, (0, 0, 0, pad))
    nc = L // q

    z, xbc_in, dt = _split_proj(p, cfg, u)
    xbc = _causal_conv(p, xbc_in)
    x = xbc[..., :di].reshape(bsz, L, h, hp)
    b_in = xbc[..., di:di + g * n].reshape(bsz, L, g, n)
    c_in = xbc[..., di + g * n:].reshape(bsz, L, g, n)
    # broadcast groups over heads
    rep = h // g
    b_h = torch.repeat_interleave(b_in, rep, dim=2)     # (B, L, H, N)
    c_h = torch.repeat_interleave(c_in, rep, dim=2)

    dt = softplus(dt.to(f32) + p["dt_bias"])           # (B, L, H)
    if pad:
        live = (torch.arange(L, device=u.device) < L0).to(dt.dtype)
        dt = dt * live[None, :, None]
    a = -torch.exp(p["a_log"])                          # (H,)
    dta = dt * a                                        # log decay
    xdt = x * dt[..., None].to(x.dtype)                 # dt-scaled input

    # chunk views
    xc = xdt.reshape(bsz, nc, q, h, hp)                 # (B, C#, Q, H, P)
    bc = b_h.reshape(bsz, nc, q, h, n)                  # (B, C#, Q, H, N)
    cc = c_h.reshape(bsz, nc, q, h, n)
    dtac = dta.reshape(bsz, nc, q, h)                   # (B, C#, Q, H)

    seg = torch.cumsum(dtac, dim=2)                     # (B,C#,Q,H)
    seg_last = seg[:, :, -1:]                           # (B,C#,1,H)

    # intra-chunk (dual / attention-like) term
    rel = seg[:, :, :, None, :] - seg[:, :, None, :, :]  # (B,C#,Qi,Qj,H)
    causal = torch.tril(torch.ones(q, q, dtype=torch.bool, device=u.device))
    # exp of the masked exponent, where JAX takes where(causal, exp(rel), 0):
    # the same values (exp(-inf) = 0), but above the diagonal rel > 0 and
    # exp(rel) overflows in f32 at long chunks, so JAX's gradient there is
    # 0 · inf = NaN; here the masked branch's gradient is exp(-inf) = 0
    decay = torch.exp(torch.where(causal[None, None, :, :, None], rel,
                                  float("-inf")))
    scores = torch.einsum("bcihn,bcjhn->bcijh", cc, bc) * decay.to(cc.dtype)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xc)

    # chunk states: S_c = sum_j exp(seg_last - seg_j) * x_j ⊗ B_j
    w = torch.exp(seg_last - seg)                       # (B,C#,Q,H)
    states = torch.einsum("bcjh,bcjhp,bcjhn->bchpn", w.to(xc.dtype), xc,
                          bc).to(f32)

    # inter-chunk recurrence over chunk states, in f32
    chunk_decay = torch.exp(seg_last[:, :, 0]).to(f32)  # (B,C#,H)
    s = torch.zeros(bsz, h, hp, n, dtype=states.dtype, device=u.device)
    s_prevs = torch.empty_like(states)                  # (B,C#,H,P,N)
    for c in range(nc):
        s_prevs[:, c] = s
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]

    # inter-chunk contribution: C_i · (exp(seg_i) * S_prev)
    y_inter = torch.einsum("bcihn,bchpn->bcihp",
                           cc * torch.exp(seg)[..., None].to(cc.dtype),
                           s_prevs.to(cc.dtype))

    y = (y_intra + y_inter).reshape(bsz, L, h, hp)
    y = y + x * p["d_skip"][None, None, :, None].to(x.dtype)
    y = y.reshape(bsz, L, di)
    y = _gated_norm(p, y, z)
    out = y @ p["out_proj"]
    if pad:
        out = out[:, :L0]
    conv = xbc_in[:, :L0][:, -(cfg.ssm_conv - 1):]
    return out, {"state": s, "conv": conv}


# --------------------------------------------------------------- decode

def init_ssd_cache(cfg: ArchConfig, batch: int, dtype, device="cuda"):
    h, hp, n = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    dev = resolve_device(device)
    return {"state": torch.zeros(batch, h, hp, n, dtype=torch.float32,
                                 device=dev),
            "conv": torch.zeros(batch, cfg.ssm_conv - 1, conv_ch,
                                dtype=dtype, device=dev)}


def ssd_cache_spec(cfg: ArchConfig):
    return {"state": P("data", "model", None, None),
            "conv": P("data", None, "model")}


def ssd_decode(p, cfg: ArchConfig, u, cache):
    """One token: u (B, 1, D) -> (B, 1, D); updates (state, conv ring)."""
    bsz = u.shape[0]
    di, g, n, h, hp = (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state,
                       cfg.ssm_nheads, cfg.ssm_headdim)
    f32 = torch.float32
    z, xbc, dt = _split_proj(p, cfg, u)
    # conv over (cached K-1 inputs, current)
    hist = torch.cat([cache["conv"], xbc], dim=1)             # (B, K, ch)
    conv_out = torch.sum(hist * p["conv_w"][None], dim=1, keepdim=True)
    xbc_t = F.silu(conv_out + p["conv_b"])
    new_conv = hist[:, 1:]

    x = xbc_t[..., :di].reshape(bsz, h, hp)
    b_t = torch.repeat_interleave(
        xbc_t[..., di:di + g * n].reshape(bsz, g, n), h // g, dim=1)
    c_t = torch.repeat_interleave(
        xbc_t[..., di + g * n:].reshape(bsz, g, n), h // g, dim=1)

    dt = softplus(dt[:, 0].to(f32) + p["dt_bias"])            # (B,H)
    a = torch.exp(dt * -torch.exp(p["a_log"]))                # decay
    xdt = x.to(f32) * dt[..., None]
    # products and a sum over n, not einsum: a batched matmul would fold
    # the head dim into its batch, which DTensor cannot do to a sharded dim
    # in every torch release
    state = (cache["state"] * a[..., None, None]
             + xdt[..., None] * b_t.to(f32)[:, :, None, :])
    y = (c_t.to(f32)[:, :, None, :] * state).sum(-1)
    y = y + x.to(f32) * p["d_skip"][None, :, None]
    y = y.reshape(bsz, 1, di).to(u.dtype)
    y = _gated_norm(p, y, z)
    return y @ p["out_proj"], {"state": state, "conv": new_conv}
