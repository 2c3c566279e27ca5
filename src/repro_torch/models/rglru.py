"""RecurrentGemma recurrent block — RG-LRU (arXiv:2402.19427).

Block: x -> (gate branch: linear+GeLU) ⊙ (recurrent branch: linear ->
causal conv1d -> RG-LRU) -> output linear.

RG-LRU per channel:
  r_t = σ(W_r x_t),  i_t = σ(W_i x_t)
  log a_t = -c · softplus(Λ) · r_t          (c = 8)
  h_t = a_t · h_{t-1} + sqrt(1 - a_t²) · (i_t ⊙ x_t)

Port of the JAX package's ``models/rglru.py``; the gates and the state stay
in f32 whatever the activations' dtype. The full-sequence path runs the
recurrence as a log-depth (Hillis-Steele) scan over the length axis, where
JAX uses ``lax.associative_scan``; decode is the single-step recurrence.
``rglru_spec`` and ``rglru_cache_spec`` give JAX's partition specs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import make_dense
from repro_torch.models.shardctx import P

_C = 8.0


def init_rglru(gen: torch.Generator, cfg: ArchConfig, dtype):
    d = cfg.d_model
    w = cfg.lru_width or d
    dev = gen.device
    return {
        "in_gate": make_dense(gen, (d, w), dtype),
        "in_rec": make_dense(gen, (d, w), dtype),
        "conv_w": make_dense(gen, (cfg.conv1d_width, w), dtype, scale=0.2),
        "conv_b": torch.zeros(w, dtype=dtype, device=dev),
        "w_r": make_dense(gen, (w, w), dtype),
        "w_i": make_dense(gen, (w, w), dtype),
        "lam": torch.full((w,), 0.7, dtype=torch.float32, device=dev),
        "out": make_dense(gen, (w, d), dtype),
    }


def rglru_spec(cfg: ArchConfig):
    return {"in_gate": P(None, "model"), "in_rec": P(None, "model"),
            "conv_w": P(None, "model"), "conv_b": P("model"),
            "w_r": P(None, "model"), "w_i": P(None, "model"),
            "lam": P("model"), "out": P("model", None)}


def causal_conv(x, w):
    """Depthwise causal conv1d over (B, L, C) with taps w (K, C), no bias:
    y_t = sum_k w_k x_{t-K+1+k}, x zero before t = 0; the taps added in
    order k = 0..K-1. (Zeros concatenated in front and a running sum, where
    F.pad and sum() trip DTensor's rules in some torch releases.)"""
    k, n = w.shape[0], x.shape[1]
    pad = torch.cat([x.new_zeros((x.shape[0], k - 1, x.shape[2])), x], dim=1)
    out = pad[:, :n] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + n] * w[i]
    return out


def softplus(x):
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (``logaddexp(x, 0)``;
    F.softplus linearises above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _conv(p, x):
    return causal_conv(x, p["conv_w"]) + p["conv_b"]


def _gates(p, x):
    f32 = torch.float32
    r = torch.sigmoid((x @ p["w_r"]).to(f32))
    i = torch.sigmoid((x @ p["w_i"]).to(f32))
    log_a = -_C * softplus(p["lam"]) * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-12))
    return a, mult * i * x.to(f32)


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0, along axis 1, in
    ceil(log2 L) elementwise passes (Hillis-Steele)."""
    n, d = a.shape[1], 1
    while d < n:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        b = torch.cat([b[:, :d], a[:, d:] * b_prev + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a_prev], dim=1)
        d *= 2
    return b


def rglru_forward(p, cfg: ArchConfig, u):
    """(B, L, D) -> ((B, L, D), cache) with the decode cache at the last
    token: the final recurrent state (B, W) and the conv window, the last
    K-1 recurrent-branch inputs (``rglru_decode``'s cache)."""
    gate = F.gelu(u @ p["in_gate"], approximate="tanh")
    xr = u @ p["in_rec"]
    x = _conv(p, xr)
    a, b = _gates(p, x)                    # (B, L, W) f32 each
    h = linear_scan(a, b)
    y = (h.to(u.dtype) * gate) @ p["out"]
    return y, {"state": h[:, -1], "conv": xr[:, -(cfg.conv1d_width - 1):]}


def init_rglru_cache(cfg: ArchConfig, batch: int, dtype, device="cuda"):
    w = cfg.lru_width or cfg.d_model
    dev = resolve_device(device)
    return {"state": torch.zeros(batch, w, dtype=torch.float32, device=dev),
            "conv": torch.zeros(batch, cfg.conv1d_width - 1, w, dtype=dtype,
                                device=dev)}


def rglru_cache_spec(cfg: ArchConfig):
    return {"state": P("data", "model"), "conv": P("data", None, "model")}


def rglru_decode(p, cfg: ArchConfig, u, cache):
    gate = F.gelu(u @ p["in_gate"], approximate="tanh")   # (B, 1, W)
    xr = u @ p["in_rec"]
    hist = torch.cat([cache["conv"], xr], dim=1)
    x = (torch.sum(hist * p["conv_w"][None], dim=1, keepdim=True)
         + p["conv_b"])
    a, b = _gates(p, x)                               # (B, 1, W)
    state = a[:, 0] * cache["state"] + b[:, 0]
    y = (state[:, None].to(u.dtype) * gate) @ p["out"]
    return y, {"state": state, "conv": hist[:, 1:]}
