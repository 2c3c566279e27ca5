"""Shared neural-net layers: norms, RoPE, MLPs, embeddings.

Port of the JAX package's ``models/layers.py``, with its f32 casts (the
norms and the rotary embedding compute in f32 and cast back). Parameters
are plain dicts of tensors; an init function draws from the
``torch.Generator`` it is given, on that generator's device. Every init
function has a matching ``*_spec`` giving the tree's partition specs
(``shardctx.P``, JAX's ``PartitionSpec`` leaves: model axis = tensor
parallel, data axis = batch/sequence) for the dry-run.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.shardctx import P


def make_dense(gen: torch.Generator, shape, dtype, scale=None) -> torch.Tensor:
    """N(0, scale²) weights, scale 1/sqrt(fan_in) by default, drawn in f32
    from `gen` on its device and cast to `dtype`."""
    scale = scale if scale is not None else (1.0 / np.sqrt(shape[0]))
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * scale).to(dtype)


# ---------------------------------------------------------------- norms

def init_norm(dtype, dim, kind="rmsnorm", device="cuda"):
    dev = resolve_device(device)
    p = {"scale": torch.ones(dim, dtype=dtype, device=dev)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(dim, dtype=dtype, device=dev)
    return p


def norm_spec(kind="rmsnorm"):
    p = {"scale": P(None)}
    if kind == "layernorm":
        p["bias"] = P(None)
    return p


def apply_norm(p, x, kind="rmsnorm", eps=1e-6):
    xf = x.to(torch.float32)
    if kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"].to(torch.float32)
    return out.to(x.dtype)


def rms_head_norm(scale, x, eps=1e-6):
    """Per-head RMS norm over head_dim (qwen3 qk_norm). x: (..., H, hd)."""
    xf = x.to(torch.float32)
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)
            * scale.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------- RoPE

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(hd, theta), dtype=torch.float32,
                            device=x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, hd/2)
    angles = angles[..., None, :]                             # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., ::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    out = torch.stack([y1, y2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def sinusoidal_positions(seq_len: int, dim: int) -> np.ndarray:
    pos = np.arange(seq_len)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / 10000 ** (2 * i / dim)
    out = np.zeros((seq_len, dim), np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return out


# ---------------------------------------------------------------- MLP

def init_mlp(gen, dtype, d_model, d_ff, act="swiglu", bias=False):
    p = {"wi": make_dense(gen, (d_model, d_ff), dtype)}
    if act in ("swiglu", "geglu"):
        p["wg"] = make_dense(gen, (d_model, d_ff), dtype)
    p["wo"] = make_dense(gen, (d_ff, d_model), dtype)
    if bias:
        p["bi"] = torch.zeros(d_ff, dtype=dtype, device=gen.device)
        p["bo"] = torch.zeros(d_model, dtype=dtype, device=gen.device)
    return p


def mlp_spec(act="swiglu", bias=False):
    p = {"wi": P(None, "model"), "wo": P("model", None)}
    if act in ("swiglu", "geglu"):
        p["wg"] = P(None, "model")
    if bias:
        p["bi"] = P("model")
        p["bo"] = P(None)
    return p


def apply_mlp(p, x, act="swiglu"):
    h = x @ p["wi"]
    if "bi" in p:
        h = h + p["bi"]
    # jax.nn.gelu defaults to the tanh approximation
    if act == "swiglu":
        h = F.silu(h) * (x @ p["wg"])
    elif act == "geglu":
        h = F.gelu(h, approximate="tanh") * (x @ p["wg"])
    else:
        h = F.gelu(h, approximate="tanh")
    out = h @ p["wo"]
    if "bo" in p:
        out = out + p["bo"]
    return out


# ---------------------------------------------------------------- embed/unembed

def init_embed(gen, dtype, vocab, d_model):
    return {"table": make_dense(gen, (vocab, d_model), dtype, scale=0.02)}


def embed_spec():
    return {"table": P("model", None)}


def apply_embed(p, tokens):
    return F.embedding(tokens, p["table"])


def unembed_logits(embed_params, head, x, tie: bool):
    if tie:
        return x @ embed_params["table"].T
    return x @ head["w"]
