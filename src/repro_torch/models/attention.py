"""Attention: GQA self-attention (full / causal / sliding-window), cross-
attention, and single-token decode against full or ring (sliding-window)
KV caches.

Port of the JAX package's ``models/attention.py``, with its f32 casts of
the scores. As there, the layer is plain PyTorch: sequences longer than
BLOCKWISE_THRESHOLD take `blockwise_attention`, the online-softmax
counterpart of the flash kernel (``kernels/flash_attention.py``) and its
numerical oracle; the layer does not call the kernel. ``attention_spec``
and ``kv_cache_spec`` give JAX's partition specs of the parameters and the
cache (``shardctx.P``). Functions are pure: a cache update returns new
tensors.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import apply_rope, make_dense, rms_head_norm
from repro_torch.models.shardctx import P, shard_local

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg: ArchConfig, dtype,
                   cross: bool = False):
    d, h, k = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    dev = gen.device
    p = {
        "wq": make_dense(gen, (d, h * hd), dtype),
        "wk": make_dense(gen, (d, k * hd), dtype),
        "wv": make_dense(gen, (d, k * hd), dtype),
        "wo": make_dense(gen, (h * hd, d), dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(h * hd, dtype=dtype, device=dev)
        p["bk"] = torch.zeros(k * hd, dtype=dtype, device=dev)
        p["bv"] = torch.zeros(k * hd, dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["qnorm"] = torch.ones(hd, dtype=dtype, device=dev)
        p["knorm"] = torch.ones(hd, dtype=dtype, device=dev)
    if cross:
        p["gate"] = torch.zeros((), dtype=dtype, device=dev)  # tanh gate
    return p


def attention_spec(cfg: ArchConfig, cross: bool = False):
    p = {"wq": P(None, "model"), "wk": P(None, "model"),
         "wv": P(None, "model"), "wo": P("model", None)}
    if cfg.qkv_bias:
        p.update(bq=P("model"), bk=P("model"), bv=P("model"))
    if cfg.qk_norm:
        p.update(qnorm=P(None), knorm=P(None))
    if cross:
        p["gate"] = P()
    return p


def attention_params_from_jax(np_params: dict, device="cuda") -> dict:
    """Carry the JAX attention layer's parameters (``wq wk wv wo`` and,
    where present, ``bq bk bv qnorm knorm gate``, as numpy arrays; bf16
    ones through f32, exactly) into the port: the layouts are the same."""
    dev = resolve_device(device)
    out = {}
    for name, value in np_params.items():
        a = np.asarray(value)
        if a.dtype.name == "bfloat16":
            out[name] = torch.from_numpy(a.astype(np.float32)).to(
                dev, torch.bfloat16)
        else:
            out[name] = torch.from_numpy(np.array(a)).to(dev)
    return out


def _project_qkv(p, cfg: ArchConfig, xq, xkv):
    h, k, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = xq @ p["wq"]
    kk = xkv @ p["wk"]
    v = xkv @ p["wv"]
    if cfg.qkv_bias:
        q, kk, v = q + p["bq"], kk + p["bk"], v + p["bv"]
    q = q.reshape(*xq.shape[:-1], h, hd)
    kk = kk.reshape(*xkv.shape[:-1], k, hd)
    v = v.reshape(*xkv.shape[:-1], k, hd)
    if cfg.qk_norm:
        q = rms_head_norm(p["qnorm"], q)
        kk = rms_head_norm(p["knorm"], kk)
    return q, kk, v


def _gqa_scores(q, k):
    """q: (B,S,H,hd), k: (B,T,K,hd) -> (B,S,K,G,T) grouped scores."""
    b, s, h, hd = q.shape
    kheads = k.shape[2]
    g = h // kheads
    qg = q.reshape(b, s, kheads, g, hd)
    root = torch.tensor(math.sqrt(hd), dtype=q.dtype, device=q.device)
    return torch.einsum("bskgd,btkd->bskgt", qg, k) / root


def _gqa_out(probs, v, h):
    b, s, kheads, g, t = probs.shape
    out = torch.einsum("bskgt,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, -1)


@shard_local
def gqa_attend(q, k, v, mask, dtype):
    """The attention core: (B,S,H,hd) queries over (B,T,K,hd) keys and
    values, f32 scores masked by `mask` (or None), probs cast to `dtype`
    -> (B,S,H,vd)."""
    scores = _gqa_scores(q, k).to(torch.float32)
    probs = _softmax_probs(scores, mask, dtype)
    return _gqa_out(probs, v, q.shape[2])


def _softmax_probs(scores, mask, dtype):
    """softmax over the last axis of the f32 scores, masked ones -1e30,
    cast to `dtype`."""
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    return torch.softmax(scores, dim=-1).to(dtype)


# Sequences longer than this use the blockwise online-softmax path (never
# materializes the S×S score matrix) — the plain analogue of the flash
# kernel, and its numerical oracle.
BLOCKWISE_THRESHOLD = 4096
Q_BLOCK = 1024
KV_BLOCK = 1024


@shard_local
def blockwise_attention(q, k, v, positions, causal: bool, window: int,
                        q_block: int = Q_BLOCK, kv_block: int = KV_BLOCK):
    """Online-softmax attention over (q, kv) blocks.

    q: (B,S,H,hd), k/v: (B,T,K,hd) -> (B,S,H,hd). positions: (S,) == (T,).
    """
    b, s, h, hd = q.shape
    t, kheads = k.shape[1], k.shape[2]
    vd = v.shape[-1]                       # may differ from hd (MLA)
    if q.device.type == "meta":
        # nothing is allocated on meta: one block gives the same shapes
        q_block, kv_block = s, t
    g = h // kheads
    assert s % q_block == 0 and t % kv_block == 0, (s, t)
    nq, nk = s // q_block, t // kv_block
    scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32

    qb = q.reshape(b, nq, q_block, kheads, g, hd)
    kb = k.reshape(b, nk, kv_block, kheads, hd)
    vb = v.reshape(b, nk, kv_block, kheads, vd)
    posq = positions.reshape(nq, q_block)
    posk = (positions.reshape(nk, kv_block) if t == s else
            torch.arange(t, device=q.device).reshape(nk, kv_block))

    outs = []
    for qi in range(nq):
        q_i, pos_i = qb[:, qi], posq[qi]
        m = torch.full((b, q_block, kheads, g), float("-inf"), dtype=f32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, q_block, kheads, g, vd, dtype=f32,
                          device=q.device)
        for ki in range(nk):
            k_j, v_j, pos_j = kb[:, ki], vb[:, ki], posk[ki]
            sc = torch.einsum("bqkgd,bckd->bqkgc", q_i, k_j).to(f32)
            sc = sc * scale
            mask = torch.ones(q_block, kv_block, dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= pos_j[None, :] <= pos_i[:, None]
            if window:
                mask &= pos_i[:, None] - pos_j[None, :] < window
            sc = torch.where(mask[None, :, None, None, :], sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            pexp = torch.exp(sc - m_new[..., None])
            l = l * alpha + pexp.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqkgc,bckd->bqkgd", pexp.to(v_j.dtype), v_j).to(f32)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.to(q.dtype))
    return torch.stack(outs, dim=1).reshape(b, s, h, vd)


def _self_mask(positions, causal: bool, window: int):
    """(1, S, 1, 1, S) mask of the dense self-attention scores."""
    s = positions.shape[0]
    mask = torch.ones(s, s, dtype=torch.bool, device=positions.device)
    if causal:
        mask &= positions[None, :] <= positions[:, None]
    if window:
        mask &= positions[:, None] - positions[None, :] < window
    return mask[None, :, None, None, :]


def self_attention(p, cfg: ArchConfig, x, positions, use_rope: bool = True,
                   causal: bool = True):
    """Full-sequence self-attention (train / prefill)."""
    q, k, v = _project_qkv(p, cfg, x, x)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    s = x.shape[1]
    if s > BLOCKWISE_THRESHOLD and s % Q_BLOCK == 0:
        out = blockwise_attention(q, k, v, positions, causal,
                                  cfg.sliding_window)
        return out.reshape(*x.shape[:-1], -1) @ p["wo"]
    out = gqa_attend(q, k, v,
                     _self_mask(positions, causal, cfg.sliding_window),
                     x.dtype)
    return out.reshape(*x.shape[:-1], -1) @ p["wo"]


def cross_attention(p, cfg: ArchConfig, x, memory, gated: bool = False):
    """Cross-attention to encoder / vision memory (no RoPE)."""
    q, k, v = _project_qkv(p, cfg, x, memory)
    out = gqa_attend(q, k, v, None, x.dtype)
    out = out.reshape(*x.shape[:-1], -1) @ p["wo"]
    if gated:
        out = torch.tanh(p["gate"]).to(out.dtype) * out
    return out


# ------------------------------------------------------------------ caches

def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                  device="cuda"):
    """Full cache, or ring cache of size sliding_window when set."""
    length = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    dev = resolve_device(device)
    shape = (batch, length, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def kv_cache_spec(cfg: ArchConfig, shard_heads: bool):
    """Shard kv-head axis when it divides the mesh; else shard cache length."""
    if shard_heads:
        return {"k": P("data", None, "model", None),
                "v": P("data", None, "model", None)}
    return {"k": P("data", "model", None, None),
            "v": P("data", "model", None, None)}


def _write_slot(cache, new, slot: int, inplace: bool = False):
    """`cache` with `new` (B, n, K, hd) written from `slot` on: a copy, or
    `cache` itself when `inplace`; the start is clamped so the update fits,
    as jax.lax's dynamic_update_slice does."""
    start = min(max(slot, 0), cache.shape[1] - new.shape[1])
    out = cache if inplace else cache.clone()
    out[:, start:start + new.shape[1]] = new
    return out


def decode_attention(p, cfg: ArchConfig, x, cache, pos: int,
                     use_rope: bool = True, inplace: bool = False):
    """One-token decode: x (B,1,D); cache holds `pos` previous tokens.

    Returns (out, new_cache).  Ring-buffer writes when sliding_window is set;
    with `inplace` the new token is written into `cache`, which is returned.
    """
    b = x.shape[0]
    pos = int(pos)
    length = cache["k"].shape[1]
    q, k_new, v_new = _project_qkv(p, cfg, x, x)
    if use_rope:
        posv = torch.full((b, 1), pos, device=x.device)
        q = apply_rope(q, posv, cfg.rope_theta)
        k_new = apply_rope(k_new, posv, cfg.rope_theta)
    slot = (pos % length) if cfg.sliding_window else pos
    k_cache = _write_slot(cache["k"], k_new, slot, inplace)
    v_cache = _write_slot(cache["v"], v_new, slot, inplace)
    idx = torch.arange(length, device=x.device)
    if cfg.sliding_window:
        # the ring holds the last `length` positions <= pos: slot t holds
        # absolute position `written`, negative where never written
        written = torch.where(idx <= slot, idx + (pos - slot),
                              idx + (pos - slot) - length)
        valid = written >= 0
    else:
        valid = idx <= pos
    out = gqa_attend(q, k_cache, v_cache, valid[None, None, None, None, :],
                     x.dtype)
    out = out.reshape(b, 1, -1) @ p["wo"]
    return out, {"k": k_cache, "v": v_cache}


def _roll1(x, shift: int):
    """torch.roll(x, shift, 1) as two slices (DTensor has no rule for
    roll in every torch release)."""
    if shift == 0:
        return x
    return torch.cat([x[:, -shift:], x[:, :-shift]], dim=1)


def prefill_attention(p, cfg: ArchConfig, x, positions, cache, use_rope=True,
                      inplace: bool = False):
    """Full-sequence (causal) attention that also fills the KV cache (a
    copy, or `cache` itself when `inplace`)."""
    q, k, v = _project_qkv(p, cfg, x, x)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    s = x.shape[1]
    out = gqa_attend(q, k, v, _self_mask(positions, True, cfg.sliding_window),
                     x.dtype)
    out = out.reshape(*x.shape[:-1], -1) @ p["wo"]
    length = cache["k"].shape[1]
    if cfg.sliding_window and length < s:
        # ring layout: absolute position t sits at slot t % length. Every
        # slot is written (the ring holds the last `length` positions), so
        # the ring is the last positions rotated by (s - length) % length
        shift = (s - length) % length
        k_ring = _roll1(k[:, -length:], shift).to(cache["k"].dtype)
        v_ring = _roll1(v[:, -length:], shift).to(cache["v"].dtype)
        k_cache = cache["k"].copy_(k_ring) if inplace else k_ring
        v_cache = cache["v"].copy_(v_ring) if inplace else v_ring
    else:
        k_cache = _write_slot(cache["k"], k, 0, inplace)
        v_cache = _write_slot(cache["v"], v, 0, inplace)
    return out, {"k": k_cache, "v": v_cache}
