"""Multi-head Latent Attention (MLA) — DeepSeek-V2 (arXiv:2405.04434).

KV is compressed into a kv_lora_rank latent c_kv plus a shared RoPE key
k_rope; the decode cache stores only (c_kv, k_rope) per token — the paper's
93 % KV-cache reduction. Per-head keys/values are re-expanded from the
latent with up-projections (faithful math; the latent-space absorbed-matmul
decode is a rewrite that does not change semantics).

Port of the JAX package's ``models/mla.py``, with its f32 scores and its
partition specs (``mla_spec``, ``mla_cache_spec``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import apply_rope, make_dense
from repro_torch.models.shardctx import P

NEG_INF = -1e30


def init_mla(gen: torch.Generator, cfg: ArchConfig, dtype):
    d = cfg.d_model
    h = cfg.num_heads
    qk_nope, qk_rope, v_dim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    p = {}
    if cfg.q_lora_rank:
        p["wq_a"] = make_dense(gen, (d, cfg.q_lora_rank), dtype)
        p["wq_b"] = make_dense(gen, (cfg.q_lora_rank, h * (qk_nope + qk_rope)),
                               dtype)
    else:
        p["wq"] = make_dense(gen, (d, h * (qk_nope + qk_rope)), dtype)
    p["wkv_a"] = make_dense(gen, (d, r), dtype)             # latent down-proj
    p["wk_rope"] = make_dense(gen, (d, qk_rope), dtype)     # shared rope key
    p["wk_b"] = make_dense(gen, (r, h * qk_nope), dtype)    # latent -> k_nope
    p["wv_b"] = make_dense(gen, (r, h * v_dim), dtype)      # latent -> v
    p["wo"] = make_dense(gen, (h * v_dim, d), dtype)
    return p


def mla_spec(cfg: ArchConfig):
    p = {"wkv_a": P(None, None), "wk_rope": P(None, None),
         "wk_b": P(None, "model"), "wv_b": P(None, "model"),
         "wo": P("model", None)}
    if cfg.q_lora_rank:
        p.update(wq_a=P(None, None), wq_b=P(None, "model"))
    else:
        p["wq"] = P(None, "model")
    return p


def _queries(p, cfg: ArchConfig, x, positions):
    h = cfg.num_heads
    qk_nope, qk_rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        q = (x @ p["wq_a"]) @ p["wq_b"]
    else:
        q = x @ p["wq"]
    q = q.reshape(*x.shape[:-1], h, qk_nope + qk_rope)
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _latents(p, cfg: ArchConfig, x, positions):
    c_kv = x @ p["wkv_a"]                                   # (B,S,r)
    k_rope = x @ p["wk_rope"]                               # (B,S,rope)
    k_rope = apply_rope(k_rope[..., None, :], positions,
                        cfg.rope_theta)[..., 0, :]
    return c_kv, k_rope


def _expand(p, cfg: ArchConfig, c_kv):
    h = cfg.num_heads
    k_nope = (c_kv @ p["wk_b"]).reshape(*c_kv.shape[:-1], h, cfg.qk_nope_dim)
    v = (c_kv @ p["wv_b"]).reshape(*c_kv.shape[:-1], h, cfg.v_head_dim)
    return k_nope, v


def _attend(p, cfg, q_nope, q_rope, k_nope, k_rope, v, mask):
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    scores = (torch.einsum("bshd,bthd->bsht", q_nope, k_nope)
              + torch.einsum("bshd,btd->bsht", q_rope, k_rope)) * scale
    scores = torch.where(mask, scores.to(torch.float32), NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bsht,bthd->bshd", probs, v)
    return out.reshape(*out.shape[:-2], -1) @ p["wo"]


def mla_self_attention(p, cfg: ArchConfig, x, positions):
    """Training / prefill full-sequence MLA."""
    q_nope, q_rope = _queries(p, cfg, x, positions)
    c_kv, k_rope = _latents(p, cfg, x, positions)
    k_nope, v = _expand(p, cfg, c_kv)
    s = x.shape[1]
    # expanded MLA is standard MHA: concat nope+rope dims
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat(
        [k_nope, k_rope[..., None, :].expand(
            *k_nope.shape[:-1], cfg.qk_rope_dim)], dim=-1)
    if s > attn_mod.BLOCKWISE_THRESHOLD and s % attn_mod.Q_BLOCK == 0:
        out = attn_mod.blockwise_attention(q_full, k_full, v, positions,
                                           causal=True,
                                           window=cfg.sliding_window)
    else:
        mask = positions[None, :] <= positions[:, None]
        if cfg.sliding_window:
            mask &= (positions[:, None] - positions[None, :]
                     < cfg.sliding_window)
        out = attn_mod.gqa_attend(q_full, k_full, v,
                                  mask[None, :, None, None, :], x.dtype)
    return out.reshape(*x.shape[:-1], -1) @ p["wo"]


def init_mla_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                   device="cuda"):
    length = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    dev = resolve_device(device)
    return {"c_kv": torch.zeros(batch, length, cfg.kv_lora_rank, dtype=dtype,
                                device=dev),
            "k_rope": torch.zeros(batch, length, cfg.qk_rope_dim, dtype=dtype,
                                  device=dev)}


def mla_cache_spec(cfg: ArchConfig):
    # latent dims are small; shard cache length over model when batch is thin
    return {"c_kv": P("data", "model", None),
            "k_rope": P("data", "model", None)}


def mla_decode(p, cfg: ArchConfig, x, cache, pos: int, inplace: bool = False):
    """One-token decode against the latent cache (written into `cache`
    itself when `inplace`): (out, new cache)."""
    b = x.shape[0]
    pos = int(pos)
    length = cache["c_kv"].shape[1]
    posv = torch.full((b, 1), pos, device=x.device)
    q_nope, q_rope = _queries(p, cfg, x, posv)
    c_new, kr_new = _latents(p, cfg, x, posv)
    slot = (pos % length) if cfg.sliding_window else pos
    c_kv = attn_mod._write_slot(cache["c_kv"], c_new, slot, inplace)
    k_rope = attn_mod._write_slot(cache["k_rope"], kr_new, slot, inplace)
    k_nope, v = _expand(p, cfg, c_kv)
    idx = torch.arange(length, device=x.device)
    if cfg.sliding_window:
        written = torch.where(idx <= slot, idx + (pos - slot),
                              idx + (pos - slot) - length)
        valid = written >= 0
    else:
        valid = idx <= pos
    out = _attend(p, cfg, q_nope, q_rope, k_nope, k_rope, v,
                  valid[None, None, None, :])
    return out, {"c_kv": c_kv, "k_rope": k_rope}
