"""Mixture-of-Experts FFN with top-k token-choice routing and capacity-bound
dispatch (gather → grouped expert GEMM → weighted combine).

Port of the JAX package's ``models/moe.py``. Capacity dropping is
weight-prioritized (per-expert top-C over routed tokens). Every top-k
choice here is `top_k`: a stable descending sort, so equal scores keep
their index order and the lower index wins, as ``jax.lax.top_k`` does
(``torch.topk`` promises no order among ties). The router and the
capacity selection therefore choose the same experts and tokens as JAX.
The weighted expert outputs are combined per token by gathers and a sum
in a fixed order, where JAX scatter-adds them, so the card repeats its
result bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import apply_mlp, init_mlp, make_dense, mlp_spec
from repro_torch.models.shardctx import P, constrain


def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype):
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    p = {
        "router": make_dense(gen, (d, e), dtype, scale=0.02),
        "wi": make_dense(gen, (e, d, f), dtype),
        "wg": make_dense(gen, (e, d, f), dtype),
        "wo": make_dense(gen, (e, f, d), dtype),
    }
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(gen, dtype, d, f * cfg.num_shared_experts,
                               act="swiglu")
    return p


def moe_spec(cfg: ArchConfig):
    p = {"router": P(None, None),
         "wi": P("model", None, None),
         "wg": P("model", None, None),
         "wo": P("model", None, None)}
    if cfg.num_shared_experts:
        p["shared"] = mlp_spec(act="swiglu")
    return p


def top_k(x, k: int):
    """The k largest entries of the last axis in descending order and their
    indices; among equal entries the lower index comes first."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def route(x, router, k: int):
    """Router softmax and its top-k: (probs, top_w renormalised, top_i)."""
    logits = (x @ router).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = top_k(probs, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return probs, top_w, top_i


def capacity(cfg: ArchConfig, tokens: int, dropless: bool) -> int:
    if dropless:
        return tokens
    cap = int(max(1, round(tokens * cfg.experts_per_tok / cfg.num_experts
                           * cfg.capacity_factor)))
    return min(cap, tokens)


def select(combine, cap: int):
    """Per-expert top-C tokens by combine weight: combine (..., T, E) ->
    (sel_w, sel_t), each (..., E, C); unrouted tokens score -1."""
    score = torch.where(combine > 0, combine, -1.0).transpose(-1, -2)
    return top_k(score, cap)


def _expert_ffn(p, gathered, spec: str):
    h = torch.einsum(f"{spec}d,edf->{spec}f", gathered, p["wi"])
    g = torch.einsum(f"{spec}d,edf->{spec}f", gathered, p["wg"])
    return torch.einsum(f"{spec}f,efd->{spec}d", F.silu(h) * g, p["wo"])


def _combine(y, sel_t, top_i):
    """Each token's k weighted expert outputs, summed in its choice order:
    y (G, E, C, D) at the slots sel_t (G, E, C) -> (G, T, D). A token an
    expert dropped adds 0. Gathers and a fixed-order sum, so the result is
    the same on every run (a scatter-add's atomics add in no fixed order)."""
    g, e, c, d = y.shape
    t = top_i.shape[1]
    gi = torch.arange(g, device=y.device)[:, None, None]
    slot = sel_t.new_full((g, e, t), c).scatter(
        -1, sel_t, torch.arange(c, device=y.device).expand_as(sel_t))
    at = slot[gi, top_i, torch.arange(t, device=y.device)[None, :, None]]
    kept = (at < c)[..., None].to(y.dtype)                  # (G, T, k, 1)
    return (y[gi, top_i, at.clamp(max=c - 1)] * kept).sum(dim=2)


def _aux(combine, probs, e: int, dims):
    density = (combine > 0).to(torch.float32).mean(dim=dims)
    mean_prob = probs.mean(dim=dims)
    return e * torch.sum(density * mean_prob)


def apply_moe(p, cfg: ArchConfig, x, dropless: bool = False):
    """x: (B, S, D) -> (B, S, D); also returns aux (load-balance stats).

    dropless=True sets capacity = num tokens (exact, no dropping) — used on
    the decode path where a dropped token would corrupt generation.
    cfg.moe_groups > 1 routes within token groups (device-local capacity);
    with dropless=True grouped and global routing are equivalent.
    """
    b, s, d = x.shape
    t = b * s
    g = max(1, min(cfg.moe_groups, t))
    if g > 1 and t % g == 0:
        out, aux = _moe_grouped(p, cfg, x.reshape(g, t // g, d), dropless)
        return out.reshape(b, s, d).to(x.dtype), aux
    out, aux = _moe_block(p, cfg, x.reshape(t, d), dropless)
    return out.reshape(b, s, d).to(x.dtype), aux


def _moe_grouped(p, cfg: ArchConfig, xg, dropless: bool):
    """Group-local routing over (G, Tg, D) token groups."""
    g, tg, d = xg.shape
    e, k = cfg.num_experts, cfg.experts_per_tok
    xg = constrain(xg, "moe_tokens")
    probs, top_w, top_i = route(xg, p["router"], k)           # (G,Tg,k)
    combine = torch.zeros_like(probs).scatter(-1, top_i, top_w)  # (G,Tg,E)

    sel_w, sel_t = select(combine, capacity(cfg, tg, dropless))  # (G,E,C)
    valid = sel_w > 0
    gi = torch.arange(g, device=xg.device)[:, None, None]
    gathered = constrain(xg[gi, sel_t], "moe_gathered")       # (G,E,C,D)
    y = constrain(_expert_ffn(p, gathered, "gec"), "moe_gathered")
    y = y * (sel_w * valid)[..., None].to(y.dtype)

    out = constrain(_combine(y, sel_t, top_i), "moe_tokens")
    if cfg.num_shared_experts:
        out = out + apply_mlp(p["shared"], xg, act="swiglu")
    return out, _aux(combine, probs, e, (0, 1))


def _moe_block(p, cfg: ArchConfig, xf, dropless: bool):
    """Routing + expert compute for one token block xf: (T, D)."""
    t, d = xf.shape
    e, k = cfg.num_experts, cfg.experts_per_tok
    probs, top_w, top_i = route(xf, p["router"], k)           # (T, k)
    # (T, E) combine weights restricted to the top-k choices
    combine = torch.zeros_like(probs).scatter(-1, top_i, top_w)

    sel_w, sel_t = select(combine, capacity(cfg, t, dropless))  # (E, C)
    valid = sel_w > 0
    gathered = constrain(xf[sel_t], "moe_expert")             # (E, C, D)
    y = constrain(_expert_ffn(p, gathered, "ec"), "moe_expert")
    y = y * (sel_w * valid)[..., None].to(y.dtype)

    out = _combine(y[None], sel_t[None], top_i[None])[0]
    if cfg.num_shared_experts:
        out = out + apply_mlp(p["shared"], xf, act="swiglu")
    return out, _aux(combine, probs, e, 0)
