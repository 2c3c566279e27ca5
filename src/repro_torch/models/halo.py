"""PipeGCN-style *stale halo* for sequence-parallel sliding-window
attention (a transfer of the paper's technique beyond GCNs).

Port of the JAX package's ``repro.models.halo``. Sequence parallelism
shards the token axis; sliding-window attention (window W) then has a
PipeGCN-shaped dependency: the first W queries of shard i attend to the
last W keys / values of shard i−1 — a halo set, like the boundary nodes of
partition-parallel GCN.

  sync mode : the halo K/V are fetched from the left neighbour every step
              (the vanilla GCN analogue; the exchange is on the critical
              path).
  stale mode: the halo consumed at step t is the one produced at t−1 (the
              PipeGCN analogue; the exchange has no data dependence on
              step t's compute and can overlap it), optionally smoothed
              by an EMA (the PipeGCN-F analogue, §3.4).

The stale halo is a constant of the current step (``detach``, where the
JAX package has ``stop_gradient``): its gradient term is dropped, as in
PipeGCN-F. The halo buffer is pipeline state threaded through the train
step, like ``PipeGCN.init_buffers``. Shards are a leading axis, as on the
sim backend. The windowed attention with its relative position bias is
plain PyTorch code, as it is plain JAX code in the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.layers import apply_rope
from repro_torch.optim import adam
from repro_torch.optim.optimizers import tree_map

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class HaloConfig:
    """Config of the halo-attention demo model: a windowed-attention LM
    whose cross-shard key/value halo is exchanged PipeGCN-style (`stale`
    defers it one step; `smooth`/`gamma` apply the EMA variant)."""

    d_model: int = 128
    num_heads: int = 4
    num_layers: int = 2
    window: int = 32
    vocab: int = 256
    stale: bool = True          # PipeGCN-style deferral
    smooth: bool = False        # EMA over the halo (PipeGCN-F)
    gamma: float = 0.9

    @property
    def head_dim(self):
        return self.d_model // self.num_heads


def init_params(generator: torch.Generator, cfg: HaloConfig,
                dtype=torch.float32) -> dict:
    """Normal weights scaled by 1/sqrt(fan_in) and a zero relative
    position bias per layer, drawn on the generator's device (the JAX
    package draws them from a PRNG key: carry those across with
    `params_from_jax`)."""
    dev = generator.device

    def dense(*shape):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=dtype) / np.sqrt(shape[0])
    d = cfg.d_model
    params = {"embed": dense(cfg.vocab, d), "head": dense(d, cfg.vocab)}
    for ell in range(cfg.num_layers):
        params[f"l{ell}"] = {
            "wq": dense(d, d), "wk": dense(d, d), "wv": dense(d, d),
            "wo": dense(d, d), "wf": dense(d, 4 * d), "wf2": dense(4 * d, d),
            # T5-style relative position bias over the window (makes
            # position-targeted retrieval directly learnable in the demo)
            "rb": torch.zeros(cfg.num_heads, cfg.window + 1, device=dev,
                              dtype=dtype),
        }
    return params


def params_from_jax(np_params: dict, device) -> dict:
    """The JAX package's halo parameters (nested dicts of arrays, as
    numpy) as tensors on `device`, keeping their dtypes."""
    return {k: params_from_jax(v, device) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)).to(device)
            for k, v in np_params.items()}


def init_halo_buffers(cfg: HaloConfig, local_len: int, batch: int,
                      num_shards: int, dtype=torch.float32,
                      device="cuda") -> list:
    """Stale halo K/V per layer, with a leading shard axis (as on the sim
    backend): [{"k", "v"}] of (num_shards, batch, W, H, head_dim) zeros,
    on the card unless the caller asks for the CPU."""
    device = resolve_device(device)
    shape = (num_shards, batch, cfg.window, cfg.num_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.num_layers)]


def _local_window_attention(q, k, v, k_halo, v_halo, pos0, window,
                            rel_bias=None):
    """Causal sliding-window attention of every shard, whose key set is
    [halo (W tokens ending at pos0-1) ; local (S_loc tokens from pos0)].
    q, k, v (n, B, S, H, hd); k_halo, v_halo (n, B, W, H, hd); pos0 (n,).
    The scores are masked and normalized in float32, as in the JAX
    package."""
    n, b, s, h, hd = q.shape
    w = k_halo.shape[2]
    kk = torch.cat([k_halo, k], dim=2)
    vv = torch.cat([v_halo, v], dim=2)
    ar_s = torch.arange(s, device=q.device)
    ar_w = torch.arange(w, device=q.device)
    qpos = pos0[:, None] + ar_s                                    # (n, s)
    kpos = torch.cat([pos0[:, None] - w + ar_w, pos0[:, None] + ar_s], 1)
    scores = torch.einsum("nbshd,nbthd->nbsht", q, kk) / np.sqrt(hd)
    rel = qpos[:, :, None] - kpos[:, None, :]                      # (n, s, t)
    if rel_bias is not None:
        idx = torch.clamp(rel, 0, rel_bias.shape[1] - 1)
        bias = torch.movedim(rel_bias.T[idx], -1, 2)   # (n,s,t,h)->(n,s,h,t)
        scores = scores + bias[:, None]                # (n,b,s,h,t)
    mask = (rel >= 0) & (rel < window)
    scores = torch.where(mask[:, None, :, None, :], scores.to(torch.float32),
                         NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("nbsht,nbthd->nbshd", probs, vv)


def _exchange_halo(k_tail, v_tail):
    """Every shard receives its left neighbour's window tail; shard 0
    receives zeros."""
    def shift(x):
        return torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)
    return shift(k_tail), shift(v_tail)


def forward(params, cfg: HaloConfig, tokens, halo_bufs, pos0):
    """Forward of every shard: tokens (num_shards, B, S_loc) int, pos0
    (num_shards,) each shard's first absolute position. Returns (logits
    (num_shards, B, S_loc, vocab), new_halo_bufs)."""
    w = cfg.window
    x = params["embed"][tokens]
    s_loc = tokens.shape[-1]
    # absolute positions per shard for RoPE; the halo K arrives pre-roped
    # with the neighbour's absolute positions, so offsets stay consistent
    positions = (pos0[:, None, None]
                 + torch.arange(s_loc, device=tokens.device)[None, None, :])
    new_bufs = []
    for ell in range(cfg.num_layers):
        p = params[f"l{ell}"]
        shape = (*x.shape[:-1], cfg.num_heads, cfg.head_dim)
        q = (x @ p["wq"]).reshape(shape)
        k = (x @ p["wk"]).reshape(shape)
        v = (x @ p["wv"]).reshape(shape)
        q = apply_rope(q, positions, 10000.0)
        k = apply_rope(k, positions, 10000.0)
        fresh_k, fresh_v = _exchange_halo(k[:, :, -w:], v[:, :, -w:])
        if cfg.stale:
            buf = halo_bufs[ell]
            use_k, use_v = buf["k"].detach(), buf["v"].detach()
            if cfg.smooth:
                new_k = cfg.gamma * buf["k"] + (1 - cfg.gamma) * fresh_k
                new_v = cfg.gamma * buf["v"] + (1 - cfg.gamma) * fresh_v
            else:
                new_k, new_v = fresh_k, fresh_v
            new_bufs.append({"k": new_k.detach(), "v": new_v.detach()})
        else:
            use_k, use_v = fresh_k, fresh_v
            new_bufs.append(halo_bufs[ell])
        att = _local_window_attention(q, k, v, use_k, use_v, pos0, w,
                                      p["rb"])
        x = x + att.reshape(x.shape) @ p["wo"]
        x = x + F.gelu(x @ p["wf"], approximate="tanh") @ p["wf2"]
    return x @ params["head"], new_bufs


def make_sim_train_step(cfg: HaloConfig, num_shards: int, lr: float = 1e-3):
    """Single-device reference: shards as a leading axis (as on the
    PipeGCN sim backend). tokens / labels (num_shards, B, S_loc); pos0
    (num_shards,). Returns (init_opt_state, step) with Adam, where
    step(params, opt_state, tokens, labels, bufs, pos0) -> (loss, params,
    opt_state, new_bufs)."""
    opt = adam(lr)

    def loss_fn(params, tokens, labels, bufs, pos0):
        logits, new_bufs = forward(params, cfg, tokens, bufs, pos0)
        logits = logits.to(torch.float32)
        lse = torch.logsumexp(logits, -1)
        ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        return torch.mean(lse - ll), new_bufs

    def step(params, opt_state, tokens, labels, bufs, pos0):
        tracked = tree_map(lambda x: x.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss, new_bufs = loss_fn(tracked, tokens, labels, bufs, pos0)
            loss.backward()
        params, opt_state = opt.apply(
            params, tree_map(lambda x: x.grad, tracked), opt_state)
        new_bufs = [{k: v.detach() for k, v in b.items()} for b in new_bufs]
        return loss.detach(), params, opt_state, new_bufs

    return opt.init, step
