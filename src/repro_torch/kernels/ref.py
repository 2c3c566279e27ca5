"""Dense oracles of the port's kernels, in PyTorch: the counterparts of the
JAX package's ``kernels/ref.py``, with its dtype casts (scores in f32,
probabilities back in q's dtype)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def spmm_ref(tile_rows, tile_cols, tile_vals, h, num_rows: int) -> torch.Tensor:
    """Dense oracle of the block-sparse SpMM over one shard's tile stream:
    tile_rows / tile_cols (n,) block indices, tile_vals (n, T, T), h (C, F)
    with C a multiple of T."""
    tile = tile_vals.shape[-1]
    f = h.shape[1]
    hb = h.reshape(-1, tile, f)
    contrib = torch.einsum("tij,tjf->tif", tile_vals, hb[tile_cols.long()])
    out = h.new_zeros(num_rows // tile, tile, f)
    out.index_add_(0, tile_rows.long(), contrib.to(h.dtype))
    return out.reshape(num_rows, f)


def mha_ref(q, k, v, causal: bool = True, window: int = 0,
            positions=None) -> torch.Tensor:
    """Dense attention oracle (GQA): q (B,S,H,d), k/v (B,T,K,d); query i
    sits at positions[i] (default i), key j at j."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    if positions is None:
        positions = torch.arange(s, device=q.device)
    tpos = torch.arange(t, device=q.device)
    qg = q.reshape(b, s, kh, g, d)
    scores = torch.einsum("bskgd,btkd->bskgt", qg, k) / d ** 0.5
    mask = torch.ones(s, t, dtype=torch.bool, device=q.device)
    if causal:
        mask &= tpos[None, :] <= positions[:, None]
    if window:
        mask &= positions[:, None] - tpos[None, :] < window
    scores = torch.where(mask[None, :, None, None, :],
                         scores.to(torch.float32), NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bskgt,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, d)
