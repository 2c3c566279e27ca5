"""The kernel entry points under the JAX package's ``kernels/ops.py`` names
and signatures, on one partition's tile arrays.

Each SpMM entry point takes one partition's tile streams (as
``build_tile_topology`` makes them: tile_rows / tile_cols / tile_vals, and
t_out / t_in / t_perm for the transpose) and the dense operand without a
partition axis, adds a partition axis of 1, builds the kernel's work
schedule (``forward_schedule`` / ``transpose_schedule``) and calls the
wrapper in ``kernels/gcn_spmm.py``: the hand-written CUDA kernel on a CUDA
tensor, its plain PyTorch version on a CPU tensor. The nonzero flags of
the tiles are computed where the tiles lie; only they and the int32 index
arrays reach the host. The training step keeps its schedules prebuilt on
its ``Topology`` and does not come through here.

PyTorch runs eagerly, so there is no jit and no ``interpret`` switch. A
phase (``spmm_phased`` / ``spmm_t_phased``) is the last ``n_bnd`` stream
slots (boundary) or the rest (interior), as in the JAX package; on the
card it runs on the output blocks of those slots, so the cut must fall
between two output blocks' runs. Rows outside a phase are unspecified
(NaN on the CPU) and must not be read.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gcn_spmm as _spmm


def _host_index(a) -> np.ndarray:
    """(n,) index array -> (1, n) int32 numpy (a tensor is copied to the
    host)."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a, np.int32)[None]


def _index(a, device) -> torch.Tensor:
    """(n,) index array -> (1, n) int32 tensor on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int32)[None]
    return torch.from_numpy(_host_index(a)).to(device)


def _on(device, work, items):
    """A schedule's numpy (work, items) as tensors on `device`."""
    return (torch.from_numpy(work).to(device),
            torch.from_numpy(items).to(device))


def forward_schedule(tile_rows, tile_cols, tile_vals, num_rows: int):
    """The forward kernels' (work (1, W, 2), items (1, I, 5)) of one
    partition's stream, on tile_vals' device."""
    return _on(tile_vals.device, *_spmm.forward_schedule(
        _host_index(tile_rows), _host_index(tile_cols),
        _spmm.nonzero_tiles(tile_vals[None]), num_rows))


def transpose_schedule(t_out, t_in, t_perm, tile_vals, num_cols: int):
    """The transpose kernels' (t_work, t_items) of one partition's
    stream, on tile_vals' device."""
    return _on(tile_vals.device, *_spmm.transpose_schedule(
        _host_index(t_out), _host_index(t_in), _host_index(t_perm),
        _spmm.nonzero_tiles(tile_vals[None]), num_cols))


def _split(stream, n_bnd: int) -> _spmm.SplitSpec:
    """The SplitSpec of a phase cut `n_bnd` slots before the end of a
    block-sorted stream: its tail is the first boundary output row, the
    same for either direction (a phased call reads only its own)."""
    s = _host_index(stream)[0]
    n = len(s)
    if not 0 < n_bnd < n:
        raise ValueError(f"phase split needs 0 < n_bnd < n_tiles, got "
                         f"{n_bnd}/{n}")
    if s[n - n_bnd - 1] == s[n - n_bnd]:
        raise ValueError(f"the phase cut at slot {n - n_bnd} splits output "
                         f"block {s[n - n_bnd]}'s run")
    tail = int(s[n - n_bnd]) * _spmm.TILE
    return _spmm.SplitSpec(row_tail=tail, col_tail=tail,
                           fwd_bnd_tiles=n_bnd, t_bnd_tiles=n_bnd)


def spmm(tile_rows, tile_cols, tile_vals, h, num_rows: int):
    """Block-sparse aggregation z = P·h: h (C, F) -> (num_rows, F)."""
    work, items = forward_schedule(tile_rows, tile_cols, tile_vals, num_rows)
    return _spmm.spmm(work, items, _index(tile_rows, h.device),
                      _index(tile_cols, h.device), tile_vals[None], h[None],
                      num_rows)[0]


def spmm_t(t_out, t_in, t_perm, tile_vals, dz, num_cols: int):
    """Block-sparse transpose aggregation δcomb = Pᵀ·δz: dz (R, F) ->
    (num_cols, F)."""
    work, items = transpose_schedule(t_out, t_in, t_perm, tile_vals, num_cols)
    d = dz.device
    return _spmm.spmm_t(work, items, _index(t_out, d), _index(t_in, d),
                        _index(t_perm, d), tile_vals[None], dz[None],
                        num_cols)[0]


def spmm_phased(tile_rows, tile_cols, tile_vals, h, num_rows: int,
                n_bnd: int, phase: str):
    """One phase ("boundary" | "interior") of z = P·h: the boundary phase
    is the last `n_bnd` stream slots, the interior phase the rest;
    out-of-phase rows are unspecified."""
    split = _split(tile_rows, n_bnd)
    work, items = forward_schedule(tile_rows, tile_cols, tile_vals, num_rows)
    return _spmm.spmm_phased(work, items, _index(tile_rows, h.device),
                             _index(tile_cols, h.device), tile_vals[None],
                             h[None], num_rows, split, phase)[0]


def spmm_t_phased(t_out, t_in, t_perm, tile_vals, dz, num_cols: int,
                  n_bnd: int, phase: str):
    """One phase of δcomb = Pᵀ·δz on the last `n_bnd` slots of the
    transpose stream (boundary) or the rest (interior)."""
    split = _split(t_out, n_bnd)
    work, items = transpose_schedule(t_out, t_in, t_perm, tile_vals, num_cols)
    d = dz.device
    return _spmm.spmm_t_phased(work, items, _index(t_out, d),
                               _index(t_in, d), _index(t_perm, d),
                               tile_vals[None], dz[None], num_cols, split,
                               phase)[0]


def spmm_fused(tile_rows, tile_cols, tile_vals, h, w, b, num_rows: int,
               relu: bool = False, with_z: bool = True):
    """Fused u = (P·h)@w + b (+ReLU): h (C, F_in), w (F_in, F_out), b
    (1, F_out) or (F_out,). Returns (u, z) with z = P·h when `with_z`,
    else (u, None)."""
    work, items = forward_schedule(tile_rows, tile_cols, tile_vals, num_rows)
    u, z = _spmm.spmm_fused(work, items, _index(tile_rows, h.device),
                            _index(tile_cols, h.device), tile_vals[None],
                            h[None], w, b.reshape(-1), num_rows, relu=relu,
                            with_z=with_z)
    return u[0], (z[0] if with_z else None)


def spmm_fused_t(t_out, t_in, t_perm, tile_vals, du, w, num_cols: int):
    """Fused δcomb = Pᵀ·(du@wᵀ): du (R, F_out), w (F_in, F_out) ->
    (num_cols, F_in)."""
    work, items = transpose_schedule(t_out, t_in, t_perm, tile_vals, num_cols)
    d = du.device
    return _spmm.spmm_fused_t(work, items, _index(t_out, d), _index(t_in, d),
                              _index(t_perm, d), tile_vals[None], du[None],
                              w, num_cols)[0]


def attention(q, k, v, causal: bool = True, window: int = 0,
              q_block: int = _fa.DEFAULT_Q_BLOCK,
              kv_block: int = _fa.DEFAULT_KV_BLOCK):
    """Flash GQA attention (see flash_attention.py): q (B, S, H, d), k/v
    (B, T, K, d) -> (B, S, H, d)."""
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               q_block=q_block, kv_block=kv_block)


build_tiles = _spmm.build_tiles
build_tile_topology = _spmm.build_tile_topology
tile_density = _spmm.tile_density
