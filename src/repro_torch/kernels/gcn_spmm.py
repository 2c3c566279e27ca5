"""Block-sparse SpMM for the PipeGCN aggregation — forward (z = P·H, Eq. 3)
and transpose (δcomb = Pᵀ·δz, Eq. 4 / Alg. 1 lines 17–30) — plus the
offline tile extraction that feeds them.

Port of the JAX package's ``repro.kernels.gcn_spmm``. The propagation shard
of each partition is cut into TILE×TILE dense tiles, only the nonempty ones
stored, and each output block sums ``tile @ h[input block]`` over its run
of tiles. The two products run on hand-written CUDA kernels for Hopper
(``csrc/gcn_spmm.cu``), which replace the Pallas kernels
``spmm_block_sparse`` and ``spmm_block_sparse_t``:

    spmm(row_ptr, live, rows, cols, vals, h, num_rows)            z = P·h
    spmm_t(col_ptr, t_live, t_out, t_in, t_perm, vals, dz, num_cols)
                                                                 δcomb = Pᵀ·δz

Both take the leading partition axis (one launch covers every partition).
A CUDA tensor goes to the kernel and a CPU tensor to the plain PyTorch
version beside it (``spmm_plain`` / ``spmm_t_plain``, the einsum +
``index_add_`` form of the JAX package's dense oracle); nothing falls back
from one to the other. The kernels use the per-partition run pointers
(``run_pointers``) over the sorted streams, cut at each stream's live
length (``live_lengths``: the slots past the last nonzero tile hold only
padding); the plain versions walk the whole block index streams.
``spmm.launches`` / ``spmm_t.launches`` count kernel launches.

Tile extraction (``build_tile_topology`` and the padding helpers) is a
numpy copy of the JAX package's and builds the same arrays byte for byte.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

TILE = 128          # adjacency tile edge


# ----------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the reference on the card)
# ----------------------------------------------------------------------

def _blocks(x: torch.Tensor, nblocks: int) -> torch.Tensor:
    """(P, R, F) -> (P, nblocks, TILE, F), zero-padding R up to the grid."""
    p, r, f = x.shape
    pad = nblocks * TILE - r
    if pad:
        x = torch.cat([x, x.new_zeros(p, pad, f)], dim=1)
    return x.reshape(p, nblocks, TILE, f)


def _gather_blocks(xb: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """xb (P, nb, T, F), idx (P, n) -> (P, n, T, F): xb[p, idx[p, s]]."""
    p = torch.arange(xb.shape[0], device=xb.device)[:, None]
    return xb[p, idx.long()]


def _scatter_blocks(contrib: torch.Tensor, idx: torch.Tensor, nblocks: int,
                    num_rows: int) -> torch.Tensor:
    """Sum contrib (P, n, T, F) into output blocks idx (P, n) -> (P, rows, F)."""
    p, n, t, f = contrib.shape
    flat = (idx.long() + nblocks * torch.arange(p, device=idx.device)[:, None])
    out = contrib.new_zeros(p * nblocks, t, f)
    out.index_add_(0, flat.reshape(-1), contrib.reshape(p * n, t, f))
    return out.reshape(p, nblocks * t, f)[:, :num_rows]


def spmm_plain(rows, cols, vals, h, num_rows: int) -> torch.Tensor:
    """z[p] = Σ_t vals[p, t] @ h[p, cols[p, t]] summed into row block
    rows[p, t]; h (P, C, F) with any C ≤ ncb·TILE, z (P, num_rows, F)."""
    hb = _gather_blocks(_blocks(h, -(-h.shape[1] // TILE)), cols)
    contrib = torch.einsum("ptij,ptjf->ptif", vals.to(h.dtype), hb)
    return _scatter_blocks(contrib, rows, -(-num_rows // TILE), num_rows)


def spmm_t_plain(t_out, t_in, t_perm, vals, dz, num_cols: int) -> torch.Tensor:
    """δcomb[p] = Σ_s vals[p, t_perm[p, s]]ᵀ @ dz[p, t_in[p, s]] summed into
    column block t_out[p, s]; dz (P, R, F), δcomb (P, num_cols, F)."""
    dzb = _gather_blocks(_blocks(dz, -(-dz.shape[1] // TILE)), t_in)
    tiles = _gather_blocks(vals, t_perm).to(dz.dtype)
    contrib = torch.einsum("ptki,ptkf->ptif", tiles, dzb)
    return _scatter_blocks(contrib, t_out, -(-num_cols // TILE), num_cols)


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------

def _library():
    from repro_torch.kernels._build import load
    lib = load("gcn_spmm")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gcn_spmm_f32.argtypes = [vp] * 6 + [ci] * 6 + [vp]
        lib.gcn_spmm_f32.restype = ci
        lib.gcn_spmm_t_f32.argtypes = [vp] * 7 + [ci] * 6 + [vp]
        lib.gcn_spmm_t_f32.restype = ci
        lib._argtypes_set = True
    return lib


def _check_kernel_args(ptr, live, idx, vals, x, nblocks: int, name: str):
    """Device, dtype, shape and contiguity checks before a kernel launch."""
    tensors = [t for t in idx] + [ptr, live, vals, x]
    dev = x.device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all tensors must be on {dev}")
    if x.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32 tiles and "
                        f"features, got {vals.dtype} / {x.dtype}")
    if any(t.dtype != torch.int32 for t in [ptr, live, *idx]):
        raise TypeError(f"{name}: index streams and run pointers must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    p, n = idx[0].shape
    if (x.dim() != 3 or x.shape[0] != p or ptr.shape != (p, nblocks + 1)
            or live.shape != (p,)
            or vals.shape != (p, n, TILE, TILE)
            or any(t.shape != (p, n) for t in idx)):
        raise ValueError(f"{name}: inconsistent shapes ptr {tuple(ptr.shape)}, "
                         f"streams {[tuple(t.shape) for t in idx]}, vals "
                         f"{tuple(vals.shape)}, input {tuple(x.shape)}")


def _raise_on_error(code: int, name: str):
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")


def spmm(row_ptr, live, rows, cols, vals, h, num_rows: int) -> torch.Tensor:
    """Block-sparse z = P·h over all partitions.

    row_ptr (P, nrb+1) int32 run pointers over the row-sorted forward
    stream and live (P,) int32 its live lengths (the kernel's); rows
    (P, n_tiles) int32 row blocks (the plain version's); cols (P, n_tiles)
    int32 column blocks; vals (P, n_tiles, T, T); h (P, C, F); returns
    z (P, num_rows, F). On CUDA: float32 only, one kernel launch."""
    if not h.is_cuda:
        return spmm_plain(rows, cols, vals, h, num_rows)
    nrb = -(-num_rows // TILE)
    _check_kernel_args(row_ptr, live, (cols,), vals, h, nrb, "spmm")
    p, n = cols.shape
    z = torch.empty(p, num_rows, h.shape[2], device=h.device,
                    dtype=torch.float32)
    code = _library().gcn_spmm_f32(
        row_ptr.data_ptr(), live.data_ptr(), cols.data_ptr(), vals.data_ptr(),
        h.data_ptr(), z.data_ptr(), p, nrb, n, h.shape[1], num_rows, h.shape[2],
        torch.cuda.current_stream(h.device).cuda_stream)
    _raise_on_error(code, "spmm")
    spmm.launches += 1
    return z


spmm.launches = 0


def spmm_t(col_ptr, t_live, t_out, t_in, t_perm, vals, dz,
           num_cols: int) -> torch.Tensor:
    """Block-sparse δcomb = Pᵀ·δz over all partitions, reusing the forward
    tile values through t_perm.

    col_ptr (P, ncb+1) int32 run pointers over the column-sorted transpose
    stream and t_live (P,) int32 its live lengths (the kernel's); t_out
    (the plain version's), t_in, t_perm (P, n_tiles) int32; vals
    (P, n_tiles, T, T); dz (P, R, F); returns δcomb (P, num_cols, F). On
    CUDA: float32 only, one kernel launch."""
    if not dz.is_cuda:
        return spmm_t_plain(t_out, t_in, t_perm, vals, dz, num_cols)
    ncb = -(-num_cols // TILE)
    _check_kernel_args(col_ptr, t_live, (t_in, t_perm), vals, dz, ncb,
                       "spmm_t")
    p, n = t_in.shape
    out = torch.empty(p, num_cols, dz.shape[2], device=dz.device,
                      dtype=torch.float32)
    code = _library().gcn_spmm_t_f32(
        col_ptr.data_ptr(), t_live.data_ptr(), t_in.data_ptr(),
        t_perm.data_ptr(), vals.data_ptr(), dz.data_ptr(), out.data_ptr(),
        p, ncb, n, dz.shape[1], num_cols, dz.shape[2],
        torch.cuda.current_stream(dz.device).cuda_stream)
    _raise_on_error(code, "spmm_t")
    spmm_t.launches += 1
    return out


spmm_t.launches = 0


def run_pointers(stream: np.ndarray, num_blocks: int) -> np.ndarray:
    """(P, n) sorted block stream -> (P, num_blocks+1) int32 run pointers:
    the slots of output block b in partition p are [ptr[p, b], ptr[p, b+1])."""
    edges = np.arange(num_blocks + 1)
    return np.stack([np.searchsorted(s, edges) for s in stream]).astype(np.int32)


def live_lengths(vals: np.ndarray, t_perm: np.ndarray | None = None) -> np.ndarray:
    """(P,) int32 live length of each partition's stream: one past the last
    slot holding a nonzero tile — vals[p, s] for the forward stream, or
    vals[p, t_perm[p, s]] for the transpose stream. The slots beyond hold
    the all-zero tiles that pad the partitions to one stream length; the
    kernels stop there."""
    nonzero = np.abs(vals).max(axis=(-1, -2)) > 0
    if t_perm is not None:
        nonzero = np.take_along_axis(nonzero, t_perm.astype(np.int64), axis=1)
    n = nonzero.shape[1]
    last = n - np.argmax(nonzero[:, ::-1], axis=1)
    return np.where(nonzero.any(axis=1), last, 0).astype(np.int32)


# ----------------------------------------------------------------------
# Tile extraction (numpy, offline preprocessing — never densifies)
# ----------------------------------------------------------------------

class TileTopology(NamedTuple):
    """Block-sparse topology of one propagation shard, for P and Pᵀ.

    The forward stream (rows/cols/vals) is GROUPED by row_block (ascending
    runs — the kernels' flush contract) with the col_blocks of each run
    serpentine (ascending in even runs, descending in odd ones — see
    `_run_major_order`; do NOT assume cols ascend within a run); the
    transpose stream (t_out/t_in/t_perm) walks the SAME vals array grouped
    by col_block via `t_perm`, rows serpentine likewise. Both streams
    carry ≥1 tile per output block (zero fillers) so every output block
    gets flushed.
    """

    rows: np.ndarray        # (n_tiles,) int32 row block, sorted
    cols: np.ndarray        # (n_tiles,) int32 col block
    vals: np.ndarray        # (n_tiles, T, T) float32
    t_out: np.ndarray       # (n_tiles,) int32 Pᵀ output block, sorted
    t_in: np.ndarray        # (n_tiles,) int32 Pᵀ input (δz) block
    t_perm: np.ndarray      # (n_tiles,) int32 index into vals
    num_row_blocks: int
    num_col_blocks: int

    @property
    def n_tiles(self) -> int:
        return len(self.rows)


def build_tile_topology(row, col, val, num_rows: int, num_cols: int,
                        tile: int = TILE) -> TileTopology:
    """Bucket a COO triple into TILE×TILE tiles without densifying.

    Memory is O(nnz + n_tiles·T²) — the block-sparse footprint itself —
    never O(num_rows·num_cols). Explicit zeros (padded edges) are dropped.
    Zero filler tiles are appended for row blocks with no tiles (so the
    forward kernel flushes them) and for column blocks with no tiles (so
    the transpose kernel flushes those).
    """
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    val = np.asarray(val, np.float32)
    keep = val != 0
    row, col, val = row[keep], col[keep], val[keep]

    nrb = -(-num_rows // tile)
    ncb = -(-num_cols // tile)
    key = (row // tile) * ncb + (col // tile)
    uk, inv = np.unique(key, return_inverse=True)
    # Scatter-add over FLATTENED (tile, r%T, c%T) keys into a flat f32
    # buffer: multi-index np.add.at was the preprocessing bottleneck at
    # large nnz (2-10x slower — the fancy-index ufunc loop), and
    # np.bincount(weights=...) loses to the flat add.at on every measured
    # regime because it allocates an f64 output of n_tiles·T² bins before
    # the f32 cast (see benchmarks/bench_kernels.run_tile_extraction).
    # Duplicate (r, c) entries still sum, matching COO semantics.
    flat = (inv.astype(np.int64) * (tile * tile)
            + (row % tile) * tile + (col % tile))
    vals = np.zeros(len(uk) * tile * tile, np.float32)
    np.add.at(vals, flat, val)
    vals = vals.reshape(len(uk), tile, tile)
    rows = (uk // ncb).astype(np.int32)
    cols = (uk % ncb).astype(np.int32)

    # Zero fillers: one per empty row block (forward flush) and per empty
    # column block (transpose flush).
    fill_r = np.setdiff1d(np.arange(nrb, dtype=np.int32), rows)
    fill_c = np.setdiff1d(np.arange(ncb, dtype=np.int32), cols)
    if len(fill_r) or len(fill_c):
        rows = np.concatenate([rows, fill_r,
                               np.zeros(len(fill_c), np.int32)])
        cols = np.concatenate([cols, np.zeros(len(fill_r), np.int32),
                               fill_c])
        vals = np.concatenate(
            [vals, np.zeros((len(fill_r) + len(fill_c), tile, tile),
                            np.float32)])

    # Run-major ordering with a serpentine minor axis: the stream stays
    # grouped by output block (the kernels' flush contract — rows ascending
    # for P, cols ascending for Pᵀ), but the input-block order alternates
    # direction between consecutive runs. The last input block of one run
    # then tends to equal the first of the next, and Pallas skips the
    # input-block DMA whenever the block index is unchanged between
    # consecutive grid steps — longer flush-free, fetch-free sequences on a
    # bandwidth-reduced layout whose runs overlap near the diagonal. Any
    # within-run order is valid (the accumulator is per run), so this only
    # permutes the floating-point accumulation order.
    order = _run_major_order(rows, cols)
    rows, cols, vals = rows[order], cols[order], vals[order]
    t_perm = _run_major_order(cols, rows).astype(np.int32)
    return TileTopology(rows=rows, cols=cols, vals=vals,
                        t_out=cols[t_perm], t_in=rows[t_perm], t_perm=t_perm,
                        num_row_blocks=nrb, num_col_blocks=ncb)


def _run_major_order(major, minor) -> np.ndarray:
    """Sort by `major` ascending (run grouping), `minor` serpentine: minor
    ascends in even runs and descends in odd runs (run parity = rank of the
    major value among the distinct majors present)."""
    _, inv = np.unique(major, return_inverse=True)
    minor = minor.astype(np.int64)
    return np.lexsort((np.where(inv % 2 == 1, -minor, minor), major))


def pad_tile_topology(tt: TileTopology, n_tiles: int) -> TileTopology:
    """Pad the tile streams to `n_tiles` with zero tiles (uniform shapes
    across partitions for SPMD stacking). Padding appends zero tiles at the
    tail of both streams pointing at the last output block of each, which
    preserves sortedness and adds exact zeros."""
    k = n_tiles - tt.n_tiles
    if k < 0:
        raise ValueError(f"cannot shrink tile topology {tt.n_tiles}->{n_tiles}")
    if k == 0:
        return tt
    tile = tt.vals.shape[-1]
    pad_i = np.arange(tt.n_tiles, tt.n_tiles + k, dtype=np.int32)
    return TileTopology(
        rows=np.concatenate([tt.rows, np.full(k, tt.rows[-1], np.int32)]),
        cols=np.concatenate([tt.cols, np.zeros(k, np.int32)]),
        vals=np.concatenate([tt.vals, np.zeros((k, tile, tile), np.float32)]),
        t_out=np.concatenate([tt.t_out, np.full(k, tt.t_out[-1], np.int32)]),
        t_in=np.concatenate([tt.t_in, np.zeros(k, np.int32)]),
        t_perm=np.concatenate([tt.t_perm, pad_i]),
        num_row_blocks=tt.num_row_blocks, num_col_blocks=tt.num_col_blocks)


def pad_tile_topology_phased(tt: TileTopology, b0: int, hb0: int,
                             n_int_f: int, n_bnd_f: int,
                             n_int_t: int, n_bnd_t: int) -> TileTopology:
    """Pad each PHASE GROUP of both streams independently to the given
    uniform lengths (cross-partition maxima), so the interior/boundary
    suffix split lands at the same static slot in every partition's
    stream and the phased kernels can slice with trace-time constants.

    The forward stream is cut at the first slot with row block ≥ `b0`,
    the transpose stream at the first slot with col block ≥ `hb0`. Pads
    are zero tiles appended at the END of their group, addressed at the
    group's LAST output block so run grouping stays intact in both
    streams (interior fwd pads: row b0-1; boundary fwd pads: row nrb-1;
    interior transpose pads: col hb0-1; boundary transpose pads: col
    ncb-1 — every output block carries ≥1 real-or-filler tile, so those
    runs exist). A pad occupies one slot in EACH stream; its (row, col)
    pair is chosen from the four group combinations so both streams pad
    to their target group lengths with one shared vals entry. The
    concatenated [interior; boundary] streams remain valid inputs for
    the unsplit kernels — zero tiles add exact 0.0, so split and unsplit
    schedules on the same padded topology are bit-identical.
    """
    cut_f = int(np.searchsorted(tt.rows, b0))
    cut_t = int(np.searchsorted(tt.t_out, hb0))
    fi = n_int_f - cut_f                       # fwd interior pads
    fb = n_bnd_f - (tt.n_tiles - cut_f)        # fwd boundary pads
    ti = n_int_t - cut_t                       # transpose interior pads
    tb = n_bnd_t - (tt.n_tiles - cut_t)        # transpose boundary pads
    if min(fi, fb, ti, tb) < 0 or fi + fb != ti + tb:
        raise ValueError(f"inconsistent phase pad targets: "
                         f"{(fi, fb, ti, tb)} for {tt.n_tiles} tiles")
    if fi + fb == 0:
        return tt
    # Pair the group memberships: bb pads sit in both boundary groups,
    # then leftovers pair boundary-with-interior, the rest is (int, int).
    bb = min(fb, tb)
    bi = fb - bb            # (fwd boundary, transpose interior)
    ib = tb - bb            # (fwd interior, transpose boundary)
    ii = fi - ib
    tile = tt.vals.shape[-1]
    nrb, ncb = tt.num_row_blocks, tt.num_col_blocks
    # Pad coordinates in fwd-stream placement order: interior group tail
    # first (ii + ib pads), then boundary group tail (bi + bb pads).
    pad_rows = np.array([b0 - 1] * (ii + ib) + [nrb - 1] * (bi + bb),
                        np.int32)
    pad_cols = np.array([hb0 - 1] * ii + [ncb - 1] * ib
                        + [hb0 - 1] * bi + [ncb - 1] * bb, np.int32)
    rows = np.concatenate([tt.rows[:cut_f], pad_rows[:fi],
                           tt.rows[cut_f:], pad_rows[fi:]])
    cols = np.concatenate([tt.cols[:cut_f], pad_cols[:fi],
                           tt.cols[cut_f:], pad_cols[fi:]])
    zi = np.zeros((fi, tile, tile), np.float32)
    zb = np.zeros((fb, tile, tile), np.float32)
    vals = np.concatenate([tt.vals[:cut_f], zi, tt.vals[cut_f:], zb])
    # Original slot i of the unpadded vals now lives at remap[i]; pads at
    # pad_idx (fwd placement order, aligned with pad_rows/pad_cols).
    remap = np.arange(tt.n_tiles, dtype=np.int64)
    remap[cut_f:] += fi
    pad_idx = np.concatenate([
        np.arange(cut_f, cut_f + fi, dtype=np.int64),
        np.arange(tt.n_tiles + fi, tt.n_tiles + fi + fb, dtype=np.int64)])
    t_int_pads = np.concatenate([pad_idx[:ii], pad_idx[fi:fi + bi]])
    t_bnd_pads = np.concatenate([pad_idx[ii:fi], pad_idx[fi + bi:]])
    t_perm = np.concatenate([remap[tt.t_perm[:cut_t]], t_int_pads,
                             remap[tt.t_perm[cut_t:]],
                             t_bnd_pads]).astype(np.int32)
    return TileTopology(
        rows=rows, cols=cols, vals=vals,
        t_out=cols[t_perm], t_in=rows[t_perm], t_perm=t_perm,
        num_row_blocks=nrb, num_col_blocks=ncb)
