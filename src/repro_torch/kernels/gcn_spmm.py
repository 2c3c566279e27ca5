"""Block-sparse SpMM for the PipeGCN aggregation — forward (z = P·H, Eq. 3)
and transpose (δcomb = Pᵀ·δz, Eq. 4 / Alg. 1 lines 17–30) — plus the
offline tile extraction that feeds them.

Port of the JAX package's ``repro.kernels.gcn_spmm``. The propagation shard
of each partition is cut into TILE×TILE dense tiles, only the nonempty ones
stored, and each output block sums ``tile @ h[input block]`` over its run
of tiles. The two products run on hand-written CUDA kernels for Hopper
(``csrc/gcn_spmm.cu``), which replace the Pallas kernels
``spmm_block_sparse`` and ``spmm_block_sparse_t``:

    spmm(work, items, rows, cols, vals, h, num_rows)              z = P·h
    spmm_t(t_work, t_items, t_out, t_in, t_perm, vals, dz, num_cols)
                                                                 δcomb = Pᵀ·δz

The fused aggregate+transform pair (``csrc/gcn_fused.cu``) replaces the
Pallas kernels ``spmm_block_sparse_fused`` and ``spmm_block_sparse_fused_t``:

    spmm_fused(row_ptr, live, rows, cols, vals, h, w, b, num_rows,
               relu, with_z)                 u = (P·h)@w + b [ReLU], z = P·h
    spmm_fused_t(col_ptr, t_live, t_out, t_in, t_perm, vals, du, w,
                 num_cols)                                δcomb = Pᵀ·(du@wᵀ)

The split-phase schedule runs the spmm pair one phase at a time
(``spmm_phased`` / ``spmm_t_phased``, replacing the Pallas entry points
``spmm_block_sparse_phased`` and ``spmm_block_sparse_t_phased``): the same
kernels launched on a range of output blocks, the boundary phase on the
blocks from ``SplitSpec.row_tail`` (``col_tail`` for the transpose) on and
the interior phase on those before. Their plain versions slice the tile
streams as the JAX package does and fill the rows outside the phase with
NaN, which the kernels leave unwritten.

All take the leading partition axis (one launch covers every
partition). A CUDA tensor goes to the kernel and a CPU tensor to the plain
PyTorch version beside it (``spmm_plain`` / ``spmm_t_plain``, the einsum +
``index_add_`` form of the JAX package's dense oracle, and
``spmm_fused_plain`` / ``spmm_fused_t_plain``, those plus a dense product);
nothing falls back from one to the other. The spmm kernels walk only the
nonzero tiles, from a schedule built once per topology
(``tile_schedule``): each output block's run of nonzero tiles cut into
work items of at most ``SCHED_CHUNK`` tiles, one thread block each, whose
partial sums the run's last block adds in chunk order; they multiply on
the tensor cores in 3×TF32, at f32 accuracy. The fused kernels use the
run pointers (``run_pointers``) over the sorted streams, cut at each
stream's live length (``live_lengths``: the slots past the last nonzero
tile hold only padding). The plain versions walk the whole block index
streams. Each wrapper's ``launches`` attribute counts its kernel launches.

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


class SplitSpec(NamedTuple):
    """The interior/boundary phase split of one partitioned graph's tile
    streams, the same for every partition (the phase-aware padding of
    `pad_tile_topology_phased` makes it so). All fields are ints."""

    row_tail: int       # first forward boundary-phase output row (b0·T)
    col_tail: int       # first transpose boundary-phase output row (hb0·T)
    fwd_bnd_tiles: int  # boundary-suffix length of the forward stream
    t_bnd_tiles: int    # boundary-suffix length of the transpose stream


def phase_blocks(tail: int, num_out: int, phase: str) -> tuple[int, int]:
    """The output-block range [begin, end) of one phase: the boundary phase
    is the blocks from tail//TILE on, the interior phase those before.
    Raises when the phase would be empty or `tail` is off the block grid."""
    nblocks = -(-num_out // TILE)
    cut, rem = divmod(tail, TILE)
    if rem or not 0 < cut < nblocks:
        raise ValueError(f"phase split at row {tail} must be a multiple of "
                         f"{TILE} strictly inside the {nblocks} output blocks")
    if phase == "boundary":
        return cut, nblocks
    if phase == "interior":
        return 0, cut
    raise ValueError(f"phase must be 'boundary' or 'interior', got {phase!r}")


def phase_slots(n_tiles: int, n_bnd: int, phase: str) -> slice:
    """The stream slots of one phase as the JAX package cuts them: the
    boundary phase is the last `n_bnd` slots, the interior phase the rest."""
    if not 0 < n_bnd < n_tiles:
        raise ValueError(f"phase split needs 0 < n_bnd < n_tiles, got "
                         f"{n_bnd}/{n_tiles}")
    if phase == "boundary":
        return slice(n_tiles - n_bnd, n_tiles)
    if phase == "interior":
        return slice(0, n_tiles - n_bnd)
    raise ValueError(f"phase must be 'boundary' or 'interior', got {phase!r}")


def _poison_out_of_phase(out: torch.Tensor, tail: int, phase: str):
    """NaN in the rows a phase does not own, which the kernels leave
    unwritten: a caller that reads one gets NaN, not a plausible zero."""
    begin, end = phase_blocks(tail, out.shape[1], phase)
    out[:, :begin * TILE] = float("nan")
    out[:, end * TILE:] = float("nan")
    return out


def spmm_phased_plain(rows, cols, vals, h, num_rows: int, split: SplitSpec,
                      phase: str) -> torch.Tensor:
    """One phase of z = P·h on its slice of the forward stream; rows
    outside the phase are NaN."""
    sl = phase_slots(rows.shape[1], split.fwd_bnd_tiles, phase)
    z = spmm_plain(rows[:, sl], cols[:, sl], vals[:, sl], h, num_rows)
    return _poison_out_of_phase(z, split.row_tail, phase)


def spmm_t_phased_plain(t_out, t_in, t_perm, vals, dz, num_cols: int,
                        split: SplitSpec, phase: str) -> torch.Tensor:
    """One phase of δcomb = Pᵀ·δz on its slice of the transpose stream
    (vals stays whole: t_perm indexes it); rows outside the phase are NaN."""
    sl = phase_slots(t_out.shape[1], split.t_bnd_tiles, phase)
    out = spmm_t_plain(t_out[:, sl], t_in[:, sl], t_perm[:, sl], vals, dz,
                       num_cols)
    return _poison_out_of_phase(out, split.col_tail, phase)


def spmm_fused_plain(rows, cols, vals, h, w, b, num_rows: int,
                     relu: bool = False, with_z: bool = True):
    """u = (P·h) @ w + b (ReLU'd when `relu`), aggregate first; returns
    (u, z) with z = P·h, or (u, None) without `with_z`."""
    z = spmm_plain(rows, cols, vals, h, num_rows)
    u = z @ w + b
    if relu:
        u = torch.relu(u)
    return u, (z if with_z else None)


def spmm_fused_t_plain(t_out, t_in, t_perm, vals, du, w,
                       num_cols: int) -> torch.Tensor:
    """δcomb = Pᵀ·(du @ wᵀ); du (P, R, F_out), w (F_in, F_out)."""
    return spmm_t_plain(t_out, t_in, t_perm, vals, du @ w.T, num_cols)


def assert_close_to_scale(got, want, what: str = "") -> float:
    """The tolerance a fused kernel is held to against its plain version:
    rtol = 1e-5 and atol = 1e-5 · max|want|. Two chained f32 contractions
    (a tile run, then K ≤ 512 of the dense product) round differently from
    the plain version, so the bound scales with the output's magnitude:
    ~170 ulp of the largest element, far below what a wrong tile or column
    slice moves. Returns max|got - want|."""
    scale = float(want.abs().max()) or 1.0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale,
                               msg=lambda m: f"{what}: {m}" if what else m)
    return float((got - want).abs().max())


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------

_ARGTYPES = {      # C entry point -> (pointer args, int args), then the stream
    "gcn_spmm": {"gcn_spmm_f32": (7, 11), "gcn_spmm_t_f32": (7, 11)},
    "gcn_fused": {"gcn_spmm_fused_f32": (9, 8),
                  "gcn_spmm_fused_t_f32": (8, 7)},
}


def _library(name: str):
    from repro_torch.kernels._build import load
    lib = load(name)
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for fn, (n_ptr, n_int) in _ARGTYPES[name].items():
            getattr(lib, fn).argtypes = [vp] * n_ptr + [ci] * n_int + [vp]
            getattr(lib, fn).restype = ci
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


def _check_weight(w, b, x, name: str, fin: int | None = None,
                  fout: int | None = None):
    """The dense operands of a fused kernel: float32, contiguous (a SAGE
    weight's row slice w[:fin] is), on x's device; w 2-D with `fin` rows
    and `fout` columns where given, b (w.shape[1],) where given."""
    dense = [w] if b is None else [w, b]
    if any(t.device != x.device for t in dense):
        raise ValueError(f"{name}: w and b must be on {x.device}")
    if any(t.dtype != torch.float32 for t in dense):
        raise TypeError(f"{name}: the CUDA kernel takes float32 weights, "
                        f"got {[t.dtype for t in dense]}")
    if not all(t.is_contiguous() for t in dense):
        raise ValueError(f"{name}: w and b must be contiguous, got strides "
                         f"{[t.stride() for t in dense]}")
    if (w.dim() != 2 or fin not in (None, w.shape[0])
            or fout not in (None, w.shape[1])
            or (b is not None and b.shape != (w.shape[1],))):
        raise ValueError(f"{name}: w {tuple(w.shape)} and b "
                         f"{None if b is None else tuple(b.shape)} do not "
                         f"match F_in {fin}, F_out {fout}")


def _raise_on_error(code: int, name: str):
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")


def _output(out, shape, like, name: str) -> torch.Tensor:
    """The kernel's output: `out` when given (checked), else torch.empty."""
    if out is None:
        return torch.empty(shape, device=like.device, dtype=torch.float32)
    if (out.shape != shape or out.dtype != torch.float32
            or out.device != like.device or not out.is_contiguous()):
        raise ValueError(f"{name}: out must be a contiguous float32 "
                         f"{tuple(shape)} tensor on {like.device}")
    return out


def _into(out, result: torch.Tensor) -> torch.Tensor:
    """`result`, copied into `out` when one is given."""
    return result if out is None else out.copy_(result)


def feature_block(f: int) -> int:
    """Feature columns one thread block of the spmm kernels covers: the
    narrowest of 8, 16, 32 and 64 that holds F, else 128 (then F/128
    column slices, each its own block)."""
    return next((fb for fb in (8, 16, 32, 64) if f <= fb), 128)


def smem_bytes(fb: int) -> int:
    """Dynamic shared memory of one spmm thread block at column block fb,
    as the built kernels use it."""
    fn = _library("gcn_spmm").gcn_spmm_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(fb)


_WORKSPACE: dict = {}


def _workspace(device, dtype: torch.dtype, n: int) -> torch.Tensor:
    """A zeroed buffer of at least n elements of `dtype` on `device`, kept
    for later launches. The int32 one holds the arrival counters, one per
    (partition, output block, column slice) of a launch: the last block to
    arrive at a counter sets it back to zero. The float32 one holds the
    (128, FB) partials of the work items of runs cut in several items,
    written and read within one launch. Launches that share them must be
    ordered on one stream, as the port's compute stream orders them."""
    buf = _WORKSPACE.get((device, dtype))
    if buf is None or buf.numel() < n:
        buf = _WORKSPACE[device, dtype] = torch.zeros(
            max(n, 1 << 12), dtype=dtype, device=device)
    return buf


def _check_schedule(work, items, vals, x, name: str):
    """Device, dtype, shape and contiguity checks before an spmm launch."""
    tensors = [work, items, vals, x]
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on {x.device}")
    if x.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32 tiles and "
                        f"features, got {vals.dtype} / {x.dtype}")
    if work.dtype != torch.int32 or items.dtype != torch.int32:
        raise TypeError(f"{name}: the work list and items must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if vals.data_ptr() % 16 or work.data_ptr() % 8:   # 16- and 8-byte loads
        raise ValueError(f"{name}: vals must start on a 16-byte boundary "
                         "and work on an 8-byte one")
    p = vals.shape[0]
    if (x.dim() != 3 or x.shape[0] != p or vals.dim() != 4
            or vals.shape[2:] != (TILE, TILE)
            or work.dim() != 3 or work.shape[::2] != (p, 2)
            or items.dim() != 3 or items.shape[::2] != (p, ITEM_FIELDS)):
        raise ValueError(f"{name}: inconsistent shapes work "
                         f"{tuple(work.shape)}, items {tuple(items.shape)}, "
                         f"vals {tuple(vals.shape)}, input {tuple(x.shape)}")


def _launch_spmm(transpose: bool, work, items, vals, x, num_out: int,
                 blocks: tuple[int, int] | None, name: str,
                 out=None) -> torch.Tensor:
    """z = P·x (Pᵀ·x when `transpose`) on output blocks `blocks` (all when
    None); rows outside a block range stay as they were in `out`
    (torch.empty when None)."""
    nb = -(-num_out // TILE)
    _check_schedule(work, items, vals, x, name)
    begin, end = (0, nb) if blocks is None else blocks
    p, n_tiles = vals.shape[:2]
    f = x.shape[2]
    fb = feature_block(f)
    slices = -(-f // fb)
    n_items = items.shape[1]
    out = _output(out, (p, num_out, f), x, name)
    scratch = _workspace(x.device, torch.float32,
                         p * n_items * slices * TILE * fb)
    counters = _workspace(x.device, torch.int32, p * nb * slices)
    lib = _library("gcn_spmm")
    fn = lib.gcn_spmm_t_f32 if transpose else lib.gcn_spmm_f32
    code = fn(work.data_ptr(), items.data_ptr(), vals.data_ptr(),
              x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
              counters.data_ptr(), p, work.shape[1], n_items, nb, begin, end,
              n_tiles, x.shape[1], num_out, f, fb,
              torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on_error(code, name)
    return out


def spmm(work, items, rows, cols, vals, h, num_rows: int) -> torch.Tensor:
    """Block-sparse z = P·h over all partitions.

    work (P, W, 2) and items (P, I, 5) int32, the forward schedule of
    `tile_schedule` (the kernel's); rows, cols (P, n_tiles) int32 row and
    column blocks (the plain version's); vals (P, n_tiles, T, T); h
    (P, C, F); returns z (P, num_rows, F). On CUDA: float32 only, one
    kernel launch."""
    if not h.is_cuda:
        return spmm_plain(rows, cols, vals, h, num_rows)
    z = _launch_spmm(False, work, items, vals, h, num_rows, None, "spmm")
    spmm.launches += 1
    return z


spmm.launches = 0


def spmm_t(t_work, t_items, t_out, t_in, t_perm, vals, dz,
           num_cols: int) -> torch.Tensor:
    """Block-sparse δcomb = Pᵀ·δz over all partitions, reusing the forward
    tile values through t_perm.

    t_work / t_items the transpose schedule of `tile_schedule` (the
    kernel's; its work list holds t_perm and t_in of the nonzero slots);
    t_out, t_in, t_perm (P, n_tiles) int32 (the plain version's); vals
    (P, n_tiles, T, T); dz (P, R, F); returns δcomb (P, num_cols, F). On
    CUDA: float32 only, one kernel launch."""
    if not dz.is_cuda:
        return spmm_t_plain(t_out, t_in, t_perm, vals, dz, num_cols)
    out = _launch_spmm(True, t_work, t_items, vals, dz, num_cols, None,
                       "spmm_t")
    spmm_t.launches += 1
    return out


spmm_t.launches = 0


def spmm_phased(work, items, rows, cols, vals, h, num_rows: int,
                split: SplitSpec, phase: str, out=None) -> torch.Tensor:
    """One phase ("boundary" or "interior") of z = P·h: arguments as for
    `spmm`. Only the phase's rows are written (the boundary phase rows
    from split.row_tail on, the interior phase those before); the others
    are unspecified on the card and NaN on the CPU, and must not be read.
    On CUDA: one kernel launch on the phase's row blocks (the work items
    of those blocks, the same as in `spmm`), into `out` (a float32
    (P, num_rows, F) tensor) when given."""
    if not h.is_cuda:
        return _into(out, spmm_phased_plain(rows, cols, vals, h, num_rows,
                                            split, phase))
    blocks = phase_blocks(split.row_tail, num_rows, phase)
    z = _launch_spmm(False, work, items, vals, h, num_rows, blocks,
                     "spmm_phased", out)
    spmm_phased.launches += 1
    return z


spmm_phased.launches = 0


def spmm_t_phased(t_work, t_items, t_out, t_in, t_perm, vals, dz,
                  num_cols: int, split: SplitSpec, phase: str,
                  out=None) -> torch.Tensor:
    """One phase of δcomb = Pᵀ·δz: arguments as for `spmm_t`. The boundary
    phase writes the rows from split.col_tail on, the interior phase those
    before; the others are unspecified (NaN on the CPU). On CUDA: one
    kernel launch on the phase's column blocks, into `out` when given."""
    if not dz.is_cuda:
        return _into(out, spmm_t_phased_plain(t_out, t_in, t_perm, vals, dz,
                                              num_cols, split, phase))
    blocks = phase_blocks(split.col_tail, num_cols, phase)
    out = _launch_spmm(True, t_work, t_items, vals, dz, num_cols, blocks,
                       "spmm_t_phased", out)
    spmm_t_phased.launches += 1
    return out


spmm_t_phased.launches = 0

FUSED_MAX_FIN = 512     # 8 blocks of 64 columns: the portable cluster size


def spmm_fused(row_ptr, live, rows, cols, vals, h, w, b, num_rows: int,
               relu: bool = False, with_z: bool = True):
    """Fused block-sparse u = (P·h) @ w + b over all partitions, aggregate
    first, with an optional ReLU epilogue and the residual z = P·h.

    Stream arguments as for `spmm`; h (P, C, F_in), w (F_in, F_out), b
    (F_out,). Returns (u (P, num_rows, F_out), z (P, num_rows, F_in) or
    None without `with_z`). On CUDA: float32, contiguous, F_in ≤ 512, one
    kernel launch; z stays on chip unless asked for."""
    if not h.is_cuda:
        return spmm_fused_plain(rows, cols, vals, h, w, b, num_rows,
                                relu=relu, with_z=with_z)
    nrb = -(-num_rows // TILE)
    _check_kernel_args(row_ptr, live, (cols,), vals, h, nrb, "spmm_fused")
    p, n = cols.shape
    fin = h.shape[2]
    _check_weight(w, b, h, "spmm_fused", fin=fin)
    if fin > FUSED_MAX_FIN:
        raise ValueError(f"spmm_fused: F_in {fin} > {FUSED_MAX_FIN} (one "
                         "thread-block cluster holds the z row block)")
    fout = w.shape[1]
    u = torch.empty(p, num_rows, fout, device=h.device, dtype=torch.float32)
    z = (torch.empty(p, num_rows, fin, device=h.device, dtype=torch.float32)
         if with_z else None)
    code = _library("gcn_fused").gcn_spmm_fused_f32(
        row_ptr.data_ptr(), live.data_ptr(), cols.data_ptr(),
        vals.data_ptr(), h.data_ptr(), w.data_ptr(), b.data_ptr(),
        u.data_ptr(), z.data_ptr() if with_z else None, p, nrb, n,
        h.shape[1], num_rows, fin, fout, int(relu),
        torch.cuda.current_stream(h.device).cuda_stream)
    _raise_on_error(code, "spmm_fused")
    spmm_fused.launches += 1
    return u, z


spmm_fused.launches = 0


def spmm_fused_t(col_ptr, t_live, t_out, t_in, t_perm, vals, du, w,
                 num_cols: int) -> torch.Tensor:
    """Fused block-sparse δcomb = Pᵀ·(du @ wᵀ) over all partitions; the
    (rows, F_in) product du @ wᵀ is never built, nor wᵀ.

    Stream arguments as for `spmm_t`; du (P, R, F_out), w (F_in, F_out).
    Returns δcomb (P, num_cols, F_in). On CUDA: float32, contiguous, one
    kernel launch."""
    if not du.is_cuda:
        return spmm_fused_t_plain(t_out, t_in, t_perm, vals, du, w, num_cols)
    ncb = -(-num_cols // TILE)
    _check_kernel_args(col_ptr, t_live, (t_in, t_perm), vals, du, ncb,
                       "spmm_fused_t")
    p, n = t_in.shape
    _check_weight(w, None, du, "spmm_fused_t", fout=du.shape[2])
    fin = w.shape[0]
    out = torch.empty(p, num_cols, fin, device=du.device, dtype=torch.float32)
    code = _library("gcn_fused").gcn_spmm_fused_t_f32(
        col_ptr.data_ptr(), t_live.data_ptr(), t_in.data_ptr(),
        t_perm.data_ptr(), vals.data_ptr(), du.data_ptr(), w.data_ptr(),
        out.data_ptr(), p, ncb, n, du.shape[1], num_cols, fin, du.shape[2],
        torch.cuda.current_stream(du.device).cuda_stream)
    _raise_on_error(code, "spmm_fused_t")
    spmm_fused_t.launches += 1
    return out


spmm_fused_t.launches = 0


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


# Nonzero tiles per work item. One item is one thread block's serial walk,
# so C bounds the longest chain on the card: a run of k nonzero tiles is
# spread over ceil(k/C) blocks, whose (128, F) partials the run's last
# block adds. `python -m repro_torch.launch.bench_spmm --chunks 16,8,4,2`
# on an H100 (ms of one call at C = 16 / 8 / 4 / 2): the narrow widths
# gain from the extra blocks in flight (yelp-sim F = 24: 0.134 / 0.119 /
# 0.096 / 0.093; F = 120: 0.328 / 0.285 / 0.256 / 0.274), the wide ones
# stay level (reddit-sim F = 256: 0.694 / 0.650 / 0.654 / 0.709) until the
# partials' bytes and the serial sum of a long run's partials catch up at
# C = 2. C = 4 is the best over the main paths' widths.
SCHED_CHUNK = 4
ITEM_FIELDS = 5     # (output block, first entry, end entry, chunk, chunks)


def tile_schedule(ptr: np.ndarray, nonzero: np.ndarray, tile: np.ndarray,
                  in_blk: np.ndarray, chunk: int = SCHED_CHUNK,
                  walk_all: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """The work list and work items the CUDA kernels walk, per partition.

    ptr (P, nb+1) run pointers of a block-sorted stream; nonzero (P, n)
    whether slot s holds a nonzero tile; tile (P, n) the value-array index
    of slot s (s itself forward, t_perm[s] for the transpose); in_blk (P, n)
    its input block. Returns

      work  (P, W, 2) int32: (value-array tile, input block) of the
            nonzero slots, grouped by output block in stream order;
      items (P, I, 5) int32: (output block r, first work entry, end work
            entry, chunk c, chunks n), sorted by (r, c): output block r's
            nonzero run cut into n ≥ 1 chunks of at most `chunk` tiles (one
            empty item when the run has none, so the block is still
            written). Pads at the tails have r = -1.

    Chunk boundaries are set by counting nonzero tiles. With `walk_all`
    the work list holds every slot instead, zero tiles included, and each
    item runs from its first nonzero slot to the next item's (the first
    from the run's start, the last to its end): the same items, each
    summing the same nonzero tiles in the same order plus exact zeros, so
    both lists give the same result bit for bit. A block range of a phase
    is a contiguous item range, the same items as in the unsplit call.
    The arrays lead with the partition axis, so a rank's view of the
    topology (``rank_view``) narrows them like every other field."""
    P, nb = ptr.shape[0], ptr.shape[1] - 1
    works, items = [], []
    for p in range(P):
        ent = np.arange(ptr[p, -1]) if walk_all else np.flatnonzero(nonzero[p])
        pos = np.searchsorted(ent, ptr[p])          # run r = ent[pos[r]:pos[r+1]]
        rows = []
        for r in range(nb):
            a, b = int(pos[r]), int(pos[r + 1])
            nz = a + np.flatnonzero(nonzero[p, ent[a:b]])  # entries of nonzero slots
            n = max(1, -(-len(nz) // chunk))
            cuts = [a] + [int(nz[c * chunk]) for c in range(1, n)] + [b]
            rows += [(r, cuts[c], cuts[c + 1], c, n) for c in range(n)]
        works.append(np.stack([tile[p, ent], in_blk[p, ent]], axis=-1))
        items.append(np.asarray(rows, np.int64).reshape(-1, ITEM_FIELDS))
    n_work = max(1, max(len(w) for w in works))
    n_items = max(len(i) for i in items)
    work = np.zeros((P, n_work, 2), np.int32)
    item = np.tile(np.array([-1, 0, 0, 0, 1], np.int32), (P, n_items, 1))
    for p in range(P):
        work[p, :len(works[p])] = works[p]
        item[p, :len(items[p])] = items[p]
    return work, item


def tile_schedules(streams, num_rows: int, num_cols: int,
                   chunk: int = SCHED_CHUNK,
                   walk_all: bool = False) -> dict[str, np.ndarray]:
    """The forward and transpose schedules (`tile_schedule`) of stacked
    (P, n) tile streams: {"work", "items", "t_work", "t_items"}. `streams`
    holds them as numpy attributes rows, cols, vals, t_out, t_in and t_perm
    (a ``PartitionTiles``, say); P has num_rows rows and num_cols columns.
    ``Topology.with_schedules`` rebuilds a topology's schedules with it."""
    rows, vals = streams.rows, streams.vals
    nonzero = np.abs(vals).max(axis=(-1, -2)) > 0
    t_perm = np.asarray(streams.t_perm, np.int64)
    slots = np.broadcast_to(np.arange(rows.shape[1]), rows.shape)
    work, items = tile_schedule(run_pointers(rows, -(-num_rows // TILE)),
                                nonzero, slots, streams.cols, chunk, walk_all)
    t_work, t_items = tile_schedule(
        run_pointers(streams.t_out, -(-num_cols // TILE)),
        np.take_along_axis(nonzero, t_perm, axis=1), t_perm, streams.t_in,
        chunk, walk_all)
    return dict(work=work, items=items, t_work=t_work, t_items=t_items)


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
