"""COO aggregation — forward (z = P·comb, Eq. 3) and transpose (δcomb =
Pᵀ·δz, Eq. 4) — over the padded edge list of each partition, plus the
sorted edge views that its CUDA kernel walks.

The plain version is the JAX package's ``segment_sum`` written with
``index_select`` + ``index_add_``: it gathers one source row per padded
edge slot, scales it and adds it into its output row (exact in float64:
the oracle). On the card each call runs one hand-written CUDA kernel
(``csrc/coo_spmm.cu``) instead, a destination-segmented reduction over a
view of the real edges grouped by output index:

    spmm(edges, view, x, num_rows)                  z = P·x
    spmm_t(edges, t_view, dz, num_cols)             δcomb = Pᵀ·δz

with edges = (edge_row, edge_col, edge_w), the padded slots, view =
(row_ptr, items, src, w) and t_view = (col_ptr, t_items, t_src, t_w);
and ``spmm_phased`` / ``spmm_t_phased``, one phase of the split-phase
schedule (`gcn_spmm.SplitSpec`): the boundary phase writes the rows from
``split.row_tail`` (``col_tail`` for the transpose) on, the interior phase
those before, and both leave the other rows zero, as the plain version
does; each phase's rows are bit-equal to the unsplit kernel's.

A CUDA tensor goes to the kernel, which reads the view alone, and a CPU
tensor to the plain version (``spmm_plain`` and the rest), which reads
the edges alone; nothing falls back from one to the other. The views are
built once per topology by `coo_views` (Topology fields ``coo_*``,
`Topology.with_coo_views`); the kernel takes float32 and float64, and its
sums are the same bits run to run. The counter
``coo_spmm.<wrapper>`` (`repro_torch.spans`) counts each wrapper's kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import spans
from repro_torch.kernels.gcn_spmm import (ITEM_FIELDS, _raise_on_error,
                                          _workspace)

# Edges per work item. One item is one warp's serial walk, so C bounds the
# longest chain on the card: a hub row of k edges is spread over ceil(k/C)
# warps, whose partials the segment's last warp adds.
COO_CHUNK = 256

# The views' Topology fields: the forward view (rows) and the transpose
# view (columns), each (pointers, work items, sources, weights).
FWD_VIEW = ("coo_row_ptr", "coo_items", "coo_src", "coo_w")
BWD_VIEW = ("coo_col_ptr", "coo_t_items", "coo_t_src", "coo_t_w")


# ----------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the reference on the card)
# ----------------------------------------------------------------------

def _flat_index(idx: torch.Tensor, stride: int) -> torch.Tensor:
    """(P, n) per-partition row index -> (P·n,) index into a (P·stride) axis."""
    p = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return (idx.long() + stride * p).reshape(-1)


def coo_plain(src, dst, w, x, num_out: int):
    """out[p, dst[p, e]] += w[p, e] · x[p, src[p, e]] for every edge e."""
    p, n_in, f = x.shape
    vals = x.reshape(p * n_in, f).index_select(0, _flat_index(src, n_in))
    vals = vals * w.to(x.dtype).reshape(-1, 1)
    out = x.new_zeros(p * num_out, f)
    out.index_add_(0, _flat_index(dst, num_out), vals)
    return out.reshape(p, num_out, f)


def _phase_keep(in_boundary: torch.Tensor, phase: str) -> torch.Tensor:
    """Edge-level phase membership from a boundary predicate."""
    if phase == "boundary":
        return in_boundary
    if phase == "interior":
        return ~in_boundary
    raise ValueError(f"phase must be 'boundary' or 'interior', got {phase!r}")


def spmm_plain(edge_row, edge_col, edge_w, x, num_rows: int) -> torch.Tensor:
    """z[p, r] = Σ edge_w · x[p, edge_col] over the slots with edge_row = r."""
    return coo_plain(edge_col, edge_row, edge_w, x, num_rows)


def spmm_t_plain(edge_row, edge_col, edge_w, dz, num_cols: int) -> torch.Tensor:
    """δcomb[p, c] = Σ edge_w · dz[p, edge_row] over the slots with
    edge_col = c."""
    return coo_plain(edge_row, edge_col, edge_w, dz, num_cols)


# Out-of-phase edges get weight 0, so each phase's own rows see the same
# sequence of terms as the unsplit call (the zeroed terms add an exact
# 0.0); out-of-phase rows come out zero, as in the JAX package.
def spmm_phased_plain(edge_row, edge_col, edge_w, x, num_rows: int, split,
                      phase: str) -> torch.Tensor:
    """One phase of `spmm_plain`: rows from split.row_tail on (boundary) or
    before it (interior); the other rows zero."""
    keep = _phase_keep(edge_row >= split.row_tail, phase)
    return coo_plain(edge_col, edge_row, torch.where(keep, edge_w, 0), x,
                     num_rows)


def spmm_t_phased_plain(edge_row, edge_col, edge_w, dz, num_cols: int, split,
                        phase: str) -> torch.Tensor:
    """One phase of `spmm_t_plain`: columns from split.col_tail on
    (boundary) or before it (interior); the other rows zero."""
    keep = _phase_keep(edge_col >= split.col_tail, phase)
    return coo_plain(edge_row, edge_col, torch.where(keep, edge_w, 0), dz,
                     num_cols)


# ----------------------------------------------------------------------
# Views: the real edges grouped by output index, and their work items
# ----------------------------------------------------------------------

def real_edges(edge_w: torch.Tensor) -> torch.Tensor:
    """(P,) int64: each partition's own edge count. The graph pipeline
    writes a partition's edges first and pads its slots past them with
    zero weights (`graph.halo`), so the count runs up to the last nonzero
    weight; an all-zero partition (an elastic pad) has none."""
    slot = torch.arange(1, edge_w.shape[1] + 1, device=edge_w.device)
    return torch.where(edge_w != 0, slot, 0).amax(dim=1)


def work_items(ptr: torch.Tensor, chunk: int = COO_CHUNK) -> torch.Tensor:
    """(P, R+1) segment pointers -> (P, I, 5) int32 work items (output row
    r, first edge, end edge, chunk c, chunks n), sorted by (r, c): segment
    r cut into n = max(1, ceil(len/chunk)) items of at most `chunk` edges
    (an empty segment keeps one empty item, which writes its zeros). A
    partition with fewer items than the widest is padded with r = -1."""
    ptr = ptr.long()
    n = torch.clamp((ptr[:, 1:] - ptr[:, :-1] + chunk - 1) // chunk, min=1)
    ends = torch.cumsum(n, dim=1)                      # (P, R)
    width = int(ends[:, -1].max())
    j = torch.arange(width, device=ptr.device).expand(ptr.shape[0], width)
    row = torch.searchsorted(ends, j.contiguous(), right=True)   # (P, I)
    pad = row >= n.shape[1]
    row = torch.clamp(row, max=n.shape[1] - 1)
    c = j - (torch.gather(ends, 1, row) - torch.gather(n, 1, row))
    begin = torch.gather(ptr, 1, row) + c * chunk
    end = torch.minimum(begin + chunk, torch.gather(ptr, 1, row + 1))
    items = torch.stack([row, begin, end, c, torch.gather(n, 1, row)], -1)
    items[pad] = torch.tensor([-1, 0, 0, 0, 1], device=ptr.device)
    return items.to(torch.int32)


def segment_view(out_idx, in_idx, w, num_out: int, chunk: int = COO_CHUNK):
    """One direction's view of stacked (P, n) COO slots: the real edges
    (`real_edges`) stably sorted by out_idx, so each output's terms keep
    their COO order. Returns (ptr (P, num_out+1) int32, items (P, I, 5)
    int32 (`work_items`), src (P, E) int32 (in_idx of each edge), w (P, E)
    in w's dtype), E the most real edges of a partition; slots past a
    partition's edges hold 0 and are never read."""
    p, n = out_idx.shape
    if n >= 2 ** 31:
        raise ValueError(f"{n} edge slots a partition do not fit int32")
    dev = out_idx.device
    count = real_edges(w)
    key = torch.where(torch.arange(n, device=dev) < count[:, None],
                      out_idx.long(), num_out)        # padding sorts last
    key, order = torch.sort(key, dim=1, stable=True)
    e = max(int(count.max()), 1)
    order = order[:, :e]
    past = torch.arange(e, device=dev) >= count[:, None]
    src = torch.gather(in_idx, 1, order).masked_fill(past, 0)
    ws = torch.gather(w, 1, order).masked_fill(past, 0)
    bounds = torch.arange(num_out + 1, device=dev).expand(p, num_out + 1)
    ptr = torch.searchsorted(key, bounds.contiguous()).to(torch.int32)
    return (ptr, work_items(ptr, chunk), src.to(torch.int32).contiguous(),
            ws.contiguous())


def coo_views(edge_row, edge_col, edge_w, num_rows: int, num_cols: int,
              chunk: int = COO_CHUNK) -> dict[str, torch.Tensor]:
    """The forward view (edges grouped by row, `FWD_VIEW`) and the
    transpose view (grouped by column, `BWD_VIEW`) of a topology's COO
    fields, on their device: {field name: tensor}."""
    fwd = segment_view(edge_row, edge_col, edge_w, num_rows, chunk)
    bwd = segment_view(edge_col, edge_row, edge_w, num_cols, chunk)
    return dict(zip(FWD_VIEW + BWD_VIEW, fwd + bwd))


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------

_ENTRY = {torch.float32: "coo_spmm_f32", torch.float64: "coo_spmm_f64"}


def _library():
    from repro_torch.kernels._build import load
    lib = load("coo_spmm")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for fn in _ENTRY.values():
            getattr(lib, fn).argtypes = [vp] * 7 + [ci] * 11 + [vp]
            getattr(lib, fn).restype = ci
        lib._argtypes_set = True
    return lib


def lanes(f: int, vec: int) -> tuple[int, int, int]:
    """How the kernel covers F columns with `vec` elements a load: (G
    lanes a row, K vectors a lane, column slices). G is the narrowest
    power of two that holds F's vectors, up to 32; past 32 vectors K grows
    to 2, then 4, and F past 128 vectors takes several slices."""
    nv = -(-f // vec)
    if nv <= 32:
        g, k = 1 << (nv - 1).bit_length(), 1
    else:
        g, k = 32, 2 if nv <= 64 else 4
    return g, k, -(-f // (g * k * vec))


def load_width(f: int, *tensors: torch.Tensor) -> int:
    """Elements the kernel loads at once over rows of F elements of these
    tensors: 16 bytes (4 floats, 2 doubles) where F and every tensor's
    first element keep them aligned, else 1."""
    size = tensors[0].element_size()
    vec = 16 // size
    if f % vec == 0 and all(t.data_ptr() % 16 == 0 for t in tensors):
        return vec
    return 1


def _launch(view, x, num_out: int, rows: tuple[int, int],
            name: str) -> torch.Tensor:
    """out = the segment sums of view (ptr, items, src, w) over x, rows
    [rows[0], rows[1]) written and the others zero."""
    if len(view) != 4 or view[1] is None:
        raise ValueError(
            f"{name}: the COO kernel walks the topology's sorted edge views, "
            "and this topology has none: build them with "
            "Topology.with_coo_views()")
    if x.dtype not in _ENTRY:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or float64 "
                        f"features, got {x.dtype}")
    ptr, items, src, w = view
    w = w.to(x.dtype)
    tensors = (ptr, items, src, w, x)
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on {x.device}")
    if any(t.dtype != torch.int32 for t in (ptr, items, src)):
        raise TypeError(f"{name}: pointers, items and sources must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    p = x.shape[0]
    if (x.dim() != 3 or ptr.shape != (p, num_out + 1)
            or items.dim() != 3 or items.shape[::2] != (p, ITEM_FIELDS)
            or src.shape != w.shape or src.dim() != 2 or src.shape[0] != p):
        raise ValueError(f"{name}: inconsistent shapes ptr {tuple(ptr.shape)}"
                         f", items {tuple(items.shape)}, src "
                         f"{tuple(src.shape)}, w {tuple(w.shape)}, input "
                         f"{tuple(x.shape)} for {num_out} outputs")
    f = x.shape[2]
    out = torch.empty(p, num_out, f, device=x.device, dtype=x.dtype)
    vec = load_width(f, x, out)
    g, k, slices = lanes(f, vec)
    n_items = items.shape[1]
    scratch = _workspace(x.device, x.dtype, p * n_items * slices * g * k * vec)
    counters = _workspace(x.device, torch.int32, p * num_out * slices)
    fn = getattr(_library(), _ENTRY[x.dtype])
    code = fn(items.data_ptr(), src.data_ptr(), w.data_ptr(), x.data_ptr(),
              out.data_ptr(), scratch.data_ptr(), counters.data_ptr(), p,
              n_items, src.shape[1], x.shape[1], num_out, rows[0], rows[1], f,
              vec, g, k, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on_error(code, name)
    spans.count("coo_spmm." + name)
    return out


def _phase_rows(tail: int, num_out: int, phase: str) -> tuple[int, int]:
    """The output rows [begin, end) of one phase; raises when either phase
    would be empty."""
    if not 0 < tail < num_out:
        raise ValueError(f"phase split at row {tail} must lie strictly "
                         f"inside the {num_out} output rows")
    if phase == "boundary":
        return tail, num_out
    if phase == "interior":
        return 0, tail
    raise ValueError(f"phase must be 'boundary' or 'interior', got {phase!r}")


def spmm(edges, view, x, num_rows: int) -> torch.Tensor:
    """z[p, r] = Σ w · x[p, col] over partition p's edges into row r.

    edges (edge_row, edge_col, edge_w), each (P, n): the padded COO slots
    (the plain version's); view (row_ptr, items, src, w): the forward view
    of `coo_views` (the kernel's; the CPU reads none, and it may be empty
    there); x (P, C, F); returns z (P, num_rows, F). On CUDA: float32 or
    float64, one kernel launch."""
    if not x.is_cuda:
        return spmm_plain(*edges, x, num_rows)
    return _launch(view, x.contiguous(), num_rows, (0, num_rows), "spmm")


def spmm_t(edges, t_view, dz, num_cols: int) -> torch.Tensor:
    """δcomb[p, c] = Σ w · dz[p, row] over partition p's edges out of
    column c: arguments as for `spmm`, with the transpose view; dz (P, R,
    F), returns (P, num_cols, F)."""
    if not dz.is_cuda:
        return spmm_t_plain(*edges, dz, num_cols)
    return _launch(t_view, dz.contiguous(), num_cols, (0, num_cols), "spmm_t")


def spmm_phased(edges, view, x, num_rows: int, split,
                phase: str) -> torch.Tensor:
    """One phase ("boundary" or "interior") of `spmm`: the rows from
    split.row_tail on, or those before; the other rows zero."""
    if not x.is_cuda:
        return spmm_phased_plain(*edges, x, num_rows, split, phase)
    return _launch(view, x.contiguous(), num_rows,
                   _phase_rows(split.row_tail, num_rows, phase),
                   "spmm_phased")


def spmm_t_phased(edges, t_view, dz, num_cols: int, split,
                  phase: str) -> torch.Tensor:
    """One phase of `spmm_t`: the columns from split.col_tail on, or those
    before; the other rows zero."""
    if not dz.is_cuda:
        return spmm_t_phased_plain(*edges, dz, num_cols, split, phase)
    return _launch(t_view, dz.contiguous(), num_cols,
                   _phase_rows(split.col_tail, num_cols, phase),
                   "spmm_t_phased")
