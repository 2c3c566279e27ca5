"""Aggregation engines for the PipeGCN hot path (Eq. 3/4 SpMM).

Port of the JAX package's ``repro.kernels.aggregate`` (unphased methods).
The training step calls aggregation through a narrow interface, over
tensors that carry the leading partition axis:

    z      = engine.spmm(tslice, comb, num_rows)      # z = P_local · comb
    dcomb  = engine.spmm_t(tslice, dz, num_cols)      # δcomb = P_localᵀ · δz
    u, z   = engine.aggregate_transform(tslice, comb, w, b, num_rows)
    dcomb  = engine.aggregate_transform_t(tslice, du, w, num_cols)

`tslice` is the tuple of Topology fields named by ``engine.fields``. The
``aggregate_transform*`` pair composes the SpMM with a dense matmul.

  coo         padded COO: ``index_select`` + ``index_add_`` over a flattened
              partition×row index (exact in float64: the oracle).
  blocksparse the block-sparse SpMM of ``repro_torch.kernels.gcn_spmm``
              (CUDA kernels on the card, the plain version on the CPU).
              Ragged row counts and feature widths are handled inside, so
              no zero padding is needed around it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import gcn_spmm


class AggregationEngine:
    """Interface + default aggregate/transform composition."""

    name: str
    fields: tuple[str, ...]

    def spmm(self, tslice, comb, num_rows: int):
        raise NotImplementedError

    def spmm_t(self, tslice, dz, num_cols: int):
        raise NotImplementedError

    def aggregate_transform(self, tslice, comb, w, b, num_rows: int,
                            with_z: bool = True):
        """u = (P·comb) @ w + b, plus the aggregation residual z = P·comb
        (None when `with_z=False`, e.g. at eval)."""
        z = self.spmm(tslice, comb, num_rows)
        return z @ w + b, (z if with_z else None)

    def aggregate_transform_t(self, tslice, du, w, num_cols: int):
        """δcomb = Pᵀ·(du @ wᵀ)."""
        return self.spmm_t(tslice, du @ w.T, num_cols)


def _flat_index(idx: torch.Tensor, stride: int) -> torch.Tensor:
    """(P, n) per-partition row index -> (P·n,) index into a (P·stride) axis."""
    p = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return (idx.long() + stride * p).reshape(-1)


def _coo(src, dst, w, x, num_out: int):
    """out[p, dst[p, e]] += w[p, e] · x[p, src[p, e]] for every edge e."""
    p, n_in, f = x.shape
    vals = x.reshape(p * n_in, f).index_select(0, _flat_index(src, n_in))
    vals = vals * w.to(x.dtype).reshape(-1, 1)
    out = x.new_zeros(p * num_out, f)
    out.index_add_(0, _flat_index(dst, num_out), vals)
    return out.reshape(p, num_out, f)


class CooEngine(AggregationEngine):
    """Padded-COO aggregation (gather + scatter-add)."""

    name = "coo"
    fields = ("edge_row", "edge_col", "edge_w")

    def spmm(self, tslice, comb, num_rows: int):
        edge_row, edge_col, edge_w = tslice
        return _coo(edge_col, edge_row, edge_w, comb, num_rows)

    def spmm_t(self, tslice, dz, num_cols: int):
        edge_row, edge_col, edge_w = tslice
        return _coo(edge_row, edge_col, edge_w, dz, num_cols)


class BlockSparseEngine(AggregationEngine):
    """Block-sparse aggregation on the tile streams (see gcn_spmm)."""

    name = "blocksparse"
    fields = ("tile_row_ptr", "tile_live", "tile_rows", "tile_cols",
              "tile_vals", "tile_col_ptr", "tile_t_live", "tile_t_out",
              "tile_t_in", "tile_t_perm")

    def spmm(self, tslice, comb, num_rows: int):
        row_ptr, live, rows, cols, vals = tslice[:5]
        return gcn_spmm.spmm(row_ptr, live, rows, cols, vals,
                             comb.contiguous(), num_rows)

    def spmm_t(self, tslice, dz, num_cols: int):
        vals = tslice[4]
        col_ptr, t_live, t_out, t_in, t_perm = tslice[5:]
        return gcn_spmm.spmm_t(col_ptr, t_live, t_out, t_in, t_perm, vals,
                               dz.contiguous(), num_cols)


ENGINES = {e.name: e for e in (CooEngine(), BlockSparseEngine())}


def get_engine(name: str):
    """Look up an aggregation engine ("coo" | "blocksparse")."""
    if name == "fused":
        raise NotImplementedError(
            "agg='fused' is not ported yet (ROADMAP Queue 2: the fused "
            "aggregate+transform kernel pair)")
    try:
        return ENGINES[name]
    except KeyError:
        raise KeyError(
            f"unknown aggregation engine {name!r}; have {sorted(ENGINES)}"
        ) from None
