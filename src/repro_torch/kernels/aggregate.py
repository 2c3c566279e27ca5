"""Aggregation engines for the PipeGCN hot path (Eq. 3/4 SpMM).

Port of the JAX package's ``repro.kernels.aggregate``. The training step
calls aggregation through a narrow interface, over tensors that carry the
leading partition axis:

    z      = engine.spmm(tslice, comb, num_rows)      # z = P_local · comb
    dcomb  = engine.spmm_t(tslice, dz, num_cols)      # δcomb = P_localᵀ · δz
    u, z   = engine.aggregate_transform(tslice, comb, w, b, num_rows)
    dcomb  = engine.aggregate_transform_t(tslice, du, w, num_cols)
    z      = engine.spmm_phased(tslice, comb, num_rows, split, phase)
    dcomb  = engine.spmm_t_phased(tslice, dz, num_cols, split, phase)

The phased pair computes one phase ("boundary" or "interior") of the
split-phase schedule (``gcn_spmm.SplitSpec``): only the phase's own output
rows are valid.

`tslice` is the tuple of Topology fields named by ``engine.fields``. The
``aggregate_transform*`` pair composes the SpMM with a dense matmul, except
in the fused engine.

  coo         padded COO (``repro_torch.kernels.coo_spmm``): on the card one
              CUDA segment-reduction kernel per call over the topology's
              sorted edge views (no per-edge intermediate, no float
              atomic); on the CPU ``index_select`` + ``index_add_`` over a
              flattened partition×row index (exact in float64: the oracle).
  blocksparse the block-sparse SpMM of ``repro_torch.kernels.gcn_spmm``
              (CUDA kernels on the card, the plain version on the CPU).
              Ragged row counts and feature widths are handled inside, so
              no zero padding is needed around it.
  fused       blocksparse storage + the fused aggregate+transform kernels:
              u = (P·comb)@w + b with the bias and an optional ReLU in the
              epilogue and z as an optional second output, and
              δcomb = Pᵀ·(du@wᵀ), computed as (Pᵀ·du)@wᵀ with the dense
              product once per output block; one launch each.

Every engine method runs inside the device span ``repro.agg.<method>``
(`repro_torch.spans`); a call nested in another counts its device time
once, in the outer span.
"""
from __future__ import annotations

import functools

import torch

from repro_torch import spans
from repro_torch.kernels import coo_spmm, gcn_spmm


def _traced(method):
    """Run an engine method inside the device span repro.agg.<method>."""
    name = "repro.agg." + method.__name__

    @functools.wraps(method)
    def call(*args, **kw):
        with spans.span(name, device=True):
            return method(*args, **kw)

    return call


class AggregationEngine:
    """Interface + default aggregate/transform composition."""

    name: str
    fields: tuple[str, ...]
    optional: tuple[str, ...] = ()    # fields a topology may leave None

    def spmm(self, tslice, comb, num_rows: int):
        raise NotImplementedError

    def spmm_t(self, tslice, dz, num_cols: int):
        raise NotImplementedError

    def spmm_phased(self, tslice, comb, num_rows: int, split, phase: str):
        raise NotImplementedError

    def spmm_t_phased(self, tslice, dz, num_cols: int, split, phase: str):
        raise NotImplementedError

    @_traced
    def aggregate_transform(self, tslice, comb, w, b, num_rows: int,
                            relu: bool = False, with_z: bool = True):
        """u = (P·comb) @ w + b (ReLU'd when `relu`), plus the aggregation
        residual z = P·comb (None when `with_z=False`, e.g. at eval)."""
        z = self.spmm(tslice, comb, num_rows)
        u = z @ w + b
        if relu:
            u = torch.relu(u)
        return u, (z if with_z else None)

    @_traced
    def aggregate_transform_t(self, tslice, du, w, num_cols: int):
        """δcomb = Pᵀ·(du @ wᵀ)."""
        return self.spmm_t(tslice, du @ w.T, num_cols)


def _named(fields: tuple[str, ...], names: tuple[str, ...]):
    """tslice (a tuple over `fields`) -> the tuple of its fields `names`."""
    at = [fields.index(n) for n in names]
    return lambda tslice: tuple(tslice[i] for i in at)


class CooEngine(AggregationEngine):
    """Padded-COO aggregation: the segment-reduction kernel of `coo_spmm`
    on the card, gather + scatter-add on the CPU. A tslice holds the three
    edge fields, then the forward and the transpose view
    (`Topology.with_coo_views`), which the CPU path does not read and a
    CPU topology leaves None."""

    name = "coo"
    optional = coo_spmm.FWD_VIEW + coo_spmm.BWD_VIEW
    fields = ("edge_row", "edge_col", "edge_w") + optional

    @_traced
    def spmm(self, tslice, comb, num_rows: int):
        return coo_spmm.spmm(tslice[:3], tslice[3:7], comb, num_rows)

    @_traced
    def spmm_t(self, tslice, dz, num_cols: int):
        return coo_spmm.spmm_t(tslice[:3], tslice[7:11], dz, num_cols)

    @_traced
    def spmm_phased(self, tslice, comb, num_rows: int, split, phase: str):
        return coo_spmm.spmm_phased(tslice[:3], tslice[3:7], comb, num_rows,
                                    split, phase)

    @_traced
    def spmm_t_phased(self, tslice, dz, num_cols: int, split, phase: str):
        return coo_spmm.spmm_t_phased(tslice[:3], tslice[7:11], dz, num_cols,
                                      split, phase)


class BlockSparseEngine(AggregationEngine):
    """Block-sparse aggregation on the tile streams (see gcn_spmm): the
    spmm kernels' schedules and streams, in their argument order."""

    name = "blocksparse"
    spmm_args = ("tile_work", "tile_items", "tile_rows", "tile_cols",
                 "tile_vals")
    spmm_t_args = ("tile_t_work", "tile_t_items", "tile_t_out", "tile_t_in",
                   "tile_t_perm", "tile_vals")
    fields = tuple(dict.fromkeys(spmm_args + spmm_t_args))
    _fwd = staticmethod(_named(fields, spmm_args))
    _bwd = staticmethod(_named(fields, spmm_t_args))

    @_traced
    def spmm(self, tslice, comb, num_rows: int):
        return gcn_spmm.spmm(*self._fwd(tslice), comb.contiguous(), num_rows)

    @_traced
    def spmm_t(self, tslice, dz, num_cols: int):
        return gcn_spmm.spmm_t(*self._bwd(tslice), dz.contiguous(), num_cols)

    @_traced
    def spmm_phased(self, tslice, comb, num_rows: int, split, phase: str):
        return gcn_spmm.spmm_phased(*self._fwd(tslice), comb.contiguous(),
                                    num_rows, split, phase)

    @_traced
    def spmm_t_phased(self, tslice, dz, num_cols: int, split, phase: str):
        return gcn_spmm.spmm_t_phased(*self._bwd(tslice), dz.contiguous(),
                                      num_cols, split, phase)


class FusedBlockSparseEngine(BlockSparseEngine):
    """Block-sparse tiles + the fused aggregate+transform kernels.

    The primitive spmm/spmm_t (the transform-first ordering) and the
    phased pair are inherited; the `aggregate_transform*` pair runs the
    single-pass fused kernels (``gcn_spmm.spmm_fused`` / ``spmm_fused_t``)
    on the spmm kernels' schedules and streams. The split-phase schedule
    runs this engine through the composed phased path: the fused epilogue
    would push the unwritten out-of-phase rows through the dense weight."""

    name = "fused"

    @_traced
    def aggregate_transform(self, tslice, comb, w, b, num_rows: int,
                            relu: bool = False, with_z: bool = True):
        return gcn_spmm.spmm_fused(*self._fwd(tslice), comb, w, b,
                                   num_rows, relu=relu, with_z=with_z)

    @_traced
    def aggregate_transform_t(self, tslice, du, w, num_cols: int):
        return gcn_spmm.spmm_fused_t(*self._bwd(tslice), du, w, num_cols)


ENGINES = {e.name: e for e in (CooEngine(), BlockSparseEngine(),
                               FusedBlockSparseEngine())}


def get_engine(name: str):
    """Look up an aggregation engine ("coo" | "blocksparse" | "fused")."""
    try:
        return ENGINES[name]
    except KeyError:
        raise KeyError(
            f"unknown aggregation engine {name!r}; have {sorted(ENGINES)}"
        ) from None
