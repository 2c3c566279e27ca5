"""Static FLOP / HBM-byte model of the PipeGCN layer matmul ordering
(aggregate-first vs transform-first) and the graph-layout report.

Port copy of the GCN part of the JAX package's ``repro.analysis.cost``
(the LM cost model is not part of the port). The "auto" matmul order
resolves through ``choose_gcn_orders`` exactly as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np

GCN_ORDERS = ("aggregate-first", "transform-first")
_TILE = 128       # adjacency tile edge (repro_torch.kernels.gcn_spmm.TILE)


@dataclasses.dataclass(frozen=True)
class GcnLayerCost:
    """FLOPs + approximate HBM traffic of one layer under one ordering."""

    flops: float
    hbm_bytes: float


def gcn_layer_order_cost(order: str, fin: int, fout: int, num_rows: int,
                         combined: int, nnz_eff: float,
                         first_layer: bool = False, train: bool = True,
                         fused: bool = False, tile: int = _TILE,
                         dtype_bytes: int = 4) -> GcnLayerCost:
    """Cost of one GCN layer (fwd + manual bwd) under `order`.

    num_rows: inner (output) rows n; combined: [inner; halo] rows c of the
    aggregation input; nnz_eff: effective sparse multiply-adds per feature
    column. `first_layer`: Alg. 1 stops the backward at layer 0 —
    aggregate-first then skips its backward SpMM entirely, while
    transform-first still needs Pᵀ·du for the weight gradient
    (gw = combᵀ·(Pᵀ·du)). `fused` (aggregate-first only): the fused kernels
    skip the HBM round-trips of the (rows, F_in) intermediates (z re-read
    fwd; dz write+read bwd) but the backward prologue recomputes du@wᵀ once
    per TILE-row tile slot instead of once per row block — e/tile
    transformed rows instead of n.
    """
    if order not in GCN_ORDERS:
        raise ValueError(f"unknown order {order!r}; have {GCN_ORDERS}")
    n, c, e = float(num_rows), float(combined), float(nnz_eff)
    spmm_in, spmm_out = 2.0 * e * fin, 2.0 * e * fout
    if order == "aggregate-first":
        # fwd: z = P·comb (spmm_in), u = z@w.
        # bwd: gw = zᵀ·du; dz = du@wᵀ; dcomb = Pᵀ·dz (spmm_in).
        flops = spmm_in + 2.0 * n * fin * fout
        bytes_ = (c * fin                          # read comb
                  + e                              # tile/edge values
                  + n * fin                        # write z (residual)
                  + (0.0 if fused else n * fin)    # re-read z for the matmul
                  + fin * fout + n * fout)         # weight + write u
        if train:
            flops += 2.0 * n * fin * fout          # gw
            bytes_ += n * fout + n * fin + fin * fout      # du, z, gw
            if not first_layer:
                # dz rows: per row block once (unfused) vs per tile slot
                # (fused prologue recompute, e/tile rows total)
                dz_rows = (e / tile) if fused else n
                flops += 2.0 * dz_rows * fin * fout + spmm_in
                bytes_ += (fin * fout                          # w for dz
                           + (0.0 if fused else 2.0 * n * fin)  # dz rt
                           + e + c * fin)                      # tiles+dcomb
        return GcnLayerCost(flops=flops, hbm_bytes=bytes_ * dtype_bytes)
    # transform-first (always composed: dense matmul + SpMM over F_out)
    # fwd: hw = comb@w, u = P·hw.
    # bwd: dhw = Pᵀ·du (always — gw = combᵀ·dhw needs it); dcomb = dhw@wᵀ.
    flops = 2.0 * c * fin * fout + spmm_out
    bytes_ = (c * fin + fin * fout             # read comb + w
              + 2.0 * c * fout                 # hw write + read
              + e + n * fout)                  # tiles + write u
    if train:
        flops += spmm_out + 2.0 * c * fin * fout           # dhw, gw
        bytes_ += (n * fout + e + 2.0 * c * fout           # du, tiles, dhw
                   + c * fin + fin * fout)                 # comb + gw
        if not first_layer:
            flops += 2.0 * c * fin * fout                  # dcomb = dhw@wᵀ
            bytes_ += fin * fout + c * fin                 # w + write dcomb
    return GcnLayerCost(flops=flops, hbm_bytes=bytes_ * dtype_bytes)


def _nnz_per_layer(nnz_eff, num_layers: int) -> list[float]:
    """Normalize `nnz_eff` to one measured value per layer.

    A scalar is broadcast (the historical uniform-density assumption — the
    propagation matrix is shared across layers, so this is exact when the
    caller passes a MEASURED count); a sequence is taken as per-layer
    measured sparse work and must match the layer count.
    """
    if hasattr(nnz_eff, "__len__"):
        vals = [float(v) for v in nnz_eff]
        if len(vals) != num_layers:
            raise ValueError(
                f"per-layer nnz_eff has {len(vals)} entries for "
                f"{num_layers} layers")
        return vals
    return [float(nnz_eff)] * num_layers


def gcn_order_report(layer_dims, num_rows: int, combined: int,
                     nnz_eff, train: bool = True,
                     fused: bool = False, tile: int = _TILE,
                     slot_rows: float = 0.0, wire_bytes_fn=None,
                     slice_boundary: bool = False,
                     comm_flops_per_byte: float = 0.0) -> list[dict]:
    """Per-layer cost table: {order: GcnLayerCost} + the argmin choice.

    `layer_dims` is ``ModelConfig.layer_dims()`` — [(fin, fout)] per layer.
    `nnz_eff` is the measured effective sparse multiply-adds per feature
    column — a scalar (broadcast to every layer) or a per-layer sequence;
    for the tile engines pass the measured post-layout tile count × T²
    (PipeGCN.layer_orders does), NOT a uniform-density estimate — a
    reordered graph has measurably fewer tiles and the argmin can differ.
    The choice minimizes FLOPs; HBM bytes break exact FLOP ties (and are
    reported for the roofline-minded reader either way). Callers with the
    real kernel tile size in hand pass it through — it prices the fused
    backward's prologue recompute.

    Boundary-byte pricing (all off by default, so the classic FLOP argmin
    is unchanged): with `slot_rows` (boundary rows per exchange payload,
    P·slot per partition) and `comm_flops_per_byte` > 0, each order is
    charged `comm_flops_per_byte × wire_bytes` in the argmin key, where
    wire_bytes prices the payload width that order ships — fin, or fout
    under transform-first when `slice_boundary` and fout <= fin (layer 0
    always ships fin: its payload is the raw input) — through
    `wire_bytes_fn(layer, width)` (default: 4 bytes/element), once forward
    plus once backward for trained layers > 0. The per-order byte figure
    lands in the report as "wire_bytes" either way."""
    per_layer_nnz = _nnz_per_layer(nnz_eff, len(layer_dims))
    if wire_bytes_fn is None:
        wire_bytes_fn = lambda ell, f: 4.0 * f     # noqa: E731
    out = []
    for ell, (fin, fout) in enumerate(layer_dims):
        costs = {}
        wire_bytes = {}
        for order in GCN_ORDERS:
            costs[order] = gcn_layer_order_cost(
                order, fin, fout, num_rows, combined, per_layer_nnz[ell],
                first_layer=(ell == 0), train=train,
                fused=(fused and order == "aggregate-first"), tile=tile)
            width = (fout if (slice_boundary and ell > 0 and fout <= fin
                              and order == "transform-first") else fin)
            n_dir = 1 + (1 if train and ell > 0 else 0)
            wire_bytes[order] = slot_rows * wire_bytes_fn(ell, width) * n_dir
        chosen = min(GCN_ORDERS,
                     key=lambda o: (costs[o].flops
                                    + comm_flops_per_byte * wire_bytes[o],
                                    costs[o].hbm_bytes))
        out.append({"layer": ell, "costs": costs, "chosen": chosen,
                    "wire_bytes": wire_bytes})
    return out


def choose_gcn_orders(layer_dims, num_rows: int, combined: int,
                      nnz_eff, train: bool = True,
                      fused: bool = False,
                      tile: int = _TILE, **wire_kw) -> tuple[str, ...]:
    """The static per-layer ordering the "auto" matmul_order resolves to.

    `nnz_eff` follows `gcn_order_report`: scalar or per-layer measured
    sparse work (tile count × T² for the tile engines); `wire_kw` passes
    the boundary-byte pricing knobs through (slot_rows / wire_bytes_fn /
    slice_boundary / comm_flops_per_byte)."""
    return tuple(r["chosen"] for r in gcn_order_report(
        layer_dims, num_rows, combined, nnz_eff, train=train, fused=fused,
        tile=tile, **wire_kw))


# ----------------------------------------------------------------------
# Graph-layout report: how well a PartitionedGraph's intra-partition node
# order packs the tile frontier the block-sparse engines pay for. Consumed
# by the trainer log line, benchmarks/bench_kernels.run_reorder_sweep (the
# BENCH_*.json natural-vs-rcm record + gate), and tests/test_reorder.py.
# ----------------------------------------------------------------------

def graph_layout_report(pg, tile: int = _TILE) -> dict:
    """Layout-quality metrics of the padded partition shards.

    Per partition (and aggregated):
      tiles       nonempty tile×tile blocks of the local [P_in | P_bd]
                  shard (TRUE count over real edges — no padding, no
                  zero fillers; the quantity the reorder shrinks)
      bandwidth   max |row − col| over intra-partition edges (the RCM
                  objective); `mean_bandwidth` alongside
      halo_rows   rows with at least one halo-column edge
      halo_runs   maximal contiguous runs of those rows — 1 means the halo
                  frontier is perfectly clustered
      bnd_tiles   nonempty tiles whose output rows land in the boundary
                  tail (row block >= the split-phase cut b0) — the
                  critical-path prefix the split schedule must run BEFORE
                  issuing the exchange; when the split is infeasible the
                  whole stream is the prefix (bnd_tiles == tiles)
    Aggregated: `bnd_tile_share` = Σbnd_tiles / Σtiles (the fraction of
    sparse work that is NOT overlappable — 1.0 when infeasible), so the
    reorder sweep shows how much of the tile stream each layout exposes
    to the split-phase overlap.
    """
    from repro_torch.graph.halo import boundary_row_split
    split = boundary_row_split(pg, tile)
    b0 = split["b0"] if split["feasible"] else 0
    combined = pg.max_inner + pg.num_parts * pg.slot
    ncb = -(-combined // tile)
    per = []
    for i in range(pg.num_parts):
        keep = pg.edge_w[i] != 0
        row = pg.edge_row[i][keep].astype(np.int64)
        col = pg.edge_col[i][keep].astype(np.int64)
        tile_ids = np.unique((row // tile) * ncb + (col // tile))
        tiles = len(tile_ids)
        intra = col < pg.max_inner
        span = np.abs(row[intra] - col[intra])
        halo_rows = np.unique(row[~intra])
        per.append({
            "tiles": int(tiles),
            "bnd_tiles": int(np.sum(tile_ids // ncb >= b0)
                             if split["feasible"] else tiles),
            "bandwidth": int(span.max()) if span.size else 0,
            "mean_bandwidth": float(span.mean()) if span.size else 0.0,
            "halo_rows": int(len(halo_rows)),
            "halo_runs": (int(np.sum(np.diff(halo_rows) > 1) + 1)
                          if len(halo_rows) else 0),
        })
    tiles_total = sum(p["tiles"] for p in per)
    bnd_total = sum(p["bnd_tiles"] for p in per)
    return {
        "layout": getattr(pg, "layout", "natural"),
        "tile": tile,
        "per_partition": per,
        "tiles": tiles_total,
        "bandwidth": max(p["bandwidth"] for p in per),
        "mean_bandwidth": float(np.mean([p["mean_bandwidth"] for p in per])),
        "halo_runs": sum(p["halo_runs"] for p in per),
        "split_feasible": bool(split["feasible"]),
        "bnd_tiles": bnd_total,
        "bnd_tile_share": float(bnd_total / max(tiles_total, 1)),
    }
