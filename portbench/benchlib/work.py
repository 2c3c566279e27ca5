"""The benchmark's yardstick: the chip's peaks and the work a PipeGCN epoch
and an aggregation call need, counted from the graph's real edges and rows.

Kept here, apart from the program's cost model (``analysis/cost.py``),
so that a change to the program cannot move it. The same work is counted
whatever implements it: padding, zero tiles and recomputation are not
work.
"""
from __future__ import annotations

import dataclasses

from benchlib.graphgen import unique_sorted

# One NVIDIA H100 SXM (data sheet, dense): TF32 495 TFLOP/s on the tensor
# cores. Exact float32 on them takes three TF32 products (3xTF32), and
# plain TF32 is below the port's precision, so 495 / 3 is the most an
# exact-f32 product may reach.
PEAK_F32_FLOPS = 495e12 / 3
HBM_BYTES_PER_S = 3.35e12
INDEX_AND_WEIGHT_BYTES = 8     # one int32 column and one f32 weight a edge
ELEM_BYTES = 4


@dataclasses.dataclass(frozen=True)
class GraphCounts:
    """Real sizes of one partitioned graph, summed over the partitions."""

    nodes: int        # real nodes (inner rows)
    edges: int        # real edges, each in the partition that receives it
    rows: int         # inner rows that receive at least one edge
    cols: int         # combined rows (inner or halo) that some edge reads


def graph_counts(layout) -> GraphCounts:
    """GraphCounts of a ``substrate.Layout``."""
    return GraphCounts(
        nodes=int(layout.inner_count.sum()),
        edges=int(sum(len(r) for r in layout.edge_row)),
        rows=int(sum(len(unique_sorted(r)) for r in layout.edge_row)),
        cols=int(sum(len(unique_sorted(c)) for c in layout.edge_col)))


def layer_flops(fin: int, fout: int, n: int, e: int, first: bool) -> int:
    """Forward + Alg. 1 backward matmul FLOPs of one GraphSAGE layer, in
    the cheaper of the two matmul orders. Dense products: the neighbour
    and the self weight, forward, weight gradient and (past layer 0) input
    gradient; aggregation: 2·e·width per pass, none backward at layer 0."""
    dense = 2 * n * fin * fout
    # aggregate-first: z = P·comb (fin wide), then z·W; backward z^T·du and
    # P^T·(du·W^T)
    agg_first = (2 * e * fin + 2 * dense) + 2 * dense
    # transform-first: P·(comb·W) (fout wide); backward P^T·du once, which
    # serves both the weight gradient and the input gradient
    tr_first = (2 * e * fout + 2 * dense) + (2 * e * fout + 2 * dense)
    if not first:
        agg_first += 2 * dense + 2 * e * fin
        tr_first += 2 * dense
    return min(agg_first, tr_first)


def epoch_flops(dims, counts: GraphCounts) -> int:
    """Model FLOPs of one training epoch over the whole graph."""
    return sum(layer_flops(fin, fout, counts.nodes, counts.edges, ell == 0)
               for ell, (fin, fout) in enumerate(dims))


def agg_call_work(method: str, counts: GraphCounts, fin: int,
                  fout: int | None = None, with_z: bool = True,
                  phase: str | None = None) -> tuple[int, int]:
    """(FLOPs, bytes) an aggregation engine call needs. `fin` is the width
    the sparse product runs at for spmm / spmm_t; for the pairs with a
    dense product, fin x fout is the weight. A phased call carries the
    whole product's work on its boundary phase and none on its interior
    phase, so a pair of phases counts once."""
    if phase == "interior":
        return 0, 0
    e = counts.edges
    edge_bytes = INDEX_AND_WEIGHT_BYTES * e
    if method in ("spmm", "spmm_phased"):
        return (2 * e * fin,
                edge_bytes + ELEM_BYTES * fin * (counts.cols + counts.rows))
    if method in ("spmm_t", "spmm_t_phased"):
        return (2 * e * fin,
                edge_bytes + ELEM_BYTES * fin * (counts.rows + counts.cols))
    if method == "aggregate_transform":
        # z = P·comb, u = z·W + b; writes u, and z when asked
        flops = 2 * e * fin + 2 * counts.rows * fin * fout
        out = fout + (fin if with_z else 0)
        return (flops, edge_bytes + ELEM_BYTES * (
            fin * counts.cols + out * counts.rows + fin * fout))
    if method == "aggregate_transform_t":
        # dcomb = P^T·(du·W^T): reads du (fout wide), writes fin wide
        flops = 2 * counts.rows * fin * fout + 2 * e * fin
        return (flops, edge_bytes + ELEM_BYTES * (
            fout * counts.rows + fin * counts.cols + fin * fout))
    raise ValueError(f"unknown engine method {method!r}")


def bound_seconds(flops: int, nbytes: int) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / PEAK_F32_FLOPS, nbytes / HBM_BYTES_PER_S)
