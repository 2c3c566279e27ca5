"""Locality-aware per-partition node reordering for the block-sparse
aggregation engines.

Port copy of the JAX package's ``repro.graph.reorder`` (numpy only): the
port imports nothing of ``repro``, and the two must build byte-identical
arrays (tests/test_torch_graph.py).

The tile engines (repro_torch.kernels.gcn_spmm) do work proportional to the
number of nonempty 128×128 tiles of each partition's propagation shard
P_local = [P_in | P_bd] over the combined [inner; halo] column space.
`build_partitioned_graph` historically ordered inner nodes by global id —
the arbitrary order the partitioner emits — which scatters both the
intra-partition edges and the halo-consuming rows across the tile grid.

This module computes a per-partition permutation of the inner nodes that
shrinks that tile frontier, composed of two standard layout moves
(Demirci et al., "Scalable Graph Convolutional Network Training on
Distributed-Memory Systems", 2022 — bandwidth-reducing reordering for
distributed SpMM):

  1. RCM bandwidth reduction over the LOCAL subgraph (intra-partition
     edges only): reverse Cuthill–McKee packs the P_in block toward the
     diagonal, so the intra-partition edges of a row block fall into few
     column blocks.
  2. Halo clustering: nodes incident to any cut edge (they consume halo
     columns and/or are sent to peers) are packed into one contiguous run
     at the tail, preserving their relative RCM order. The P_bd block's
     nonzeros then live in ~⌈boundary/128⌉ row blocks instead of being
     sprinkled over all of them, and the boundary-destined rows a peer
     gathers are contiguous.

The permutation never leaves the graph-build layer: features/labels/masks
are packed through `PartitionedGraph.pack_nodes` (which routes through
`part_of`/`local_of`) and results are unpacked — i.e. unpermuted — only at
the eval/metric boundary by `unpack_nodes`. Training numerics are
permutation-equivariant, so any layout is bit-identical modulo the
permutation (enforced at 1e-12 in f64 by tests/test_reorder.py and the
SPMD parity matrix).

Pure numpy, offline; no jax dependency.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph

#: Node layouts `build_partitioned_graph` accepts ("auto" is resolved to
#: one of these by `resolve_layout` before it reaches the builder).
LAYOUTS = ("natural", "rcm")

#: Aggregation engines that consume tile streams — the ones a reordered
#: layout actually speeds up (see repro_torch.kernels.aggregate).
TILE_ENGINES = ("blocksparse", "fused")


def resolve_layout(layout: str, agg: str) -> str:
    """Resolve the user-facing layout knob ("natural" | "rcm" | "auto")
    to a concrete layout: "auto" picks "rcm" exactly when the selected
    aggregation engine consumes tiles. GraphDataPipeline.build resolves
    through this at pipeline construction; the trainer's consistency
    check then compares declared vs built layouts directly ("auto" there
    simply defers to whatever the pipeline carries)."""
    if layout == "auto":
        return "rcm" if agg in TILE_ENGINES else "natural"
    return layout


def _neighbors(indptr: np.ndarray, indices: np.ndarray,
               frontier: np.ndarray) -> np.ndarray:
    """Concatenated neighbor lists of `frontier`, preserving frontier order
    then adjacency order — one flat gather, no per-node Python loop."""
    counts = indptr[frontier + 1] - indptr[frontier]
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=indices.dtype)
    starts = np.repeat(indptr[frontier], counts)
    run_starts = np.cumsum(counts) - counts
    offs = np.arange(total, dtype=np.int64) - np.repeat(run_starts, counts)
    return indices[starts + offs]


def _local_subgraph(nodes: np.ndarray, dst: np.ndarray,
                    src: np.ndarray, num_nodes: int):
    """Symmetrized intra-partition structure over `nodes`, in local ids.

    `dst`/`src` are the global COO endpoints of the (pre-filtered)
    intra-partition edges of this partition. Self-loops are dropped (they
    never affect a traversal order) and the structure is symmetrized so
    RCM sees an undirected graph even for asymmetric propagation weights.
    Returns (indptr, indices) CSR over len(nodes) local ids.
    """
    k = len(nodes)
    loc = np.full(num_nodes, -1, dtype=np.int64)
    loc[nodes] = np.arange(k)
    a = np.concatenate([loc[dst], loc[src]])
    b = np.concatenate([loc[src], loc[dst]])
    keep = a != b
    a, b = a[keep], b[keep]
    key = np.unique(a * k + b)
    a, b = key // k, key % k
    # bincount, not np.add.at — the buffered ufunc-at loop is the slow
    # scatter path (same finding as the tile-extraction scatter)
    indptr = np.zeros(k + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(a, minlength=k))
    return indptr, b.astype(np.int64)


def rcm_order(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Reverse Cuthill–McKee over an undirected local graph.

    Per connected component: start from a minimum-degree node, BFS level
    by level with each level sorted by (degree, id) — the classic CM
    order, vectorized per level — then reverse the whole sequence.
    Returns all n local ids as a permutation (isolated nodes included).
    """
    n = len(indptr) - 1
    deg = np.diff(indptr)
    visited = np.zeros(n, dtype=bool)
    out = np.empty(n, dtype=np.int64)
    pos = 0
    for start in np.argsort(deg, kind="stable"):
        if visited[start]:
            continue
        visited[start] = True
        out[pos] = start
        pos += 1
        frontier = np.array([start], dtype=np.int64)
        while frontier.size:
            nbrs = _neighbors(indptr, indices, frontier)
            nbrs = np.unique(nbrs[~visited[nbrs]])
            if nbrs.size == 0:
                break
            nbrs = nbrs[np.lexsort((nbrs, deg[nbrs]))]
            visited[nbrs] = True
            out[pos:pos + len(nbrs)] = nbrs
            pos += len(nbrs)
            frontier = nbrs
    assert pos == n
    return out[::-1].copy()


def boundary_mask(prop: CSRGraph, part: np.ndarray) -> np.ndarray:
    """(N,) bool: nodes incident to at least one real cut edge in either
    direction — they consume halo columns and/or are gathered into a
    peer's halo. Under the rcm layout these are exactly the nodes packed
    into each partition's contiguous tail run, i.e. the rows the
    split-phase schedule's boundary phase must produce before the
    exchange can be issued."""
    part = np.asarray(part, dtype=np.int64)
    n = prop.num_nodes
    dst = np.repeat(np.arange(n, dtype=np.int64), np.diff(prop.indptr))
    src = prop.indices.astype(np.int64)
    cross = (part[dst] != part[src]) & (prop.weights != 0)
    out = np.zeros(n, dtype=bool)
    out[dst[cross]] = True       # consumes halo columns
    out[src[cross]] = True       # gathered into a peer's halo
    return out


def interior_boundary_counts(prop: CSRGraph, part: np.ndarray,
                             num_parts: int) -> list[tuple[int, int]]:
    """Per-partition (interior, boundary) node counts — the layout-level
    view of how much aggregation work the split-phase schedule can
    overlap with the exchange (interior share) vs must run before
    issuing it (boundary tail)."""
    part = np.asarray(part, dtype=np.int64)
    bnd = boundary_mask(prop, part)
    out = []
    for i in range(num_parts):
        m = part == i
        b = int(np.count_nonzero(bnd & m))
        out.append((int(np.count_nonzero(m)) - b, b))
    return out


def partition_orders(prop: CSRGraph, part: np.ndarray,
                     num_parts: int) -> list[np.ndarray]:
    """Per-partition node orders (arrays of GLOBAL ids, new local order).

    RCM over each partition's local subgraph, composed with halo
    clustering: boundary nodes (incident to at least one real cut edge,
    in either direction) are stably moved to the tail of the order. The
    relative RCM order inside each of the two groups is preserved, so the
    P_in block keeps most of its bandwidth reduction while the halo
    frontier collapses to one contiguous row run.
    """
    part = np.asarray(part, dtype=np.int64)
    n = prop.num_nodes
    dst = np.repeat(np.arange(n, dtype=np.int64), np.diff(prop.indptr))
    src = prop.indices.astype(np.int64)
    real = prop.weights != 0
    is_boundary = boundary_mask(prop, part)

    # Group intra-partition edges (and nodes) by owner ONCE — per-partition
    # masks over the global edge arrays would make the build O(P·E).
    intra_idx = np.flatnonzero((part[dst] == part[src]) & real)
    owner = part[dst[intra_idx]]
    e_order = np.argsort(owner, kind="stable")
    by_owner = intra_idx[e_order]
    e_bounds = np.searchsorted(owner[e_order], np.arange(num_parts + 1))
    node_by_part = np.argsort(part, kind="stable")   # ascending id per part
    n_bounds = np.searchsorted(part[node_by_part], np.arange(num_parts + 1))

    orders: list[np.ndarray] = []
    for i in range(num_parts):
        nodes = node_by_part[n_bounds[i]:n_bounds[i + 1]]  # natural order
        sel = by_owner[e_bounds[i]:e_bounds[i + 1]]
        indptr_l, indices_l = _local_subgraph(nodes, dst[sel], src[sel], n)
        loc = rcm_order(indptr_l, indices_l)
        bnd = is_boundary[nodes[loc]]
        loc = np.concatenate([loc[~bnd], loc[bnd]])  # stable interior|boundary
        orders.append(nodes[loc])
    return orders
