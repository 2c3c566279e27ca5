"""Graph partitioning with a METIS-like objective (minimize communication
volume under a balance constraint).

Port copy of the JAX package's ``repro.graph.partition`` (numpy only): the
port imports nothing of ``repro``, and the two must build byte-identical
arrays (tests/test_torch_graph.py).

METIS itself is unavailable offline; we implement the same recipe the paper
relies on at a smaller scale: balanced BFS growth (Kernighan-style seeding)
followed by greedy boundary refinement that moves nodes to the neighboring
partition with the largest edge-cut gain, subject to balance.  The objective
the paper sets for METIS is *communication volume* — the number of replicated
boundary nodes — which edge-cut refinement tracks closely on these graphs.

Both phases are vectorized with numpy frontier expansion / delta-updated
gain tables and are BIT-IDENTICAL to the per-node Python loops they replaced
(kept below as ``_bfs_grow_loop`` / ``_refine_loop``: the equivalence oracle
for tests and the before/after baseline for the build-time record in
benchmarks/bench_kernels.py).
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.reorder import _neighbors


def edge_cut(g: CSRGraph, part: np.ndarray) -> int:
    dst = np.repeat(np.arange(g.num_nodes), np.diff(g.indptr))
    return int(np.sum(part[dst] != part[g.indices]))


def comm_volume(g: CSRGraph, part: np.ndarray, num_parts: int) -> int:
    """Total replicated boundary nodes = sum over partitions of |halo|."""
    dst = np.repeat(np.arange(g.num_nodes), np.diff(g.indptr))
    src = g.indices.astype(np.int64)
    cross = part[dst] != part[src]
    # Unique (receiving partition, remote node) pairs.
    key = part[dst][cross].astype(np.int64) * g.num_nodes + src[cross]
    return len(np.unique(key))


def _first_occurrence(a: np.ndarray) -> np.ndarray:
    """`a` with duplicates dropped, keeping the FIRST occurrence in place
    (np.unique alone would re-sort by value)."""
    _, first = np.unique(a, return_index=True)
    return a[np.sort(first)]


def _bfs_grow(g: CSRGraph, num_parts: int, rng: np.random.Generator) -> np.ndarray:
    """Grow num_parts balanced regions from spread-out seeds.

    Vectorized frontier expansion: each round expands a whole partition
    frontier with one flat neighbor gather + first-occurrence dedup,
    matching the sequential per-node loop exactly (same assignment order,
    same capacity cap), so the output is bit-identical to
    ``_bfs_grow_loop``.
    """
    n = g.num_nodes
    part = np.full(n, -1, dtype=np.int32)
    target = -(-n // num_parts)
    sizes = np.zeros(num_parts, dtype=np.int64)
    indices = g.indices.astype(np.int64)
    seeds = rng.choice(n, size=num_parts, replace=False)
    frontiers: list[np.ndarray] = [np.array([s], dtype=np.int64)
                                   for s in seeds]
    for p, s in enumerate(seeds):
        if part[s] == -1:
            part[s] = p
            sizes[p] += 1
    active = True
    while active:
        active = False
        for p in range(num_parts):
            if sizes[p] >= target or not len(frontiers[p]):
                continue
            cand = _neighbors(g.indptr, indices, frontiers[p])
            cand = _first_occurrence(cand)
            cand = cand[part[cand] == -1]
            nxt = cand[:target - sizes[p]]
            part[nxt] = p
            sizes[p] += len(nxt)
            frontiers[p] = nxt
            if len(nxt):
                active = True
    # Unreached nodes (disconnected): round-robin into smallest parts.
    for v in np.flatnonzero(part == -1):
        p = int(np.argmin(sizes))
        part[v] = p
        sizes[p] += 1
    return part


def _refine(g: CSRGraph, part: np.ndarray, num_parts: int,
            passes: int, imbalance: float) -> np.ndarray:
    """Greedy gain-based boundary refinement (one-sided KL/FM sweep).

    The per-node neighbor-partition histograms are built ONCE per pass with
    a vectorized scatter-add, then delta-updated as nodes move (only the
    histogram rows of a moved node's boundary neighbors change), so the
    sequential sweep keeps its exact semantics — same visit order, same
    tie-breaks, same interaction through sizes — at O(E_boundary + moves·deg)
    instead of O(n·deg) Python-interpreted work (bit-identical to
    ``_refine_loop``).
    """
    n = g.num_nodes
    max_size = int((n / num_parts) * (1 + imbalance)) + 1
    part = part.copy()
    dst_all = np.repeat(np.arange(n), np.diff(g.indptr))
    src_all = g.indices.astype(np.int64)
    for _ in range(passes):
        sizes = np.bincount(part, minlength=num_parts)
        boundary = np.unique(dst_all[part[dst_all] != part[src_all]])
        if not len(boundary):
            break
        nb = len(boundary)
        brow = np.full(n, -1, dtype=np.int64)
        brow[boundary] = np.arange(nb)
        on_b = brow[dst_all] >= 0
        e_b, e_src = brow[dst_all[on_b]], src_all[on_b]
        # Flat-key bincount, not 2-D np.add.at — the multi-index fancy-index
        # ufunc loop is the slow path (same finding as the tile-extraction
        # scatter in repro_torch.kernels.gcn_spmm).
        counts = np.bincount(e_b * num_parts + part[e_src],
                             minlength=nb * num_parts).reshape(nb, num_parts)
        # Reverse index: for a moved node u, the histogram rows to patch are
        # the boundary rows having u as a neighbor.
        by_src = np.argsort(e_src, kind="stable")
        src_sorted, brow_sorted = e_src[by_src], e_b[by_src]
        lo_all = np.searchsorted(src_sorted, boundary)
        hi_all = np.searchsorted(src_sorted, boundary + 1)
        # The sweep itself runs entirely on Python scalars/lists (the
        # per-node numpy-call overhead was the remaining interpreted cost);
        # the move patches touch deg(v) rows each and moves are the minority.
        counts_l = counts.tolist()
        rows_l = brow_sorted.tolist()
        sizes_l = sizes.tolist()
        part_l = part.tolist()
        moved = 0
        for bi, v in enumerate(boundary.tolist()):
            row = counts_l[bi]
            home = part_l[v]
            best = home
            best_gain = 0
            for p in range(num_parts):
                if not row[p] or p == home or sizes_l[p] + 1 > max_size:
                    continue
                gain = row[p] - row[home]
                if gain > best_gain:
                    best_gain, best = gain, p
            if best != home and sizes_l[home] > 1:
                sizes_l[home] -= 1
                sizes_l[best] += 1
                part_l[v] = best
                moved += 1
                for r in rows_l[lo_all[bi]:hi_all[bi]]:
                    counts_l[r][home] -= 1
                    counts_l[r][best] += 1
        part = np.asarray(part_l, dtype=np.int32)
        if moved == 0:
            break
    return part


# ----------------------------------------------------------------------
# Reference implementations (the pre-vectorization per-node loops).
# Kept verbatim: tests assert the vectorized versions above are
# bit-identical, and benchmarks/bench_kernels.py records the before/after
# build time against them.
# ----------------------------------------------------------------------

def _bfs_grow_loop(g: CSRGraph, num_parts: int,
                   rng: np.random.Generator) -> np.ndarray:
    n = g.num_nodes
    part = np.full(n, -1, dtype=np.int32)
    target = -(-n // num_parts)
    sizes = np.zeros(num_parts, dtype=np.int64)
    seeds = rng.choice(n, size=num_parts, replace=False)
    frontiers: list[list[int]] = [[int(s)] for s in seeds]
    for p, s in enumerate(seeds):
        if part[s] == -1:
            part[s] = p
            sizes[p] += 1
    active = True
    while active:
        active = False
        for p in range(num_parts):
            if sizes[p] >= target or not frontiers[p]:
                continue
            nxt: list[int] = []
            for v in frontiers[p]:
                s, e = g.indptr[v], g.indptr[v + 1]
                for u in g.indices[s:e]:
                    if part[u] == -1 and sizes[p] < target:
                        part[u] = p
                        sizes[p] += 1
                        nxt.append(int(u))
            frontiers[p] = nxt
            if nxt:
                active = True
    for v in np.flatnonzero(part == -1):
        p = int(np.argmin(sizes))
        part[v] = p
        sizes[p] += 1
    return part


def _refine_loop(g: CSRGraph, part: np.ndarray, num_parts: int,
                 passes: int, imbalance: float) -> np.ndarray:
    n = g.num_nodes
    max_size = int((n / num_parts) * (1 + imbalance)) + 1
    part = part.copy()
    for _ in range(passes):
        sizes = np.bincount(part, minlength=num_parts)
        moved = 0
        dst = np.repeat(np.arange(n), np.diff(g.indptr))
        boundary = np.unique(dst[part[dst] != part[g.indices]])
        for v in boundary:
            s, e = g.indptr[v], g.indptr[v + 1]
            nbr_parts = part[g.indices[s:e]]
            counts = np.bincount(nbr_parts, minlength=num_parts)
            home = part[v]
            best = home
            best_gain = 0
            for p in np.flatnonzero(counts):
                if p == home or sizes[p] + 1 > max_size:
                    continue
                gain = counts[p] - counts[home]
                if gain > best_gain:
                    best_gain, best = gain, p
            if best != home and sizes[home] > 1:
                sizes[home] -= 1
                sizes[best] += 1
                part[v] = best
                moved += 1
        if moved == 0:
            break
    return part


def partition_graph(g: CSRGraph, num_parts: int, seed: int = 0,
                    refine_passes: int = 4, imbalance: float = 0.05,
                    method: str = "bfs+refine") -> np.ndarray:
    """Partition nodes into num_parts balanced parts; returns part[v]."""
    if num_parts <= 1:
        return np.zeros(g.num_nodes, dtype=np.int32)
    if num_parts > g.num_nodes:
        raise ValueError("more partitions than nodes")
    rng = np.random.default_rng(seed)
    if method == "random":
        part = rng.integers(0, num_parts, size=g.num_nodes).astype(np.int32)
        # Rebalance exactly.
        order = rng.permutation(g.num_nodes)
        part = (np.arange(g.num_nodes) % num_parts)[np.argsort(order)].astype(np.int32)
        return part
    part = _bfs_grow(g, num_parts, rng)
    if "refine" in method:
        part = _refine(g, part, num_parts, refine_passes, imbalance)
    return part
