"""The reference's own graph substrate: frozen numpy copies of the port's
mean normalization, partitioner (balanced BFS growth + greedy boundary
refinement), RCM + halo-clustering node order and halo slot layout
(``repro_torch/graph/csr.py``, ``partition.py``, ``reorder.py``,
``halo.py``).

PipeGCN's result depends on the partition (which edges read stale
features) and, through the dropout masks the step draws over each
partition's combined [inner; halo] rows, on the node layout. The reference
works both out again from the generated graph with these copies, so it
takes nothing the program derived. Only the layout is built here: no tile
extraction.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from benchlib.graphgen import Graph, unique_first_index, unique_sorted


@dataclasses.dataclass
class Layout:
    """One partitioned graph as the PipeGCN step lays it out.

    Partition i's combined array is [inner rows (max_inner); halo rows
    (P·slot)]: halo row max_inner + j·slot + k holds the k-th node that
    partition j sends to i. ``comb_src`` names, for every combined row,
    the flat (P·max_inner) row of the node it holds (its own inner row, or
    the owner's row for a halo row), -1 for padding."""

    num_parts: int
    max_inner: int
    slot: int
    part: np.ndarray          # (N,) owner partition
    local_of: np.ndarray      # (N,) inner row at the owner
    inner_count: np.ndarray   # (P,) real inner rows
    comb_src: np.ndarray      # (P, combined) int64 flat owner row, -1 pad
    is_halo: np.ndarray       # (P, combined) bool
    edge_row: list            # per partition: (E_i,) int64 inner row
    edge_col: list            # per partition: (E_i,) int64 combined column
    edge_w: list              # per partition: (E_i,) float32 weight

    @property
    def combined(self) -> int:
        return self.max_inner + self.num_parts * self.slot


def mean_weights(g: Graph) -> np.ndarray:
    """GraphSAGE's mean aggregator D^-1 A: each in-edge of v weighs
    1/deg(v), in float32."""
    deg = np.maximum(np.diff(g.indptr), 1).astype(np.float64)
    dst = np.repeat(np.arange(g.num_nodes), np.diff(g.indptr))
    return (1.0 / deg[dst]).astype(np.float32)


def _neighbors(indptr, indices, frontier):
    counts = indptr[frontier + 1] - indptr[frontier]
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=indices.dtype)
    starts = np.repeat(indptr[frontier], counts)
    run_starts = np.cumsum(counts) - counts
    offs = np.arange(total, dtype=np.int64) - np.repeat(run_starts, counts)
    return indices[starts + offs]


def _first_occurrence(a):
    _, first = unique_first_index(a)
    return a[np.sort(first)]


def _bfs_grow(g: Graph, num_parts: int, rng) -> np.ndarray:
    n = g.num_nodes
    part = np.full(n, -1, dtype=np.int32)
    target = -(-n // num_parts)
    sizes = np.zeros(num_parts, dtype=np.int64)
    indices = g.indices.astype(np.int64)
    seeds = rng.choice(n, size=num_parts, replace=False)
    frontiers = [np.array([s], dtype=np.int64) for s in seeds]
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
            cand = _first_occurrence(_neighbors(g.indptr, indices,
                                                frontiers[p]))
            cand = cand[part[cand] == -1]
            nxt = cand[:target - sizes[p]]
            part[nxt] = p
            sizes[p] += len(nxt)
            frontiers[p] = nxt
            if len(nxt):
                active = True
    for v in np.flatnonzero(part == -1):
        p = int(np.argmin(sizes))
        part[v] = p
        sizes[p] += 1
    return part


def _refine(g: Graph, part, num_parts: int, passes: int, imbalance: float):
    n = g.num_nodes
    max_size = int((n / num_parts) * (1 + imbalance)) + 1
    part = part.copy()
    dst_all = np.repeat(np.arange(n), np.diff(g.indptr))
    src_all = g.indices.astype(np.int64)
    for _ in range(passes):
        sizes = np.bincount(part, minlength=num_parts)
        boundary = unique_sorted(dst_all[part[dst_all] != part[src_all]])
        if not len(boundary):
            break
        nb = len(boundary)
        brow = np.full(n, -1, dtype=np.int64)
        brow[boundary] = np.arange(nb)
        on_b = brow[dst_all] >= 0
        e_b, e_src = brow[dst_all[on_b]], src_all[on_b]
        counts = np.bincount(e_b * num_parts + part[e_src],
                             minlength=nb * num_parts).reshape(nb, num_parts)
        by_src = np.argsort(e_src, kind="stable")
        src_sorted, brow_sorted = e_src[by_src], e_b[by_src]
        lo_all = np.searchsorted(src_sorted, boundary)
        hi_all = np.searchsorted(src_sorted, boundary + 1)
        counts_l = counts.tolist()
        rows_l = brow_sorted.tolist()
        sizes_l = sizes.tolist()
        part_l = part.tolist()
        moved = 0
        for bi, v in enumerate(boundary.tolist()):
            row = counts_l[bi]
            home = part_l[v]
            best, best_gain = home, 0
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


def partition(g: Graph, num_parts: int, seed: int = 0,
              refine_passes: int = 4, imbalance: float = 0.05) -> np.ndarray:
    """part[v] by balanced BFS growth and greedy refinement ("bfs+refine")."""
    if num_parts <= 1:
        return np.zeros(g.num_nodes, dtype=np.int32)
    rng = np.random.default_rng(seed)
    part = _bfs_grow(g, num_parts, rng)
    return _refine(g, part, num_parts, refine_passes, imbalance)


def _rcm(indptr, indices) -> np.ndarray:
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
            nbrs = unique_sorted(nbrs[~visited[nbrs]])
            if nbrs.size == 0:
                break
            nbrs = nbrs[np.lexsort((nbrs, deg[nbrs]))]
            visited[nbrs] = True
            out[pos:pos + len(nbrs)] = nbrs
            pos += len(nbrs)
            frontier = nbrs
    return out[::-1].copy()


def _rcm_orders(g: Graph, w: np.ndarray, part, num_parts: int):
    """Per partition, global ids in RCM order over the local subgraph with
    the boundary nodes (any real cut edge, either direction) moved, in
    order, to the tail."""
    part = np.asarray(part, dtype=np.int64)
    n = g.num_nodes
    dst = np.repeat(np.arange(n, dtype=np.int64), np.diff(g.indptr))
    src = g.indices.astype(np.int64)
    real = w != 0
    cross = (part[dst] != part[src]) & real
    is_boundary = np.zeros(n, dtype=bool)
    is_boundary[dst[cross]] = True
    is_boundary[src[cross]] = True
    intra_idx = np.flatnonzero((part[dst] == part[src]) & real)
    owner = part[dst[intra_idx]]
    e_order = np.argsort(owner, kind="stable")
    by_owner = intra_idx[e_order]
    e_bounds = np.searchsorted(owner[e_order], np.arange(num_parts + 1))
    node_by_part = np.argsort(part, kind="stable")
    n_bounds = np.searchsorted(part[node_by_part], np.arange(num_parts + 1))
    orders = []
    for i in range(num_parts):
        nodes = node_by_part[n_bounds[i]:n_bounds[i + 1]]
        sel = by_owner[e_bounds[i]:e_bounds[i + 1]]
        k = len(nodes)
        loc = np.full(n, -1, dtype=np.int64)
        loc[nodes] = np.arange(k)
        a = np.concatenate([loc[dst[sel]], loc[src[sel]]])
        b = np.concatenate([loc[src[sel]], loc[dst[sel]]])
        keep = a != b
        key = unique_sorted(a[keep] * k + b[keep])
        a, b = key // k, key % k
        indptr = np.zeros(k + 1, dtype=np.int64)
        indptr[1:] = np.cumsum(np.bincount(a, minlength=k))
        order = _rcm(indptr, b)
        bnd = is_boundary[nodes[order]]
        orders.append(nodes[np.concatenate([order[~bnd], order[bnd]])])
    return orders


def build_layout(g: Graph, num_parts: int, layout: str,
                 part_seed: int = 0, pad_multiple: int = 8) -> Layout:
    """Partition `g` (mean-normalized) and lay it out as the step does."""
    w_all = mean_weights(g)
    p = num_parts
    part = partition(g, p, seed=part_seed)
    n = g.num_nodes
    if layout == "natural":
        inner_lists = [np.flatnonzero(part == i) for i in range(p)]
    elif layout == "rcm":
        inner_lists = _rcm_orders(g, w_all, part, p)
    else:
        raise ValueError(f"unknown layout {layout!r}")
    local_of = np.zeros(n, dtype=np.int64)
    for i in range(p):
        local_of[inner_lists[i]] = np.arange(len(inner_lists[i]))
    inner_count = np.array([len(v) for v in inner_lists])
    max_inner = int(-(-int(inner_count.max()) // pad_multiple) * pad_multiple)

    dst_all = np.repeat(np.arange(n, dtype=np.int64), np.diff(g.indptr))
    src_all = g.indices.astype(np.int64)
    pi, pj = part[dst_all], part[src_all]
    halo_nodes = [[None] * p for _ in range(p)]
    slot = 0
    for i in range(p):
        for j in range(p):
            if i == j:
                continue
            m = (pi == i) & (pj == j)
            uniq = unique_sorted(src_all[m])
            if layout != "natural" and len(uniq):
                # order each (i, j) halo block by the first row of i that
                # reads the node, global id breaking ties
                slot_key = np.searchsorted(uniq, src_all[m])
                rows_i = local_of[dst_all[m]]
                order = np.lexsort((rows_i, slot_key))
                starts = np.searchsorted(slot_key[order], np.arange(len(uniq)))
                first_row = rows_i[order][starts]
                uniq = uniq[np.lexsort((uniq, first_row))]
            halo_nodes[i][j] = uniq
            slot = max(slot, len(uniq))
    slot = max(int(-(-slot // pad_multiple) * pad_multiple), pad_multiple)

    combined = max_inner + p * slot
    comb_src = np.full((p, combined), -1, dtype=np.int64)
    is_halo = np.zeros((p, combined), dtype=bool)
    for i in range(p):
        nodes = inner_lists[i]
        comb_src[i, :len(nodes)] = i * max_inner + np.arange(len(nodes))
        for j in range(p):
            if i == j or not len(halo_nodes[i][j]):
                continue
            u = halo_nodes[i][j]
            at = max_inner + j * slot
            comb_src[i, at:at + len(u)] = j * max_inner + local_of[u]
            is_halo[i, at:at + len(u)] = True

    rows, cols, ws = [], [], []
    for i in range(p):
        m = pi == i
        d, s, w = dst_all[m], src_all[m], w_all[m]
        col = np.empty(len(s), dtype=np.int64)
        own = part[s] == i
        col[own] = local_of[s[own]]
        for j in range(p):
            mj = (~own) & (part[s] == j)
            if j == i or not mj.any():
                continue
            uniq = halo_nodes[i][j]
            by_gid = np.argsort(uniq, kind="stable")
            k = by_gid[np.searchsorted(uniq[by_gid], s[mj])]
            col[mj] = max_inner + j * slot + k
        rows.append(local_of[d])
        cols.append(col)
        ws.append(w)
    return Layout(num_parts=p, max_inner=max_inner, slot=slot,
                  part=part.astype(np.int64), local_of=local_of,
                  inner_count=inner_count, comb_src=comb_src,
                  is_halo=is_halo, edge_row=rows, edge_col=cols, edge_w=ws)
