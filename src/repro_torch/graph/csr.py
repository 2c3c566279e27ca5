"""CSR graph container and propagation-matrix normalizations.

Port copy of the JAX package's ``repro.graph.csr`` (numpy only): the
port imports nothing of ``repro``, and the two must build byte-identical
arrays (tests/test_torch_graph.py).

The propagation matrix P follows the paper (Appendix A.1):
  GCN:  P = D̃^{-1/2} Ã D̃^{-1/2},  Ã = A + I
  SAGE: P = D^{-1} A               (mean neighbor aggregator; self via concat)

Weights are computed on the *global* graph before partitioning so that the
per-partition split P = P_in + P_bd (paper notation) uses global degrees,
exactly as Eq. 3/4 (the 1/d_v terms are global).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Weighted directed CSR graph (row -> weighted neighbor columns)."""

    indptr: np.ndarray   # (N+1,) int64
    indices: np.ndarray  # (E,)  int32  column ids
    weights: np.ndarray  # (E,)  float32

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return len(self.indices)

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def row(self, v: int) -> tuple[np.ndarray, np.ndarray]:
        s, e = self.indptr[v], self.indptr[v + 1]
        return self.indices[s:e], self.weights[s:e]

    def to_dense(self) -> np.ndarray:
        n = self.num_nodes
        out = np.zeros((n, n), dtype=np.float64)
        for v in range(n):
            cols, w = self.row(v)
            np.add.at(out[v], cols, w)
        return out


def coo_to_csr(src: np.ndarray, dst: np.ndarray, num_nodes: int,
               weights: np.ndarray | None = None,
               dedup: bool = True) -> CSRGraph:
    """Build CSR from COO edge list (rows=dst receives from cols=src).

    Row v of the result lists v's in-neighbors, which is what neighbor
    aggregation consumes (z_v = sum_u P[v,u] h_u).
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if weights is None:
        weights = np.ones(len(src), dtype=np.float32)
    if dedup and len(src):
        key = dst * num_nodes + src
        key, idx = np.unique(key, return_index=True)
        src, dst, weights = src[idx], dst[idx], weights[idx]
    order = np.argsort(dst, kind="stable")
    src, dst, weights = src[order], dst[order], weights[order]
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.add.at(indptr, dst + 1, 1)
    indptr = np.cumsum(indptr)
    return CSRGraph(indptr=indptr,
                    indices=src.astype(np.int32),
                    weights=weights.astype(np.float32))


def _coo_of(g: CSRGraph) -> tuple[np.ndarray, np.ndarray]:
    dst = np.repeat(np.arange(g.num_nodes, dtype=np.int64), np.diff(g.indptr))
    return g.indices.astype(np.int64), dst


def symmetrize(g: CSRGraph) -> CSRGraph:
    """Make the adjacency symmetric (undirected), unit weights."""
    src, dst = _coo_of(g)
    s2 = np.concatenate([src, dst])
    d2 = np.concatenate([dst, src])
    return coo_to_csr(s2, d2, g.num_nodes)


def sym_normalized(g: CSRGraph, add_self_loops: bool = True) -> CSRGraph:
    """GCN propagation: D̃^{-1/2} Ã D̃^{-1/2}."""
    src, dst = _coo_of(g)
    n = g.num_nodes
    if add_self_loops:
        loop = np.arange(n, dtype=np.int64)
        src = np.concatenate([src, loop])
        dst = np.concatenate([dst, loop])
    base = coo_to_csr(src, dst, n)  # dedups
    src, dst = _coo_of(base)
    deg = np.bincount(dst, minlength=n).astype(np.float64)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1.0))
    w = (dinv[dst] * dinv[src]).astype(np.float32)
    return CSRGraph(indptr=base.indptr, indices=base.indices, weights=w)


def mean_normalized(g: CSRGraph) -> CSRGraph:
    """GraphSAGE mean aggregator: D^{-1} A (row-normalized, no self loop)."""
    deg = np.maximum(g.degrees(), 1).astype(np.float64)
    dst = np.repeat(np.arange(g.num_nodes), np.diff(g.indptr))
    w = (1.0 / deg[dst]).astype(np.float32)
    return CSRGraph(indptr=g.indptr, indices=g.indices, weights=w)
