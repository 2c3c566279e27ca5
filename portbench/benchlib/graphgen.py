"""The benchmark's graph generator: a frozen numpy copy of the port's
synthetic-graph recipe (``repro_torch/graph/synthetic.py`` ``_make_sim``),
with the stochastic-block-model block count as its own field.

A configuration file fixes every argument, so every run of a cell builds
the same graph, features, labels and masks: the graph is the dataset, and
``--seed`` sets only the parameters and the dropout bits. Kept here, and
not imported from the program, so that a change to the program's
generator cannot move the yardstick.

The graph mixes a stochastic block model (community structure) with an
R-MAT overlay (heavy-tailed degrees); both are symmetrized and merged with
duplicates removed, so the directed edge count is what the configuration's
``edges_per_node`` is checked against.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Graph:
    """CSR adjacency: row v lists v's in-neighbours (unit weights)."""

    indptr: np.ndarray      # (N + 1,) int64
    indices: np.ndarray     # (E,) int32

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return int(self.indptr[-1])


@dataclasses.dataclass
class GraphData:
    """A generated node-classification dataset."""

    graph: Graph
    features: np.ndarray     # (N, F) float32
    labels: np.ndarray       # (N,) int32, or (N, C) float32 when multilabel
    train_mask: np.ndarray   # (N,) bool
    val_mask: np.ndarray
    test_mask: np.ndarray
    num_classes: int
    multilabel: bool

    @property
    def edges_per_node(self) -> float:
        return self.graph.num_edges / self.graph.num_nodes


def unique_sorted(a: np.ndarray) -> np.ndarray:
    """np.unique(a) by a sort: numpy 2.3's hash-based np.unique takes
    20 s for 20 M int64 keys where a sort takes 0.3 s."""
    a = np.sort(a)
    if a.size < 2:
        return a
    keep = np.empty(a.size, dtype=bool)
    keep[0] = True
    np.not_equal(a[1:], a[:-1], out=keep[1:])
    return a[keep]


def unique_first_index(a: np.ndarray):
    """np.unique(a, return_index=True) by a stable sort."""
    order = np.argsort(a, kind="stable")
    s = a[order]
    keep = np.ones(s.size, dtype=bool)
    if s.size > 1:
        np.not_equal(s[1:], s[:-1], out=keep[1:])
    return s[keep], order[keep]


def coo_to_csr(src, dst, num_nodes: int) -> Graph:
    """CSR of a COO edge list (rows = dst), duplicates removed."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if len(src):
        key = unique_sorted(dst * num_nodes + src)
        dst, src = key // num_nodes, key % num_nodes
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(dst, minlength=num_nodes))
    return Graph(indptr=indptr, indices=src.astype(np.int32))


def _coo(g: Graph):
    dst = np.repeat(np.arange(g.num_nodes, dtype=np.int64), np.diff(g.indptr))
    return g.indices.astype(np.int64), dst


def symmetrize(g: Graph) -> Graph:
    src, dst = _coo(g)
    return coo_to_csr(np.concatenate([src, dst]), np.concatenate([dst, src]),
                      g.num_nodes)


def sbm_graph(num_nodes: int, num_blocks: int, p_in: float, p_out: float,
              rng: np.random.Generator):
    """Stochastic block model by binomial edge counts per block pair;
    returns (undirected graph, block of each node)."""
    blocks = rng.integers(0, num_blocks, size=num_nodes)
    order = np.argsort(blocks, kind="stable")
    blocks_sorted = blocks[order]
    starts = np.searchsorted(blocks_sorted, np.arange(num_blocks))
    ends = np.searchsorted(blocks_sorted, np.arange(num_blocks) + 1)
    srcs, dsts = [], []
    for a in range(num_blocks):
        na = ends[a] - starts[a]
        for b in range(a, num_blocks):
            nb = ends[b] - starts[b]
            p = p_in if a == b else p_out
            pairs = na * nb if a != b else na * (na - 1) // 2
            if pairs <= 0 or p <= 0:
                continue
            m = rng.binomial(pairs, min(p, 1.0))
            if m == 0:
                continue
            i = order[starts[a] + rng.integers(0, na, size=m)]
            j = order[starts[b] + rng.integers(0, nb, size=m)]
            keep = i != j
            srcs.append(i[keep])
            dsts.append(j[keep])
    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
    return symmetrize(coo_to_csr(src, dst, num_nodes)), blocks


def rmat_graph(num_nodes: int, num_edges: int, rng: np.random.Generator,
               a: float = 0.57, b: float = 0.19, c: float = 0.19) -> Graph:
    """R-MAT power-law graph (Chakrabarti et al.), undirected."""
    scale = int(np.ceil(np.log2(max(num_nodes, 2))))
    src = np.zeros(num_edges, dtype=np.int64)
    dst = np.zeros(num_edges, dtype=np.int64)
    for _ in range(scale):
        r = rng.random(num_edges)
        bit_s = (r >= a + b).astype(np.int64)
        r2 = rng.random(num_edges)
        bit_d = np.where(bit_s == 0, (r2 >= a / (a + b)).astype(np.int64),
                         (r2 >= c / max(c + (1 - a - b - c), 1e-9)
                          ).astype(np.int64))
        src = (src << 1) | bit_s
        dst = (dst << 1) | bit_d
    src %= num_nodes
    dst %= num_nodes
    keep = src != dst
    return symmetrize(coo_to_csr(src[keep], dst[keep], num_nodes))


def _splits(n: int, rng: np.random.Generator, frac=(0.6, 0.2, 0.2)):
    perm = rng.permutation(n)
    n_tr, n_va = int(frac[0] * n), int(frac[1] * n)
    tr = np.zeros(n, bool)
    va = np.zeros(n, bool)
    te = np.zeros(n, bool)
    tr[perm[:n_tr]] = True
    va[perm[n_tr:n_tr + n_va]] = True
    te[perm[n_tr + n_va:]] = True
    return tr, va, te


def make_graph_data(cfg: dict) -> GraphData:
    """The dataset a configuration file describes (keys: num_nodes,
    num_classes, sbm_blocks, feat_dim, degree_arg, signal, rmat_frac,
    multilabel, data_seed)."""
    n = int(cfg["num_nodes"])
    blocks_n = int(cfg["sbm_blocks"])
    classes = int(cfg["num_classes"])
    feat_dim = int(cfg["feat_dim"])
    deg = float(cfg["degree_arg"])
    rmat_frac = float(cfg["rmat_frac"])
    multilabel = bool(cfg["multilabel"])
    if multilabel and blocks_n > classes:
        raise ValueError("a multilabel graph needs sbm_blocks <= num_classes")
    rng = np.random.default_rng(int(cfg["data_seed"]))
    p_out = deg * (1 - rmat_frac) * 0.25 / n
    p_in = deg * (1 - rmat_frac) * 0.75 * blocks_n / n
    g_sbm, blocks = sbm_graph(n, blocks_n, p_in, p_out, rng)
    g_rmat = rmat_graph(n, int(n * deg * rmat_frac / 2), rng)
    src = np.concatenate([g_sbm.indices, g_rmat.indices]).astype(np.int64)
    dst = np.concatenate([
        np.repeat(np.arange(n, dtype=np.int64), np.diff(g_sbm.indptr)),
        np.repeat(np.arange(n, dtype=np.int64), np.diff(g_rmat.indptr))])
    g = coo_to_csr(src, dst, n)
    del g_sbm, g_rmat, src, dst
    # class-mean Gaussian features: one mean per block
    means = rng.normal(0.0, 1.0, size=(blocks_n, feat_dim))
    x = rng.normal(0.0, 1.0, size=(n, feat_dim))
    feats = (x + float(cfg["signal"]) * means[blocks]).astype(np.float32)
    del x
    if multilabel:
        # the block's label, plus each other label on with probability
        # 0.15 where a random projection of the features is positive
        proj = rng.normal(size=(feat_dim, classes)).astype(np.float32)
        extra = (feats @ proj > 0)
        labels = (extra & (rng.random((n, classes)) < 0.15)).astype(np.float32)
        labels[np.arange(n), blocks] = 1.0
    else:
        if blocks_n != classes:
            raise ValueError("a single-label graph takes its labels from "
                             "the blocks: sbm_blocks must equal num_classes")
        labels = blocks.astype(np.int32)
    tr, va, te = _splits(n, rng)
    return GraphData(graph=g, features=feats, labels=labels, train_mask=tr,
                     val_mask=va, test_mask=te, num_classes=classes,
                     multilabel=multilabel)
