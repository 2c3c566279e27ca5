"""Synthetic graph datasets standing in for Reddit / ogbn-products / Yelp /
ogbn-papers100M (none of which is available offline).

Port copy of the JAX package's ``repro.graph.synthetic`` (numpy only): the
port imports nothing of ``repro``, and the two must build byte-identical
arrays (tests/test_torch_graph.py).

Each simulated dataset mimics the *shape* of the paper's Tab. 3 setup at a
CPU-tractable scale: community structure (so accuracy experiments are
meaningful), heavy-tailed degrees (R-MAT mix), train/val/test splits, and the
same model/optimizer hyper-parameter template.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.csr import CSRGraph, coo_to_csr, symmetrize


def sbm_graph(num_nodes: int, num_blocks: int, p_in: float, p_out: float,
              rng: np.random.Generator) -> tuple[CSRGraph, np.ndarray]:
    """Stochastic block model; returns (undirected graph, block labels).

    Sparse sampling: expected-count binomial edge sampling per block pair,
    O(E) rather than O(N^2).
    """
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
            srcs.append(i[keep]); dsts.append(j[keep])
    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
    g = symmetrize(coo_to_csr(src, dst, num_nodes))
    return g, blocks


def grid_graph(grid_rows: int, grid_cols: int) -> CSRGraph:
    """4-neighbor 2D lattice (undirected), row-major node ids.

    Unlike the SBM/R-MAT mixes, a lattice cut by a balanced partitioner has
    a boundary that is O(sqrt(n)) of each partition — most nodes are
    interior. That is the regime PipeGCN targets (and the planar/mesh
    regime METIS-style partitioners are built for), and it is what the
    split-phase overlap schedule needs to be non-degenerate: the
    SBM/R-MAT sims are so well-mixed that nearly every node is boundary.
    """
    idx = np.arange(grid_rows * grid_cols, dtype=np.int64).reshape(
        grid_rows, grid_cols)
    src = np.concatenate([idx[:-1, :].ravel(), idx[:, :-1].ravel()])
    dst = np.concatenate([idx[1:, :].ravel(), idx[:, 1:].ravel()])
    return symmetrize(coo_to_csr(src, dst, grid_rows * grid_cols))


def rmat_graph(num_nodes: int, num_edges: int, rng: np.random.Generator,
               a: float = 0.57, b: float = 0.19, c: float = 0.19) -> CSRGraph:
    """R-MAT power-law graph (Chakrabarti et al.), undirected."""
    scale = int(np.ceil(np.log2(max(num_nodes, 2))))
    src = np.zeros(num_edges, dtype=np.int64)
    dst = np.zeros(num_edges, dtype=np.int64)
    for level in range(scale):
        r = rng.random(num_edges)
        bit_s = (r >= a + b).astype(np.int64)                # c or d quadrant
        r2 = rng.random(num_edges)
        bit_d = np.where(bit_s == 0, (r2 >= a / (a + b)).astype(np.int64),
                         (r2 >= c / max(c + (1 - a - b - c), 1e-9)).astype(np.int64))
        src = (src << 1) | bit_s
        dst = (dst << 1) | bit_d
    src %= num_nodes
    dst %= num_nodes
    keep = src != dst
    return symmetrize(coo_to_csr(src[keep], dst[keep], num_nodes))


@dataclasses.dataclass
class GraphDataset:
    """Full-graph node-classification dataset."""

    name: str
    graph: CSRGraph                # undirected, unnormalized adjacency
    features: np.ndarray           # (N, F) float32
    labels: np.ndarray             # (N,) int32 or (N, C) float32 (multilabel)
    train_mask: np.ndarray         # (N,) bool
    val_mask: np.ndarray
    test_mask: np.ndarray
    num_classes: int
    multilabel: bool = False

    @property
    def num_nodes(self) -> int:
        return self.graph.num_nodes

    @property
    def feat_dim(self) -> int:
        return self.features.shape[1]


def _class_features(blocks: np.ndarray, num_classes: int, feat_dim: int,
                    signal: float, rng: np.random.Generator) -> np.ndarray:
    """Gaussian features with class-mean signal (keeps accuracy runs meaningful)."""
    means = rng.normal(0.0, 1.0, size=(num_classes, feat_dim))
    x = rng.normal(0.0, 1.0, size=(len(blocks), feat_dim))
    return (x + signal * means[blocks]).astype(np.float32)


def _splits(n: int, rng: np.random.Generator,
            frac=(0.6, 0.2, 0.2)) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    perm = rng.permutation(n)
    n_tr = int(frac[0] * n)
    n_va = int(frac[1] * n)
    tr = np.zeros(n, bool); va = np.zeros(n, bool); te = np.zeros(n, bool)
    tr[perm[:n_tr]] = True
    va[perm[n_tr:n_tr + n_va]] = True
    te[perm[n_tr + n_va:]] = True
    return tr, va, te


def _make_sim(name: str, num_nodes: int, num_classes: int, feat_dim: int,
              avg_degree: float, signal: float, seed: int,
              multilabel: bool = False, rmat_frac: float = 0.3) -> GraphDataset:
    rng = np.random.default_rng(seed)
    # Community structure + a power-law overlay (heavy-tailed like Reddit).
    p_out = avg_degree * (1 - rmat_frac) * 0.25 / num_nodes
    p_in = (avg_degree * (1 - rmat_frac) * 0.75) * num_classes / num_nodes
    g_sbm, blocks = sbm_graph(num_nodes, num_classes, p_in, p_out, rng)
    g_rmat = rmat_graph(num_nodes, int(num_nodes * avg_degree * rmat_frac / 2), rng)
    src = np.concatenate([g_sbm.indices, g_rmat.indices]).astype(np.int64)
    dst1 = np.repeat(np.arange(num_nodes, dtype=np.int64), np.diff(g_sbm.indptr))
    dst2 = np.repeat(np.arange(num_nodes, dtype=np.int64), np.diff(g_rmat.indptr))
    g = coo_to_csr(src, np.concatenate([dst1, dst2]), num_nodes)
    feats = _class_features(blocks, num_classes, feat_dim, signal, rng)
    if multilabel:
        # Derive a second label bit-plane from parity of a random projection.
        proj = rng.normal(size=(feat_dim, num_classes)).astype(np.float32)
        extra = (feats @ proj > 0).astype(np.float32)
        labels = np.zeros((num_nodes, num_classes), np.float32)
        labels[np.arange(num_nodes), blocks] = 1.0
        labels = np.clip(labels + extra * 0.0 + (extra > 0.5) * (rng.random((num_nodes, num_classes)) < 0.15), 0, 1)
        labels[np.arange(num_nodes), blocks] = 1.0
    else:
        labels = blocks.astype(np.int32)
    tr, va, te = _splits(num_nodes, rng)
    return GraphDataset(name=name, graph=g, features=feats, labels=labels,
                        train_mask=tr, val_mask=va, test_mask=te,
                        num_classes=num_classes, multilabel=multilabel)


def _make_grid(name: str, grid: tuple[int, int], num_classes: int,
               feat_dim: int, signal: float, seed: int) -> GraphDataset:
    """Lattice dataset: spatial-quadrant labels (class = superblock of the
    grid) keep accuracy runs meaningful while the topology stays planar."""
    gr, gc = grid
    rng = np.random.default_rng(seed)
    g = grid_graph(gr, gc)
    side = int(round(num_classes ** 0.5))
    if side * side != num_classes:
        raise ValueError(f"grid datasets need a square num_classes, got "
                         f"{num_classes}")
    r, c = np.divmod(np.arange(gr * gc, dtype=np.int64), gc)
    blocks = np.minimum(r * side // gr, side - 1) * side \
        + np.minimum(c * side // gc, side - 1)
    feats = _class_features(blocks, num_classes, feat_dim, signal, rng)
    tr, va, te = _splits(gr * gc, rng)
    return GraphDataset(name=name, graph=g, features=feats,
                        labels=blocks.astype(np.int32),
                        train_mask=tr, val_mask=va, test_mask=te,
                        num_classes=num_classes, multilabel=False)


# name -> (factory, paper-analogue GraphSAGE model template from Tab. 3)
DATASETS: dict[str, dict] = {
    # Reddit: 233K nodes / 114M edges / 602 feats -> 8K nodes sim
    "reddit-sim": dict(num_nodes=8192, num_classes=16, feat_dim=128,
                       avg_degree=32.0, signal=0.8, seed=0,
                       model=dict(num_layers=4, hidden=256, lr=0.01, dropout=0.5)),
    # ogbn-products: 2.4M / 62M / 100 -> 16K sim
    "products-sim": dict(num_nodes=16384, num_classes=32, feat_dim=100,
                         avg_degree=16.0, signal=0.6, seed=1,
                         model=dict(num_layers=3, hidden=128, lr=0.003, dropout=0.3)),
    # Yelp: 716K / 7.0M / 300, multilabel F1-micro -> 8K sim
    "yelp-sim": dict(num_nodes=8192, num_classes=24, feat_dim=120,
                     avg_degree=10.0, signal=0.7, seed=2, multilabel=True,
                     model=dict(num_layers=4, hidden=512, lr=0.001, dropout=0.1)),
    # ogbn-papers100M: 111M / 1.6B / 128 -> 32K sim (bench/analysis only)
    "papers100m-sim": dict(num_nodes=32768, num_classes=64, feat_dim=128,
                           avg_degree=14.0, signal=0.5, seed=3,
                           model=dict(num_layers=3, hidden=48, lr=0.01, dropout=0.0)),
    # Tiny graphs for tests/examples.
    "tiny": dict(num_nodes=256, num_classes=4, feat_dim=16,
                 avg_degree=8.0, signal=1.0, seed=4,
                 model=dict(num_layers=2, hidden=32, lr=0.01, dropout=0.0)),
    "small": dict(num_nodes=2048, num_classes=8, feat_dim=32,
                  avg_degree=12.0, signal=0.8, seed=5,
                  model=dict(num_layers=3, hidden=64, lr=0.01, dropout=0.2)),
    # Planar lattices: low-boundary-fraction partitions (the mesh/planar
    # regime PipeGCN targets) — the datasets where the split-phase overlap
    # schedule has a real interior phase to hide the exchange behind.
    "grid-sim": dict(grid=(64, 64), num_classes=4, feat_dim=32,
                     signal=1.0, seed=6,
                     model=dict(num_layers=3, hidden=64, lr=0.01, dropout=0.2)),
    "grid-tiny": dict(grid=(48, 48), num_classes=4, feat_dim=16,
                      signal=1.0, seed=7,
                      model=dict(num_layers=2, hidden=16, lr=0.01, dropout=0.0)),
}


def make_dataset(name: str, **overrides) -> GraphDataset:
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(DATASETS)}")
    spec = {k: v for k, v in DATASETS[name].items() if k != "model"}
    spec.update(overrides)
    return _make_grid(name, **spec) if "grid" in spec else _make_sim(name, **spec)


def model_template(name: str) -> dict:
    return dict(DATASETS[name]["model"])
