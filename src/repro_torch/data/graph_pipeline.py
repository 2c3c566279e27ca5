"""End-to-end graph data pipeline: dataset -> normalization -> partition ->
padded shards -> tensors on the training device.

Port of the JAX package's ``repro.data.graph_pipeline``. Building with a
tile engine (``agg="blocksparse"`` or ``"fused"``) also extracts the
per-partition tile streams and their run pointers onto the Topology; the
COO shards are always present.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core.pipegcn import (ShardedData, Topology, shard_data,
                                      split_spec_from, topology_from)
from repro_torch.device import resolve_device
from repro_torch.graph.csr import mean_normalized, sym_normalized
from repro_torch.graph.halo import PartitionedGraph, build_partitioned_graph
from repro_torch.graph.partition import partition_graph
from repro_torch.graph.reorder import TILE_ENGINES, resolve_layout
from repro_torch.graph.synthetic import GraphDataset, make_dataset


def to_local_layout(tree, n_local: int, axis: int = 0):
    """Reshape every (…, P, …) partition-axis tensor of a NamedTuple,
    tuple, list or dict to the per-rank view (…, n_dev, n_local, …)
    (device-major: partition p lives on rank p // n_local). `axis` is the
    partition axis (0 for Topology / ShardedData tensors, 1 for k-step
    staleness FIFOs). None leaves stay None."""

    def r(x):
        p = x.shape[axis]
        if p % n_local:
            raise ValueError(
                f"partition axis {axis} has size {p}, not a multiple of "
                f"n_local={n_local}")
        return x.reshape(x.shape[:axis] + (p // n_local, n_local)
                         + x.shape[axis + 1:])

    return _tree_map(r, tree)


def from_local_layout(tree, axis: int = 0):
    """Inverse of `to_local_layout`: merge the (n_dev, n_local) pair at
    `axis` back into a flat partition axis."""

    def r(x):
        return x.reshape(x.shape[:axis] + (x.shape[axis] * x.shape[axis + 1],)
                         + x.shape[axis + 2:])

    return _tree_map(r, tree)


def rank_view(tree, rank: int, n_local: int, axis: int = 0):
    """The partitions of rank `rank`, [rank·n_local, (rank+1)·n_local),
    of every partition-axis tensor of a tree (a view, no copy)."""
    return _tree_map(lambda x: x.narrow(axis, rank * n_local, n_local), tree)


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class _Lap:
    """Adds the host seconds since the last call to ``pipeline.<name>_s``
    (an upload from the host returns once it has landed)."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, name: str):
        now = time.perf_counter()
        spans.count(f"pipeline.{name}_s", now - self.t)
        self.t = now


@dataclasses.dataclass
class GraphDataPipeline:
    """Device-ready view of one partitioned graph dataset: the Topology,
    the three ShardedData splits (train/val/test share the packed
    feature/label tensors), and the build-time knobs that shaped them
    (`agg` engine, resolved node `layout`). Construct via `build`; eval
    metrics route back through `metric` (unpacks the node permutation)."""

    dataset: GraphDataset
    pg: PartitionedGraph
    topo: Topology
    train_data: ShardedData
    val_data: ShardedData
    test_data: ShardedData
    agg: str = "coo"
    layout: str = "natural"        # resolved node layout ("auto" never stored)

    @staticmethod
    def build(name_or_ds, num_parts: int, kind: str = "sage",
              seed: int = 0, partition_method: str = "bfs+refine",
              agg: str = "coo", layout: str = "auto",
              device="cuda") -> "GraphDataPipeline":
        """`layout` picks the intra-partition node order ("natural" | "rcm"
        | "auto"; auto = rcm exactly when `agg` consumes tiles). The graph
        work is numpy and gives the JAX package's arrays byte for byte;
        the results are then placed on `device` (default the card; CUDA
        missing raises, device="cpu" runs on the CPU). The host seconds of
        each phase add to the counters ``pipeline.<phase>_s``
        (`repro_torch.spans`): normalize, partition, layout (the
        partitioned graph in its node order), topology (with the tiles and
        their upload) and shard (features, labels and masks, uploaded)."""
        dev = resolve_device(device)
        ds = (make_dataset(name_or_ds) if isinstance(name_or_ds, str)
              else name_or_ds)
        layout = resolve_layout(layout, agg)
        lap = _Lap()
        prop = (mean_normalized(ds.graph) if kind == "sage"
                else sym_normalized(ds.graph))
        lap("normalize")
        part = partition_graph(ds.graph, num_parts, seed=seed,
                               method=partition_method)
        lap("partition")
        pg = build_partitioned_graph(prop, part, num_parts, layout=layout)
        lap("layout")
        topo = topology_from(pg, with_tiles=(agg in TILE_ENGINES), device=dev)
        lap("topology")
        base = shard_data(pg, ds.features, ds.labels, ds.train_mask,
                          ds.val_mask, device=dev)
        test_mask = torch.from_numpy(
            pg.pack_nodes(np.asarray(ds.test_mask))).to(dev)
        lap("shard")
        return GraphDataPipeline(
            dataset=ds, pg=pg, topo=topo,
            train_data=base._replace(eval_mask=base.train_mask),
            val_data=base, test_data=base._replace(eval_mask=test_mask),
            agg=agg, layout=layout)

    def split_spec(self):
        """`SplitSpec` of this pipeline's partitioned graph for the
        split-phase overlap schedule (`PipeConfig.overlap`), or None when
        the split is infeasible (one partition, no boundary sends, or a
        layout whose boundary rows are not clustered into a tail, such as
        "natural"). Memoized with the tile extraction on `pg`."""
        return split_spec_from(self.pg)

    def device_layout(self, num_devices: int):
        """Explicit (n_dev, n_local, ...) per-device view of (topo,
        train_data) for num_devices hosts: the layout the SPMD backend's
        rank views cut from the flat partition axis."""
        if self.topo.num_parts % num_devices:
            raise ValueError(
                f"num_parts={self.topo.num_parts} is not a multiple of "
                f"num_devices={num_devices}")
        n_local = self.topo.num_parts // num_devices
        return (to_local_layout(self.topo, n_local),
                to_local_layout(self.train_data, n_local))

    def elastic_views(self, plan):
        """Remapped (topo, train_data, val_data) for a
        `repro_torch.core.elastic.ElasticPlan`: the padded survivor layout
        of this pipeline's tensors (pads appended and masked out; the
        partitioned graph is not rebuilt)."""
        from repro_torch.core.elastic import remap_data, remap_topology
        return (remap_topology(self.topo, plan),
                remap_data(self.train_data, plan),
                remap_data(self.val_data, plan))

    def metric(self, logits_packed) -> dict:
        """Global accuracy (single-label) or F1-micro (multilabel) on
        train/val/test splits, from packed (P, max_inner, C) logits."""
        ds = self.dataset
        with spans.sync("metric"):
            host = logits_packed.detach().cpu().numpy()
        # [:num_parts] drops the pad partitions of an elastic survivor layout
        logits = self.pg.unpack_nodes(host[:self.pg.num_parts])
        out = {}
        for split, mask in (("train", ds.train_mask), ("val", ds.val_mask),
                            ("test", ds.test_mask)):
            if ds.multilabel:
                pred = logits[mask] > 0
                true = ds.labels[mask] > 0.5
                tp = np.sum(pred & true)
                fp = np.sum(pred & ~true)
                fn = np.sum(~pred & true)
                out[split] = float(2 * tp / max(2 * tp + fp + fn, 1))
            else:
                pred = logits[mask].argmax(-1)
                out[split] = float(np.mean(pred == ds.labels[mask]))
        return out
