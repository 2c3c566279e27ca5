"""End-to-end graph data pipeline: dataset -> normalization -> partition ->
padded shards -> tensors on the training device.

Port of the JAX package's ``repro.data.graph_pipeline``. Building with a
tile engine (``agg="blocksparse"`` or ``"fused"``) also extracts the
per-partition tile streams and their run pointers onto the Topology; the
COO shards are always present.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.pipegcn import (ShardedData, Topology, resolve_device,
                                      shard_data, topology_from)
from repro_torch.graph.csr import mean_normalized, sym_normalized
from repro_torch.graph.halo import PartitionedGraph, build_partitioned_graph
from repro_torch.graph.partition import partition_graph
from repro_torch.graph.reorder import TILE_ENGINES, resolve_layout
from repro_torch.graph.synthetic import GraphDataset, make_dataset


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
        missing raises, device="cpu" runs on the CPU)."""
        dev = resolve_device(device)
        ds = (make_dataset(name_or_ds) if isinstance(name_or_ds, str)
              else name_or_ds)
        layout = resolve_layout(layout, agg)
        prop = (mean_normalized(ds.graph) if kind == "sage"
                else sym_normalized(ds.graph))
        part = partition_graph(ds.graph, num_parts, seed=seed,
                               method=partition_method)
        pg = build_partitioned_graph(prop, part, num_parts, layout=layout)
        topo = topology_from(pg, with_tiles=(agg in TILE_ENGINES), device=dev)
        base = shard_data(pg, ds.features, ds.labels, ds.train_mask,
                          ds.val_mask, device=dev)
        test_mask = torch.from_numpy(
            pg.pack_nodes(np.asarray(ds.test_mask))).to(dev)
        return GraphDataPipeline(
            dataset=ds, pg=pg, topo=topo,
            train_data=base._replace(eval_mask=base.train_mask),
            val_data=base, test_data=base._replace(eval_mask=test_mask),
            agg=agg, layout=layout)

    def split_spec(self):
        """Always None: the split-phase overlap schedule is not ported
        (ROADMAP Queue 1 item 6), so every step runs unsplit."""
        return None

    def metric(self, logits_packed) -> dict:
        """Global accuracy (single-label) or F1-micro (multilabel) on
        train/val/test splits, from packed (P, max_inner, C) logits."""
        ds = self.dataset
        logits = self.pg.unpack_nodes(
            logits_packed.detach().cpu().numpy()[:self.pg.num_parts])
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
