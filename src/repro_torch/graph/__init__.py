"""Graph substrate (numpy copies of the JAX package's ``repro.graph``)."""
from repro_torch.graph.csr import CSRGraph, coo_to_csr, mean_normalized, sym_normalized
from repro_torch.graph.halo import (PartitionedGraph, PartitionTiles,
                                    build_partitioned_graph,
                                    extract_partition_tiles)
from repro_torch.graph.partition import edge_cut, partition_graph
from repro_torch.graph.reorder import LAYOUTS, partition_orders, rcm_order
from repro_torch.graph.synthetic import DATASETS, GraphDataset, make_dataset

__all__ = [
    "CSRGraph", "coo_to_csr", "sym_normalized", "mean_normalized",
    "make_dataset", "DATASETS", "GraphDataset",
    "partition_graph", "edge_cut",
    "LAYOUTS", "partition_orders", "rcm_order",
    "PartitionedGraph", "PartitionTiles", "build_partitioned_graph",
    "extract_partition_tiles",
]
