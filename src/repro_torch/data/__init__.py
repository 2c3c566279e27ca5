"""Graph data pipeline: dataset to partitioned tensors on the device."""
from repro_torch.data.graph_pipeline import GraphDataPipeline

__all__ = ["GraphDataPipeline"]
