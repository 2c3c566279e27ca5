"""Data pipelines: the graph dataset partitioned onto the device, and the
LM zoo's synthetic token batches."""
from repro_torch.data.graph_pipeline import GraphDataPipeline
from repro_torch.data.tokens import TokenStream, synthetic_token_batches

__all__ = ["GraphDataPipeline", "TokenStream", "synthetic_token_batches"]
