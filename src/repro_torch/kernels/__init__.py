"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions, and
the aggregation engines built on them."""
from repro_torch.kernels.aggregate import BlockSparseEngine, CooEngine, get_engine
from repro_torch.kernels.gcn_spmm import spmm, spmm_t

__all__ = ["BlockSparseEngine", "CooEngine", "get_engine", "spmm", "spmm_t"]
