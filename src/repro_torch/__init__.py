"""PyTorch/CUDA port of the PipeGCN reproduction (see README "PyTorch/CUDA
port"). Imports torch and numpy only: nothing of JAX or of ``repro``."""

__all__ = ["analysis", "configs", "core", "data", "device", "graph", "kernels",
           "launch", "models", "optim", "spans"]
