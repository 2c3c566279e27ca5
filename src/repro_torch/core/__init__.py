"""PipeGCN core: configuration, the partition-parallel step, health guards
and the trainer."""
from repro_torch.core.config import ModelConfig, PipeConfig
from repro_torch.core.health import HealthConfig, TrainingAnomalyError
from repro_torch.core.pipegcn import (PipeGCN, ShardedData, Topology,
                                      params_from_jax, resolve_device,
                                      shard_data, topology_from)
from repro_torch.core.trainer import TrainResult, make_train_step, train_pipegcn

__all__ = [
    "ModelConfig", "PipeConfig", "HealthConfig", "TrainingAnomalyError",
    "PipeGCN", "ShardedData", "Topology", "params_from_jax", "resolve_device",
    "shard_data", "topology_from", "TrainResult", "make_train_step",
    "train_pipegcn",
]
