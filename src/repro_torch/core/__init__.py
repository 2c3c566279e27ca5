"""PipeGCN core: configuration, the partition-parallel step, fault
injection, health guards, the elastic runtime and the trainer."""
from repro_torch.core.config import ModelConfig, PipeConfig
from repro_torch.core.elastic import (DeviceLossError, ElasticConfig,
                                      ElasticPlan)
from repro_torch.core.faults import (FaultPlan, FaultSite, FaultTables,
                                     StalenessExceededError,
                                     device_down_site)
from repro_torch.core.health import (HealthConfig, TrainingAnomalyError,
                                     health_check)
from repro_torch.core.module import make_pipegcn_loss
from repro_torch.core.pipegcn import (PipeGCN, ShardedData, SimBackend,
                                      SpmdBackend, Topology, params_from_jax,
                                      shard_data, topology_from)
from repro_torch.core.trainer import TrainResult, make_train_step, train_pipegcn
from repro_torch.device import resolve_device

__all__ = [
    "ModelConfig", "PipeConfig", "HealthConfig", "TrainingAnomalyError",
    "health_check", "FaultPlan", "FaultSite", "FaultTables",
    "StalenessExceededError", "device_down_site",
    "DeviceLossError", "ElasticConfig", "ElasticPlan",
    "PipeGCN", "ShardedData", "SimBackend", "SpmdBackend", "Topology",
    "params_from_jax", "resolve_device", "shard_data", "topology_from",
    "TrainResult", "make_train_step", "train_pipegcn", "make_pipegcn_loss",
]
