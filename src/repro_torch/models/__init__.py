"""Assigned-architecture model zoo (dense / MoE / MLA / SSM / hybrid / VLM /
enc-dec): the architecture configuration, the shared layers, the sequence
mixers (GQA attention, MLA, SSD, RG-LRU), the MoE FFN and the `LM` with its
prefill and decode entry points."""
from repro_torch.models.config import INPUT_SHAPES, ArchConfig, InputShape
from repro_torch.models.model import LM

__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "LM"]
