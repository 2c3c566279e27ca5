"""The attention layer of the model zoo and what it needs: the
architecture configuration, the shared layers (norms, RoPE, MLP,
embeddings) and GQA self-, cross- and cached decode attention."""
from repro_torch.models.config import INPUT_SHAPES, ArchConfig, InputShape

__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES"]
