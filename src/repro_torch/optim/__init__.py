"""Adam and the global norm (the port's optimizer)."""
from repro_torch.optim.optimizers import Optimizer, OptState, adam, global_norm

__all__ = ["Optimizer", "OptState", "adam", "global_norm"]
