"""Adam over plain parameter dicts (the paper trains every model with Adam,
Tab. 3).

Port of ``adam`` and ``global_norm`` from the JAX package's
``repro.optim.optimizers``, mirroring its arithmetic: the moments stay
float32 whatever the parameter dtype, and the update is computed in
float32 and cast back to the parameter's dtype. The optimizer is
functional — ``apply`` returns new tensors and leaves its inputs alone —
so the trainer's health guard can roll a step back by selection.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt(Σ x²) over every tensor of a dict, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree.values()))


class OptState(NamedTuple):
    """Optimizer state: the step counter and the first/second moments."""

    step: int
    mu: dict
    nu: dict


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """apply(params, grads, state) -> (new_params, new_state)."""

    init: Callable
    apply: Callable
    name: str = "opt"


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """Adam with a constant learning rate."""

    def init(params):
        z = {k: torch.zeros_like(p, dtype=torch.float32)
             for k, p in params.items()}
        return OptState(step=0, mu=z,
                        nu={k: torch.zeros_like(v) for k, v in z.items()})

    def apply(params, grads, state: OptState):
        step = state.step + 1
        f32 = torch.float32
        b1t = 1 - torch.tensor(b1, dtype=f32) ** torch.tensor(step, dtype=f32)
        b2t = 1 - torch.tensor(b2, dtype=f32) ** torch.tensor(step, dtype=f32)
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            g32 = grads[k].to(f32)
            m = b1 * state.mu[k] + (1 - b1) * g32
            v = b2 * state.nu[k] + (1 - b2) * torch.square(g32)
            delta = (m / b1t.to(m.device)) / (
                torch.sqrt(v / b2t.to(v.device)) + eps)
            new_p[k] = (p.to(f32) - lr * delta).to(p.dtype)
            new_m[k], new_v[k] = m, v
        return new_p, OptState(step=step, mu=new_m, nu=new_v)

    return Optimizer(init=init, apply=apply, name="adam")
