"""Optimizers and learning-rate schedules over (nested) dicts of tensors.

Port of the JAX package's ``repro.optim.optimizers``, mirroring its
arithmetic: the schedules return a float32 rate for an integer step, the
moments stay float32 whatever the parameter dtype, and each update is
computed in float32 and cast back to the parameter's dtype. The paper
trains every model with Adam (Tab. 3); AdamW and SGD serve the other
architectures and ablations. The optimizers are functional — ``apply``
returns new tensors and leaves its inputs alone — so the trainer's health
guard can roll a step back by selection. Parameters may nest dicts and
lists (the halo model's nest dicts; the LM zoo's keep a list of layer
groups); the optimizer state mirrors their structure. Each leaf's Adam
update runs inside the span ``repro.opt.leaf`` (`repro_torch.spans`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from repro_torch import spans

Schedule = Callable[[int], torch.Tensor]

_F32 = torch.float32


def constant_schedule(lr: float) -> Schedule:
    return lambda step: torch.tensor(lr, dtype=_F32)


def cosine_schedule(lr: float, total_steps: int,
                    final_frac: float = 0.0) -> Schedule:
    def f(step):
        t = torch.clamp(torch.as_tensor(step, dtype=_F32)
                        / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return f


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1) -> Schedule:
    cos = cosine_schedule(lr, max(total_steps - warmup, 1), final_frac)

    def f(step):
        s = torch.as_tensor(step, dtype=_F32)
        wu = lr * torch.clamp(s / max(warmup, 1), max=1.0)
        return torch.where(s < warmup, wu, cos(step - warmup))
    return f


def _leaves(tree) -> list:
    """The tensors of nested dicts and lists, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts and lists `tree` and the matching
    leaves of `rest` (trees of the same structure), keeping `tree`'s
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _unzip(tree, n: int) -> tuple:
    """A tree whose leaves are n-tuples -> n trees."""
    if isinstance(tree, dict):
        parts = {k: _unzip(v, n) for k, v in tree.items()}
        return tuple({k: p[i] for k, p in parts.items()} for i in range(n))
    if isinstance(tree, list):
        parts = [_unzip(v, n) for v in tree]
        return tuple([p[i] for p in parts] for i in range(n))
    return tree


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ x²) over every tensor of a (nested) dict, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(_F32)))
                          for x in _leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to a global norm of at most max_norm, its norm)."""
    norm = global_norm(tree)
    limit = torch.tensor(max_norm, dtype=_F32, device=norm.device)
    scale = torch.clamp(limit / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), norm


class OptState(NamedTuple):
    """Optimizer state: the integer step counter and the first / second
    moment trees (nu is empty for SGD)."""

    step: int
    mu: dict
    nu: dict


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """apply(params, grads, state) -> (new_params, new_state)."""

    init: Callable
    apply: Callable
    name: str = "opt"


def _upload(x: torch.Tensor, device) -> torch.Tensor:
    """`x` (a host scalar) on `device`: on the card a blocking copy, which
    synchronizes the stream, so it counts as a host sync (``opt_upload``)."""
    if x.device == device:
        return x
    with spans.sync("opt_upload"):
        return x.to(device)


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=_F32), params)


def adam(schedule: Schedule | float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0,
         max_grad_norm: float | None = None,
         decoupled: bool = False) -> Optimizer:
    """Adam; `schedule` maps the step (1 at the first update) to the rate,
    or is a constant rate. `max_grad_norm` clips the gradients by their
    global norm first. A `weight_decay` is decoupled (AdamW) with
    `decoupled`; coupled, it adds nothing to the update, as in the JAX
    package, which leaves coupled decay to the caller's gradients."""

    def init(params):
        return OptState(step=0, mu=_zeros_f32(params),
                        nu=_zeros_f32(params))

    def apply(params, grads, state: OptState):
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        step = state.step + 1
        lr = schedule(step) if callable(schedule) else schedule
        b1t = 1 - torch.tensor(b1, dtype=_F32) ** torch.tensor(step, dtype=_F32)
        b2t = 1 - torch.tensor(b2, dtype=_F32) ** torch.tensor(step, dtype=_F32)

        def upd(p, g, m, v):
            with spans.span("repro.opt.leaf"):
                g32 = g.to(_F32)
                m = b1 * m + (1 - b1) * g32
                v = b2 * v + (1 - b2) * torch.square(g32)
                m_hat = m / _upload(b1t, m.device)
                delta = m_hat / (torch.sqrt(v / _upload(b2t, v.device)) + eps)
                if weight_decay:
                    if decoupled:       # AdamW
                        delta = delta + weight_decay * p.to(_F32)
                    else:               # coupled decay belongs in the gradients
                        delta = delta + 0.0
                return (p.to(_F32) - lr * delta).to(p.dtype), m, v

        new_p, new_m, new_v = _unzip(
            tree_map(upd, params, grads, state.mu, state.nu), 3)
        return new_p, OptState(step=step, mu=new_m, nu=new_v)

    return Optimizer(init=init, apply=apply,
                     name="adamw" if decoupled and weight_decay else "adam")


def adamw(schedule: Schedule | float, weight_decay: float = 0.01,
          **kw) -> Optimizer:
    return adam(schedule, weight_decay=weight_decay, decoupled=True, **kw)


def sgd(schedule: Schedule | float, momentum: float = 0.0,
        max_grad_norm: float | None = None) -> Optimizer:
    """SGD with heavy-ball momentum (m = momentum·m + g)."""

    def init(params):
        return OptState(step=0, mu=_zeros_f32(params), nu={})

    def apply(params, grads, state: OptState):
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        step = state.step + 1
        lr = schedule(step) if callable(schedule) else schedule

        def upd(p, g, m):
            m = momentum * m + g.to(_F32)
            return (p.to(_F32) - lr * m).to(p.dtype), m

        new_p, new_m = _unzip(tree_map(upd, params, grads, state.mu), 2)
        return new_p, OptState(step=step, mu=new_m, nu={})

    return Optimizer(init=init, apply=apply, name="sgd")
