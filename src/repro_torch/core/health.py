"""Numerical health guards for the training loop.

Port of the JAX package's ``repro.core.health``. A single non-finite loss
or gradient poisons every later step (Adam moments, stale boundary
buffers, params). :func:`health_check` is a verdict on one step's outputs
— finite loss, finite gradients, finite floating buffers, and an optional
global grad-norm bound — and the trainer's skip-and-rollback policy
selects between the updated and the previous state with ``torch.where``
(:func:`tree_select`), so a healthy run is bit-identical to an unguarded
one.

Escalation is host-side: :class:`HealthConfig.max_consecutive_anomalies`
back-to-back skipped steps raise :class:`TrainingAnomalyError`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.optim.optimizers import global_norm


class TrainingAnomalyError(RuntimeError):
    """Too many consecutive non-finite / out-of-bound training steps."""


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Policy knobs for the trainer's health guard.

    ``grad_norm_limit`` — reject steps whose global grad norm exceeds the
    bound (``None`` = finiteness only). ``max_consecutive_anomalies`` —
    consecutive skipped steps before :class:`TrainingAnomalyError`.
    """

    enabled: bool = True
    grad_norm_limit: float | None = None
    max_consecutive_anomalies: int = 25

    def __post_init__(self):
        if self.grad_norm_limit is not None and self.grad_norm_limit <= 0:
            raise ValueError("grad_norm_limit must be positive or None, "
                             f"got {self.grad_norm_limit}")
        if self.max_consecutive_anomalies < 1:
            raise ValueError("max_consecutive_anomalies must be >= 1, got "
                             f"{self.max_consecutive_anomalies}")


def _leaves(tree):
    """Tensors of a nested dict / tuple / list."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _finite_tree(tree) -> torch.Tensor:
    """All-finite predicate over a tree's floating tensors."""
    ok = torch.tensor(True)
    for leaf in _leaves(tree):
        if leaf.is_floating_point():
            ok = ok.to(leaf.device) & torch.all(torch.isfinite(leaf))
    return ok


def health_check(loss, grads, buffers=None, grad_norm_limit=None):
    """Health verdict on one training step's outputs.

    Returns ``{"ok": bool tensor, "grad_norm": f32 tensor}``. ``ok`` needs
    a finite loss, finite gradients (one Inf/NaN drives the global norm
    non-finite), finite floating buffers, and — when ``grad_norm_limit``
    is set — a global norm at or under the bound.
    """
    gn = global_norm(grads)
    ok = torch.isfinite(loss) & torch.isfinite(gn)
    if buffers is not None:
        ok = ok & _finite_tree(buffers).to(ok.device)
    if grad_norm_limit is not None:
        ok = ok & (gn <= grad_norm_limit)
    return {"ok": ok, "grad_norm": gn}


def tree_select(pred, on_true, on_false):
    """Leafwise ``torch.where`` over matching trees (dicts, tuples, lists,
    NamedTuples of tensors; plain ints are selected on the host) — the
    rollback primitive: bitwise identity on whichever branch is taken."""
    if isinstance(on_true, dict):
        return {k: tree_select(pred, on_true[k], on_false[k])
                for k in on_true}
    if isinstance(on_true, tuple) and hasattr(on_true, "_fields"):
        return type(on_true)(*(tree_select(pred, a, b)
                               for a, b in zip(on_true, on_false)))
    if isinstance(on_true, (tuple, list)):
        return type(on_true)(tree_select(pred, a, b)
                             for a, b in zip(on_true, on_false))
    if isinstance(on_true, torch.Tensor):
        return torch.where(pred, on_true, on_false)
    return on_true if bool(pred) else on_false
