"""An autograd-compatible wrapper around the PipeGCN step.

Port of the JAX package's ``repro.core.module``. The hand-written Alg. 1
backward cannot be derived by autograd (stale gradient routing), but it
can be packaged as a ``torch.autograd.Function``, so the pipelined loss
composes with ordinary PyTorch training code:

    loss_fn = make_pipegcn_loss(model, topo)
    loss, new_buffers = loss_fn(params, buffers, data, generator)
    loss.backward()          # each params[k].grad is the Alg. 1 gradient

The forward runs ``model.train_step`` once and keeps its gradients; the
backward returns them scaled by the loss's cotangent (so an outer loss
g(loss_fn(...)) composes) and runs no second step. Buffers, data and the
generator get no gradient: the pipeline state is not differentiable by the
paper's semantics, and the new buffers come back marked so.
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.core.pipegcn import PipeGCN, Topology


class _AlgOneLoss(torch.autograd.Function):
    """loss(params) with the Alg. 1 gradient as its vector-Jacobian
    product. Inputs: (step, keys, box, *params in `keys` order); outputs:
    (loss, *new buffer leaves), the leaves non-differentiable, their
    structure left in box["buffers"]."""

    @staticmethod
    def forward(ctx, step, keys, box, *flat_params):
        loss, grads, new_buffers = step(dict(zip(keys, flat_params)))
        ctx.grads = [grads[k] for k in keys]
        leaves, box["buffers"] = tree_flatten(new_buffers)
        ctx.mark_non_differentiable(*leaves)
        return (loss, *leaves)

    @staticmethod
    def backward(ctx, ct_loss, *ct_buffers):
        return (None, None, None, *(g * ct_loss for g in ctx.grads))


def make_pipegcn_loss(model: PipeGCN, topo: Topology):
    """Returns loss_fn(params, buffers, data, generator=None) -> (loss,
    new_buffers), differentiable w.r.t. params through the Alg. 1 manual
    backward."""

    def loss_fn(params, buffers, data, generator=None):
        def step(p):
            loss, grads, new_buffers, _ = model.train_step(
                topo, p, buffers, data, generator)
            return loss, grads, new_buffers

        keys, box = sorted(params), {}
        loss, *leaves = _AlgOneLoss.apply(step, keys, box,
                                          *(params[k] for k in keys))
        return loss, tree_unflatten(leaves, box["buffers"])

    return loss_fn
