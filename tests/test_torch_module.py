"""`make_pipegcn_loss` of the port against the JAX package's, on the CPU.

JAX differentiates its custom_vjp wrapper with `jax.value_and_grad`; the
port's wrapper is a `torch.autograd.Function` differentiated by
`loss.backward()`. From the same float64 parameters on tiny (4
partitions), loss, gradients and new buffers agree within 1e-12; against
the port's own `train_step` they are bitwise equal, the step runs once
(the backward replays its gradients), the gradient of 3·loss is 3× the
gradient, and the buffers get no gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

jax.config.update("jax_enable_x64", True)

from repro.core import make_pipegcn_loss as jmake_loss  # noqa: E402
from repro.core.config import ModelConfig as JModelConfig  # noqa: E402
from repro.core.config import PipeConfig as JPipeConfig  # noqa: E402
from repro.core.pipegcn import PipeGCN as JPipeGCN  # noqa: E402
from repro.data import GraphDataPipeline as JPipeline  # noqa: E402
from repro_torch.core import (ModelConfig, PipeConfig, PipeGCN,  # noqa: E402
                              make_pipegcn_loss, params_from_jax)
from repro_torch.data import GraphDataPipeline  # noqa: E402

TOL = 1e-12


@pytest.fixture(scope="module")
def graphs():
    out = {}
    for agg in ("coo", "blocksparse"):
        jp = JPipeline.build("tiny", 4, kind="sage", agg=agg)
        tp = GraphDataPipeline.build("tiny", 4, kind="sage", agg=agg,
                                     device="cpu")
        jtopo = jax.tree.map(lambda x: x.astype(jnp.float64)
                             if x.dtype == jnp.float32 else x, jp.topo)
        jdata = jp.train_data._replace(
            x=jp.train_data.x.astype(jnp.float64))
        tdata = tp.train_data._replace(x=tp.train_data.x.to(torch.float64))
        out[agg] = (tp, jtopo, jdata, tp.topo.to(torch.float64), tdata)
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _models(tp, agg, variant, layers=3):
    ds = tp.dataset
    cfg = dict(kind="sage", feat_dim=ds.feat_dim, hidden=16,
               num_layers=layers, num_classes=ds.num_classes, dropout=0.0,
               agg=agg)
    return (JPipeGCN(JModelConfig(**cfg), JPipeConfig.named(variant)),
            PipeGCN(ModelConfig(**cfg), PipeConfig.named(variant)))


@pytest.mark.parametrize("agg,variant", [("coo", "pipegcn"),
                                         ("blocksparse", "pipegcn-gf"),
                                         ("coo", "vanilla")])
def test_loss_and_grads_match_jax_value_and_grad(graphs, agg, variant):
    tp, jtopo, jdata, topo, data = graphs[agg]
    jmodel, model = _models(tp, agg, variant)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), dtype=jnp.float64)
    jbufs = jmodel.init_buffers(jtopo, dtype=jnp.float64)
    params = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                             "cpu")
    bufs = model.init_buffers(topo, dtype=torch.float64)
    jloss_fn, loss_fn = jmake_loss(jmodel, jtopo), make_pipegcn_loss(model,
                                                                      topo)
    jvg = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))
    for t in range(2):          # the second step reads the first's buffers
        (jl, jnb), jg = jvg(jparams, jbufs, jdata, jax.random.PRNGKey(t))
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss, new_bufs = loss_fn(leaves, bufs, data)
        loss.backward()
        assert abs(float(loss.detach()) - float(jl)) < TOL, t
        for k in jg:
            np.testing.assert_allclose(leaves[k].grad.numpy(),
                                       np.asarray(jg[k]), rtol=0, atol=TOL,
                                       err_msg=f"{k} step {t}")
        for a, b in zip(_leaves(new_bufs), jax.tree.leaves(jnb)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=TOL)
        jparams = {k: jparams[k] - 0.05 * jg[k] for k in jparams}
        params = {k: params[k] - 0.05 * leaves[k].grad for k in params}
        jbufs, bufs = jnb, new_bufs


def test_equals_train_step_bitwise_and_runs_it_once(graphs, monkeypatch):
    """Loss, gradients and buffers are train_step's bitwise; the loss runs
    train_step once (the backward runs no second step); the new buffers
    carry no gradient and the input buffers are left as they were."""
    tp, _, _, topo, data = graphs["blocksparse"]
    _, model = _models(tp, "blocksparse", "pipegcn")
    params = model.init_params(torch.Generator().manual_seed(0),
                               dtype=torch.float64)
    bufs = model.init_buffers(topo, dtype=torch.float64)
    l0, g0, b0, _ = model.train_step(topo, params, bufs, data)
    l0, g0, b0, _ = model.train_step(topo, params, b0, data)   # nonzero bufs
    before = [x.clone() for x in _leaves(b0)]
    l1, g1, b1, _ = model.train_step(topo, params, b0, data)
    steps, train_step = [], PipeGCN.train_step

    def counted(self, *args, **kwargs):
        steps.append(args)
        return train_step(self, *args, **kwargs)
    monkeypatch.setattr(PipeGCN, "train_step", counted)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss, new_bufs = make_pipegcn_loss(model, topo)(leaves, b0, data)
    loss.backward()
    assert len(steps) == 1
    assert torch.equal(loss.detach(), l1)
    assert all(torch.equal(leaves[k].grad, g1[k]) for k in g1)
    for a, b in zip(_leaves(new_bufs), _leaves(b1)):
        assert torch.equal(a, b)
        assert not a.requires_grad and a.grad_fn is None
    assert all(torch.equal(a, b) for a, b in zip(_leaves(b0), before))


def test_cotangent_scaling(graphs):
    """The gradient of 3·loss is 3× the gradient of loss (the backward
    scales by the cotangent), and an outer function composes."""
    tp, _, _, topo, data = graphs["coo"]
    _, model = _models(tp, "coo", "pipegcn", layers=2)
    params = model.init_params(torch.Generator().manual_seed(1),
                               dtype=torch.float64)
    bufs = model.init_buffers(topo, dtype=torch.float64)
    loss_fn = make_pipegcn_loss(model, topo)
    grads = {}
    for scale in (1.0, 3.0):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss, _ = loss_fn(leaves, bufs, data)
        (scale * loss).backward()
        grads[scale] = {k: v.grad for k, v in leaves.items()}
    for k in params:
        torch.testing.assert_close(grads[3.0][k], 3 * grads[1.0][k],
                                   rtol=1e-15, atol=0)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss, _ = loss_fn(leaves, bufs, data)
    g = torch.autograd.grad(loss ** 2, [leaves["w0"]])[0]
    torch.testing.assert_close(g, 2 * loss.detach() * grads[1.0]["w0"],
                               rtol=1e-15, atol=0)
