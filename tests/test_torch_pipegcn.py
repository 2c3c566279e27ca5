"""The PyTorch port's PipeGCN step against the JAX package's, in float64.

Both packages build the same partitioned graph (byte-identical numpy
arrays), start from the same parameters (carried by `params_from_jax`),
and take 3 training steps at dropout 0: loss, every gradient and every
pipeline buffer must agree to 1e-12 after each step. The JAX block-sparse
engine runs its Pallas kernels in interpret mode, the port's on the plain
PyTorch versions (CPU tensors).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

jax.config.update("jax_enable_x64", True)

from repro.core.config import ModelConfig as JModelConfig  # noqa: E402
from repro.core.config import PipeConfig as JPipeConfig  # noqa: E402
from repro.core.pipegcn import PipeGCN as JPipeGCN  # noqa: E402
from repro.data import GraphDataPipeline as JPipeline  # noqa: E402
from repro.graph import make_dataset as jmake_dataset  # noqa: E402
from repro_torch.core.config import ModelConfig, PipeConfig  # noqa: E402
from repro_torch.core.pipegcn import PipeGCN, params_from_jax  # noqa: E402
from repro_torch.data import GraphDataPipeline  # noqa: E402
from repro_torch.graph import make_dataset  # noqa: E402

TOL = 1e-12
STEPS = 3


def _pipelines(dataset, kind, agg, parts=4):
    """`dataset` is a preset name, or (name, overrides) for make_dataset."""
    name, over = (dataset, {}) if isinstance(dataset, str) else dataset
    jp = JPipeline.build(jmake_dataset(name, **over), parts, kind=kind,
                         agg=agg)
    tp = GraphDataPipeline.build(make_dataset(name, **over), parts,
                                 kind=kind, agg=agg, device="cpu")
    return jp, tp


def _f64_jax(jp):
    topo = jax.tree.map(
        lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x,
        jp.topo)
    return topo, jp.train_data._replace(x=jp.train_data.x.astype(jnp.float64))


def _f64_torch(tp):
    return tp.topo.to(torch.float64), tp.train_data._replace(
        x=tp.train_data.x.to(torch.float64))


def _assert_tree(jtree, ttree, what):
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree), what
        for k in jtree:
            _assert_tree(jtree[k], ttree[k], f"{what}/{k}")
    elif isinstance(jtree, (tuple, list)):
        assert len(jtree) == len(ttree), what
        for i, (a, b) in enumerate(zip(jtree, ttree)):
            _assert_tree(a, b, f"{what}[{i}]")
    else:
        np.testing.assert_allclose(ttree.numpy(), np.asarray(jtree),
                                   rtol=0, atol=TOL, err_msg=what)


def _run_both(dataset, kind, agg, pipe_kw, layers=3, hidden=16):
    jp, tp = _pipelines(dataset, kind, agg)
    ds = tp.dataset
    cfg = dict(kind=kind, feat_dim=ds.feat_dim, hidden=hidden,
               num_layers=layers, num_classes=ds.num_classes, dropout=0.0,
               multilabel=ds.multilabel, agg=agg, matmul_order="auto")
    jmodel = JPipeGCN(JModelConfig(**cfg), JPipeConfig(**pipe_kw))
    tmodel = PipeGCN(ModelConfig(**cfg), PipeConfig(**pipe_kw))
    jtopo, jdata = _f64_jax(jp)
    ttopo, tdata = _f64_torch(tp)
    assert tmodel.layer_orders(ttopo) == jmodel.layer_orders(jtopo)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), dtype=jnp.float64)
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                              "cpu")
    jbufs = jmodel.init_buffers(jtopo, dtype=jnp.float64)
    tbufs = tmodel.init_buffers(ttopo, dtype=torch.float64)
    lr = 0.05
    for t in range(STEPS):
        jloss, jgrads, jbufs, jlogits = jmodel.train_step(
            jtopo, jparams, jbufs, jdata, jax.random.PRNGKey(t))
        tloss, tgrads, tbufs, tlogits = tmodel.train_step(
            ttopo, tparams, tbufs, tdata)
        assert abs(float(jloss) - float(tloss)) < TOL, (t, jloss, tloss)
        _assert_tree(jgrads, tgrads, f"step {t} grads")
        _assert_tree(jbufs, tbufs, f"step {t} buffers")
        _assert_tree(jlogits, tlogits, f"step {t} logits")
        jparams = {k: jparams[k] - lr * jgrads[k] for k in jparams}
        tparams = {k: tparams[k] - lr * tgrads[k] for k in tparams}
    return jmodel, tmodel, jtopo, ttopo, jparams, tparams, jp, tp


@pytest.mark.parametrize("dataset", ["tiny", "grid-tiny"])
@pytest.mark.parametrize("agg", ["coo", "blocksparse"])
@pytest.mark.parametrize("variant", ["vanilla", "pipegcn", "pipegcn-gf"])
def test_train_step_matches_jax(dataset, agg, variant):
    pipe = JPipeConfig.named(variant, gamma=0.9)
    kw = dict(stale=pipe.stale, smooth_feat=pipe.smooth_feat,
              smooth_grad=pipe.smooth_grad, gamma=pipe.gamma)
    _run_both(dataset, "sage", agg, kw)


@pytest.mark.parametrize("agg", ["coo", "blocksparse"])
@pytest.mark.parametrize("fuse", [True, False])
def test_k_step_fifo_matches_jax(agg, fuse):
    """staleness_steps=2 FIFOs, with the fused and the per-layer exchange."""
    _run_both("tiny", "gcn", agg, dict(stale=True, staleness_steps=2,
                                       fuse_exchange=fuse))


@pytest.mark.parametrize("agg", ["coo", "blocksparse"])
def test_multilabel_bce_matches_jax(agg):
    """The sigmoid BCE loss (Yelp-style multilabel) on a multilabel tiny."""
    _run_both(("tiny", dict(multilabel=True)), "sage", agg,
              dict(stale=True, smooth_grad=True, gamma=0.9))


@pytest.mark.parametrize("dataset", ["tiny", "grid-tiny"])
def test_eval_forward_matches_jax(dataset):
    """The eval forward (fresh exchange, ReLU fused) after 3 training steps."""
    jmodel, tmodel, jtopo, ttopo, jparams, tparams, jp, tp = _run_both(
        dataset, "sage", "blocksparse", dict(stale=True))
    jloss, jlogits = jmodel.forward(jtopo, jparams, _f64_jax(jp)[1])
    tloss, tlogits = tmodel.forward(ttopo, tparams, _f64_torch(tp)[1])
    assert abs(float(jloss) - float(tloss)) < TOL
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=TOL)


def test_stale_training_matches_dense_oracle():
    """The port against the dense numpy Alg. 1 oracle of the JAX package's
    tests: 5 SGD iterations of PipeGCN-GF, losses, gradients and weights."""
    from test_pipegcn_core import LR, dense_alg1_oracle

    from repro_torch.core.pipegcn import shard_data, topology_from
    from repro_torch.graph import (build_partitioned_graph, make_dataset,
                                   partition_graph)
    from repro_torch.graph.csr import sym_normalized

    ds = make_dataset("tiny")
    prop = sym_normalized(ds.graph)
    part = partition_graph(ds.graph, 4, seed=0)
    pg = build_partitioned_graph(prop, part, 4)
    topo = topology_from(pg, device="cpu").to(torch.float64)
    data = shard_data(pg, ds.features, ds.labels, ds.train_mask, ds.val_mask,
                      device="cpu")
    data = data._replace(x=data.x.to(torch.float64))
    mc = ModelConfig(kind="gcn", feat_dim=ds.feat_dim, hidden=16,
                     num_layers=3, num_classes=ds.num_classes, dropout=0.0)
    pipe = PipeConfig.named("pipegcn-gf", gamma=0.9)
    model = PipeGCN(mc, pipe)
    rng = np.random.default_rng(0)
    np_params = {}
    for ell, (fin, fout) in enumerate(mc.layer_dims()):
        np_params[f"w{ell}"] = rng.standard_normal((fin, fout)) * 0.3
        np_params[f"b{ell}"] = rng.standard_normal(fout) * 0.1
    o_losses, o_grads, o_W = dense_alg1_oracle(
        np.asarray(prop.to_dense()), part, ds.features.astype(np.float64),
        ds.labels, ds.train_mask.astype(np.float64), np_params, pipe, T=5,
        lr=LR, num_classes=ds.num_classes, layers=mc.num_layers)
    params = params_from_jax(np_params, "cpu")
    bufs = model.init_buffers(topo, dtype=torch.float64)
    for t in range(5):
        loss, grads, bufs, _ = model.train_step(topo, params, bufs, data)
        assert abs(float(loss) - o_losses[t]) < 1e-10, t
        for k in grads:
            np.testing.assert_allclose(grads[k].numpy(), o_grads[t][k],
                                       atol=1e-10, err_msg=f"t={t} {k}")
        params = {k: params[k] - LR * grads[k] for k in params}
    for k in params:
        np.testing.assert_allclose(params[k].numpy(), o_W[k], atol=1e-9)


def test_unported_options_raise():
    """Every PipeConfig option is ported now, so only an engine neither
    package has raises; the guarded exchange (tests/test_torch_faults.py),
    the split-phase schedule (tests/test_torch_overlap.py), the wire
    codecs and feature slicing (tests/test_torch_slice.py) construct."""
    mc = ModelConfig(feat_dim=8, hidden=8, num_layers=2, num_classes=2)
    with pytest.raises(KeyError, match="unknown aggregation engine"):
        PipeGCN(dataclasses.replace(mc, agg="dense"), PipeConfig())
    model = PipeGCN(mc, PipeConfig(guard_exchange=True))
    assert model.wire_codecs(None)[0].name == "f32"
    PipeGCN(mc, PipeConfig(overlap="split-phase"))
    for pipe in (PipeConfig(wire="bf16"), PipeConfig(wire="auto"),
                 PipeConfig(compress_boundary=True),
                 PipeConfig(slice_boundary=True)):
        PipeGCN(mc, pipe)
