"""Shared setup of the split-phase parity cells (tests/test_torch_overlap*.py).

The 16 cells of `test_split_equals_unsplit_and_jax` run the port's split
step against its own unsplit step (bitwise) and against the JAX package's
split step (1e-12) on grid-tiny in float64. Each cell spends most of its
time in the JAX reference's eager steps (Pallas in interpret mode), so the
cells are spread over three files that pytest-xdist's `loadfile` gives to
different workers; each file builds its setups once and runs `run_cell`
on its share of `CELLS`.

Importing this module sets PyTorch to one intra-op thread (see
tests/_torch_threads.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_threads  # noqa: F401

jax.config.update("jax_enable_x64", True)

from repro.core.config import ModelConfig as JModelConfig  # noqa: E402
from repro.core.config import PipeConfig as JPipeConfig  # noqa: E402
from repro.core.pipegcn import PipeGCN as JPipeGCN  # noqa: E402
from repro.core.pipegcn import shard_data as jshard_data  # noqa: E402
from repro.core.pipegcn import split_spec_from as jsplit_spec_from  # noqa: E402
from repro.core.pipegcn import topology_from as jtopology_from  # noqa: E402
from repro.graph import build_partitioned_graph as jbuild_pg  # noqa: E402
from repro.graph import make_dataset as jmake_dataset  # noqa: E402
from repro.graph import partition_graph as jpartition_graph  # noqa: E402
from repro.graph.csr import mean_normalized as jmean  # noqa: E402
from repro.graph.csr import sym_normalized as jsym  # noqa: E402
from repro_torch.core import (ModelConfig, PipeConfig, PipeGCN,  # noqa: E402
                              params_from_jax)
from repro_torch.data import GraphDataPipeline  # noqa: E402

TOL = 1e-12
P = 4


def _port(kind):
    tp = GraphDataPipeline.build("grid-tiny", P, kind=kind, agg="fused",
                                 layout="rcm", device="cpu")
    topo = tp.topo.to(torch.float64)
    data = tp.train_data._replace(x=tp.train_data.x.to(torch.float64))
    return tp, topo, data


def _jax(kind):
    ds = jmake_dataset("grid-tiny")
    prop = jmean(ds.graph) if kind == "sage" else jsym(ds.graph)
    pg = jbuild_pg(prop, jpartition_graph(ds.graph, P, seed=0), P,
                   layout="rcm")
    topo = jtopology_from(pg, with_tiles=True)
    topo = topo._replace(edge_w=topo.edge_w.astype(jnp.float64),
                         tile_vals=topo.tile_vals.astype(jnp.float64))
    data = jshard_data(pg, ds.features.astype(np.float64), ds.labels,
                       ds.train_mask, ds.val_mask)
    return topo, data._replace(x=data.x.astype(jnp.float64)), \
        jsplit_spec_from(pg)


def build_setups():
    """Both packages' grid-tiny setups, per GCN kind (each file's module
    fixture `setups`)."""
    return {kind: (_port(kind), _jax(kind)) for kind in ("sage", "gcn")}


_JAX_PARAMS = {}


def _jax_params(jmodel, cfg):
    """The JAX model's float64 parameters from PRNGKey(0); they depend on
    the layer widths alone, so cells of one kind share them."""
    key = (cfg["kind"], cfg["feat_dim"], cfg["hidden"], cfg["num_layers"],
           cfg["num_classes"])
    if key not in _JAX_PARAMS:
        _JAX_PARAMS[key] = jmodel.init_params(jax.random.PRNGKey(0),
                                              dtype=jnp.float64)
    return _JAX_PARAMS[key]


def _configs(tp, kind, variant, agg, order, pipe_kw, dropout, layers=3):
    ds = tp.dataset
    cfg = dict(kind=kind, feat_dim=ds.feat_dim, hidden=16,
               num_layers=layers, num_classes=ds.num_classes,
               dropout=dropout, agg=agg, matmul_order=order, layout="rcm")
    base = JPipeConfig.named(variant, gamma=0.9)
    pipe = dict(stale=base.stale, smooth_feat=base.smooth_feat,
                smooth_grad=base.smooth_grad, gamma=base.gamma, **pipe_kw)
    return cfg, pipe


def _equal_trees(a, b, what):
    if isinstance(a, dict):
        for k in a:
            _equal_trees(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_trees(x, y, f"{what}[{i}]")
    else:
        assert torch.equal(a, b), what
        assert not torch.isnan(a).any(), what


def _close_to_jax(jtree, ttree, what):
    if isinstance(jtree, dict):
        for k in jtree:
            _close_to_jax(jtree[k], ttree[k], f"{what}/{k}")
    elif isinstance(jtree, (tuple, list)):
        for i, (x, y) in enumerate(zip(jtree, ttree)):
            _close_to_jax(x, y, f"{what}[{i}]")
    else:
        np.testing.assert_allclose(ttree.numpy(), np.asarray(jtree),
                                   rtol=0, atol=TOL, err_msg=what)


# kind, variant, agg, matmul order, pipe knobs, dropout: the JAX package's
# matrix (tests/test_overlap.py), plus fused/auto and the int8 and auto
# wires (the split moves each encoded exchange, and must stay bitwise)
CELLS = [
    ("sage", "pipegcn", "coo", "aggregate-first", {}, 0.0),
    ("sage", "pipegcn", "blocksparse", "aggregate-first", {}, 0.0),
    ("sage", "pipegcn", "fused", "aggregate-first", {}, 0.0),
    ("sage", "vanilla", "blocksparse", "aggregate-first", {}, 0.0),
    ("sage", "vanilla", "coo", "transform-first", {}, 0.0),
    ("sage", "pipegcn-gf", "blocksparse", "transform-first", {}, 0.0),
    ("gcn", "pipegcn", "blocksparse", "aggregate-first", {}, 0.0),
    ("gcn", "vanilla", "fused", "transform-first", {}, 0.0),
    ("gcn", "pipegcn", "coo", "auto", {}, 0.0),
    ("sage", "pipegcn", "blocksparse", "auto", {}, 0.5),
    ("sage", "pipegcn", "blocksparse", "aggregate-first",
     {"fuse_exchange": False}, 0.0),
    ("sage", "pipegcn", "fused", "aggregate-first",
     {"staleness_steps": 2}, 0.0),
    ("sage", "pipegcn", "fused", "auto", {}, 0.0),
    ("sage", "pipegcn-g", "blocksparse", "aggregate-first",
     {"compress_boundary": True}, 0.0),
    ("gcn", "pipegcn", "blocksparse", "transform-first",
     {"wire": "int8", "fuse_exchange": False}, 0.0),
    ("sage", "vanilla", "coo", "auto", {"wire": "auto"}, 0.0),
]


def cell_ids(cells):
    """The parameter ids of `cells`, numbered by their place in CELLS."""
    return [f"{c[0]}-{c[1]}-{c[2]}-{c[3]}-pipe_kw{CELLS.index(c)}-{c[5]}"
            for c in cells]


def run_cell(setups, kind, variant, agg, order, pipe_kw, dropout):
    """One cell: 3 training steps (4 with a 2-deep FIFO) and the eval
    forward, split vs unsplit bitwise and vs the JAX split step."""
    (tp, topo, data), (jtopo, jdata, jsp) = setups[kind]
    sp = tp.split_spec()
    assert sp == tuple(jsp)
    cfg, pipe = _configs(tp, kind, variant, agg, order, pipe_kw, dropout)
    mc = ModelConfig(**cfg)
    ref = PipeGCN(mc, PipeConfig(**pipe, overlap="none"), split=sp)
    spl = PipeGCN(mc, PipeConfig(**pipe, overlap="split-phase"), split=sp)
    assert ref._split_active() is None and spl._split_active() == sp
    with_jax = dropout == 0.0     # the dropout bits differ across packages
    if with_jax:
        jmodel = JPipeGCN(JModelConfig(**cfg),
                          JPipeConfig(**pipe, overlap="split-phase"),
                          split=jsp)
        jparams = _jax_params(jmodel, cfg)
        jbufs = jmodel.init_buffers(jtopo, dtype=jnp.float64)
        params = params_from_jax({k: np.asarray(v)
                                  for k, v in jparams.items()}, "cpu")
        assert spl.step_orders(topo) == jmodel.layer_orders(jtopo,
                                                            fused=False)
    else:
        params = ref.init_params(torch.Generator().manual_seed(0),
                                 dtype=torch.float64)
    b_ref = ref.init_buffers(topo, dtype=torch.float64)
    b_spl = spl.init_buffers(topo, dtype=torch.float64)
    g_ref, g_spl = (torch.Generator().manual_seed(7) for _ in range(2))
    steps = 4 if pipe_kw.get("staleness_steps", 1) > 1 else 3
    for t in range(steps):
        l0, gr0, b_ref, lg0 = ref.train_step(topo, params, b_ref, data, g_ref)
        l1, gr1, b_spl, lg1 = spl.train_step(topo, params, b_spl, data, g_spl)
        if order != "auto" or agg != "fused":   # fused/auto: other orders
            _equal_trees((l0, gr0, b_ref, lg0), (l1, gr1, b_spl, lg1),
                         f"split vs unsplit, step {t}")
        if with_jax:
            jl, jg, jbufs, jlg = jmodel.train_step(jtopo, jparams, jbufs,
                                                   jdata,
                                                   jax.random.PRNGKey(t))
            assert abs(float(jl) - float(l1)) < TOL, t
            _close_to_jax((jg, jbufs, jlg), (gr1, b_spl, lg1),
                          f"split vs JAX split, step {t}")
            jparams = {k: jparams[k] - 0.05 * jg[k] for k in jparams}
        params = {k: params[k] - 0.05 * gr1[k] for k in params}
    le0, lo0 = ref.forward(topo, params, data)
    le1, lo1 = spl.forward(topo, params, data)
    assert torch.equal(lo0, lo1) or (agg == "fused" and order == "auto")
    if with_jax:
        jle, jlo = jmodel.forward(jtopo, jparams, jdata)
        assert abs(float(jle) - float(le1)) < TOL
        np.testing.assert_allclose(lo1.numpy(), np.asarray(jlo), rtol=0,
                                   atol=TOL)
