"""The port's step under every boundary wire and under feature slicing,
against the JAX package's, on the CPU in float64.

Both packages build the same partitioned graph, start from the same
parameters and take 3 training steps (4 with a 2-deep FIFO) at dropout 0:
loss, every gradient, every pipeline buffer and the logits agree to 1e-12
after each step. The wire cells run bf16, int8, int4, auto and the
``compress_boundary`` alias over both layer kinds, the three engines and
the fused and per-layer exchanges; the sliced cells run int8 and auto
(whose plan mixes an int8 wire with a bf16 one where grid-tiny's last
layer slices to width 4) under forced transform-first and auto orders.
The slicing tables (sliced layers, payload widths, orders, codecs, buffer
shapes) equal JAX's, and in vanilla mode the sliced step equals the
unsliced one.
"""
import dataclasses
import functools

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
from repro_torch.core import ModelConfig, PipeConfig, PipeGCN  # noqa: E402
from repro_torch.core.pipegcn import params_from_jax  # noqa: E402
from repro_torch.data import GraphDataPipeline  # noqa: E402

TOL = 1e-12
P = 4


@functools.lru_cache(maxsize=None)
def _pipelines(dataset, kind, agg):
    """The JAX and the port pipelines of one graph, in float64."""
    jp = JPipeline.build(dataset, P, kind=kind, agg=agg)
    tp = GraphDataPipeline.build(dataset, P, kind=kind, agg=agg, device="cpu")
    jtopo = jax.tree.map(
        lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x,
        jp.topo)
    jdata = jp.train_data._replace(x=jp.train_data.x.astype(jnp.float64))
    tdata = tp.train_data._replace(x=tp.train_data.x.to(torch.float64))
    return tp, (jtopo, jdata), (tp.topo.to(torch.float64), tdata)


def _models(dataset, kind, agg, order, pipe_kw, layers=3):
    ds = _pipelines(dataset, kind, agg)[0].dataset
    cfg = dict(kind=kind, feat_dim=ds.feat_dim, hidden=16,
               num_layers=layers, num_classes=ds.num_classes, dropout=0.0,
               agg=agg, matmul_order=order)
    pipe = {"stale": True, **pipe_kw}
    return (JPipeGCN(JModelConfig(**cfg), JPipeConfig(**pipe)),
            PipeGCN(ModelConfig(**cfg), PipeConfig(**pipe)))


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
        assert ttree.shape == jtree.shape, what
        np.testing.assert_allclose(ttree.numpy(), np.asarray(jtree),
                                   rtol=0, atol=TOL, err_msg=what)


def _run_both(dataset, kind, agg, order, pipe_kw):
    """3 steps (4 with a FIFO) of both packages; returns the port model
    and its topology."""
    _, (jtopo, jdata), (topo, data) = _pipelines(dataset, kind, agg)
    jmodel, tmodel = _models(dataset, kind, agg, order, pipe_kw)
    assert tmodel.layer_orders(topo) == jmodel.layer_orders(jtopo)
    assert tmodel.payload_widths(topo) == jmodel.payload_widths(jtopo)
    assert [c.name for c in tmodel.wire_codecs(topo)] == \
        [c.name for c in jmodel.wire_codecs(jtopo)]
    jparams = jmodel.init_params(jax.random.PRNGKey(0), dtype=jnp.float64)
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                              "cpu")
    jbufs = jmodel.init_buffers(jtopo, dtype=jnp.float64)
    tbufs = tmodel.init_buffers(topo, dtype=torch.float64)
    for t in range(4 if pipe_kw.get("staleness_steps", 1) > 1 else 3):
        jloss, jgrads, jbufs, jlogits = jmodel.train_step(
            jtopo, jparams, jbufs, jdata, jax.random.PRNGKey(t))
        tloss, tgrads, tbufs, tlogits = tmodel.train_step(
            topo, tparams, tbufs, data)
        assert abs(float(jloss) - float(tloss)) < TOL, (t, jloss, tloss)
        _assert_tree(jgrads, tgrads, f"step {t} grads")
        _assert_tree(jbufs, tbufs, f"step {t} buffers")
        _assert_tree(jlogits, tlogits, f"step {t} logits")
        jparams = {k: jparams[k] - 0.05 * jgrads[k] for k in jparams}
        tparams = {k: tparams[k] - 0.05 * tgrads[k] for k in tparams}
    return tmodel, topo


# (wire knobs, kind, agg, fuse_exchange): every wire on both kinds and both
# exchange schedules, every engine under at least three wires
WIRE_CELLS = [
    ({"wire": "bf16"}, "sage", "coo", True),
    ({"wire": "bf16"}, "gcn", "fused", False),
    ({"wire": "int8"}, "sage", "blocksparse", False),
    ({"wire": "int8"}, "gcn", "coo", True),
    ({"wire": "int4"}, "sage", "fused", True),
    ({"wire": "int4"}, "gcn", "blocksparse", False),
    ({"wire": "auto"}, "sage", "coo", False),
    ({"wire": "auto"}, "gcn", "fused", True),
    ({"compress_boundary": True}, "sage", "blocksparse", True),
    ({"compress_boundary": True}, "gcn", "coo", False),
]


@pytest.mark.parametrize("wire_kw,kind,agg,fuse", WIRE_CELLS)
def test_wire_step_matches_jax(wire_kw, kind, agg, fuse):
    model, _ = _run_both("tiny", kind, agg, "auto",
                         dict(wire_kw, fuse_exchange=fuse))
    assert model.pipe.wire != "f32"


# (dataset, kind, agg, order, pipe knobs, sliced layers, payload widths,
# wire formats)
SLICE_CELLS = [
    ("tiny", "sage", "coo", "transform-first",
     {"wire": "int8", "slice_boundary": True},
     {1, 2}, (16, 16, 4), ("int8",) * 3),
    ("tiny", "gcn", "blocksparse", "transform-first",
     {"wire": "int8", "slice_boundary": True, "staleness_steps": 2,
      "fuse_exchange": False},
     {1, 2}, (16, 16, 4), ("int8",) * 3),
    ("grid-tiny", "sage", "blocksparse", "auto",
     {"wire": "auto", "slice_boundary": True},
     {2}, (16, 16, 4), ("int8", "int8", "bf16")),
    ("grid-tiny", "gcn", "fused", "transform-first",
     {"wire": "auto", "slice_boundary": True, "fuse_exchange": False},
     {1, 2}, (16, 16, 4), ("int8", "int8", "bf16")),
    ("grid-tiny", "sage", "coo", "transform-first",
     {"wire": "auto", "slice_boundary": True, "stale": False},
     {1, 2}, (16, 16, 4), ("int8", "int8", "bf16")),
]


@pytest.mark.parametrize(
    "dataset,kind,agg,order,pipe_kw,sliced,widths,formats", SLICE_CELLS)
def test_sliced_step_matches_jax(dataset, kind, agg, order, pipe_kw, sliced,
                                 widths, formats):
    model, topo = _run_both(dataset, kind, agg, order, pipe_kw)
    assert model.sliced_layers(topo) == sliced
    assert model.payload_widths(topo) == widths
    assert tuple(c.name for c in model.wire_codecs(topo)) == formats
    # slicing disables the split where the graph has one
    split = _pipelines(dataset, kind, agg)[0].split_spec()
    assert dataclasses.replace(model, split=split)._split_active() is None


@pytest.mark.parametrize("dataset,kind,agg,order,pipe_kw", [
    ("tiny", "sage", "coo", "transform-first", {}),
    ("tiny", "sage", "blocksparse", "auto", {"wire": "int8"}),
    ("grid-tiny", "gcn", "fused", "auto", {"wire": "auto"}),
    ("grid-tiny", "sage", "coo", "transform-first",
     {"wire": "int4", "staleness_steps": 2}),
])
def test_slicing_tables_match_jax(dataset, kind, agg, order, pipe_kw):
    """sliced_layers, payload_widths, layer_orders (train, eval and priced
    unfused), wire_codecs and the buffer shapes equal JAX's, with and
    without slicing."""
    _, (jtopo, _), (topo, _) = _pipelines(dataset, kind, agg)
    for sl in (False, True):
        kw = dict(pipe_kw, slice_boundary=sl)
        jm, tm = _models(dataset, kind, agg, order, kw)
        assert tm.sliced_layers(topo) == jm.sliced_layers(jtopo)
        assert bool(tm.sliced_layers(topo)) == sl
        assert tm.payload_widths(topo) == jm.payload_widths(jtopo)
        for train in (True, False):
            for fused in (None, False):
                assert tm.layer_orders(topo, train, fused) == \
                    jm.layer_orders(jtopo, train, fused)
        assert [(c.name, getattr(c, "block", None))
                for c in tm.wire_codecs(topo)] == \
            [(c.name, getattr(c, "block", None))
             for c in jm.wire_codecs(jtopo)]
        tb = tm.init_buffers(topo, dtype=torch.float64)
        jb = jm.init_buffers(jtopo, dtype=jnp.float64)
        for k in ("feat", "grad"):
            assert [tuple(b.shape) for b in tb[k]] == \
                [tuple(b.shape) for b in jb[k]]


@pytest.mark.parametrize("kind,agg", [("sage", "coo"), ("gcn", "blocksparse")])
def test_sliced_equals_unsliced_vanilla(kind, agg):
    """Slicing moves where the transform runs (owner side instead of halo
    side), not what is computed: in vanilla mode the sliced and unsliced
    steps agree to f64 round-off on loss, every gradient and the logits."""
    _, _, (topo, data) = _pipelines("tiny", kind, agg)
    kw = dict(stale=False, overlap="none")
    _, ref = _models("tiny", kind, agg, "transform-first", kw)
    _, sli = _models("tiny", kind, agg, "transform-first",
                     dict(kw, slice_boundary=True))
    assert sli.sliced_layers(topo)
    params = ref.init_params(torch.Generator().manual_seed(0),
                             dtype=torch.float64)
    b_ref = ref.init_buffers(topo, dtype=torch.float64)
    b_sli = sli.init_buffers(topo, dtype=torch.float64)
    for t in range(3):
        l0, g0, b_ref, lg0 = ref.train_step(topo, params, b_ref, data)
        l1, g1, b_sli, lg1 = sli.train_step(topo, params, b_sli, data)
        assert abs(float(l0) - float(l1)) < TOL, t
        for k in g0:
            torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=TOL)
        torch.testing.assert_close(lg1, lg0, rtol=0, atol=TOL)
        params = {k: params[k] - 0.05 * g0[k] for k in params}
