"""The port's fused aggregate+transform path (``agg="fused"``) against the
JAX package's, on the same numpy-seeded inputs.

(a) the plain versions of the fused kernels against the JAX Pallas kernels
    (interpret mode) on random block-sparse shards with an empty row block
    and an empty column block, in float32 at 5e-5;
(b) FusedBlockSparseEngine against JAX's at ragged widths, float64, 1e-12;
(c) 3 training steps and an eval forward with agg="fused", float64, 1e-12,
    GCN (whose eval runs the in-kernel ReLU) and SAGE, under both the
    aggregate-first and the auto matmul order;
(d) the fused engine's layer orders against JAX's, train and eval.
The CUDA kernels are held against the plain versions on the card by
tests/test_torch_cuda.py.
"""
from types import SimpleNamespace

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
from repro.kernels.aggregate import get_engine as jget_engine  # noqa: E402
from repro.kernels.gcn_spmm import build_tile_topology as jbuild  # noqa: E402
from repro.kernels.gcn_spmm import pad_tile_topology as jpad  # noqa: E402
from repro.kernels.gcn_spmm import spmm_block_sparse_fused as jfused  # noqa: E402
from repro.kernels.gcn_spmm import spmm_block_sparse_fused_t as jfused_t  # noqa: E402
from repro_torch.core import ModelConfig, PipeConfig, PipeGCN  # noqa: E402
from repro_torch.core.pipegcn import params_from_jax  # noqa: E402
from repro_torch.data import GraphDataPipeline  # noqa: E402
from repro_torch.graph.synthetic import model_template  # noqa: E402
from repro_torch.kernels import gcn_spmm  # noqa: E402
from repro_torch.kernels.aggregate import get_engine  # noqa: E402

T = gcn_spmm.TILE
ATOL_F32 = 5e-5          # the JAX fused-engine tests' f32 bar
TOL = 1e-12              # float64 parity
FIELDS = ("rows", "cols", "vals", "t_out", "t_in", "t_perm")


def _shards(R, C, parts=3, density=0.05, seed=0):
    """Random block-sparse shards; the last has one nonzero tile, at (row
    block 0, last column block), so its other row blocks and column blocks
    are empty (zero filler tiles only). Returns the padded JAX tile
    topologies and the dense shards."""
    rng = np.random.default_rng(seed)
    tts, dense = [], []
    for p in range(parts):
        d = (rng.random((R, C)) < density) * rng.normal(size=(R, C)) * 0.3
        if p == parts - 1:
            d[:, :] = 0.0
            d[:T, C - T:] = (rng.random((T, T)) < 0.1) * 0.5
        d = d.astype(np.float32)
        r, c = np.nonzero(d)
        tts.append(jbuild(r, c, d[r, c], R, C))
        dense.append(d)
    n = max(t.n_tiles for t in tts)
    return [jpad(t, n) for t in tts], dense


def _port_tslice(tts, R, C, dtype=torch.float32):
    """The fused engine's Topology fields (the kernels' schedules and the
    tile streams), stacked over partitions."""
    st = {k: np.stack([getattr(t, k) for t in tts]) for k in FIELDS}
    t = {k: torch.from_numpy(v) for k, v in st.items()}
    t["vals"] = t["vals"].to(dtype)
    sch = {k: torch.from_numpy(v) for k, v in gcn_spmm.tile_schedules(
        SimpleNamespace(**st), R, C).items()}
    return (sch["work"], sch["items"], t["rows"], t["cols"], t["vals"],
            sch["t_work"], sch["t_items"], t["t_out"], t["t_in"], t["t_perm"])


def _jax_tslice(tt, dtype):
    return (jnp.asarray(tt.rows), jnp.asarray(tt.cols),
            jnp.asarray(tt.vals, dtype), jnp.asarray(tt.t_out),
            jnp.asarray(tt.t_in), jnp.asarray(tt.t_perm))


# ---------------------------------------------------------------------
# (a) kernel level, float32
# ---------------------------------------------------------------------

@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("with_z", [True, False])
def test_fused_plain_matches_jax_kernel(relu, with_z):
    R, C, FI, FO = 3 * T, 2 * T, 128, 256
    tts, _ = _shards(R, C)
    rng = np.random.default_rng(1)
    h = rng.normal(size=(len(tts), C, FI)).astype(np.float32)
    w = (rng.normal(size=(FI, FO)) / np.sqrt(FI)).astype(np.float32)
    b = rng.normal(size=FO).astype(np.float32)
    ts = _port_tslice(tts, R, C)
    u, z = gcn_spmm.spmm_fused_plain(
        ts[2], ts[3], ts[4], torch.from_numpy(h), torch.from_numpy(w),
        torch.from_numpy(b), R, relu=relu, with_z=with_z)
    assert u.shape == (len(tts), R, FO)
    assert (z is None) == (not with_z)
    for p, tt in enumerate(tts):
        ju, jz = jfused(jnp.asarray(tt.rows), jnp.asarray(tt.cols),
                        jnp.asarray(tt.vals), jnp.asarray(h[p]),
                        jnp.asarray(w), jnp.asarray(b[None]), R, relu=relu,
                        with_z=with_z)
        np.testing.assert_allclose(u[p].numpy(), np.asarray(ju), rtol=0,
                                   atol=ATOL_F32)
        if with_z:
            np.testing.assert_allclose(z[p].numpy(), np.asarray(jz), rtol=0,
                                       atol=ATOL_F32)
    # the last shard's empty row blocks flush u = b (ReLU'd), z = 0
    want = np.maximum(b, 0) if relu else b
    np.testing.assert_allclose(u[-1, T:].numpy(),
                               np.broadcast_to(want, (R - T, FO)), atol=1e-6)
    if with_z:
        assert torch.all(z[-1, T:] == 0)


def test_fused_t_plain_matches_jax_kernel():
    R, C, FI, FO = 2 * T, 3 * T, 256, 128
    tts, dense = _shards(R, C)
    rng = np.random.default_rng(2)
    du = rng.normal(size=(len(tts), R, FO)).astype(np.float32)
    w = (rng.normal(size=(FI, FO)) / np.sqrt(FO)).astype(np.float32)
    ts = _port_tslice(tts, R, C)
    d = gcn_spmm.spmm_fused_t_plain(ts[7], ts[8], ts[9], ts[4],
                                    torch.from_numpy(du), torch.from_numpy(w),
                                    C)
    assert d.shape == (len(tts), C, FI)
    for p, tt in enumerate(tts):
        jd = jfused_t(jnp.asarray(tt.t_out), jnp.asarray(tt.t_in),
                      jnp.asarray(tt.t_perm), jnp.asarray(tt.vals),
                      jnp.asarray(du[p]), jnp.asarray(w), C)
        np.testing.assert_allclose(d[p].numpy(), np.asarray(jd), rtol=0,
                                   atol=ATOL_F32)
        np.testing.assert_allclose(
            d[p].numpy(), dense[p].T.astype(np.float64) @ (du[p] @ w.T),
            rtol=0, atol=ATOL_F32)
    # the last shard's empty column blocks flush δcomb = 0
    assert torch.all(d[-1, :C - T] == 0)


# ---------------------------------------------------------------------
# (b) engine level, float64, ragged widths
# ---------------------------------------------------------------------

@pytest.mark.parametrize("relu,with_z", [(False, True), (True, False),
                                         (True, True)])
def test_fused_engine_matches_jax(relu, with_z):
    R, C, FI, FO = 200, 300, 120, 24
    tts, _ = _shards(R, C, density=0.15, seed=3)
    rng = np.random.default_rng(4)
    comb = rng.normal(size=(len(tts), C, FI))
    w = rng.normal(size=(FI, FO)) / np.sqrt(FI)
    b = rng.normal(size=FO)
    du = rng.normal(size=(len(tts), R, FO))
    eng, jeng = get_engine("fused"), jget_engine("fused")
    ts = _port_tslice(tts, R, C, dtype=torch.float64)
    u, z = eng.aggregate_transform(ts, torch.from_numpy(comb),
                                   torch.from_numpy(w), torch.from_numpy(b),
                                   R, relu=relu, with_z=with_z)
    d = eng.aggregate_transform_t(ts, torch.from_numpy(du),
                                  torch.from_numpy(w), C)
    assert u.shape == (len(tts), R, FO) and d.shape == (len(tts), C, FI)
    for p, tt in enumerate(tts):
        jts = _jax_tslice(tt, jnp.float64)
        ju, jz = jeng.aggregate_transform(jts, jnp.asarray(comb[p]),
                                          jnp.asarray(w), jnp.asarray(b), R,
                                          relu=relu, with_z=with_z)
        np.testing.assert_allclose(u[p].numpy(), np.asarray(ju), rtol=0,
                                   atol=TOL)
        if with_z:
            np.testing.assert_allclose(z[p].numpy(), np.asarray(jz), rtol=0,
                                       atol=TOL)
        else:
            assert z is None and jz is None
        jd = jeng.aggregate_transform_t(jts, jnp.asarray(du[p]),
                                        jnp.asarray(w), C)
        np.testing.assert_allclose(d[p].numpy(), np.asarray(jd), rtol=0,
                                   atol=TOL)


# ---------------------------------------------------------------------
# (c) training steps and the eval forward, float64
# ---------------------------------------------------------------------

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


@pytest.mark.parametrize("kind", ["sage", "gcn"])
@pytest.mark.parametrize("order", ["aggregate-first", "auto"])
def test_fused_steps_and_eval_match_jax(kind, order):
    jp = JPipeline.build("tiny", 4, kind=kind, agg="fused")
    tp = GraphDataPipeline.build("tiny", 4, kind=kind, agg="fused",
                                 device="cpu")
    assert jp.split_spec() is None      # tiny cannot split: both unsplit
    ds = tp.dataset
    cfg = dict(kind=kind, feat_dim=ds.feat_dim, hidden=16, num_layers=3,
               num_classes=ds.num_classes, dropout=0.0, agg="fused",
               matmul_order=order)
    jmodel = JPipeGCN(JModelConfig(**cfg), JPipeConfig.named("pipegcn"))
    tmodel = PipeGCN(ModelConfig(**cfg), PipeConfig.named("pipegcn"))
    jtopo = jax.tree.map(
        lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x,
        jp.topo)
    jdata = jp.train_data._replace(x=jp.train_data.x.astype(jnp.float64))
    ttopo = tp.topo.to(torch.float64)
    tdata = tp.train_data._replace(x=tp.train_data.x.to(torch.float64))
    orders = tmodel.layer_orders(ttopo)
    assert orders == jmodel.layer_orders(jtopo)
    assert orders[:2] == ("aggregate-first",) * 2   # runs both fused kernels
    jparams = jmodel.init_params(jax.random.PRNGKey(0), dtype=jnp.float64)
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                              "cpu")
    jbufs = jmodel.init_buffers(jtopo, dtype=jnp.float64)
    tbufs = tmodel.init_buffers(ttopo, dtype=torch.float64)
    for t in range(3):
        jloss, jgrads, jbufs, jlogits = jmodel.train_step(
            jtopo, jparams, jbufs, jdata, jax.random.PRNGKey(t))
        tloss, tgrads, tbufs, tlogits = tmodel.train_step(
            ttopo, tparams, tbufs, tdata)
        assert abs(float(jloss) - float(tloss)) < TOL, (t, jloss, tloss)
        _assert_tree(jgrads, tgrads, f"step {t} grads")
        _assert_tree(jbufs, tbufs, f"step {t} buffers")
        _assert_tree(jlogits, tlogits, f"step {t} logits")
        jparams = {k: jparams[k] - 0.05 * jgrads[k] for k in jparams}
        tparams = {k: tparams[k] - 0.05 * tgrads[k] for k in tparams}
    jeval = jp.val_data._replace(x=jp.val_data.x.astype(jnp.float64))
    teval = tp.val_data._replace(x=tp.val_data.x.to(torch.float64))
    jloss, jlogits = jmodel.forward(jtopo, jparams, jeval)
    tloss, tlogits = tmodel.forward(ttopo, tparams, teval)
    assert abs(float(jloss) - float(tloss)) < TOL
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=TOL)


def test_gcn_eval_relu_runs_in_the_kernel(monkeypatch):
    """A GCN eval layer under aggregate-first asks the fused kernel for the
    ReLU; a SAGE layer applies it after its self term."""
    tp = GraphDataPipeline.build("tiny", 2, kind="gcn", agg="fused",
                                 device="cpu")
    ds = tp.dataset
    seen = []
    real = gcn_spmm.spmm_fused

    def spy(*args, relu=False, with_z=True):
        seen.append((relu, with_z))
        return real(*args, relu=relu, with_z=with_z)

    monkeypatch.setattr(gcn_spmm, "spmm_fused", spy)
    for kind, want in (("gcn", [(True, False), (True, False), (False, False)]),
                       ("sage", [(False, False)] * 3)):
        seen.clear()
        model = PipeGCN(ModelConfig(kind=kind, feat_dim=ds.feat_dim,
                                    hidden=8, num_layers=3,
                                    num_classes=ds.num_classes, dropout=0.0,
                                    agg="fused",
                                    matmul_order="aggregate-first"),
                        PipeConfig())
        params = model.init_params(torch.Generator().manual_seed(0))
        model.forward(tp.topo, params, tp.val_data)
        assert seen == want, kind


@pytest.mark.parametrize("kind", ["sage", "gcn"])
def test_fused_engine_hands_the_kernels_contiguous_operands(kind, monkeypatch):
    """The CUDA wrappers refuse strided operands rather than copy them; the
    engine's operands on the training and eval path (SAGE's row slice
    w[:fin], dropout-masked inputs, the backward's du) are contiguous."""
    tp = GraphDataPipeline.build("tiny", 2, kind=kind, agg="fused",
                                 device="cpu")
    ds = tp.dataset
    seen = []
    real_fwd, real_t = gcn_spmm.spmm_fused, gcn_spmm.spmm_fused_t

    def fwd(work, items, rows, cols, vals, h, w, b, num_rows, **kw):
        seen.append(("fwd", [t.is_contiguous() for t in (h, w, b)]))
        return real_fwd(work, items, rows, cols, vals, h, w, b, num_rows,
                        **kw)

    def bwd(t_work, t_items, t_out, t_in, t_perm, vals, du, w, num_cols):
        seen.append(("bwd", [t.is_contiguous() for t in (du, w)]))
        return real_t(t_work, t_items, t_out, t_in, t_perm, vals, du, w,
                      num_cols)

    monkeypatch.setattr(gcn_spmm, "spmm_fused", fwd)
    monkeypatch.setattr(gcn_spmm, "spmm_fused_t", bwd)
    model = PipeGCN(ModelConfig(kind=kind, feat_dim=ds.feat_dim, hidden=8,
                                num_layers=3, num_classes=ds.num_classes,
                                dropout=0.5, agg="fused",
                                matmul_order="aggregate-first"),
                    PipeConfig.named("pipegcn"))
    gen = torch.Generator().manual_seed(0)
    params = model.init_params(gen)
    model.train_step(tp.topo, params, model.init_buffers(tp.topo),
                     tp.train_data, gen)
    model.forward(tp.topo, params, tp.val_data)
    assert [k for k, _ in seen] == ["fwd"] * 3 + ["bwd"] * 2 + ["fwd"] * 3
    assert all(all(c) for _, c in seen), seen


# ---------------------------------------------------------------------
# (d) layer orders
# ---------------------------------------------------------------------

class _Shapes:
    """The shapes of a port Topology that the order choice reads, as numpy
    arrays the JAX package's `layer_orders` takes."""

    def __init__(self, topo):
        self.max_inner, self.halo_size = topo.max_inner, topo.halo_size
        self.tile_rows = np.zeros(tuple(topo.tile_rows.shape), np.int32)
        self.edge_row = np.zeros(tuple(topo.edge_row.shape), np.int32)


@pytest.mark.parametrize("dataset", ["tiny", "reddit-sim", "yelp-sim"])
def test_fused_layer_orders_match_jax(dataset):
    tp = GraphDataPipeline.build(dataset, 4, kind="sage", agg="fused",
                                 device="cpu")
    ds = tp.dataset
    tpl = (dict(hidden=16, num_layers=3) if dataset == "tiny"
           else model_template(dataset))
    shapes = _Shapes(tp.topo)
    got = {}
    for agg in ("blocksparse", "fused"):
        cfg = dict(kind="sage", feat_dim=ds.feat_dim, hidden=tpl["hidden"],
                   num_layers=tpl["num_layers"], num_classes=ds.num_classes,
                   agg=agg, matmul_order="auto")
        tmodel = PipeGCN(ModelConfig(**cfg), PipeConfig())
        jmodel = JPipeGCN(JModelConfig(**cfg), JPipeConfig())
        for train in (True, False):
            o = tmodel.layer_orders(tp.topo, train=train)
            assert o == jmodel.layer_orders(shapes, train=train), (agg, train)
            got[agg, train] = o
    if dataset != "tiny":
        # pricing the fused kernels moves layers 1-2 of training to
        # transform-first; evaluation keeps aggregate-first there
        a, t = "aggregate-first", "transform-first"
        assert got["blocksparse", True] == (a, a, a, t)
        assert got["fused", True] == (a, t, t, t)
        assert got["fused", False] == got["blocksparse", False] == (a, a, a, t)
