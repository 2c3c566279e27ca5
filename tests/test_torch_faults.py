"""The port's fault injection and guarded exchange against the JAX
package's, on the CPU in float64.

Both packages build the `tiny` P = 4 graph of tests/test_faults.py
(GraphSAGE, hidden 16, 3 layers, dropout 0) from byte-identical numpy
arrays and start from the same parameters. Checked here:

- fault tables: `FaultPlan.compile` gives JAX's drop and corrupt tables
  byte for byte (sites, delay, background rates, device_down), and the
  validation errors are JAX's;
- checksum wires: `ChecksumCodec.encode` gives JAX's bytes for every
  wire at widths 16, 120 and 257, and `decode_checked` JAX's valid rows
  on tampered wires;
- zero-fault identity: the guarded step equals the unguarded one
  bitwise, and JAX's guarded step to 1e-12 with "es" equal;
- drops: JAX's fallback scenarios give buffers and gradients within
  1e-12 of JAX's and "es" equal to JAX's element for element;
- corrupt faults, by behaviour (their bits come from torch.Generator,
  not jax.random): the flipped site alone falls back, the guarded run
  stays finite, the unguarded run lands the garbage;
- the trainer: the three `BENCH_9.json` degraded cells give JAX's
  fallback counts, and a staleness overrun raises JAX's error at JAX's
  epoch.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

jax.config.update("jax_enable_x64", True)

from repro.core import codec as jcodec  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core.config import ModelConfig as JModelConfig  # noqa: E402
from repro.core.config import PipeConfig as JPipeConfig  # noqa: E402
from repro.core.pipegcn import PipeGCN as JPipeGCN  # noqa: E402
from repro.core.pipegcn import shard_data as jshard_data  # noqa: E402
from repro.core.pipegcn import topology_from as jtopology_from  # noqa: E402
from repro.graph import build_partitioned_graph as jbuild_pg  # noqa: E402
from repro.graph import make_dataset as jmake_dataset  # noqa: E402
from repro.graph import partition_graph as jpartition  # noqa: E402
from repro.graph.csr import mean_normalized as jmean_normalized  # noqa: E402
from repro_torch.core import codec  # noqa: E402
from repro_torch.core import faults  # noqa: E402
from repro_torch.core.config import ModelConfig, PipeConfig  # noqa: E402
from repro_torch.core.faults import (BWD, FWD, FaultPlan,  # noqa: E402
                                     FaultSite, StalenessExceededError)
from repro_torch.core.pipegcn import (PipeGCN, params_from_jax,  # noqa: E402
                                      shard_data, topology_from)
from repro_torch.graph import (build_partitioned_graph,  # noqa: E402
                               make_dataset, partition_graph)
from repro_torch.graph.csr import mean_normalized  # noqa: E402

TOL = 1e-12
P = 4
ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's small tensors: under the
    suite's parallel workers, several threads per worker oversubscribe
    the cores and a tiny training step then takes seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """tests/test_faults.py's tiny P = 4 setup in both packages, f64."""
    jds = jmake_dataset("tiny")
    jpg = jbuild_pg(jmean_normalized(jds.graph),
                    jpartition(jds.graph, P, seed=0), P)
    jtopo = jtopology_from(jpg, with_tiles=True)
    jtopo = jtopo._replace(edge_w=jtopo.edge_w.astype(jnp.float64),
                           tile_vals=jtopo.tile_vals.astype(jnp.float64))
    jdata = jshard_data(jpg, jds.features.astype(np.float64), jds.labels,
                        jds.train_mask, jds.val_mask)
    jdata = jdata._replace(x=jdata.x.astype(jnp.float64))
    ds = make_dataset("tiny")
    pg = build_partitioned_graph(mean_normalized(ds.graph),
                                 partition_graph(ds.graph, P, seed=0), P)
    topo = topology_from(pg, with_tiles=True, device="cpu").to(torch.float64)
    data = shard_data(pg, ds.features, ds.labels, ds.train_mask, ds.val_mask,
                      device="cpu")
    data = data._replace(x=data.x.to(torch.float64))
    return ds, (jtopo, jdata), (topo, data)


def _models(ds, agg="coo", variant="pipegcn", **pipe_kw):
    cfg = dict(kind="sage", feat_dim=ds.feat_dim, hidden=16, num_layers=3,
               num_classes=ds.num_classes, dropout=0.0, agg=agg)
    jpc = dataclasses.replace(JPipeConfig.named(variant, gamma=0.9),
                              **pipe_kw)
    pc = dataclasses.replace(PipeConfig.named(variant, gamma=0.9), **pipe_kw)
    return JPipeGCN(JModelConfig(**cfg), jpc), PipeGCN(ModelConfig(**cfg), pc)


def _params(jmodel):
    jp = jmodel.init_params(jax.random.PRNGKey(0), dtype=jnp.float64)
    return jp, params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                               "cpu")


def _assert_tree(jtree, ttree, what):
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree), what
        for k in jtree:
            _assert_tree(jtree[k], ttree[k], f"{what}/{k}")
    elif isinstance(jtree, (tuple, list)):
        assert len(jtree) == len(ttree), what
        for i, (a, b) in enumerate(zip(jtree, ttree)):
            _assert_tree(a, b, f"{what}[{i}]")
    elif jtree.dtype == jnp.int32:
        np.testing.assert_array_equal(ttree.numpy(), np.asarray(jtree),
                                      err_msg=what)
    else:
        assert ttree.shape == jtree.shape, what
        np.testing.assert_allclose(ttree.numpy(), np.asarray(jtree),
                                   rtol=0, atol=TOL, err_msg=what)


def _bitwise(a, b, what):
    if isinstance(a, dict):
        assert set(a) <= set(b), what
        for k in a:
            _bitwise(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            _bitwise(x, y, f"{what}[{i}]")
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), what


# ---------------------------------------------------------------------------
# fault tables and validation
# ---------------------------------------------------------------------------

def _sites(mod):
    return (mod.FaultSite(step=1, layer=2, src=0, dst=3),
            mod.FaultSite(step=0, layer=1, src=2, dst=1, direction="bwd"),
            mod.FaultSite(step=3, layer=0, src=1, dst=0, kind="corrupt"),
            mod.FaultSite(step=2, layer=2, src=3, dst=2, direction="bwd",
                          kind="delay"),
            mod.FaultSite(step=9, layer=0, src=0, dst=1))   # past horizon


# (plan kwargs builder, compile kwargs): explicit sites in both directions
# with delay, background rates of every kind and seed, device_down over
# one and two partitions per device
TABLE_CASES = [
    (lambda m: dict(sites=_sites(m)), {}),
    (lambda m: dict(rate=0.3, seed=7), {}),
    (lambda m: dict(rate=0.1, seed=1, rate_kind="corrupt"), {}),
    (lambda m: dict(rate=0.2, seed=3, rate_kind="delay",
                    sites=_sites(m)), {}),
    (lambda m: dict(sites=(m.device_down_site(step=1, device=2),)), {}),
    (lambda m: dict(sites=(m.device_down_site(step=2, device=1, until=4),
                           m.FaultSite(step=0, layer=0, src=0, dst=1))),
     {"parts_per_device": 2}),
]


@pytest.mark.parametrize("plan_kw,compile_kw", TABLE_CASES)
def test_fault_tables_match_jax(plan_kw, compile_kw):
    jt = jfaults.FaultPlan(**plan_kw(jfaults)).compile(5, 3, P, **compile_kw)
    tt = FaultPlan(**plan_kw(faults)).compile(5, 3, P, **compile_kw)
    for name in ("drop", "corrupt"):
        want = np.asarray(getattr(jt, name))
        np.testing.assert_array_equal(getattr(tt, name + "_np"), want)
        np.testing.assert_array_equal(getattr(tt, name).numpy(), want)
    assert tt.density == pytest.approx(float(jt.density))


# constructions that raise in JAX; each must raise the same in the port
BAD_PLANS = [
    lambda m: m.FaultPlan(rate=1.5),
    lambda m: m.FaultPlan(rate_kind="meteor"),
    lambda m: m.FaultPlan(density=0.0),
    lambda m: m.FaultSite(step=0, layer=0, src=0, dst=1,
                          direction="sideways"),
    lambda m: m.FaultSite(step=0, layer=0, src=0, dst=1, kind="gamma-ray"),
    lambda m: m.FaultSite(step=0, layer=0, src=0, dst=1, until=3),
    lambda m: m.device_down_site(step=2, device=0, until=2),
    lambda m: m.FaultPlan(sites=(m.FaultSite(step=0, layer=9, src=0,
                                             dst=1),)).compile(4, 3, P),
    lambda m: m.FaultPlan(sites=(m.device_down_site(step=0, device=2),)
                          ).compile(4, 3, P, parts_per_device=2),
    lambda m: m.FaultPlan(sites=(m.device_down_site(step=0, device=0),)
                          ).compile(4, 3, 3, parts_per_device=2),
]


@pytest.mark.parametrize("bad", BAD_PLANS)
def test_fault_validation_matches_jax(bad):
    with pytest.raises(ValueError) as jerr:
        bad(jfaults)
    with pytest.raises(ValueError) as terr:
        bad(faults)
    assert str(terr.value) == str(jerr.value)


def test_plan_queries_match_jax():
    for mod in (jfaults, faults):
        plan = mod.FaultPlan(sites=(mod.device_down_site(1, 2, until=3),
                                    mod.device_down_site(2, 0),
                                    mod.FaultSite(0, 0, 0, 1)))
        assert mod.FaultPlan().is_empty() and not plan.is_empty()
        assert not mod.FaultPlan(rate=0.1).is_empty()
        assert [plan.downed_devices(s) for s in range(4)] == [
            frozenset(), {2}, {0, 2}, {0}]
        assert plan.without_device_down().sites == (mod.FaultSite(0, 0, 0,
                                                                  1),)


# ---------------------------------------------------------------------------
# checksum wires
# ---------------------------------------------------------------------------

def _payload(f, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, P, 3, f)).astype(np.float32)
    x[0, 1, 2] = 0.0                       # an all-zero row
    x[1, 2, 0, :3] = [1e30, -1e-30, 7.5]   # extreme magnitudes
    return x


def _bytes(w):
    """The raw bytes of a JAX array or a tensor, as numpy uint8."""
    if isinstance(w, torch.Tensor):
        return w.contiguous().view(torch.uint8).numpy()
    return np.asarray(w).view(np.uint8)


@pytest.mark.parametrize("f", [16, 120, 257])
@pytest.mark.parametrize("wire", ["f32", "bf16", "int8", "int4"])
def test_checksum_wire_matches_jax(wire, f):
    x = _payload(f)
    jw = jcodec.make_codec(wire, guard=True).encode(jnp.asarray(x))
    c = codec.make_codec(wire, guard=True)
    tw = c.encode(torch.from_numpy(x))
    assert c.wire_width(f) == tw.shape[-1] == jw.shape[-1]
    assert c.wire_bytes(f) == jcodec.make_codec(wire, guard=True).wire_bytes(f)
    np.testing.assert_array_equal(_bytes(tw), _bytes(jw))
    np.testing.assert_array_equal(
        codec.row_checksum(tw[..., :-1]).numpy(),
        np.asarray(jcodec.row_checksum(jw[..., :-1])))


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8", "int4"])
def test_decode_checked_matches_jax(wire):
    """Tampered wires: a flipped payload byte, a changed checksum column,
    a NaN payload element and a NaN checksum column (float wires), and a
    tamper that keeps the sum (two bytes moved by +1 and -1): the valid
    rows and the decoded payload equal JAX's."""
    for f in (16, 257):
        x = _payload(f, seed=f)
        raw = _bytes(jcodec.make_codec(wire, guard=True).encode(
            jnp.asarray(x))).copy()
        it = 1 if wire in ("int8", "int4") else (2 if wire == "bf16" else 4)
        row = raw.reshape(-1, raw.shape[-1])
        row[0, 0] ^= 0x10                          # payload byte
        row[1, -1] ^= 0x01                         # checksum column
        row[2, 3] = (int(row[2, 3]) + 1) % 256     # sum kept when both
        row[2, 5] = (int(row[2, 5]) - 1) % 256     # stay in range
        if wire in ("f32", "bf16"):
            nan = np.array([np.nan], np.float32).view(np.uint8)
            if wire == "f32":
                row[3, 4:8] = nan                  # NaN payload element
                row[4, -4:] = nan                  # NaN checksum column
            else:
                row[3, 2:4] = nan[2:4]             # bf16 NaN (high half)
                row[4, -2:] = nan[2:4]
        dt = {"f32": np.float32, "int8": np.uint8, "int4": np.uint8}.get(wire)
        jwire = (jnp.asarray(raw.view(dt)) if dt is not None else
                 jax.lax.bitcast_convert_type(
                     jnp.asarray(raw.view(np.uint16)), jnp.bfloat16))
        tdt = {"f32": torch.float32, "bf16": torch.bfloat16}.get(
            wire, torch.uint8)
        twire = torch.from_numpy(raw).view(tdt)
        assert it * twire.shape[-1] == raw.shape[-1]
        jpay, jvalid = jcodec.make_codec(wire, guard=True).decode_checked(
            jwire, f, jnp.float32)
        tpay, tvalid = codec.make_codec(wire, guard=True).decode_checked(
            twire, f, torch.float32)
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
        assert not tvalid.reshape(-1)[:2].any()
        ok = tvalid.numpy()
        np.testing.assert_array_equal(tpay.numpy()[ok],
                                      np.asarray(jpay)[ok])


# ---------------------------------------------------------------------------
# zero-fault identity
# ---------------------------------------------------------------------------

PARITY_CELLS = [
    ("pipegcn", "coo", {}),
    ("pipegcn", "blocksparse", {}),
    ("pipegcn-gf", "coo", {}),
    ("pipegcn", "coo", {"staleness_steps": 3}),
    ("pipegcn", "coo", {"wire": "bf16"}),
    ("pipegcn", "coo", {"wire": "int8"}),
    ("pipegcn-g", "blocksparse", {"wire": "int4"}),
    ("pipegcn", "coo", {"fuse_exchange": False}),
    ("pipegcn", "coo", {"wire": "auto", "staleness_steps": 2}),
]


@pytest.mark.parametrize("variant,agg,pipe_kw", PARITY_CELLS)
def test_guard_zero_fault_identity(setup, variant, agg, pipe_kw):
    """tests/test_faults.py's PARITY_CELLS: the guarded port step equals
    the unguarded one bitwise (loss, gradients, every feat/grad leaf) and
    JAX's guarded step to 1e-12, with "es" all zero and equal."""
    ds, (jtopo, jdata), (topo, data) = setup
    _, ref = _models(ds, agg, variant, **pipe_kw)
    jgrd, grd = _models(ds, agg, variant, guard_exchange=True, **pipe_kw)
    jparams, params = _params(jgrd)
    b_ref = ref.init_buffers(topo, dtype=torch.float64)
    b_grd = grd.init_buffers(topo, dtype=torch.float64)
    jb = jgrd.init_buffers(jtopo, dtype=jnp.float64)
    steps = 5 if pipe_kw.get("staleness_steps", 1) > 1 else 3
    for t in range(steps):
        l0, g0, b_ref, _ = ref.train_step(topo, params, b_ref, data)
        l1, g1, b_grd, _ = grd.train_step(topo, params, b_grd, data)
        jl, jg, jb, _ = jgrd.train_step(jtopo, jparams, jb, jdata,
                                        jax.random.PRNGKey(t))
        assert torch.equal(l0, l1), (pipe_kw, t)
        _bitwise(g0, g1, f"{pipe_kw} step {t} grads")
        _bitwise(b_ref, b_grd, f"{pipe_kw} step {t} buffers")
        assert int(b_grd["es"].max()) == 0
        assert abs(float(jl) - float(l1)) < TOL
        _assert_tree(jg, g1, f"step {t} grads vs JAX")
        _assert_tree(jb, b_grd, f"step {t} buffers vs JAX")


# ---------------------------------------------------------------------------
# drops against JAX
# ---------------------------------------------------------------------------

def _run_faulted(setup, plan_kw, steps, horizon, **model_kw):
    """`steps` guarded steps of both packages under the same plan (fixed
    parameters, as tests/test_faults.py runs them); each step's loss,
    gradients, buffers and "es" against JAX's. Returns the port's es per
    step and its buffers before each step."""
    ds, (jtopo, jdata), (topo, data) = setup
    jm, tm = _models(ds, guard_exchange=True, **model_kw)
    jtab = jfaults.FaultPlan(**plan_kw(jfaults)).compile(horizon, 3, P)
    ttab = FaultPlan(**plan_kw(faults)).compile(horizon, 3, P)
    jparams, params = _params(jm)
    jb = jm.init_buffers(jtopo, dtype=jnp.float64)
    tb = tm.init_buffers(topo, dtype=torch.float64)
    es, before = [], []
    for t in range(steps):
        before.append(tb)
        jl, jg, jb, _ = jm.train_step(jtopo, jparams, jb, jdata,
                                      jax.random.PRNGKey(t), jnp.int32(t),
                                      jtab)
        tl, tg, tb, _ = tm.train_step(topo, params, tb, data, step_idx=t,
                                      faults=ttab)
        assert abs(float(jl) - float(tl)) < TOL, t
        _assert_tree(jg, tg, f"step {t} grads")
        _assert_tree(jb, tb, f"step {t} buffers")
        es.append(tb["es"].numpy())
    return es, before + [tb]


@pytest.mark.parametrize("fuse", [True, False])
def test_dropped_feature_falls_back_like_jax(setup, fuse):
    """tests/test_faults.py's forward drop (step 1, layer 1, 0 -> 2):
    JAX's numbers, and partition 2's rows from peer 0 keep their value."""
    plan = lambda m: dict(sites=(m.FaultSite(step=1, layer=1, src=0, dst=2,
                                             direction="fwd", kind="drop"),))
    es, bufs = _run_faulted(setup, plan, 3, 4, fuse_exchange=fuse)
    assert es[1][2, FWD, 1, 0] == 1 and es[1].sum() == 1
    assert es[0].sum() == 0 and es[2].sum() == 0
    slot = setup[2][0].slot
    assert torch.equal(bufs[2]["feat"][1][2, :slot],
                       bufs[1]["feat"][1][2, :slot])


def test_consecutive_drops_accumulate_es_like_jax(setup):
    """Three backward drops in a row (layer 2, 1 -> 0): es 1, 2, 3, 0."""
    plan = lambda m: dict(sites=tuple(
        m.FaultSite(step=t, layer=2, src=1, dst=0, direction="bwd",
                    kind="drop") for t in range(3)))
    es, _ = _run_faulted(setup, plan, 4, 5, max_staleness=8)
    assert [int(e[0, BWD, 2, 1]) for e in es] == [1, 2, 3, 0]


@pytest.mark.parametrize("model_kw", [{"wire": "int8"},
                                      {"staleness_steps": 2}])
def test_background_drops_match_jax(setup, model_kw):
    """A 10% background drop plan under the int8 wire and under a 2-deep
    FIFO: 4 steps equal JAX's, es included."""
    es, _ = _run_faulted(setup, lambda m: dict(rate=0.1, seed=5), 4, 4,
                         **model_kw)
    assert sum(int((e > 0).sum()) for e in es) > 0


# ---------------------------------------------------------------------------
# corrupt faults, by behaviour
# ---------------------------------------------------------------------------

def test_apply_faults_bytes():
    """Drops zero the rows and set the checksum column to 1; flips touch
    only the faulted destinations, about `density` of their bytes, always
    changing a chosen byte; the bytes do not depend on how the sources
    are split into leading-axis slots (sim vs SPMD ranks)."""
    plan = FaultPlan(sites=(FaultSite(0, 1, 2, 3, kind="corrupt"),
                            FaultSite(0, 1, 2, 0, kind="corrupt"),
                            FaultSite(0, 1, 1, 2, kind="drop")),
                     density=0.25, seed=4)
    tab = plan.compile(2, 3, P)
    wire = codec.make_codec("f32", guard=True).encode(
        torch.from_numpy(_payload(64).repeat(2, 0)))     # (4, P, 3, 65)
    out = faults.apply_faults(wire, tab, 0, FWD, 1, range(P), True)
    assert torch.equal(out[1, 2, ..., :-1], torch.zeros_like(out[1, 2,
                                                                 ..., :-1]))
    assert (out[1, 2, ..., -1] == 1).all()
    changed = _bytes(out) != _bytes(wire)
    assert changed[2, 3].any() and changed[2, 0].any()
    keep = np.ones(changed.shape[:2], bool)
    keep[2, 3] = keep[2, 0] = keep[1, 2] = False
    assert not changed[keep].any()
    share = changed[2, 3].mean()
    assert 0.15 < share < 0.35, share
    halves = [faults.apply_faults(wire[r:r + 2], tab, 0, FWD, 1,
                                  range(r, r + 2), True) for r in (0, 2)]
    assert torch.equal(torch.cat(halves), out)
    assert faults.apply_faults(wire, tab, 0, BWD, 1, range(P), True) is wire


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
def test_corrupt_site_alone_falls_back(setup, wire):
    """A corrupt site (layer 1 forward, 3 -> 1): the rows whose flips
    change their checksum are flagged and keep their stale value, that
    (dst, dir, layer, src) entry alone counts a fallback, and every other
    peer's rows equal the clean run's."""
    from repro_torch.core.pipegcn import SimBackend

    class Capture(SimBackend):
        def __init__(self):
            super().__init__()
            self.sent = []

        def exchange(self, s):
            self.sent.append(s)
            return super().exchange(s)

    ds, _, (topo, data) = setup
    _, m = _models(ds, wire=wire, guard_exchange=True, fuse_exchange=False)
    plan = FaultPlan(sites=(FaultSite(step=0, layer=1, src=3, dst=1,
                                      direction="fwd", kind="corrupt"),),
                     density=0.2, seed=3)
    tab = plan.compile(2, 3, P)
    params = m.init_params(torch.Generator().manual_seed(0),
                           dtype=torch.float64)
    bufs = m.init_buffers(topo, dtype=torch.float64)
    cap = Capture()
    _, _, got, _ = m.train_step(topo, params, bufs, data, backend=cap,
                                step_idx=0, faults=tab)
    _, _, clean, _ = m.train_step(topo, params, bufs, data)
    c = m.wire_codecs(topo)[1]
    valid = c.decode_checked(cap.sent[1][3, 1], 16, torch.float64)[1]
    assert (~valid).sum() > 0, wire
    es = got["es"].numpy()
    assert es[1, FWD, 1, 3] == 1 and es.sum() == 1, wire
    rows = slice(3 * topo.slot, 4 * topo.slot)
    assert torch.equal(got["feat"][1][1, rows][~valid],
                       bufs["feat"][1][1, rows][~valid])
    mask = torch.ones(got["feat"][1].shape[:2], dtype=torch.bool)
    mask[1, rows] = False
    assert torch.equal(got["feat"][1][mask], clean["feat"][1][mask])


def test_corrupt_plan_guarded_stays_finite_unguarded_lands_garbage(setup):
    """A 20% background corrupt plan at density 0.5 under the f32 wire:
    the guarded run's 3 steps stay finite and count fallbacks; the
    unguarded run lands the flipped rows (non-finite or far from the
    clean run), as JAX's unguarded drop lands zeros."""
    ds, _, (topo, data) = setup
    tab = FaultPlan(rate=0.2, rate_kind="corrupt", seed=2,
                    density=0.5).compile(3, 3, P)
    _, grd = _models(ds, guard_exchange=True)
    _, raw = _models(ds)
    params = grd.init_params(torch.Generator().manual_seed(0),
                             dtype=torch.float64)
    bg = grd.init_buffers(topo, dtype=torch.float64)
    br = raw.init_buffers(topo, dtype=torch.float64)
    bc = raw.init_buffers(topo, dtype=torch.float64)
    fallbacks = 0
    for t in range(3):
        lg, gg, bg, _ = grd.train_step(topo, params, bg, data, step_idx=t,
                                       faults=tab)
        _, _, br, _ = raw.train_step(topo, params, br, data, step_idx=t,
                                     faults=tab)
        _, _, bc, _ = raw.train_step(topo, params, bc, data)
        fallbacks += int((bg["es"] > 0).sum())
        assert torch.isfinite(lg)
        for x in list(gg.values()) + list(bg["feat"]) + list(bg["grad"]):
            assert torch.isfinite(x).all(), t
    assert fallbacks > 0
    assert "es" not in br
    diff = [(a - b).abs().nan_to_num(nan=float("inf")).max()
            for a, b in zip(br["feat"], bc["feat"])]
    assert max(diff) > 1.0, diff


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def test_bench9_degraded_counts():
    """`BENCH_9.json` meta.faults.degraded on the port's trainer: tiny
    P = 4, hidden 32, 3 layers, FaultPlan(rate 0.05, drop, seed 1), 30
    epochs (benchmarks/bench_faults.py's cells): exchange_fallbacks and
    max_effective_staleness equal the recorded ones."""
    from repro_torch.core import train_pipegcn
    from repro_torch.data import GraphDataPipeline
    with open(os.path.join(ROOT, "benchmarks", "baselines",
                           "BENCH_9.json")) as f:
        meta = json.load(f)["meta"]["faults"]
    tp = GraphDataPipeline.build(meta["dataset"], P, kind="sage",
                                 device="cpu")
    ds = tp.dataset
    mc = ModelConfig(kind="sage", feat_dim=ds.feat_dim, hidden=32,
                     num_layers=3, num_classes=ds.num_classes, dropout=0.0,
                     multilabel=ds.multilabel)
    assert len(meta["degraded"]) == 3
    for cell, want in meta["degraded"].items():
        variant, wire, k = cell.split("/")
        k = int(k[1:])
        pc = dataclasses.replace(PipeConfig.named(variant, gamma=0.95),
                                 wire=wire, staleness_steps=k,
                                 guard_exchange=True,
                                 max_staleness=max(8, k + 4))
        res = train_pipegcn(tp, mc, pc, epochs=meta["epochs"],
                            eval_every=meta["epochs"], device="cpu",
                            faults=FaultPlan(rate=0.05, rate_kind="drop",
                                             seed=1))
        assert res.anomalies["exchange_fallbacks"] == want["fallbacks"], cell
        assert res.anomalies["max_effective_staleness"] == want["es_max"], \
            cell


def test_staleness_overrun_raises_like_jax():
    """Forward drops 0 -> 2 at layer 1 for 5 steps with max_staleness 3:
    the port's trainer raises StalenessExceededError at the JAX trainer's
    epoch with its message, after the same fallback count."""
    from repro.core.trainer import train_pipegcn as jtrain
    from repro.data import GraphDataPipeline as JPipeline
    from repro_torch.core import train_pipegcn
    from repro_torch.data import GraphDataPipeline
    jp = JPipeline.build("tiny", P)
    tp = GraphDataPipeline.build("tiny", P, device="cpu")
    ds = tp.dataset
    cfg = dict(kind="sage", feat_dim=ds.feat_dim, hidden=16, num_layers=3,
               num_classes=ds.num_classes, dropout=0.0)
    msgs = []
    for mod, train, pipe, mcfg, pcfg, kw in (
            (jfaults, jtrain, jp, JModelConfig, JPipeConfig, {}),
            (faults, train_pipegcn, tp, ModelConfig, PipeConfig,
             {"device": "cpu"})):
        plan = mod.FaultPlan(sites=tuple(
            mod.FaultSite(step=t, layer=1, src=0, dst=2) for t in range(5)))
        pc = pcfg(guard_exchange=True, max_staleness=3)
        lines = []
        with pytest.raises(mod.StalenessExceededError) as err:
            train(pipe, mcfg(**cfg), pc, epochs=6, eval_every=1,
                  faults=plan, log=lines.append, **kw)
        msgs.append((str(err.value), [ln for ln in lines
                                      if ln.startswith("epoch")]))
    assert msgs[1][0] == msgs[0][0]
    assert "at epoch 2" in msgs[0][0]
    fallbacks = [[ln.split(" fallbacks ")[1] for ln in m[1]] for m in msgs]
    assert fallbacks[1] == fallbacks[0] == ["1 es 2/3", "2 es 3/3"]
    assert issubclass(StalenessExceededError, RuntimeError)
