"""The port's elastic runtime (`core/elastic.py`, the trainer's recovery
and rejoin) against the JAX package's, on the CPU.

The plan algebra, the remaps, `warm_mark`, `mask_pad_faults` and
`detect_device_loss` equal JAX's arrays bitwise (the inputs seeded with
numpy). The port's Topology also carries the CUDA kernels' schedules: on
the padded layout the real partitions keep their forward schedule bit for
bit and their transpose schedule gains one empty item per column block
the pads' halo slots add; each pad has the schedule `tile_schedule` gives
an all-zero partition; the result is the schedules of the padded tile
streams, and the kernels' item walk (emulated here in float64) writes
every output row. The trainer's drill matches JAX's: the same device
losses, histories within the Adam parity bar (its update is float32 in
both packages), and the padded-layout step within 1e-12 in float64.
Recovery equals a fresh survivor-layout launch from the same checkpoint
bitwise; `BENCH_10.json`'s drill gives its ints. The gloo drills are in
tests/test_torch_elastic_spmd.py.
"""
import dataclasses
import json
import os
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

jax.config.update("jax_enable_x64", True)

from _hypothesis_compat import given, settings, st  # noqa: E402
from repro.core import elastic as jel  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core.config import ModelConfig as JModelConfig  # noqa: E402
from repro.core.config import PipeConfig as JPipeConfig  # noqa: E402
from repro.core.pipegcn import PipeGCN as JPipeGCN  # noqa: E402
from repro.core.trainer import train_pipegcn as jtrain  # noqa: E402
from repro.data import GraphDataPipeline as JPipeline  # noqa: E402
from repro.launch.mesh import partition_layout as jpartition_layout  # noqa: E402
from repro_torch.core import (DeviceLossError, ElasticConfig,  # noqa: E402
                              ElasticPlan, FaultPlan, ModelConfig,
                              PipeConfig, PipeGCN, device_down_site,
                              params_from_jax, train_pipegcn)
from repro_torch.core import elastic as tel  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core.faults import FWD  # noqa: E402
from repro_torch.core.health import health_check  # noqa: E402
from repro_torch.core.pipegcn import SimBackend  # noqa: E402
from repro_torch.core.trace_utils import (RecordingBackend,  # noqa: E402
                                          expected_boundary_collectives)
from repro_torch.data import GraphDataPipeline  # noqa: E402
from repro_torch.kernels import gcn_spmm  # noqa: E402
from repro_torch.launch.mesh import (make_survivor_group,  # noqa: E402
                                     partition_layout, survivor_ranks)

P = 4
T = gcn_spmm.TILE
ROOT = os.path.join(os.path.dirname(__file__), "..")
# Adam's moments and update are float32 in both packages (XLA contracts
# the update into FMAs), so trainer histories agree to float32 rounding:
# the bar of tests/test_torch_trainer.py::test_adam_steps_match_jax
ADAM_TOL = 1e-6
TOL = 1e-12
# plans on P = 4: one device of four lost (uneven: 2 pads), two of four
# lost (even), and 2 partitions per device with one of two lost
PLANS = [(4, (0, 2, 3)), (4, (1, 3)), (2, (0,))]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's small tensors (the suite runs
    several workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pipes():
    """tiny P = 4 with tiles, in both packages."""
    return (JPipeline.build("tiny", P, seed=0, agg="blocksparse"),
            GraphDataPipeline.build("tiny", P, seed=0, agg="blocksparse",
                                    device="cpu"))


@pytest.fixture(scope="module")
def pipeline():
    return GraphDataPipeline.build("tiny", P, seed=0, device="cpu")


def _plans(orig, survivors):
    return (jel.ElasticPlan(P, orig, survivors),
            ElasticPlan(P, orig, survivors))


def _same(j, t, what):
    """A JAX array and a port tensor (or numpy array) are equal bitwise."""
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert j.shape == t.shape and j.dtype == t.dtype, (what, j.shape, t.shape)
    assert np.array_equal(j, t), what


def _bitwise(a, b, what=""):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _bitwise(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _bitwise(x, y, f"{what}[{i}]")
    elif a is None:
        assert b is None, what
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), what


def _cfgs(pipeline, **pipe_kw):
    ds = pipeline.dataset
    mc = ModelConfig(kind="sage", feat_dim=ds.feat_dim, hidden=16,
                     num_layers=3, num_classes=ds.num_classes, dropout=0.0,
                     agg=pipeline.agg)
    pipe_kw.setdefault("guard_exchange", True)
    pipe_kw.setdefault("max_staleness", 8)
    return mc, dataclasses.replace(PipeConfig.named("pipegcn"), **pipe_kw)


# ---------------------------------------------------------------------------
# plan algebra and validation
# ---------------------------------------------------------------------------

@settings(max_examples=40)
@given(n_local=st.sampled_from([1, 2, 4]),
       orig=st.integers(min_value=2, max_value=5),
       mask=st.integers(min_value=1, max_value=31))
def test_plan_algebra_matches_jax(n_local, orig, mask):
    """For any survivor subset the port's plan has JAX's layout: sizes,
    assignment, moved partitions and lost devices."""
    survivors = tuple(d for d in range(orig) if (mask >> d) & 1) or (0,)
    j = jel.ElasticPlan(orig * n_local, orig, survivors[::-1])
    t = ElasticPlan(orig * n_local, orig, survivors[::-1])
    for name in ("survivors", "orig_n_local", "n_devices", "n_local",
                 "padded_parts", "pad_parts", "lost"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.assignment() == j.assignment()
    assert t.moved_partitions() == j.moved_partitions()
    hosted = sorted(p for dev in t.assignment() for p in dev)
    assert hosted == list(range(t.num_parts))


@pytest.mark.parametrize("cls,kw", [
    ("ElasticPlan", dict(num_parts=4, orig_devices=3, survivors=(0,))),
    ("ElasticPlan", dict(num_parts=4, orig_devices=4, survivors=())),
    ("ElasticPlan", dict(num_parts=4, orig_devices=4, survivors=(0, 7))),
    ("ElasticConfig", dict(detect_after=0)),
    ("ElasticConfig", dict(detect_after=2, warm_staleness=2)),
    ("ElasticConfig", dict(max_recoveries=-1)),
    ("ElasticConfig", dict(parts_per_device=0)),
], ids=str)
def test_validation_matches_jax(cls, kw):
    with pytest.raises(ValueError) as jerr:
        getattr(jel, cls)(**kw)
    with pytest.raises(ValueError) as terr:
        getattr(tel, cls)(**kw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("args", [(4, 1, 4), (4, 2, 2), (6, 4, 9), (6, 3, 1),
                                  (4, 0, 4)], ids=str)
def test_partition_layout_matches_jax(args):
    try:
        want = jpartition_layout(*args)
    except ValueError as err:
        with pytest.raises(ValueError) as terr:
            partition_layout(*args)
        assert str(terr.value) == str(err)
    else:
        assert partition_layout(*args) == want


def test_survivor_ranks_and_group_without_a_process_group():
    """Survivors that address live ranks are those ranks; a renumbered
    remainder takes the first ones; without a process group there is no
    group to make."""
    plan = ElasticPlan(4, 4, (0, 2, 3))
    assert survivor_ranks(plan, 4) == [0, 2, 3]
    assert survivor_ranks(plan, 3) == [0, 1, 2]
    with pytest.raises(ValueError, match="needs 3 ranks"):
        survivor_ranks(plan, 2)
    assert make_survivor_group(plan) is None
    assert partition_layout(4, 4) == (1, 4)      # one process: one device


# ---------------------------------------------------------------------------
# remaps, field by field
# ---------------------------------------------------------------------------

def _zero_schedule(n_tiles, rows, cols):
    """`tile_schedules` of one all-zero partition with n_tiles slots."""
    z = np.zeros((1, n_tiles), np.int32)
    return gcn_spmm.tile_schedules(SimpleNamespace(
        rows=z, cols=z, vals=np.zeros((1, n_tiles, T, T), np.float32),
        t_out=z, t_in=z, t_perm=z), rows, cols)


@pytest.mark.parametrize("orig,survivors", PLANS, ids=str)
def test_topology_remap_matches_jax_and_pads_walkable_schedules(
        pipes, orig, survivors):
    jp, tp = pipes
    jplan, plan = _plans(orig, survivors)
    jt, t = jel.remap_topology(jp.topo, jplan), tel.remap_topology(tp.topo,
                                                                   plan)
    assert t.num_parts == plan.padded_parts
    for name in jp.topo._fields:
        _same(getattr(jt, name), getattr(t, name), name)
    top, p, pad = tp.topo, P, plan.pad_parts
    if pad == 0:            # an even fit: the identity
        assert t is tp.topo and jt is jp.topo
        return
    # the kernels' schedules: the real forward rows as they were ...
    for name in ("tile_row_ptr", "tile_work", "tile_items", "tile_t_work"):
        assert torch.equal(getattr(t, name)[:p], getattr(top, name)), name
    # ... the real transpose rows with an empty item per new column block
    ncb = -(-(top.max_inner + top.halo_size) // T)
    ncb_new = -(-(t.max_inner + t.halo_size) // T)
    assert ncb_new > ncb
    count = (top.tile_t_items[..., 0] >= 0).sum(1)
    for q in range(p):
        c = int(count[q])
        assert torch.equal(t.tile_t_items[q, :c], top.tile_t_items[q, :c])
        end = int(top.tile_t_items[q, c - 1, 2])
        new = t.tile_t_items[q, c:c + ncb_new - ncb].tolist()
        assert new == [[r, end, end, 0, 1] for r in range(ncb, ncb_new)]
        assert (t.tile_t_items[q, c + ncb_new - ncb:, 0] == -1).all()
        assert torch.equal(t.tile_col_ptr[q, :ncb + 1], top.tile_col_ptr[q])
    # ... every pad the schedule of an all-zero partition: one empty item
    # per output block
    zero = _zero_schedule(top.tile_rows.shape[1], t.max_inner,
                          t.max_inner + t.halo_size)
    for q in range(p, p + pad):
        for k in ("work", "items", "t_work", "t_items"):
            got = getattr(t, "tile_" + k)[q].numpy()
            want = zero[k][0]
            assert np.array_equal(got[:len(want)], want), k
            fill = [-1, 0, 0, 0, 1] if "items" in k else [0, 0]
            assert (got[len(want):] == fill).all(), k
        valid = t.tile_items[q, :, 0] >= 0
        assert (t.tile_items[q, valid, 3:] == torch.tensor([0, 1])).all()
    # the result is the schedules of the padded streams
    rebuilt = t.with_schedules()
    for k in ("tile_work", "tile_items", "tile_t_work", "tile_t_items"):
        assert torch.equal(getattr(rebuilt, k), getattr(t, k)), k
    nrb = -(-t.max_inner // T)
    assert np.array_equal(gcn_spmm.run_pointers(t.tile_rows.numpy(), nrb),
                          t.tile_row_ptr.numpy())
    assert np.array_equal(gcn_spmm.run_pointers(t.tile_t_out.numpy(),
                                                ncb_new),
                          t.tile_col_ptr.numpy())
    # unmap gives the original back bitwise, JAX's fields as JAX's
    _bitwise(tuple(tel.unmap_topology(t, plan)), tuple(top))
    ju = jel.unmap_topology(jt, jplan)
    for name in jp.topo._fields:
        _same(getattr(ju, name), getattr(top, name), name)


def test_remap_refuses_a_schedule_the_kernels_cannot_walk():
    """A topology whose item rows cannot hold a pad's one item per output
    block raises at remap time."""
    t = GraphDataPipeline.build("grid-tiny", P, agg="blocksparse",
                                device="cpu").topo
    short = t._replace(tile_items=t.tile_items[:, :2])
    assert t.tile_row_ptr.shape[1] - 1 > 2
    with pytest.raises(ValueError, match="could not walk"):
        tel.remap_topology(short, ElasticPlan(4, 4, (0, 2, 3)))


@pytest.mark.parametrize("orig,survivors", PLANS, ids=str)
def test_data_remap_matches_jax(pipes, orig, survivors):
    jp, tp = pipes
    jplan, plan = _plans(orig, survivors)
    for split in ("train_data", "val_data"):
        jd = jel.remap_data(getattr(jp, split), jplan)
        td = tel.remap_data(getattr(tp, split), plan)
        for name in jd._fields:
            _same(getattr(jd, name), getattr(td, name), f"{split}.{name}")
        _bitwise(tuple(tel.unmap_data(td, plan)),
                 tuple(getattr(tp, split)))
    tj, dj, vj = jp.elastic_views(jplan)
    tt, dt, vt = tp.elastic_views(plan)
    for name in jp.topo._fields:
        _same(getattr(tj, name), getattr(tt, name), name)
    _same(vj.x, vt.x, "val x")


def test_device_layout_matches_jax(pipes):
    jp, tp = pipes
    for n in (1, 2, 4):
        (jt, jd), (tt, td) = jp.device_layout(n), tp.device_layout(n)
        for name in jt._fields:
            _same(getattr(jt, name), getattr(tt, name), name)
        _same(jd.x, td.x, "x")
    with pytest.raises(ValueError, match="multiple"):
        tp.device_layout(3)


def _state(topo, k, guard, rng):
    """Random buffers shaped like the pipeline state of `topo` (f64)."""
    lead = (k,) if k > 1 else ()
    L, w = 3, (5, 7, 4)
    out = {"feat": tuple(rng.standard_normal(
               lead + (topo.num_parts, topo.halo_size, w[i]))
               for i in range(L)),
           "grad": tuple(rng.standard_normal(
               lead + (topo.num_parts, topo.max_inner, w[i]))
               for i in range(L))}
    if guard:
        out["es"] = rng.integers(0, 4, (topo.num_parts, 2, L,
                                        topo.num_parts)).astype(np.int32)
    return out


@pytest.mark.parametrize("guard", [False, True])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("orig,survivors", PLANS[:2], ids=str)
def test_buffer_remap_matches_jax(pipes, orig, survivors, k, guard):
    """remap / unmap of k = 1 and a k = 2 FIFO, with and without "es",
    equal JAX's bitwise; the remapped shapes are those the model's
    init_buffers gives the remapped topology."""
    jp, tp = pipes
    jplan, plan = _plans(orig, survivors)
    rng = np.random.default_rng(k * 10 + guard + len(survivors))
    host = _state(tp.topo, k, guard, rng)
    jb = jel.remap_buffers(jax.tree.map(jnp.asarray, host), jplan)
    tb = tel.remap_buffers(jax.tree.map(torch.from_numpy, host), plan)
    jax.tree.map(lambda a, b: _same(a, b, "buffers"), jb,
                 jax.tree.map(lambda x: x.numpy(), tb))
    _bitwise(tel.unmap_buffers(tb, plan),
             jax.tree.map(torch.from_numpy, host))
    mc, pc = _cfgs(tp, staleness_steps=k, guard_exchange=guard)
    model = PipeGCN(mc, pc)
    flat = model.init_buffers(tp.topo)
    padded = model.init_buffers(tel.remap_topology(tp.topo, plan))
    got = tel.remap_buffers(flat, plan)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(padded)):
        assert a.shape == b.shape and a.dtype == b.dtype
    _bitwise(tel.unmap_buffers(got, plan), flat)


# ---------------------------------------------------------------------------
# warm marks, pad faults and detection
# ---------------------------------------------------------------------------

@settings(max_examples=30)
@given(orig=st.sampled_from([2, 4]), mask=st.integers(min_value=1,
                                                      max_value=15),
       warm=st.integers(min_value=0, max_value=3),
       seed=st.integers(min_value=0, max_value=1000))
def test_warm_mark_matches_jax(orig, mask, warm, seed):
    survivors = tuple(d for d in range(orig) if (mask >> d) & 1) or (0,)
    jplan, plan = _plans(orig, survivors)
    rng = np.random.default_rng(seed)
    es = rng.integers(0, 3, (plan.padded_parts, 2, 3, plan.padded_parts)
                      ).astype(np.int32)
    moved = plan.moved_partitions()
    jb = jel.warm_mark({"es": jnp.asarray(es), "feat": (), "grad": ()},
                       moved, warm, P)
    bufs = {"es": torch.from_numpy(es), "feat": (), "grad": ()}
    tb = tel.warm_mark(bufs, moved, warm, P)
    _same(jb["es"], tb["es"], "es")
    if warm == 0 or not moved:
        assert tb is bufs
    assert (tb["es"][P:] == torch.from_numpy(es)[P:]).all()   # pads untouched


@pytest.mark.parametrize("kind", ["drop", "corrupt"])
@pytest.mark.parametrize("orig,survivors", PLANS, ids=str)
def test_mask_pad_faults_matches_jax(orig, survivors, kind):
    """The pad sites are cleared in the tensors and in their host copies,
    as JAX clears them; the real sites survive."""
    jplan, plan = _plans(orig, survivors)
    args = (6, 3, plan.padded_parts)
    kw = dict(parts_per_device=plan.n_local)
    spec = dict(rate=0.3, rate_kind=kind, seed=5)
    jtab = jel.mask_pad_faults(jfaults.FaultPlan(**spec).compile(*args, **kw),
                               P)
    ttab = tel.mask_pad_faults(FaultPlan(**spec).compile(*args, **kw), P)
    for name in ("drop", "corrupt"):
        _same(getattr(jtab, name), getattr(ttab, name), name)
        _same(getattr(jtab, name), getattr(ttab, name + "_np"), name)
    sel = getattr(ttab, kind + "_np")
    assert not sel[..., P:, :].any() and not sel[..., :, P:].any()
    assert sel[..., :P, :P].any()


def test_detect_device_loss_fixed_cases_match_jax():
    """tests/test_elastic.py's cases: whole device only, multi-local, pads
    and backward-only streaks."""
    L = 3
    cases = []
    es = np.zeros((P, 2, L, P), np.int32)
    cases.append((es.copy(), 1))
    es[0, FWD, :, 1] = 9
    cases.append((es.copy(), 1))
    for dst in (0, 2, 3):
        es[dst, FWD, :, 1] = 2
    cases.append((es.copy(), 1))
    es[2, FWD, 1, 1] = 1
    cases.append((es.copy(), 1))
    pp = 6
    es = np.zeros((pp, 2, 2, pp), np.int32)
    es[2:4, FWD, :, 0] = 3
    cases.append((es.copy(), 2))
    es[2:4, FWD, :, 1] = 3
    cases.append((es.copy(), 2))
    es = np.zeros((pp, 2, 2, pp), np.int32)
    es[:, 1 - FWD] = 9
    cases.append((es, 2))
    got = [tel.detect_device_loss(torch.from_numpy(e), n, P, 2)
           for e, n in cases]
    assert got == [jel.detect_device_loss(e, n, P, 2) for e, n in cases]
    assert got == [None, None, 1, None, None, 0, None]


@settings(max_examples=40)
@given(n_local=st.sampled_from([1, 2]), pad=st.sampled_from([0, 2]),
       threshold=st.integers(min_value=1, max_value=3),
       seed=st.integers(min_value=0, max_value=10 ** 6))
def test_detect_device_loss_matches_jax(n_local, pad, threshold, seed):
    """Random es arrays, skewed towards blanketing one device's rows."""
    rng = np.random.default_rng(seed)
    pp = P + pad
    es = rng.integers(0, 2, (pp, 2, 3, pp)).astype(np.int32)
    d = int(rng.integers(0, pp // n_local))
    es[:, FWD, :, d * n_local:(d + 1) * n_local] += rng.integers(
        threshold - 1, threshold + 2)
    assert (tel.detect_device_loss(es, n_local, P, threshold)
            == jel.detect_device_loss(es, n_local, P, threshold))


# ---------------------------------------------------------------------------
# the padded layout through the plain kernels and the kernels' item walk
# ---------------------------------------------------------------------------

def _walk(work, items, vals, x, num_out, transpose):
    """The CUDA kernels' schedule in float64: per item the sum of its
    tiles' products, each output block the sum of its items' partials,
    every block NaN until an item writes it. Fails on a block whose items
    do not form one complete run of chunks 0..n-1 (n ≥ 1), which the
    kernel's run counter could not complete."""
    p_, f = x.shape[0], x.shape[2]
    nb = -(-num_out // T)
    xb = gcn_spmm._blocks(x, -(-x.shape[1] // T))
    out = torch.full((p_, nb * T, f), float("nan"), dtype=x.dtype)
    for p in range(p_):
        runs = {}
        for r, lo, hi, c, n in items[p].tolist():
            if r < 0:
                continue
            acc = torch.zeros(T, f, dtype=x.dtype)
            for t, blk in work[p, lo:hi].tolist():
                a = vals[p, t].T if transpose else vals[p, t]
                acc = acc + a @ xb[p, blk]
            runs.setdefault(r, []).append((c, n, acc))
        for r, parts in runs.items():
            assert [(c, n) for c, n, _ in parts] == [
                (c, len(parts)) for c in range(len(parts))], (p, r)
            out[p, r * T:(r + 1) * T] = sum(a for _, _, a in parts)
    return out[:, :num_out]


@pytest.mark.parametrize("orig,survivors", PLANS[:2], ids=str)
def test_padded_schedules_write_every_row(pipes, orig, survivors):
    """On the padded layout the kernels' item walk writes every output row
    of every partition (pads and the pads' halo blocks included) and
    equals the plain versions at 1e-12; pad rows and the pads' halo rows
    of δcomb are zero."""
    plan = ElasticPlan(P, orig, survivors)
    t = tel.remap_topology(pipes[1].topo, plan)
    rows, cols = t.max_inner, t.max_inner + t.halo_size
    vals = t.tile_vals.double()
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.standard_normal((t.num_parts, cols, 3)))
    dz = torch.from_numpy(rng.standard_normal((t.num_parts, rows, 3)))
    z = _walk(t.tile_work, t.tile_items, vals, h, rows, False)
    d = _walk(t.tile_t_work, t.tile_t_items, vals, dz, cols, True)
    assert torch.isfinite(z).all() and torch.isfinite(d).all()
    torch.testing.assert_close(z, gcn_spmm.spmm_plain(
        t.tile_rows, t.tile_cols, vals, h, rows), rtol=0, atol=TOL)
    torch.testing.assert_close(d, gcn_spmm.spmm_t_plain(
        t.tile_t_out, t.tile_t_in, t.tile_t_perm, vals, dz, cols),
        rtol=0, atol=TOL)
    assert (z[P:] == 0).all() and (d[P:] == 0).all()
    first_pad_halo = t.max_inner + P * t.slot
    assert (d[:, first_pad_halo:] == 0).all()


@pytest.mark.parametrize("agg", ["blocksparse", "fused"])
def test_padded_step_is_healthy_with_plain_kernels(agg):
    """A guarded train step on the padded layout (the plain kernels) with
    nonzero biases: every buffer is finite, the pads' es stay 0, the
    health check passes, and every pad row of the logits is the same
    finite row (pads see only zero edges and zero inputs)."""
    tp = GraphDataPipeline.build("tiny", P, seed=0, agg=agg, device="cpu")
    plan = ElasticPlan(P, P, (0, 2, 3))
    topo, data, _ = tp.elastic_views(plan)
    mc, pc = _cfgs(tp)
    mc = dataclasses.replace(mc, matmul_order="aggregate-first")
    model = PipeGCN(mc, pc)
    params = model.init_params(torch.Generator().manual_seed(0))
    params = {k: v + 0.1 if k.startswith("b") else v
              for k, v in params.items()}
    bufs = model.init_buffers(topo)
    for _ in range(2):
        loss, grads, bufs, logits = model.train_step(topo, params, bufs,
                                                     data)
    rep = health_check(loss, grads, bufs)
    assert bool(rep["ok"])
    for x in jax.tree.leaves(bufs):
        assert torch.isfinite(x.float()).all()
    assert int(bufs["es"].abs().max()) == 0
    pad_rows = logits[P:].reshape(-1, logits.shape[-1])
    assert torch.isfinite(pad_rows).all()
    assert torch.equal(pad_rows, pad_rows[:1].expand_as(pad_rows))


@pytest.mark.parametrize("fused", [True, False])
def test_padded_step_exchange_count(pipeline, fused):
    """The padded survivor layout hands the exchange exactly the boundary
    exchanges the comm model prices: the pads ride the same exchanges."""
    mc, pc = _cfgs(pipeline, fuse_exchange=fused)
    model = PipeGCN(mc, pc)
    topo, data, _ = pipeline.elastic_views(ElasticPlan(P, P, (0, 2, 3)))
    rec = RecordingBackend(SimBackend())
    params = model.init_params(torch.Generator().manual_seed(0))
    model.train_step(topo, params, model.init_buffers(topo), data,
                     backend=rec)
    assert rec.events.count("exchange") == expected_boundary_collectives(
        mc.num_layers, fused, train=True)


# ---------------------------------------------------------------------------
# JAX parity in float64
# ---------------------------------------------------------------------------

def _f64_pipelines():
    jp = JPipeline.build("tiny", P, seed=0)
    tp = GraphDataPipeline.build("tiny", P, seed=0, device="cpu")
    jtopo = jax.tree.map(lambda x: x.astype(jnp.float64)
                         if x.dtype == jnp.float32 else x, jp.topo)
    jp = dataclasses.replace(
        jp, topo=jtopo,
        train_data=jp.train_data._replace(
            x=jp.train_data.x.astype(jnp.float64)),
        val_data=jp.val_data._replace(x=jp.val_data.x.astype(jnp.float64)))
    tp = dataclasses.replace(
        tp, topo=tp.topo.to(torch.float64),
        train_data=tp.train_data._replace(x=tp.train_data.x.double()),
        val_data=tp.val_data._replace(x=tp.val_data.x.double()))
    return jp, tp


def test_padded_step_matches_jax_f64():
    """Two guarded steps on the remapped layout from warm-marked state,
    float64, dropout 0: loss, grads, buffers and logits within 1e-12 of
    JAX's, "es" equal, under a drop plan (pads masked)."""
    jp, tp = _f64_pipelines()
    ds = tp.dataset
    cfg = dict(kind="sage", feat_dim=ds.feat_dim, hidden=16, num_layers=3,
               num_classes=ds.num_classes, dropout=0.0)
    jm = JPipeGCN(JModelConfig(**cfg), dataclasses.replace(
        JPipeConfig.named("pipegcn"), guard_exchange=True))
    tm = PipeGCN(ModelConfig(**cfg), dataclasses.replace(
        PipeConfig.named("pipegcn"), guard_exchange=True))
    jplan, plan = _plans(P, (0, 2, 3))
    jt, jd, _ = jp.elastic_views(jplan)
    tt, td, _ = tp.elastic_views(plan)
    jparams = jm.init_params(jax.random.PRNGKey(1), dtype=jnp.float64)
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                              "cpu")
    moved = plan.moved_partitions()
    jb = jel.warm_mark(jel.remap_buffers(
        jm.init_buffers(jp.topo, dtype=jnp.float64), jplan), moved, 1, P)
    tb = tel.warm_mark(tel.remap_buffers(
        tm.init_buffers(tp.topo, dtype=torch.float64), plan), moved, 1, P)
    spec = dict(rate=0.2, seed=3)
    jtab = jel.mask_pad_faults(jfaults.FaultPlan(**spec).compile(
        2, 3, plan.padded_parts, parts_per_device=plan.n_local), P)
    ttab = tel.mask_pad_faults(FaultPlan(**spec).compile(
        2, 3, plan.padded_parts, parts_per_device=plan.n_local), P)
    for t in range(2):
        jl, jg, jb, jlog = jm.train_step(jt, jparams, jb, jd,
                                         jax.random.PRNGKey(t), step_idx=t,
                                         faults=jtab)
        tl, tg, tb, tlog = tm.train_step(tt, tparams, tb, td, step_idx=t,
                                         faults=ttab)
        assert abs(float(jl) - float(tl)) <= TOL
        for name, (a, b) in {"grads": (jg, tg), "buffers": (jb, tb),
                             "logits": (jlog, tlog)}.items():
            for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
                if y.dtype == torch.int32:
                    _same(x, y, name)
                else:
                    np.testing.assert_allclose(y.numpy(), np.asarray(x),
                                               rtol=0, atol=TOL,
                                               err_msg=f"{name} step {t}")
    assert int(tb["es"].max()) > 0


def test_drill_matches_jax(tmp_path, monkeypatch):
    """tests/test_elastic.py's drill (tiny, P = 4, device 1 down at step 5,
    checkpoint every 4, 12 epochs) in both packages from the same float64
    parameters at dropout 0: equal device_losses and recoveries, equal
    epochs and val accuracies, losses and parameters within the Adam
    parity bar."""
    jp, tp = _f64_pipelines()
    ds = tp.dataset
    cfg = dict(kind="sage", feat_dim=ds.feat_dim, hidden=16, num_layers=3,
               num_classes=ds.num_classes, dropout=0.0)
    start = {k: np.asarray(v) for k, v in JPipeGCN(
        JModelConfig(**cfg), JPipeConfig()).init_params(
            jax.random.PRNGKey(0), dtype=jnp.float64).items()}
    jbufs, tbufs = JPipeGCN.init_buffers, PipeGCN.init_buffers
    monkeypatch.setattr(JPipeGCN, "init_params", lambda self, key, dtype=0: {
        k: jnp.asarray(v) for k, v in start.items()})
    monkeypatch.setattr(JPipeGCN, "init_buffers", lambda self, topo, dtype=0:
                        jbufs(self, topo, dtype=jnp.float64))
    monkeypatch.setattr(PipeGCN, "init_params", lambda self, gen, dtype=0: {
        k: torch.from_numpy(v.copy()) for k, v in start.items()})
    monkeypatch.setattr(PipeGCN, "init_buffers", lambda self, topo, dtype=0:
                        tbufs(self, topo, dtype=torch.float64))
    runs = {}
    for name, train, mcls, pcls, mod, pipe, kw in (
            ("jax", jtrain, JModelConfig, JPipeConfig, (jel, jfaults), jp,
             {}),
            ("port", train_pipegcn, ModelConfig, PipeConfig,
             (tel, tfaults), tp, {"device": "cpu"})):
        pc = dataclasses.replace(pcls.named("pipegcn"), guard_exchange=True,
                                 max_staleness=8)
        plan = mod[1].FaultPlan(sites=(mod[1].device_down_site(step=5,
                                                               device=1),))
        runs[name] = train(pipe, mcls(**cfg), pc, epochs=12, eval_every=1,
                           elastic=mod[0].ElasticConfig(rejoin=False),
                           faults=plan, ckpt_dir=str(tmp_path / name),
                           checkpoint_every=4, **kw)
    j, t = runs["jax"], runs["port"]
    assert t.recoveries == j.recoveries == 1
    assert t.anomalies == j.anomalies
    assert t.anomalies["device_losses"] == [{
        "device": 1, "detected_epoch": 6, "resumed_from": 4,
        "survivors": [0, 2, 3]}]
    assert t.history["epoch"] == j.history["epoch"]
    assert t.history["val_acc"] == j.history["val_acc"]
    np.testing.assert_allclose(t.history["loss"], j.history["loss"],
                               rtol=0, atol=ADAM_TOL)
    for k, v in t.params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(j.params[k]),
                                   rtol=0, atol=ADAM_TOL, err_msg=k)


# ---------------------------------------------------------------------------
# the trainer's gates (sim backend)
# ---------------------------------------------------------------------------

EC = ElasticConfig(parts_per_device=1, rejoin=False)


def _drill(pipeline, tmp_path, dropout=0.0, log=None):
    mc, pc = _cfgs(pipeline)
    mc = dataclasses.replace(mc, dropout=dropout)
    plan_f = FaultPlan(sites=(device_down_site(step=5, device=1),))
    d_a = str(tmp_path / "a")
    res_a = train_pipegcn(pipeline, mc, pc, epochs=12, eval_every=1,
                          elastic=EC, faults=plan_f, ckpt_dir=d_a,
                          checkpoint_every=4, device="cpu", log=log)
    d_b = str(tmp_path / "b")
    os.makedirs(d_b)
    shutil.copytree(os.path.join(d_a, "step_00000004"),
                    os.path.join(d_b, "step_00000004"))
    res_b = train_pipegcn(pipeline, mc, pc, epochs=12, eval_every=1,
                          elastic=EC,
                          elastic_plan=ElasticPlan(P, P, (0, 2, 3)),
                          ckpt_dir=d_b, checkpoint_every=4, resume=True,
                          device="cpu")
    return res_a, res_b


@pytest.mark.parametrize("agg,dropout", [("coo", 0.0), ("blocksparse", 0.5),
                                         ("fused", 0.0)])
def test_recovery_bitwise_equals_fresh_survivor_launch(tmp_path, agg,
                                                        dropout):
    """Mid-run recovery (restore, remap, warm-mark) and a fresh launch on
    the survivor layout from a copy of the same checkpoint give bitwise
    equal parameters and histories (at dropout 0.5 too: the generator
    state is in the checkpoint)."""
    pipeline = GraphDataPipeline.build("tiny", P, seed=0, agg=agg,
                                       device="cpu")
    lines = []
    res_a, res_b = _drill(pipeline, tmp_path, dropout, log=lines.append)
    assert res_a.recoveries == 1 and res_b.recoveries == 0
    loss = res_a.anomalies["device_losses"][0]
    assert loss["device"] == 1 and loss["survivors"] == [0, 2, 3]
    assert loss["resumed_from"] == 4
    assert loss["detected_epoch"] <= 5 + EC.detect_after
    assert res_b.resumed_from == 4
    _bitwise(res_a.params, res_b.params)
    n = len(res_b.history["epoch"])     # the epochs after the restore
    for k in ("epoch", "loss", "val_acc", "test_acc"):
        assert res_a.history[k][-n:] == res_b.history[k], k
    assert ("device 1 lost at epoch 6: remapped 4 partitions onto "
            "survivors [0, 2, 3] (2/device, 2 pad), restored checkpoint "
            "step 4, resuming at epoch 4") in lines


def test_zero_fault_elastic_is_bitwise_invisible(pipeline):
    mc, pc = _cfgs(pipeline)
    kw = dict(epochs=6, eval_every=2, device="cpu")
    plain = train_pipegcn(pipeline, mc, pc, **kw)
    armed = train_pipegcn(pipeline, mc, pc, elastic=EC, **kw)
    assert armed.recoveries == 0
    assert armed.anomalies["device_losses"] == []
    _bitwise(plain.params, armed.params)
    assert plain.history == armed.history


def test_rejoin_scales_back_up_at_checkpoint(pipeline, tmp_path):
    """Device 2 down for steps [5, 9): recovery at detection, rejoin at the
    first checkpoint boundary after it returns, the run ends on the full
    layout. The JAX trainer logs the same recovery and rejoin lines."""
    mc, pc = _cfgs(pipeline)
    ec = ElasticConfig(parts_per_device=1, rejoin=True)
    plan_f = FaultPlan(sites=(device_down_site(step=5, device=2, until=9),))
    lines = []
    res = train_pipegcn(pipeline, mc, pc, epochs=16, eval_every=2,
                        elastic=ec, faults=plan_f, ckpt_dir=str(tmp_path),
                        checkpoint_every=4, device="cpu", log=lines.append)
    assert res.recoveries == 1
    assert res.anomalies["rejoins"] == 1
    assert res.final_metrics["val"] > 0.5
    jl = []
    jp = JPipeline.build("tiny", P, seed=0)
    ds = jp.dataset
    jtrain(jp, JModelConfig(kind="sage", feat_dim=ds.feat_dim, hidden=16,
                            num_layers=3, num_classes=ds.num_classes,
                            dropout=0.0),
           dataclasses.replace(JPipeConfig.named("pipegcn"),
                               guard_exchange=True, max_staleness=8),
           epochs=16, eval_every=2,
           elastic=jel.ElasticConfig(parts_per_device=1, rejoin=True),
           faults=jfaults.FaultPlan(sites=(jfaults.device_down_site(
               step=5, device=2, until=9),)),
           ckpt_dir=str(tmp_path / "jax"), checkpoint_every=4, log=jl.append)

    def events(ls):
        return [ln for ln in ls if ln.startswith(("device ", "rejoin:"))]

    assert events(lines) == events(jl)
    assert len(events(lines)) == 2


def test_recovery_budget_reraises(pipeline, tmp_path):
    mc, pc = _cfgs(pipeline)
    ec = ElasticConfig(parts_per_device=1, max_recoveries=0)
    plan_f = FaultPlan(sites=(device_down_site(step=3, device=1),))
    with pytest.raises(DeviceLossError) as e:
        train_pipegcn(pipeline, mc, pc, epochs=8, eval_every=4, elastic=ec,
                      faults=plan_f, ckpt_dir=str(tmp_path),
                      checkpoint_every=2, device="cpu")
    assert e.value.device == 1 and e.value.survivors == (0, 2, 3)


def test_loss_before_first_checkpoint_is_fatal(pipeline, tmp_path):
    mc, pc = _cfgs(pipeline)
    plan_f = FaultPlan(sites=(device_down_site(step=0, device=1),))
    with pytest.raises(RuntimeError, match="first checkpoint"):
        train_pipegcn(pipeline, mc, pc, epochs=8, eval_every=4, elastic=EC,
                      faults=plan_f, ckpt_dir=str(tmp_path),
                      checkpoint_every=100, device="cpu")


@pytest.mark.parametrize("what", ["guard", "plan", "detect", "parts"])
def test_trainer_validation(pipeline, what):
    mc, pc = _cfgs(pipeline)
    kw = dict(epochs=1, device="cpu", elastic=EC)
    if what == "guard":
        pc, match = dataclasses.replace(pc, guard_exchange=False), \
            "guard_exchange"
    elif what == "plan":
        kw, match = dict(epochs=1, device="cpu", elastic_plan=ElasticPlan(
            P, P, (0, 2, 3))), "ElasticConfig"
    elif what == "detect":
        pc, match = dataclasses.replace(pc, max_staleness=2), "never"
    else:
        kw["elastic_plan"], match = ElasticPlan(8, 4, (0, 1)), "remaps 8"
    with pytest.raises(ValueError, match=match):
        train_pipegcn(pipeline, mc, pc, **kw)


def test_bench10_elastic_drill():
    """`BENCH_10.json` meta.faults.elastic on the port's trainer: tiny P = 4
    (hidden 32, 3 layers, pipegcn, guarded, max_staleness 8), 30 epochs,
    device 1 killed at epoch 15, checkpoint every 5: the JSON's device,
    detection epoch, restore step and recovery count, and val within 1
    point of the loss-free run."""
    with open(os.path.join(ROOT, "benchmarks", "baselines",
                           "BENCH_10.json")) as f:
        meta = json.load(f)["meta"]["faults"]
    want, epochs = meta["elastic"], meta["epochs"]
    tp = GraphDataPipeline.build(meta["dataset"], P, kind="sage",
                                 device="cpu")
    ds = tp.dataset
    mc = ModelConfig(kind="sage", feat_dim=ds.feat_dim, hidden=32,
                     num_layers=3, num_classes=ds.num_classes, dropout=0.0,
                     multilabel=ds.multilabel)
    pc = dataclasses.replace(PipeConfig.named("pipegcn", gamma=0.95),
                             guard_exchange=True, max_staleness=8)
    kw = dict(epochs=epochs, eval_every=epochs, device="cpu", elastic=EC)
    clean = train_pipegcn(tp, mc, pc, **kw)
    plan = FaultPlan(sites=(device_down_site(step=epochs // 2, device=1),))
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        drilled = train_pipegcn(tp, mc, pc, faults=plan, ckpt_dir=d,
                                checkpoint_every=5, **kw)
    loss = drilled.anomalies["device_losses"][0]
    got = dict(device=loss["device"], detected_epoch=loss["detected_epoch"],
               resumed_from=loss["resumed_from"],
               recoveries=drilled.recoveries,
               within_1pt=abs(clean.final_metrics["val"]
                              - drilled.final_metrics["val"]) <= 0.01)
    assert got == want
    assert (want["device"], want["detected_epoch"], want["resumed_from"],
            want["recoveries"]) == (1, 16, 15, 1)
    assert clean.recoveries == 0
