"""The port's split-phase overlap schedule on the CPU, in float64.

The split cuts each layer's SpMM into a boundary phase and an interior
phase and starts the boundary exchange between them. It moves exchanges
and changes no arithmetic, so the port's split step must equal its own
unsplit step bitwise, and the JAX package's split step to 1e-12, over 3
training steps (4 with a 2-deep FIFO) and the eval forward, on grid-tiny
(4 partitions, rcm), the graph of the JAX package's own matrix
(tests/test_overlap.py). The JAX engines run their Pallas kernels in
interpret mode, the port's on the plain PyTorch versions, whose phased
pair fills the rows outside a phase with NaN: a finite result shows the
split step never reads them.

The 16 parity cells of `test_split_equals_unsplit_and_jax` (the setup and
the cell body in tests/_torch_overlap_cells.py) are spread over this file
and tests/test_torch_overlap_b.py and _c.py, which pytest-xdist's
`loadfile` gives to different workers.
"""
import dataclasses

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

from _torch_overlap_cells import (CELLS, P, _configs,  # noqa: E402
                                  build_setups, cell_ids, run_cell)
from repro.core.config import ModelConfig as JModelConfig  # noqa: E402
from repro.core.config import PipeConfig as JPipeConfig  # noqa: E402
from repro.core.pipegcn import PipeGCN as JPipeGCN  # noqa: E402
from repro.core.trace_utils import \
    expected_split_events as jexpected_split_events  # noqa: E402
from repro_torch import spans  # noqa: E402
from repro_torch.core import (ModelConfig, PipeConfig, PipeGCN,  # noqa: E402
                              train_pipegcn)
from repro_torch.core.pipegcn import SimBackend  # noqa: E402
from repro_torch.core.trace_utils import (RecordingBackend,  # noqa: E402
                                          check_overlap, count_exchanges,
                                          expected_boundary_collectives,
                                          expected_split_events)
from repro_torch.data import GraphDataPipeline  # noqa: E402
from repro_torch.graph import (build_partitioned_graph,  # noqa: E402
                               make_dataset, partition_graph)
from repro_torch.graph.csr import mean_normalized  # noqa: E402
from repro_torch.graph.halo import extract_partition_tiles  # noqa: E402
from repro_torch.kernels import gcn_spmm  # noqa: E402
from repro_torch.kernels.aggregate import get_engine  # noqa: E402

MINE = CELLS[:6]


@pytest.fixture(scope="module")
def setups():
    return build_setups()


@pytest.mark.parametrize("kind,variant,agg,order,pipe_kw,dropout", MINE,
                         ids=cell_ids(MINE))
def test_split_equals_unsplit_and_jax(setups, kind, variant, agg, order,
                                      pipe_kw, dropout):
    run_cell(setups, kind, variant, agg, order, pipe_kw, dropout)


def test_fused_auto_prices_the_composed_split_path(setups):
    """Under the split the fused engine runs the composed phased path, so
    "auto" prices fused=False, as the JAX package does; the unsplit step
    keeps the fused pricing."""
    (tp, topo, _), (jtopo, _, jsp) = setups["sage"]
    cfg, pipe = _configs(tp, "sage", "pipegcn", "fused", "auto", {}, 0.0)
    model = PipeGCN(ModelConfig(**cfg), PipeConfig(**pipe),
                    split=tp.split_spec())
    jmodel = JPipeGCN(JModelConfig(**cfg), JPipeConfig(**pipe), split=jsp)
    for train in (True, False):
        got = model.step_orders(topo, train=train)
        assert got == model.layer_orders(topo, train=train, fused=False)
        assert got == jmodel.layer_orders(jtopo, train=train, fused=False)
    unsplit = dataclasses.replace(model, split=None)
    assert unsplit.step_orders(topo) == model.layer_orders(topo, fused=True)


@pytest.mark.parametrize("graph,parts", [("grid-tiny", 2), ("grid-tiny", 4),
                                         ("grid-tiny", 8), ("yelp-sim", 2)])
def test_phase_block_range_selects_the_phase_slice(graph, parts):
    """The card launches a phase on a range of output blocks, the JAX
    package on a slice of the stream; the phase-aware padding makes them
    select the same slots in every partition, for both streams."""
    ds = make_dataset(graph)
    pg = build_partitioned_graph(mean_normalized(ds.graph),
                                 partition_graph(ds.graph, parts, seed=0),
                                 parts, layout="rcm")
    pt = extract_partition_tiles(pg)
    assert pt.fwd_bnd is not None, "the split must be feasible here"
    n = pt.rows.shape[1]
    for stream, cut, n_bnd in ((pt.rows, pt.b0, pt.fwd_bnd),
                               (pt.t_out, pt.hb0, pt.t_bnd)):
        assert (np.diff(stream, axis=1) >= 0).all()     # grouped by block
        for phase in ("boundary", "interior"):
            sl = gcn_spmm.phase_slots(n, n_bnd, phase)
            lo, hi = ((cut, np.inf) if phase == "boundary" else (0, cut))
            in_range = (stream >= lo) & (stream < hi)
            want = np.zeros(n, bool)
            want[sl] = True
            assert (in_range == want[None]).all(), (graph, parts, phase)


@pytest.mark.parametrize("f", [8, 16])
def test_phased_plain_versions(setups, f):
    """Each phase's rows equal the unsplit product bitwise, the two phases
    reassemble it, and the rows outside a phase are NaN."""
    (tp, topo, _), _ = setups["sage"]
    sp = tp.split_spec()
    R, C = topo.max_inner, topo.max_inner + topo.halo_size
    rng = np.random.default_rng(f)
    h = torch.from_numpy(rng.standard_normal((P, C, f)))
    dz = torch.from_numpy(rng.standard_normal((P, R, f)))
    fwd = (topo.tile_work, topo.tile_items, topo.tile_rows,
           topo.tile_cols, topo.tile_vals)
    bwd = (topo.tile_t_work, topo.tile_t_items, topo.tile_t_out,
           topo.tile_t_in, topo.tile_t_perm, topo.tile_vals)
    z = gcn_spmm.spmm(*fwd, h, R)
    d = gcn_spmm.spmm_t(*bwd, dz, C)
    before = spans.counter("gcn_spmm.spmm_phased"), spans.counter("gcn_spmm.spmm_t_phased")
    for full, tail, run in ((z, sp.row_tail, lambda ph: gcn_spmm.spmm_phased(
                                 *fwd, h, R, sp, ph)),
                            (d, sp.col_tail, lambda ph: gcn_spmm.spmm_t_phased(
                                 *bwd, dz, C, sp, ph))):
        bnd, inr = run("boundary"), run("interior")
        assert torch.equal(bnd[:, tail:], full[:, tail:])
        assert torch.equal(inr[:, :tail], full[:, :tail])
        assert torch.isnan(bnd[:, :tail]).all()
        assert torch.isnan(inr[:, tail:]).all()
    # the CPU path runs the plain versions: no kernel launch is counted
    assert (spans.counter("gcn_spmm.spmm_phased"),
            spans.counter("gcn_spmm.spmm_t_phased")) == before


def test_phase_helpers_refuse_empty_or_off_grid_phases():
    with pytest.raises(ValueError, match="strictly inside"):
        gcn_spmm.phase_blocks(0, 300, "interior")
    with pytest.raises(ValueError, match="strictly inside"):
        gcn_spmm.phase_blocks(384, 300, "boundary")
    with pytest.raises(ValueError, match="multiple"):
        gcn_spmm.phase_blocks(100, 300, "boundary")
    with pytest.raises(ValueError, match="phase must be"):
        gcn_spmm.phase_blocks(128, 300, "both")
    with pytest.raises(ValueError, match="n_bnd"):
        gcn_spmm.phase_slots(10, 10, "boundary")


def test_coo_phases_zero_out_of_phase_rows(setups):
    """The COO engine's phases mask edges: out-of-phase rows are zero, as
    in the JAX package, and the phases sum to the unsplit product."""
    (tp, topo, data), _ = setups["sage"]
    sp = tp.split_spec()
    coo = get_engine("coo")
    ts = tuple(getattr(topo, k) for k in coo.fields)
    R = topo.max_inner
    h = torch.cat([data.x, torch.ones(P, topo.halo_size, data.x.shape[-1],
                                      dtype=torch.float64)], dim=1)
    full = coo.spmm(ts, h, R)
    bnd = coo.spmm_phased(ts, h, R, sp, "boundary")
    inr = coo.spmm_phased(ts, h, R, sp, "interior")
    assert torch.equal(bnd[:, sp.row_tail:], full[:, sp.row_tail:])
    assert torch.equal(inr[:, :sp.row_tail], full[:, :sp.row_tail])
    assert not bnd[:, :sp.row_tail].any() and not inr[:, sp.row_tail:].any()


@pytest.mark.parametrize("layers", [1, 2, 3])
@pytest.mark.parametrize("fuse", [True, False])
def test_split_event_sequence_and_exchange_counts(setups, layers, fuse):
    """The recorded schedule of a split step is the ported
    `expected_split_events` (the JAX sequence with the waits placed):
    every exchange started after a phase launch sits between a boundary
    and an interior phase and is waited on after it; the split keeps the
    unsplit step's exchange count (2 per fused step, 2L-1 per layer)."""
    (tp, topo, data), _ = setups["sage"]
    cfg, pipe = _configs(tp, "sage", "pipegcn", "blocksparse",
                         "aggregate-first", {"fuse_exchange": fuse}, 0.0,
                         layers=layers)
    mc = ModelConfig(**cfg)
    sp = tp.split_spec()
    events = {}
    for overlap in ("none", "split-phase"):
        # without a spec: the eval forward keeps the spec and would split
        model = PipeGCN(mc, PipeConfig(**pipe, overlap=overlap),
                        split=sp if overlap != "none" else None)
        params = model.init_params(torch.Generator().manual_seed(0),
                                   dtype=torch.float64)
        for train in (True, False):
            rec = RecordingBackend(SimBackend())
            if train:
                model.train_step(topo, params, model.init_buffers(
                    topo, dtype=torch.float64), data, backend=rec)
            else:
                model.forward(topo, params, data, backend=rec)
            events[overlap, train] = rec.events
    for train in (True, False):
        split_ev = events["split-phase", train]
        assert split_ev == expected_split_events(layers, fuse and train,
                                                 train=train)
        check_overlap(split_ev)
        n = expected_boundary_collectives(layers, fuse and train, train=train)
        assert count_exchanges(split_ev) == n
        assert events["none", train] == ["exchange"] * n
        # the JAX sequence is the port's without the waits
        jev = jexpected_split_events(layers, fuse and train, train=train)
        assert [("A" if e == "exchange_start" else "P") for e in split_ev
                if e != "exchange_wait"] == [
            "A" if e == "all_to_all" else "P" for e in jev]


def test_expected_split_events_by_hand():
    S, W = "exchange_start", "exchange_wait"
    fb, fi = ("spmm_phased", "boundary"), ("spmm_phased", "interior")
    tb, ti = ("spmm_t_phased", "boundary"), ("spmm_t_phased", "interior")
    assert expected_split_events(1, fused=True) == [S, fb, fi, W]
    assert expected_split_events(2, fused=True) == [
        fb, S, fi, fb, fi, W, tb, S, ti, W]
    assert expected_split_events(2, fused=False) == [
        S, W, fb, S, fi, W, fb, fi, tb, S, ti, W]
    assert expected_split_events(2, fused=False, train=False) == [
        S, W, fb, S, fi, W, fb, fi]
    check_overlap(expected_split_events(3, fused=True))
    with pytest.raises(AssertionError, match="between"):
        check_overlap([fb, fi, S, fb, fi, W])
    with pytest.raises(AssertionError, match="waited"):
        check_overlap([fb, S, fi])


@pytest.mark.parametrize("dataset,parts,layout", [
    ("grid-tiny", 1, "rcm"),       # P=1: no peers, nothing to exchange
    ("grid-tiny", 4, "natural"),   # no halo clustering -> no contiguous tail
    ("tiny", 4, "rcm"),            # power-law: ~all nodes are boundary
])
def test_degenerate_graphs_fall_back_unsplit(dataset, parts, layout):
    """No feasible split: split_spec() is None and a forced "split-phase"
    model runs the unsplit step, bit for bit."""
    tp = GraphDataPipeline.build(dataset, parts, kind="sage",
                                 agg="blocksparse", layout=layout,
                                 device="cpu")
    assert tp.split_spec() is None
    ds = tp.dataset
    mc = ModelConfig(kind="sage", feat_dim=ds.feat_dim, hidden=16,
                     num_layers=2, num_classes=ds.num_classes, dropout=0.0,
                     agg="blocksparse", layout=layout)
    forced = PipeGCN(mc, PipeConfig(overlap="split-phase"), split=None)
    ref = PipeGCN(mc, PipeConfig(overlap="none"))
    assert forced._split_active() is None
    params = ref.init_params(torch.Generator().manual_seed(0))
    bufs = ref.init_buffers(tp.topo)
    rec = RecordingBackend(SimBackend())
    l0, g0, _, _ = ref.train_step(tp.topo, params, bufs, tp.train_data)
    l1, g1, _, _ = forced.train_step(tp.topo, params, bufs, tp.train_data,
                                     backend=rec)
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert not any(isinstance(e, tuple) for e in rec.events)


def test_auto_overlap_engine_gating(setups):
    """overlap="auto" splits iff the engine consumes tile streams;
    "split-phase" splits every engine; "none" never splits."""
    (tp, _, _), _ = setups["sage"]
    sp = tp.split_spec()
    for agg, auto in (("coo", False), ("blocksparse", True),
                      ("fused", True)):
        cfg, pipe = _configs(tp, "sage", "pipegcn", agg, "auto", {}, 0.0)
        for overlap, want in (("auto", auto), ("split-phase", True),
                              ("none", False)):
            model = PipeGCN(ModelConfig(**cfg),
                            PipeConfig(**pipe, overlap=overlap), split=sp)
            assert (model._split_active() is not None) == want, (agg, overlap)


@pytest.mark.parametrize("overlap,agg", [("none", "blocksparse"),
                                         ("auto", "blocksparse"),
                                         ("auto", "coo"),
                                         ("split-phase", "fused")])
def test_train_pipegcn_on_a_splittable_graph(overlap, agg):
    """train_pipegcn trains grid-tiny, where a split exists, under every
    overlap setting and logs the schedule the step runs, as the JAX
    trainer does."""
    tp = GraphDataPipeline.build("grid-tiny", P, agg=agg, layout="rcm",
                                 device="cpu")
    assert tp.split_spec() is not None
    ds = tp.dataset
    mc = ModelConfig(feat_dim=ds.feat_dim, hidden=16, num_layers=3,
                     num_classes=ds.num_classes, dropout=0.5, agg=agg)
    lines = []
    res = train_pipegcn(tp, mc, PipeConfig(overlap=overlap), epochs=3,
                        eval_every=1, log=lines.append, device="cpu")
    assert all(np.isfinite(res.history["loss"]))
    sched = next(s for s in lines if s.startswith("overlap schedule"))
    if overlap == "none":
        assert sched == "overlap schedule: unsplit (disabled)"
    elif agg == "coo":
        assert sched == ("overlap schedule: unsplit (engine 'coo' has no "
                         "tile phases)")
    else:
        assert sched.startswith("overlap schedule: split-phase (fwd boundary")


@pytest.mark.parametrize("overlap", ["none", "auto", "split-phase"])
def test_cli_runs_every_overlap(capsys, overlap):
    from repro_torch.launch.train import main
    out = main(["--device", "cpu", "--dataset", "grid-tiny", "--epochs", "2",
                "--agg", "blocksparse", "--overlap", overlap,
                "--eval-every", "1"])
    printed = capsys.readouterr().out
    assert out["overlap"] == overlap
    assert all(np.isfinite(out["history"]["loss"]))
    want = ("overlap schedule: unsplit (disabled)" if overlap == "none"
            else "overlap schedule: split-phase (fwd boundary")
    assert want in printed


def test_cli_spmd_single_rank(capsys):
    """--spmd without torchrun: one gloo rank holding all 4 partitions;
    the same losses as the sim backend, and the process group is gone
    afterwards. Without --spmd, --parts-per-device is accepted as the JAX
    launcher accepts it (the sim backend's device size under --elastic)
    and leaves the sim run as it is."""
    import torch.distributed as dist
    from repro_torch.launch.train import main
    args = ["--device", "cpu", "--dataset", "grid-tiny", "--epochs", "2",
            "--agg", "blocksparse", "--eval-every", "1"]
    spmd = main(args + ["--spmd", "--parts-per-device", "4"])
    printed = capsys.readouterr().out
    assert "boundary collectives/train step, 1 ranks × 4 partitions" in printed
    assert not dist.is_initialized()
    sim = main(args)
    assert spmd["history"]["loss"] == sim["history"]["loss"]
    per_device = main(args + ["--parts-per-device", "2"])
    assert per_device["history"]["loss"] == sim["history"]["loss"]
