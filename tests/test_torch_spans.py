"""The port's spans and counters (`repro_torch.spans`) on the CPU.

- Off (no profiler session): `span` hands back one shared null context and
  never opens a profiler range, in the training loop too.
- On, under a CPU ``torch.profiler`` session: a tiny `train_pipegcn`, on the
  unsplit step (COO) and on the split-phase step (blocksparse on
  grid-tiny), records every ``repro.*`` range, each nested where the
  trainer and the step open it, and no leaf range opens more than 400 host
  events before its end (the look-back of the benchmark's idle-gap naming).
- ``exchange.bytes`` over one training step equals
  `trace_utils.step_wire_bytes` on the f32, int8 and sliced wires.
- `last_run()` gives the run's epochs and counter changes; ``sync.host``
  counts each host-sync site once.
"""
import bisect
import collections
import dataclasses

import pytest
import torch

import _torch_threads  # noqa: F401
from repro_torch import spans
from repro_torch.core import (HealthConfig, ModelConfig, PipeConfig, PipeGCN,
                              make_train_step, train_pipegcn)
from repro_torch.core.trace_utils import step_wire_bytes
from repro_torch.data import GraphDataPipeline
from repro_torch.optim import adam

LOOK_BACK = 400
# (dataset, engine): the unsplit step, and the split-phase step (grid-tiny's
# rcm layout clusters its boundary rows, so blocksparse/auto splits)
CASES = [("tiny", "coo"), ("grid-tiny", "blocksparse")]


def _setup(name, agg, num_layers=3, dropout=0.5, **pipe_kw):
    pipe = GraphDataPipeline.build(name, 4, kind="sage", agg=agg,
                                   device="cpu")
    ds = pipe.dataset
    mc = ModelConfig(kind="sage", feat_dim=ds.feat_dim, hidden=32,
                     num_layers=num_layers, num_classes=ds.num_classes,
                     dropout=dropout, agg=agg, layout=pipe.layout)
    pc = dataclasses.replace(PipeConfig.named("pipegcn"), **pipe_kw)
    return pipe, mc, pc


def _train(pipe, mc, pc, epochs=3, eval_every=2, **kw):
    return train_pipegcn(pipe, mc, pc, epochs=epochs, eval_every=eval_every,
                         log=None, device="cpu", **kw)


def _host_events(prof):
    out = []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        out.append((e.name(), s, s + e.duration_ns()))
    out.sort(key=lambda t: t[1])
    return out


def _parent(events, rng):
    """The innermost repro.* range that strictly contains `rng`."""
    name, s, e = rng
    best = None
    for other in events:
        o, os_, oe = other
        if other is rng or not o.startswith("repro."):
            continue
        if os_ <= s and e <= oe and (os_, oe) != (s, e):
            if best is None or oe - os_ < best[2] - best[1]:
                best = other
    return None if best is None else best[0]


def test_span_off_is_the_shared_null_context(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not spans.tracing()
    assert spans.span("repro.x") is spans.span("repro.y", device=True)
    with spans.span("repro.x") as s:
        assert s is None
    pipe, mc, pc = _setup("tiny", "coo")
    _train(pipe, mc, pc, epochs=2)
    assert spans.last_run()["device_s"] == {}


@pytest.mark.parametrize("name,agg", CASES)
def test_train_pipegcn_records_the_repro_ranges_nested(name, agg):
    pipe, mc, pc = _setup(name, agg)
    L = mc.num_layers
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = _train(pipe, mc, pc, epochs=3, eval_every=2)
    n_eval = len(res.history["epoch"])
    events = _host_events(prof)
    ranges = [t for t in events if t[0].startswith("repro.")]
    got = collections.Counter(n for n, _, _ in ranges)
    assert got["repro.run.setup"] == 1
    assert got["repro.epoch"] == 3
    assert got["repro.eval"] == got["repro.eval.metric"] == n_eval
    assert got["repro.opt"] == got["repro.health"] == 3
    assert got["repro.opt.leaf"] == 3 * 2 * L        # w and b per layer
    for ell in range(L):
        assert got[f"repro.step.fwd.L{ell}"] == 3 + n_eval
        assert got[f"repro.step.bwd.L{ell}"] == 3
    assert got["repro.step.loss"] == 3 + n_eval
    assert got["repro.exchange"] > 0
    assert any(n.startswith("repro.agg.") for n in got)
    if agg == "blocksparse":
        assert got["repro.agg.spmm_phased"] > 0      # the split step ran

    allowed = {
        "repro.epoch": {None}, "repro.run.setup": {None},
        "repro.eval": {"repro.epoch"}, "repro.eval.metric": {"repro.eval"},
        "repro.opt": {"repro.epoch"}, "repro.health": {"repro.epoch"},
        "repro.opt.leaf": {"repro.opt"},
        "repro.sync.verdict": {"repro.epoch"},
        "repro.sync.select": {"repro.health"},
        "repro.sync.loss": {"repro.epoch"},
        "repro.sync.metric": {"repro.eval.metric"},
        "repro.step.loss": {"repro.epoch", "repro.eval"},
    }
    steps = {f"repro.step.{d}.L{ell}" for d in ("fwd", "bwd")
             for ell in range(L)}
    for rng in ranges:
        name_ = rng[0]
        parent = _parent(ranges, rng)
        if name_ in allowed:
            assert parent in allowed[name_], (name_, parent)
        elif name_ in steps:
            assert parent in ("repro.epoch", "repro.eval"), (name_, parent)
        elif name_ == "repro.exchange":
            assert parent in steps | {"repro.epoch", "repro.eval"}, parent
        elif name_.startswith("repro.agg."):
            assert parent in steps | {"repro.agg.aggregate_transform",
                                      "repro.agg.aggregate_transform_t"}, (
                name_, parent)
        else:
            raise AssertionError(f"unexpected range {name_}")

    # every leaf range closes within the idle-gap look-back of its start
    starts = [s for _, s, _ in events]
    for rng in ranges:
        _, s, e = rng
        if any(o is not rng and s <= o[1] and o[2] <= e for o in ranges):
            continue
        opened = bisect.bisect_right(starts, e) - bisect.bisect_left(starts, s)
        assert opened < LOOK_BACK, (rng[0], opened)


@pytest.mark.parametrize("pipe_kw", [
    {},
    {"wire": "int8"},
    {"wire": "int8", "slice_boundary": True, "overlap": "none"},
], ids=["f32", "int8", "int8-sliced"])
def test_exchange_bytes_of_a_step_equal_step_wire_bytes(pipe_kw):
    pipe, mc, pc = _setup("tiny", "coo", dropout=0.0, **pipe_kw)
    if pc.slice_boundary:
        mc = dataclasses.replace(mc, matmul_order="transform-first")
    model = PipeGCN(mc, pc)
    if pc.slice_boundary:
        assert model.sliced_layers(pipe.topo)
    want = step_wire_bytes(model, pipe.topo, pipe.train_data)
    opt = adam(0.01)
    params = model.init_params(torch.Generator().manual_seed(0))
    step = make_train_step(model, opt, HealthConfig())
    before = spans.counter("exchange.bytes")
    step(pipe.topo, params, opt.init(params), model.init_buffers(pipe.topo),
         pipe.train_data)
    assert spans.counter("exchange.bytes") - before == want > 0


def test_last_run_gives_epochs_and_counter_changes():
    pipe, mc, pc = _setup("tiny", "coo", dropout=0.0)
    model = PipeGCN(mc, pc)
    evaluator = dataclasses.replace(model, pipe=PipeConfig.vanilla())
    train_b = step_wire_bytes(model, pipe.topo, pipe.train_data)
    eval_b = step_wire_bytes(evaluator, pipe.topo, pipe.val_data, train=False)
    spans.count("test.outside")          # outside the run: not in its delta
    res = _train(pipe, mc, pc, epochs=5, eval_every=2)
    n_eval = len(res.history["epoch"])
    run = spans.last_run()
    assert run["epochs"] == 5
    assert run["counters"]["exchange.bytes"] == 5 * train_b + n_eval * eval_b
    assert "test.outside" not in run["counters"]
    assert run["device_s"] == {} and run["spans"] == []
    assert spans.last_run() is run      # resolved once


@pytest.mark.parametrize("guard", [False, True])
def test_sync_host_counts_each_site_once(guard):
    pipe, mc, pc = _setup("tiny", "coo", dropout=0.0, guard_exchange=guard)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = _train(pipe, mc, pc, epochs=4, eval_every=3)
    n_eval = len(res.history["epoch"])
    sites = collections.Counter(
        n[len("repro.sync."):] for n, _, _ in _host_events(prof)
        if n.startswith("repro.sync."))
    # per step: the verdict, the rollback's host-side select (and the es
    # counters under the guard); per evaluation: the metric and the loss;
    # the closing synchronize and the uploads from the host (Adam's, the
    # finite check's) happen on the card only
    want = {"verdict": 4, "select": 4, "metric": n_eval, "loss": n_eval}
    if guard:
        want["es"] = 4
    assert dict(sites) == want
    assert spans.last_run()["counters"]["sync.host"] == sum(want.values())


def test_uploads_from_the_host_count_as_syncs():
    """On the card Adam's bias corrections and the finite check's verdict
    are uploaded by a blocking copy, which synchronizes the stream: each
    counts once where it crosses devices (here to the meta device), and
    not where the tensor is already in place."""
    from repro_torch.core.health import _finite_tree
    from repro_torch.optim.optimizers import _upload
    x = torch.tensor(0.5)
    before = spans.counter("sync.host")
    assert _upload(x, x.device) is x
    assert spans.counter("sync.host") == before
    assert _upload(x, torch.device("meta")).device.type == "meta"
    assert spans.counter("sync.host") == before + 1
    _finite_tree({"a": torch.zeros(3, device="meta"),
                  "b": torch.zeros(2, device="meta")})
    assert spans.counter("sync.host") == before + 2
    _finite_tree({"a": torch.zeros(3)})
    assert spans.counter("sync.host") == before + 2


def test_span_records_only_while_the_profiler_records():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert spans.tracing()
        with spans.span("repro.test.on"):
            torch.ones(3).sum()
    assert not spans.tracing()
    with spans.span("repro.test.off"):
        pass
    names = {n for n, _, _ in _host_events(prof)}
    assert "repro.test.on" in names and "repro.test.off" not in names
