"""Full-graph training driver: PipeGCN step + Adam + eval loop.

Port of the JAX package's ``repro.core.trainer`` on the single-device sim
backend or, with ``parts_per_device``, on the ``torch.distributed`` SPMD
backend (one process per rank), with fault injection, the guarded
exchange's staleness bound, atomic checkpoints with bit-exact resume,
SIGTERM / SIGINT preemption, and the elastic runtime (device-loss
detection, survivor remap, warm recovery and rejoin; ``core/elastic.py``).
The log lines, the history, ``TrainResult`` and ``epochs_per_sec`` are the
JAX trainer's. Dropout masks come from a
``torch.Generator`` on the training device seeded with ``seed + 1``, one
mask per layer per step; they differ from the JAX package's
``jax.random`` bits, which cannot be reproduced.

A checkpoint holds the full training state in the flat all-P layout
(``{"params", "opt_state", "buffers", "key", "epoch"}``, the JAX
trainer's tree): under SPMD the first survivor (rank 0 unless an elastic
recovery left it out) writes it after gathering the buffers, and every
rank restores it and takes its own partitions. ``key`` is the
dropout generator's state, one uint8 leaf (every rank holds the same).
A JAX checkpoint's ``uint32[2]`` key is accepted and seeds the generator
with ``key[0] << 32 | key[1]``.
"""
from __future__ import annotations

import dataclasses
import signal
import threading
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import elastic as elastic_mod
from repro_torch.core.config import ModelConfig, PipeConfig
from repro_torch.core.elastic import ElasticConfig, ElasticPlan
from repro_torch.core.faults import FaultPlan, StalenessExceededError
from repro_torch.core.health import (HealthConfig, TrainingAnomalyError,
                                     health_check, tree_select)
from repro_torch.core.pipegcn import PipeGCN, SpmdBackend
from repro_torch.core.trace_utils import expected_boundary_collectives
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_survivor_group, survivor_ranks
from repro_torch.optim.optimizers import Optimizer, adam


@dataclasses.dataclass
class TrainResult:
    """Outcome of one `train_pipegcn` run: the eval-metric trajectory
    (`history` lists loss / val_acc / test_acc / epoch), the final
    parameters, the last metric dict, the wall-clock epoch rate, the
    health / guard anomaly counters (skipped_steps, max_consecutive, and
    under `guard_exchange` exchange_fallbacks, max_effective_staleness;
    device_losses and rejoins under an enabled ElasticConfig), the
    checkpoint step the run resumed from (None for a fresh run), how many
    elastic device-loss recoveries ran, and whether a SIGTERM / SIGINT
    ended it early (`preempted`, after a final checkpoint)."""

    history: dict
    params: dict
    final_metrics: dict
    epochs_per_sec: float
    anomalies: dict = dataclasses.field(default_factory=dict)
    resumed_from: int | None = None
    recoveries: int = 0
    preempted: bool = False


def make_train_step(model: PipeGCN, opt: Optimizer,
                    health: HealthConfig | None = None, backend=None):
    """(topo, params, opt_state, buffers, data, generator[, step_idx,
    faults]) -> (loss, params, opt_state, buffers[, report]).

    `backend` runs the step (default the sim backend). With `health` (an
    enabled HealthConfig) the step health-checks the update and ROLLS
    BACK by selection: a non-finite / out-of-bound step returns the
    previous params/opt_state/buffers bitwise, plus a fifth element, the
    ``{"ok", "grad_norm"}`` report; on the SPMD backend every rank takes
    the same verdict. `step_idx` + `faults` (compiled FaultTables) inject
    that step's exchange faults; None runs the fault-free step."""
    guarded = health is not None and health.enabled
    limit = health.grad_norm_limit if guarded else None

    def step(topo, params, opt_state, buffers, data, generator=None,
             step_idx=None, faults=None):
        loss, grads, new_buffers, _ = model.train_step(
            topo, params, buffers, data, generator, backend=backend,
            step_idx=step_idx, faults=faults)
        with spans.span("repro.opt", device=True):
            new_params, new_opt_state = opt.apply(params, grads, opt_state)
        if not guarded:
            return loss, new_params, new_opt_state, new_buffers
        with spans.span("repro.health"):
            rep = health_check(loss, grads, new_buffers,
                               grad_norm_limit=limit)
            if backend is not None:
                rep["ok"] = backend.all_ok(rep["ok"])
            ok = rep["ok"]
            new_params = tree_select(ok, new_params, params)
            new_opt_state = tree_select(ok, new_opt_state, opt_state)
            new_buffers = tree_select(ok, new_buffers, buffers)
        return loss, new_params, new_opt_state, new_buffers, rep

    return step


def make_spmd_train_step(model: PipeGCN, opt: Optimizer, n_local: int,
                         health: HealthConfig | None = None, group=None):
    """`make_train_step` on the torch.distributed backend: each rank steps
    on its own n_local partitions (the rank's view of the topology, data
    and buffers), the weight gradients are summed over every partition of
    every rank, and each rank applies the same Adam update to its copy of
    the parameters. Same signature and returns as the sim-backend step
    (loss global, buffers the rank's)."""
    return make_train_step(model, opt, health,
                           backend=SpmdBackend(n_local, group=group))


def _orders_line(what, how, agg, orders):
    return (f"{what} ({how}, agg={agg}): "
            + " ".join(f"L{i}:{'PH.W' if o == 'aggregate-first' else 'P.HW'}"
                       for i, o in enumerate(orders)))


def _check_staleness(es, pipe_cfg: PipeConfig, anomalies: dict, epoch: int):
    """Host-side guard bookkeeping on one step's global "es" counters
    (numpy, (P, 2, L, P)); raises StalenessExceededError once any
    exchange's effective staleness (FIFO depth + consecutive fallbacks)
    exceeds `max_staleness`. The message is the JAX trainer's."""
    anomalies["exchange_fallbacks"] += int((es > 0).sum())
    worst = int(es.max()) if es.size else 0
    eff = pipe_cfg.staleness_steps + worst
    anomalies["max_effective_staleness"] = max(
        anomalies["max_effective_staleness"], eff)
    if eff > pipe_cfg.max_staleness:
        dst, d, ell, src = np.unravel_index(int(es.argmax()), es.shape)
        raise StalenessExceededError(
            f"effective staleness {eff} exceeds max_staleness="
            f"{pipe_cfg.max_staleness} at epoch {epoch}: the "
            f"{'forward feature' if d == 0 else 'backward gradient'} "
            f"exchange of layer {ell} from partition {src} to partition "
            f"{dst} has fallen back {worst} consecutive steps on top of "
            f"the base staleness {pipe_cfg.staleness_steps}; the bounded-"
            "staleness convergence contract no longer holds")


def _buffer_axis(kind: str, fifo: bool) -> int:
    """The partition axis of a buffer leaf: 1 under a k-step FIFO, except
    the "es" counters, which never grow a FIFO axis."""
    return 1 if fifo and kind != "es" else 0


def _map_buffers(fn, buffers):
    """{kind: fn(kind, leaf)} over the feat / grad tuples and "es"."""
    return {k: tuple(fn(k, x) for x in v) if isinstance(v, tuple)
            else fn(k, v) for k, v in buffers.items()}


def _flat_buffers(buffers, backend, fifo: bool):
    """A rank's buffers gathered into the flat all-P layout (the buffers
    themselves on the sim backend)."""
    if backend is None:
        return buffers

    def gather(kind, x):
        ax = _buffer_axis(kind, fifo)
        return backend.gather_parts(x.movedim(ax, 0)).movedim(0, ax)

    return _map_buffers(gather, buffers)


def _rank_buffers(buffers, backend, fifo: bool):
    """This rank's partitions of flat all-P buffers."""
    if backend is None:
        return buffers
    from repro_torch.data.graph_pipeline import rank_view
    return _map_buffers(lambda kind, x: rank_view(
        x, backend.rank, backend.n_local,
        axis=_buffer_axis(kind, fifo)).contiguous(), buffers)


# What the survivors did in an epoch, as the followers (idle ranks) read it
# from the writer's broadcast: continue, rejoin at this checkpoint, a
# device loss (then the device and the epoch), or an abort.
_GO, _REJOIN, _LOSS, _ABORT = range(4)


@dataclasses.dataclass
class _Layout:
    """The partitions this process steps on under one plan (None: the
    original layout). Under SPMD an idle rank (a lost device of a logical
    loss) holds no partition and follows the survivors: `topo`, `train`,
    `val` and `backend` are None there. `writer` is the global rank that
    writes checkpoints and broadcasts to the followers; `followers` says
    whether the job has idle ranks."""

    topo: object
    train: object
    val: object
    backend: SpmdBackend | None
    survivors: tuple
    n_local: int
    idle: bool = False
    writer: int = 0
    followers: bool = False


@spans.run
def train_pipegcn(pipeline, model_cfg: ModelConfig, pipe_cfg: PipeConfig,
                  epochs: int, lr: float = 0.01, seed: int = 0,
                  eval_every: int = 10,
                  log: Callable[[str], None] | None = None,
                  health: HealthConfig | None = None,
                  device="cuda",
                  parts_per_device: int | None = None,
                  faults: FaultPlan | None = None,
                  ckpt_dir: str | None = None, checkpoint_every: int = 0,
                  resume: bool = False,
                  checkpoint_keep: int | None = None,
                  elastic: ElasticConfig | None = None,
                  elastic_plan: ElasticPlan | None = None) -> TrainResult:
    """Reference training loop. By default the step runs on the sim
    backend (partitions as a leading tensor axis on one device); with
    `parts_per_device` it runs on the torch.distributed SPMD backend of the
    initialized default process group, each rank (one process) stepping
    on its `parts_per_device` partitions, with the same parameters and
    Adam updates on every rank. `device` must be the device the pipeline
    was built on (a rank's own card under SPMD).

    Fault tolerance:
      * `health` — numerical guard policy; None means HealthConfig()
        (guards ON: non-finite steps are skipped with bitwise rollback and
        counted in TrainResult.anomalies).
      * `faults` — a FaultPlan compiled over the epoch horizon and
        injected into every exchange; with `pipe_cfg.guard_exchange` the
        receiver detects and falls back, and each step's "es" counters
        (gathered from every rank under SPMD) are held to
        `max_staleness` (StalenessExceededError).
      * `ckpt_dir` + `checkpoint_every` — atomically checkpoint the full
        training state (params, opt_state, buffers, generator state,
        epoch) every N epochs; `resume=True` restores the latest
        checkpoint and continues bit-exactly. `checkpoint_keep` prunes
        all but the newest N checkpoints after each save.

    Elasticity (`core/elastic.py`):
      * `elastic` — an enabled ElasticConfig arms device-loss detection
        (requires `pipe_cfg.guard_exchange`): once every forward exchange
        out of one device has fallen back `detect_after` consecutive
        steps, the trainer restores the latest checkpoint, remaps the
        lost device's partitions onto the survivors (idle pad partitions
        for uneven fits), warm-marks the remapped exchanges with
        `warm_staleness` es counts and resumes; it scales back up at a
        checkpoint boundary once the device is healthy (`rejoin`).
        Checkpoints are always written in the flat original layout, by
        the first survivor, so any device count can restore them. A
        device is `elastic.parts_per_device` partitions on the sim
        backend and a rank under SPMD. The SPMD loss is logical (every
        process alive): the survivors step on their own process group
        (`launch.mesh.make_survivor_group`), and the lost rank takes no
        step; it follows the survivors through one broadcast per epoch,
        restores the written checkpoint when it rejoins, and receives the
        final parameters, so every rank returns the same result.
      * `elastic_plan` — start on a survivor layout (a fresh launch at the
        smaller device count): with `resume=True` this takes the same
        restore → remap → warm-mark path as a mid-run recovery, which
        makes the two bitwise identical from the shared checkpoint on.
        Under SPMD its `orig_devices` is the world size.

    Preemption: SIGTERM / SIGINT (main thread only) finishes the epoch,
    writes a final checkpoint (when checkpointing is configured) and
    returns with `TrainResult.preempted=True`.

    Tracing (`repro_torch.spans`): under a ``torch.profiler`` session the
    run records the spans ``repro.run.setup`` (entry to the first epoch),
    ``repro.epoch`` and those of the step, the optimizer, the health guard,
    each host sync and each evaluation; `spans.last_run()` then gives the
    run's epochs, counter changes and device seconds per span."""
    spans.enter("repro.run.setup")
    dev = resolve_device(device)
    topo = pipeline.topo
    if topo.send_idx.device.type != dev.type:
        raise ValueError(f"the pipeline lives on {topo.send_idx.device}, "
                         f"not on the requested device {dev}")
    if resume and not ckpt_dir:
        raise ValueError("resume=True requires ckpt_dir")
    split = pipeline.split_spec()
    model = PipeGCN(model_cfg, pipe_cfg, split=split)
    # Fail fast if the engine needs Topology fields the pipeline lacks ...
    model._agg_slice(topo)
    # ... or if the config explicitly declares another node layout.
    have = pipeline.layout
    if model_cfg.layout != "auto" and model_cfg.layout != have:
        raise ValueError(
            f"ModelConfig.layout={model_cfg.layout!r} but the pipeline "
            f"was built with layout={have!r}; pass the same layout to "
            "GraphDataPipeline.build (or use layout=\"auto\")")
    from repro_torch.data.graph_pipeline import rank_view
    P = topo.num_parts
    full_backend = None
    grank = 0
    if parts_per_device is not None:
        import torch.distributed as dist
        full_backend = SpmdBackend(parts_per_device)
        if full_backend.num_parts != P:
            raise ValueError(
                f"{full_backend.world_size} ranks × {parts_per_device} "
                f"partitions per rank != the pipeline's {P} partitions")
        grank = dist.get_rank()
        topo = rank_view(topo, full_backend.rank, parts_per_device)
    if log:
        n_coll = expected_boundary_collectives(model_cfg.num_layers,
                                               pipe_cfg.fused, train=True)
        sched = "fused-deferred" if pipe_cfg.fused else "per-layer"
        where = (f"{n_coll} boundary collectives/train step, "
                 f"{full_backend.world_size} ranks × {parts_per_device} "
                 "partitions" if full_backend is not None else
                 f"{n_coll} boundary exchanges/train step, local on the "
                 "sim backend")
        log(f"comm schedule: {sched} ({where}, L={model_cfg.num_layers})")
        sp = model._split_active()
        if sp is not None:
            log(f"overlap schedule: split-phase (fwd boundary "
                f"{sp.fwd_bnd_tiles} tiles @ rows>={sp.row_tail}, "
                f"transpose boundary {sp.t_bnd_tiles} tiles @ "
                f"cols>={sp.col_tail}; collectives issued between phases)")
        else:
            why = ("disabled" if pipe_cfg.overlap == "none" else
                   "no feasible split" if split is None else
                   "feature slicing" if pipe_cfg.slice_boundary else
                   f"engine {model_cfg.agg!r} has no tile phases")
            log(f"overlap schedule: unsplit ({why})")
        # under the split the fused epilogue is bypassed: log the orders
        # the split step resolves (fused=False pricing)
        how = ("static FLOP model" if model_cfg.matmul_order == "auto"
               else "forced")
        log(_orders_line("matmul order", how, model_cfg.agg,
                         model.step_orders(topo, train=True)))
        eval_model = dataclasses.replace(model, pipe=PipeConfig.vanilla())
        log(_orders_line("eval matmul order", how, model_cfg.agg,
                         eval_model.step_orders(topo, train=False)))
        if pipe_cfg.wire != "f32" or pipe_cfg.slice_boundary:
            codecs = model.wire_codecs(topo)
            widths = model.payload_widths(topo)
            sl = model.sliced_layers(topo)
            log("boundary wire: " + " ".join(
                f"L{i}:{c.name}x{w}{'s' if i in sl else ''}"
                for i, (c, w) in enumerate(zip(codecs, widths)))
                + (" (s = sliced to the post-transform width)" if sl else ""))
        if topo.tile_rows is not None:
            from repro_torch.analysis.cost import graph_layout_report
            rep = graph_layout_report(pipeline.pg)
            log(f"graph layout: {have} ({rep['tiles']} nonempty tiles, "
                f"bandwidth {rep['bandwidth']}, "
                f"{rep['halo_runs']} halo row runs)")
        else:
            log(f"graph layout: {have}")
    if health is None:
        health = HealthConfig()
    hc = health if health.enabled else None
    guard = pipe_cfg.guard_exchange

    el_on = elastic is not None and elastic.enabled
    if elastic_plan is not None and not el_on:
        raise ValueError("elastic_plan requires an enabled ElasticConfig "
                         "(pass elastic=ElasticConfig(...))")
    if el_on:
        if not guard:
            raise ValueError(
                "the elastic runtime detects device loss through the "
                "guarded exchange's es counters; set "
                "PipeConfig.guard_exchange=True")
        if (pipe_cfg.staleness_steps + elastic.detect_after
                > pipe_cfg.max_staleness):
            raise ValueError(
                f"elastic detect_after={elastic.detect_after} can never "
                f"fire: staleness_steps={pipe_cfg.staleness_steps} + "
                f"detect_after exceeds max_staleness="
                f"{pipe_cfg.max_staleness}, so the run would abort first")
    plan = elastic_plan
    if plan is not None and plan.num_parts != P:
        raise ValueError(f"elastic_plan remaps {plan.num_parts} partitions "
                         f"but the pipeline has {P}")
    # original device granularity: what "one device" means to the
    # device_down fault plane and the loss detector
    if plan is not None:
        orig_devices = plan.orig_devices
    elif full_backend is not None:
        orig_devices = full_backend.world_size
    elif el_on:
        orig_devices = P // elastic.parts_per_device
    else:
        orig_devices = P
    if orig_devices < 1 or P % orig_devices:
        raise ValueError(
            f"num_parts={P} is not a multiple of the device count "
            f"{orig_devices}")
    if (plan is not None and full_backend is not None
            and plan.orig_devices != full_backend.world_size):
        raise ValueError(
            f"elastic_plan has orig_devices={plan.orig_devices} but the "
            f"job has {full_backend.world_size} ranks: under SPMD the loss "
            "is logical, every original rank still runs")
    orig_ppd = P // orig_devices

    def make_layout(p) -> _Layout:
        # under SPMD, every rank of the job calls this together (the
        # survivor group is made collectively)
        if p is None:
            views = (pipeline.topo, pipeline.train_data, pipeline.val_data)
            lay = _Layout(*views, full_backend, tuple(range(orig_devices)),
                          orig_ppd)
        else:
            lay = _Layout(*pipeline.elastic_views(p), None, p.survivors,
                          p.n_local)
        if full_backend is None:
            return lay
        if p is None:
            lay.topo, lay.train, lay.val = (
                rank_view(t, full_backend.rank, orig_ppd)
                for t in (lay.topo, lay.train, lay.val))
            return lay
        group = make_survivor_group(p)
        members = survivor_ranks(p, full_backend.world_size)
        lay.writer = members[0]
        lay.followers = len(members) < full_backend.world_size
        if grank not in members:
            lay.idle = True
            lay.topo = lay.train = lay.val = None
            return lay
        lay.backend = SpmdBackend(p.n_local, group=group)
        lay.topo, lay.train, lay.val = (
            rank_view(t, lay.backend.rank, p.n_local)
            for t in (lay.topo, lay.train, lay.val))
        return lay

    params = model.init_params(
        torch.Generator(device=dev).manual_seed(seed))
    opt = adam(lr)
    opt_state = opt.init(params)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    fifo = pipe_cfg.staleness_steps > 1
    lay = make_layout(plan)
    buffers = None if lay.idle else model.init_buffers(lay.topo)

    def build_step(lay):
        return (None if lay.idle else
                make_train_step(model, opt, health=hc, backend=lay.backend))

    step = build_step(lay)

    def fwd(p):
        logits = model.forward(lay.topo, p, lay.val, backend=lay.backend)[1]
        return (logits if lay.backend is None
                else lay.backend.gather_parts(logits))

    def evaluate(p):
        with spans.span("repro.eval"):
            logits = fwd(p)
            with spans.span("repro.eval.metric"):
                return pipeline.metric(logits)

    def build_tables(active_plan):
        # with a plan active the lost device is already remapped away, so
        # its device_down sites are moot; pad partitions never carry real
        # faults (mask_pad_faults): their idle wires must stay valid
        if faults is None or faults.is_empty():
            return None
        fp = faults if active_plan is None else faults.without_device_down()
        if fp.is_empty():
            return None
        if active_plan is None:
            return fp.compile(epochs, model_cfg.num_layers, P,
                              parts_per_device=orig_ppd, device=dev)
        tab = fp.compile(epochs, model_cfg.num_layers,
                         active_plan.padded_parts,
                         parts_per_device=active_plan.n_local, device=dev)
        return elastic_mod.mask_pad_faults(tab, P)

    tables = build_tables(plan)
    if tables is not None and log:
        n = int(tables.drop_np.sum() + tables.corrupt_np.sum())
        log(f"fault injection: {n} faulted exchange sites over "
            f"{epochs} epochs"
            + (", guard_exchange ON (checksum + stale fallback)"
               if guard else
               ", guard_exchange OFF (faults land undetected)"))

    def restore(step_no):
        """Params, Adam state, flat buffers and epoch of checkpoint
        `step_no`; sets the dropout generator's state."""
        from repro_torch.checkpoint import read_manifest, restore_checkpoint
        key = next((rec for rec in read_manifest(ckpt_dir, step_no)[
            "leaves"] if rec["path"] == "['key']"), None)
        # a state without a key (a params-only export) fails the
        # restore's own validation below
        jax_key = key is not None and key["dtype"] != "uint8"
        key_tmpl = (np.zeros(key["shape"], np.dtype(key["dtype"]))
                    if jax_key else gen.get_state())
        # checkpoints are always in the flat original layout (a remapped
        # run unmaps before saving), so one template serves every layout
        state = restore_checkpoint(ckpt_dir, step_no, {
            "params": params, "opt_state": opt_state,
            "buffers": model.init_buffers(pipeline.topo), "key": key_tmpl,
            "epoch": 0})
        if jax_key:
            k = state["key"].astype(np.uint64)
            gen.manual_seed(int(k[0]) << 32 | int(k[1]))
        else:
            gen.set_state(state["key"])
        return (state["params"], state["opt_state"], state["buffers"],
                state["epoch"])

    def apply_plan_state(flat_bufs, p):
        # the one restore → remap → warm-mark path shared by mid-run
        # recovery and a fresh survivor-layout launch: routing both
        # through it is what makes them bitwise identical
        b = elastic_mod.remap_buffers(flat_bufs, p)
        return elastic_mod.warm_mark(b, p.moved_partitions(),
                                     elastic.warm_staleness if el_on else 0,
                                     P)

    def own(flat_bufs):
        """This process's partitions of (remapped) flat buffers."""
        return (None if lay.idle else
                _rank_buffers(flat_bufs, lay.backend, fifo))

    start_epoch = 0
    resumed_from = None
    if resume:
        from repro_torch.checkpoint import latest_step
        last = latest_step(ckpt_dir)
        if last is not None:
            params, opt_state, flat, start_epoch = restore(last)
            buffers = own(apply_plan_state(flat, plan) if plan is not None
                          else flat)
            resumed_from = last
            if log:
                log(f"resumed from checkpoint step {last} "
                    f"(continuing at epoch {start_epoch})")

    anomalies = {"skipped_steps": 0, "max_consecutive": 0}
    if guard:
        anomalies["exchange_fallbacks"] = 0
        anomalies["max_effective_staleness"] = pipe_cfg.staleness_steps
    if el_on:
        anomalies["device_losses"] = []
        anomalies["rejoins"] = 0

    def save_state(step_no):
        # the generator state is already advanced past this epoch's
        # draws, so a resumed run continues the exact stream
        from repro_torch.checkpoint import save_checkpoint
        flat = _flat_buffers(buffers, lay.backend, fifo)
        if plan is not None:
            flat = elastic_mod.unmap_buffers(flat, plan)
        if grank == lay.writer:
            save_checkpoint(ckpt_dir, step_no, {
                "params": params, "opt_state": opt_state, "buffers": flat,
                "key": gen.get_state(), "epoch": step_no},
                keep_last=checkpoint_keep)
        if lay.backend is not None:
            lay.backend.barrier()
        return flat

    def status(src, kind=_GO, a=0, b=0, stop=False):
        """The writer's (`src`) per-epoch broadcast to every rank while
        some are idle: what the survivors did (the followers pass
        nothing)."""
        import torch.distributed as dist
        t = torch.tensor([kind, a, b, int(stop)], dtype=torch.int64,
                         device=dev)
        dist.broadcast(t, src=src)
        with spans.sync("status"):
            return [int(v) for v in t.tolist()]

    def device_back(at_step):
        lost = set(range(orig_devices)) - set(plan.survivors)
        return not (faults is not None
                    and faults.downed_devices(at_step) & lost)

    stop_signals: list = []
    sig_handlers = {}
    if threading.current_thread() is threading.main_thread():
        for signum in (signal.SIGTERM, signal.SIGINT):
            try:
                sig_handlers[signum] = signal.signal(
                    signum, lambda s, _f: stop_signals.append(s))
            except (ValueError, OSError):
                pass

    consec = 0
    recoveries = 0
    preempted = False
    last_metric, last_metric_epoch = None, -1
    history = {"loss": [], "val_acc": [], "test_acc": [], "epoch": []}

    def host_state(src):
        """Every rank takes the writer's host-side records (an idle rank
        missed them)."""
        import torch.distributed as dist
        box = [(history, anomalies, last_metric, last_metric_epoch, consec)]
        dist.broadcast_object_list(box, src=src)
        return box[0]

    spans.leave()
    t0 = time.perf_counter()
    epoch = start_epoch
    try:
        while epoch < epochs:
            spans.enter("repro.epoch", epoch)
            try:
                if lay.idle:
                    kind, a, b, stop = status(lay.writer)
                    if kind == _LOSS:
                        raise elastic_mod.DeviceLossError(
                            f"device {a} detected down at epoch {b}", a,
                            tuple(s for s in lay.survivors if s != a), b)
                    if kind == _ABORT:
                        raise RuntimeError(
                            f"the survivors aborted the run at epoch {b}")
                    if kind == _REJOIN:
                        writer = lay.writer
                        params, opt_state, flat, _ = restore(epoch + 1)
                        moved = plan.moved_partitions()
                        plan = None
                        lay = make_layout(None)
                        buffers = own(elastic_mod.warm_mark(
                            flat, moved, elastic.warm_staleness, P))
                        step = build_step(lay)
                        tables = build_tables(None)
                        (history, anomalies, last_metric, last_metric_epoch,
                         consec) = host_state(writer)
                    if stop:
                        preempted = True
                        break
                    epoch += 1
                    continue
                followers = lay.followers
                try:
                    if tables is not None:
                        out = step(lay.topo, params, opt_state, buffers,
                                   lay.train, gen, epoch, tables)
                    else:
                        out = step(lay.topo, params, opt_state, buffers,
                                   lay.train, gen)
                    if hc is not None:
                        loss, params, opt_state, buffers, rep = out
                        with spans.sync("verdict"):
                            ok = bool(rep["ok"])
                        if not ok:
                            anomalies["skipped_steps"] += 1
                            consec += 1
                            anomalies["max_consecutive"] = max(
                                anomalies["max_consecutive"], consec)
                            if consec >= hc.max_consecutive_anomalies:
                                raise TrainingAnomalyError(
                                    f"{consec} consecutive unhealthy "
                                    f"training steps (epoch {epoch}, loss "
                                    f"{float(loss)}, grad norm "
                                    f"{float(rep['grad_norm'])}); aborting "
                                    "instead of spinning on a poisoned run")
                        else:
                            consec = 0
                    else:
                        loss, params, opt_state, buffers = out
                    if guard:
                        # every rank checks the global counters, so all
                        # ranks raise together rather than one blocking
                        # the others
                        es = buffers["es"]
                        if lay.backend is not None:
                            es = lay.backend.gather_parts(es)
                        with spans.sync("es"):
                            es_host = es.cpu().numpy()
                        if el_on:
                            # device loss pre-empts the staleness abort: a
                            # blanket whole-device fallback row is an
                            # outage to recover from, not a contract
                            # violation
                            down = elastic_mod.detect_device_loss(
                                es_host, lay.n_local, P,
                                elastic.detect_after)
                            if down is not None:
                                lost = lay.survivors[down]
                                if followers:
                                    status(lay.writer, _LOSS, lost, epoch)
                                raise elastic_mod.DeviceLossError(
                                    f"device {lost} detected down at epoch "
                                    f"{epoch}: every forward exchange out "
                                    f"of it has fallen back >= "
                                    f"{elastic.detect_after} consecutive "
                                    "steps", lost,
                                    tuple(s for s in lay.survivors
                                          if s != lost), epoch)
                        _check_staleness(es_host, pipe_cfg, anomalies, epoch)
                except (StalenessExceededError,
                        TrainingAnomalyError) as err:
                    if followers and not isinstance(
                            err, elastic_mod.DeviceLossError):
                        status(lay.writer, _ABORT, 0, epoch)
                    raise
                if epoch % eval_every == 0 or epoch == epochs - 1:
                    m = evaluate(params)
                    last_metric, last_metric_epoch = m, epoch
                    with spans.sync("loss"):
                        loss_host = float(loss)
                    history["loss"].append(loss_host)
                    history["val_acc"].append(m["val"])
                    history["test_acc"].append(m["test"])
                    history["epoch"].append(epoch)
                    if log:
                        line = (f"epoch {epoch:5d} loss {loss_host:.4f} "
                                f"val {m['val']:.4f} test {m['test']:.4f}")
                        if anomalies["skipped_steps"]:
                            line += f" anomalies {anomalies['skipped_steps']}"
                        if guard and anomalies["exchange_fallbacks"]:
                            line += (
                                f" fallbacks {anomalies['exchange_fallbacks']}"
                                f" es {anomalies['max_effective_staleness']}"
                                f"/{pipe_cfg.max_staleness}")
                        log(line)
                saved = rejoined = False
                writer = lay.writer
                if (ckpt_dir and checkpoint_every
                        and (epoch + 1) % checkpoint_every == 0):
                    flat = save_state(epoch + 1)
                    saved = True
                    if (plan is not None and el_on and elastic.rejoin
                            and device_back(epoch + 1)):
                        # rejoin: the just-saved flat state is the live
                        # state unmapped; resume it on the full device
                        # count, warm-marking the partitions moving home
                        moved = plan.moved_partitions()
                        plan = None
                        lay = make_layout(None)
                        buffers = own(elastic_mod.warm_mark(
                            flat, moved, elastic.warm_staleness, P))
                        step = build_step(lay)
                        tables = build_tables(None)
                        anomalies["rejoins"] += 1
                        rejoined = True
                        if log:
                            log(f"rejoin: scaled back up to {orig_devices} "
                                f"devices at checkpoint step {epoch + 1} "
                                f"({len(moved)} partitions warm-marked)")
                stop = bool(stop_signals)
                if stop and ckpt_dir and checkpoint_every and not saved:
                    save_state(epoch + 1)
                if followers:
                    status(writer, _REJOIN if rejoined else _GO, stop=stop)
                    if rejoined:
                        host_state(writer)
                if stop:
                    preempted = True
                    if log:
                        log(f"preempted (signal {int(stop_signals[0])}): "
                            f"epoch {epoch} finished, final checkpoint "
                            "written, exiting cleanly")
                    break
                epoch += 1
            except elastic_mod.DeviceLossError as err:
                if not el_on:
                    raise
                if recoveries >= elastic.max_recoveries:
                    raise
                if not ckpt_dir:
                    raise RuntimeError(
                        "elastic recovery needs a checkpoint to restore "
                        "from — run with ckpt_dir + checkpoint_every"
                    ) from err
                from repro_torch.checkpoint import latest_step
                last = latest_step(ckpt_dir)
                if last is None:
                    raise RuntimeError(
                        "device lost before the first checkpoint landed — "
                        "nothing to recover from") from err
                if not err.survivors:
                    raise RuntimeError(
                        "no surviving devices to remap onto") from err
                plan = ElasticPlan(num_parts=P, orig_devices=orig_devices,
                                   survivors=err.survivors)
                lay = make_layout(plan)
                params, opt_state, flat, epoch = restore(last)
                buffers = own(apply_plan_state(flat, plan))
                step = build_step(lay)
                tables = build_tables(plan)
                recoveries += 1
                consec = 0
                anomalies["device_losses"].append({
                    "device": err.device, "detected_epoch": err.epoch,
                    "resumed_from": int(last),
                    "survivors": list(plan.survivors)})
                if log:
                    log(f"device {err.device} lost at epoch {err.epoch}: "
                        f"remapped {P} partitions onto survivors "
                        f"{list(plan.survivors)} ({plan.n_local}/device, "
                        f"{plan.pad_parts} pad), restored checkpoint step "
                        f"{last}, resuming at epoch {epoch}")
    finally:
        spans.leave()
        for signum, h in sig_handlers.items():
            signal.signal(signum, h)
    if dev.type == "cuda":
        with spans.sync("end"):
            torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    final = None
    if not lay.idle:           # the last epoch may have run this eval
        if last_metric_epoch == epochs - 1:
            final = last_metric
        else:
            final = evaluate(params)
    if lay.followers:
        # the idle ranks take the survivors' result
        import torch.distributed as dist
        for k in sorted(params):
            dist.broadcast(params[k], src=lay.writer)
        box = [(history, anomalies, final, preempted)]
        dist.broadcast_object_list(box, src=lay.writer)
        history, anomalies, final, preempted = box[0]
    ran = max(epochs - start_epoch, 0)
    return TrainResult(history=history, params=params, final_metrics=final,
                       epochs_per_sec=ran / dt if dt > 0 and ran else 0.0,
                       anomalies=anomalies, resumed_from=resumed_from,
                       recoveries=recoveries, preempted=preempted)
