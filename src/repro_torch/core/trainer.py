"""Full-graph training driver: PipeGCN step + Adam + eval loop.

Port of the JAX package's ``repro.core.trainer`` on the single-device sim
backend or, with ``parts_per_device``, on the ``torch.distributed`` SPMD
backend (one process per rank), with fault injection, the guarded
exchange's staleness bound, atomic checkpoints with bit-exact resume, and
SIGTERM / SIGINT preemption; elastic recovery is not ported (ROADMAP
Queue 1 item 10). The log lines, the history, ``TrainResult`` and
``epochs_per_sec`` are the JAX trainer's. Dropout masks come from a
``torch.Generator`` on the training device seeded with ``seed + 1``, one
mask per layer per step; they differ from the JAX package's
``jax.random`` bits, which cannot be reproduced.

A checkpoint holds the full training state in the flat all-P layout
(``{"params", "opt_state", "buffers", "key", "epoch"}``, the JAX
trainer's tree): under SPMD rank 0 writes it after gathering the buffers,
and every rank restores it and takes its own partitions. ``key`` is the
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

from repro_torch.core.config import ModelConfig, PipeConfig
from repro_torch.core.faults import FaultPlan, StalenessExceededError
from repro_torch.core.health import (HealthConfig, TrainingAnomalyError,
                                     health_check, tree_select)
from repro_torch.core.pipegcn import PipeGCN, SpmdBackend
from repro_torch.core.trace_utils import expected_boundary_collectives
from repro_torch.device import resolve_device
from repro_torch.optim.optimizers import Optimizer, adam


@dataclasses.dataclass
class TrainResult:
    """Outcome of one `train_pipegcn` run: the eval-metric trajectory
    (`history` lists loss / val_acc / test_acc / epoch), the final
    parameters, the last metric dict, the wall-clock epoch rate, the
    health / guard anomaly counters (skipped_steps, max_consecutive, and
    under `guard_exchange` exchange_fallbacks, max_effective_staleness),
    the checkpoint step the run resumed from (None for a fresh run), and
    whether a SIGTERM / SIGINT ended it early (`preempted`, after a final
    checkpoint)."""

    history: dict
    params: dict
    final_metrics: dict
    epochs_per_sec: float
    anomalies: dict = dataclasses.field(default_factory=dict)
    resumed_from: int | None = None
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
        new_params, new_opt_state = opt.apply(params, grads, opt_state)
        if not guarded:
            return loss, new_params, new_opt_state, new_buffers
        rep = health_check(loss, grads, new_buffers, grad_norm_limit=limit)
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
                  checkpoint_keep: int | None = None) -> TrainResult:
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

    Preemption: SIGTERM / SIGINT (main thread only) finishes the epoch,
    writes a final checkpoint (when checkpointing is configured) and
    returns with `TrainResult.preempted=True`."""
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
    P = topo.num_parts
    full_topo = topo
    backend = None
    train_data, val_data = pipeline.train_data, pipeline.val_data
    if parts_per_device is not None:
        from repro_torch.data.graph_pipeline import rank_view
        backend = SpmdBackend(parts_per_device)
        if backend.num_parts != P:
            raise ValueError(
                f"{backend.world_size} ranks × {parts_per_device} partitions "
                f"per rank != the pipeline's {P} partitions")
        rank = backend.rank
        topo, train_data, val_data = (
            rank_view(t, rank, parts_per_device)
            for t in (topo, train_data, val_data))
    if log:
        n_coll = expected_boundary_collectives(model_cfg.num_layers,
                                               pipe_cfg.fused, train=True)
        sched = "fused-deferred" if pipe_cfg.fused else "per-layer"
        where = (f"{n_coll} boundary collectives/train step, "
                 f"{backend.world_size} ranks × {parts_per_device} "
                 "partitions" if backend is not None else
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

    params = model.init_params(
        torch.Generator(device=dev).manual_seed(seed))
    opt = adam(lr)
    opt_state = opt.init(params)
    buffers = model.init_buffers(topo)
    step = make_train_step(model, opt, health=hc, backend=backend)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    fifo = pipe_cfg.staleness_steps > 1
    guard = pipe_cfg.guard_exchange

    def fwd(p):
        logits = model.forward(topo, p, val_data, backend=backend)[1]
        return logits if backend is None else backend.gather_parts(logits)

    tables = None
    if faults is not None and not faults.is_empty():
        tables = faults.compile(epochs, model_cfg.num_layers, P,
                                parts_per_device=parts_per_device or 1,
                                device=dev)
        if log:
            n = int(tables.drop_np.sum() + tables.corrupt_np.sum())
            log(f"fault injection: {n} faulted exchange sites over "
                f"{epochs} epochs"
                + (", guard_exchange ON (checksum + stale fallback)"
                   if guard else
                   ", guard_exchange OFF (faults land undetected)"))

    start_epoch = 0
    resumed_from = None
    if resume:
        from repro_torch.checkpoint import (latest_step, read_manifest,
                                            restore_checkpoint)
        last = latest_step(ckpt_dir)
        if last is not None:
            key = next((rec for rec in read_manifest(ckpt_dir, last)[
                "leaves"] if rec["path"] == "['key']"), None)
            # a state without a key (a params-only export) fails the
            # restore's own validation below
            jax_key = key is not None and key["dtype"] != "uint8"
            key_tmpl = (np.zeros(key["shape"], np.dtype(key["dtype"]))
                        if jax_key else gen.get_state())
            state = restore_checkpoint(ckpt_dir, last, {
                "params": params, "opt_state": opt_state,
                "buffers": model.init_buffers(full_topo), "key": key_tmpl,
                "epoch": 0})
            params, opt_state = state["params"], state["opt_state"]
            buffers = _rank_buffers(state["buffers"], backend, fifo)
            if jax_key:
                k = state["key"].astype(np.uint64)
                gen.manual_seed(int(k[0]) << 32 | int(k[1]))
            else:
                gen.set_state(state["key"])
            start_epoch = state["epoch"]
            resumed_from = last
            if log:
                log(f"resumed from checkpoint step {last} "
                    f"(continuing at epoch {start_epoch})")

    anomalies = {"skipped_steps": 0, "max_consecutive": 0}
    if guard:
        anomalies["exchange_fallbacks"] = 0
        anomalies["max_effective_staleness"] = pipe_cfg.staleness_steps

    def save_state(step_no):
        # the generator state is already advanced past this epoch's
        # draws, so a resumed run continues the exact stream
        from repro_torch.checkpoint import save_checkpoint
        flat = _flat_buffers(buffers, backend, fifo)
        if backend is None or backend.rank == 0:
            save_checkpoint(ckpt_dir, step_no, {
                "params": params, "opt_state": opt_state, "buffers": flat,
                "key": gen.get_state(), "epoch": step_no},
                keep_last=checkpoint_keep)
        if backend is not None:
            backend.barrier()

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
    preempted = False
    last_metric, last_metric_epoch = None, -1
    history = {"loss": [], "val_acc": [], "test_acc": [], "epoch": []}
    t0 = time.perf_counter()
    try:
        for epoch in range(start_epoch, epochs):
            if tables is not None:
                out = step(topo, params, opt_state, buffers, train_data, gen,
                           epoch, tables)
            else:
                out = step(topo, params, opt_state, buffers, train_data, gen)
            if hc is not None:
                loss, params, opt_state, buffers, rep = out
                if not bool(rep["ok"]):
                    anomalies["skipped_steps"] += 1
                    consec += 1
                    anomalies["max_consecutive"] = max(
                        anomalies["max_consecutive"], consec)
                    if consec >= hc.max_consecutive_anomalies:
                        raise TrainingAnomalyError(
                            f"{consec} consecutive unhealthy training steps "
                            f"(epoch {epoch}, loss {float(loss)}, grad norm "
                            f"{float(rep['grad_norm'])}); aborting instead "
                            "of spinning on a poisoned run")
                else:
                    consec = 0
            else:
                loss, params, opt_state, buffers = out
            if guard:
                # every rank checks the global counters, so all ranks
                # raise together rather than one blocking the others
                es = buffers["es"]
                if backend is not None:
                    es = backend.gather_parts(es)
                _check_staleness(es.cpu().numpy(), pipe_cfg, anomalies,
                                 epoch)
            if epoch % eval_every == 0 or epoch == epochs - 1:
                m = pipeline.metric(fwd(params))
                last_metric, last_metric_epoch = m, epoch
                history["loss"].append(float(loss))
                history["val_acc"].append(m["val"])
                history["test_acc"].append(m["test"])
                history["epoch"].append(epoch)
                if log:
                    line = (f"epoch {epoch:5d} loss {float(loss):.4f} "
                            f"val {m['val']:.4f} test {m['test']:.4f}")
                    if anomalies["skipped_steps"]:
                        line += f" anomalies {anomalies['skipped_steps']}"
                    if guard and anomalies["exchange_fallbacks"]:
                        line += (
                            f" fallbacks {anomalies['exchange_fallbacks']}"
                            f" es {anomalies['max_effective_staleness']}"
                            f"/{pipe_cfg.max_staleness}")
                    log(line)
            saved = False
            if (ckpt_dir and checkpoint_every
                    and (epoch + 1) % checkpoint_every == 0):
                save_state(epoch + 1)
                saved = True
            if stop_signals:
                if ckpt_dir and checkpoint_every and not saved:
                    save_state(epoch + 1)
                preempted = True
                if log:
                    log(f"preempted (signal {int(stop_signals[0])}): "
                        f"epoch {epoch} finished, final checkpoint "
                        "written, exiting cleanly")
                break
    finally:
        for signum, h in sig_handlers.items():
            signal.signal(signum, h)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    if last_metric_epoch == epochs - 1:
        final = last_metric    # the last epoch already ran this eval
    else:
        final = pipeline.metric(fwd(params))
    ran = max(epochs - start_epoch, 0)
    return TrainResult(history=history, params=params, final_metrics=final,
                       epochs_per_sec=ran / dt if dt > 0 and ran else 0.0,
                       anomalies=anomalies, resumed_from=resumed_from,
                       preempted=preempted)
