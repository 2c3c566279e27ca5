"""Full-graph training driver: PipeGCN step + Adam + eval loop.

Port of the JAX package's ``repro.core.trainer`` on the single-device sim
backend or, with ``parts_per_device``, on the ``torch.distributed`` SPMD
backend (one process per rank), without fault injection, elastic
recovery, checkpoints or signal handling (ROADMAP Queue 1). The log
lines, the history, ``TrainResult`` and ``epochs_per_sec`` are the JAX
trainer's. Dropout masks come from a ``torch.Generator`` on the training
device seeded with ``seed + 1``, one mask per layer per step; they differ
from the JAX package's ``jax.random`` bits, which cannot be reproduced.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.core.config import ModelConfig, PipeConfig
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
    parameters, the last metric dict, the wall-clock epoch rate and the
    health anomaly counters (skipped_steps, max_consecutive)."""

    history: dict
    params: dict
    final_metrics: dict
    epochs_per_sec: float
    anomalies: dict = dataclasses.field(default_factory=dict)


def make_train_step(model: PipeGCN, opt: Optimizer,
                    health: HealthConfig | None = None, backend=None):
    """(topo, params, opt_state, buffers, data, generator)
    -> (loss, params, opt_state, buffers[, report]).

    `backend` runs the step (default the sim backend). With `health` (an
    enabled HealthConfig) the step health-checks the update and ROLLS
    BACK by selection: a non-finite / out-of-bound step returns the
    previous params/opt_state/buffers bitwise, plus a fifth element, the
    ``{"ok", "grad_norm"}`` report; on the SPMD backend every rank takes
    the same verdict."""
    guarded = health is not None and health.enabled
    limit = health.grad_norm_limit if guarded else None

    def step(topo, params, opt_state, buffers, data, generator=None):
        loss, grads, new_buffers, _ = model.train_step(
            topo, params, buffers, data, generator, backend=backend)
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


def train_pipegcn(pipeline, model_cfg: ModelConfig, pipe_cfg: PipeConfig,
                  epochs: int, lr: float = 0.01, seed: int = 0,
                  eval_every: int = 10,
                  log: Callable[[str], None] | None = None,
                  health: HealthConfig | None = None,
                  device="cuda",
                  parts_per_device: int | None = None) -> TrainResult:
    """Reference training loop. By default the step runs on the sim
    backend (partitions as a leading tensor axis on one device); with
    `parts_per_device` it runs on the torch.distributed SPMD backend of the
    initialized default process group, each rank (one process) stepping
    on its `parts_per_device` partitions, with the same parameters and
    Adam updates on every rank. `device` must be the device the pipeline
    was built on (a rank's own card under SPMD). `health` — numerical
    guard policy; None means HealthConfig() (guards ON: non-finite steps
    are skipped with bitwise rollback and counted in
    TrainResult.anomalies)."""
    dev = resolve_device(device)
    topo = pipeline.topo
    if topo.send_idx.device.type != dev.type:
        raise ValueError(f"the pipeline lives on {topo.send_idx.device}, "
                         f"not on the requested device {dev}")
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
    backend = None
    train_data, val_data = pipeline.train_data, pipeline.val_data
    if parts_per_device is not None:
        from repro_torch.data.graph_pipeline import rank_view
        backend = SpmdBackend(parts_per_device)
        if backend.num_parts != topo.num_parts:
            raise ValueError(
                f"{backend.world_size} ranks × {parts_per_device} partitions "
                f"per rank != the pipeline's {topo.num_parts} partitions")
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

    def fwd(p):
        logits = model.forward(topo, p, val_data, backend=backend)[1]
        return logits if backend is None else backend.gather_parts(logits)

    anomalies = {"skipped_steps": 0, "max_consecutive": 0}
    consec = 0
    last_metric, last_metric_epoch = None, -1
    history = {"loss": [], "val_acc": [], "test_acc": [], "epoch": []}
    t0 = time.perf_counter()
    for epoch in range(epochs):
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
                        f"{float(rep['grad_norm'])}); aborting instead of "
                        "spinning on a poisoned run")
            else:
                consec = 0
        else:
            loss, params, opt_state, buffers = out
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
                log(line)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    if last_metric_epoch == epochs - 1:
        final = last_metric    # the last epoch already ran this eval
    else:
        final = pipeline.metric(fwd(params))
    return TrainResult(history=history, params=params, final_metrics=final,
                       epochs_per_sec=epochs / dt if dt > 0 and epochs else 0.0,
                       anomalies=anomalies)
