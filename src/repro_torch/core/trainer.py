"""Full-graph training driver: PipeGCN step + Adam + eval loop.

Port of the JAX package's ``repro.core.trainer`` on the single-device sim
backend, without fault injection, elastic recovery, checkpoints or signal
handling (ROADMAP Queue 1). The log lines, the history, ``TrainResult``
and ``epochs_per_sec`` are the JAX trainer's. Dropout masks come from a
``torch.Generator`` on the training device seeded with ``seed + 1``, one
mask per layer per step; they differ from the JAX package's ``jax.random``
bits, which cannot be reproduced.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.core.config import ModelConfig, PipeConfig
from repro_torch.core.health import (HealthConfig, TrainingAnomalyError,
                                     health_check, tree_select)
from repro_torch.core.pipegcn import PipeGCN, resolve_device
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


def expected_boundary_collectives(num_layers: int, fused: bool,
                                  train: bool = True) -> int:
    """Boundary exchanges per step: L forward + (L-1) backward per layer
    when blocking, 1 + 1 packed when fused-deferred (a 1-layer model has
    no gradient sends)."""
    L = num_layers
    if fused:
        fwd, bwd = 1, (1 if L > 1 else 0)
    else:
        fwd, bwd = L, L - 1
    return fwd + (bwd if train else 0)


def make_train_step(model: PipeGCN, opt: Optimizer,
                    health: HealthConfig | None = None):
    """(topo, params, opt_state, buffers, data, generator)
    -> (loss, params, opt_state, buffers[, report]).

    With `health` (an enabled HealthConfig) the step health-checks the
    update and ROLLS BACK by selection: a non-finite / out-of-bound step
    returns the previous params/opt_state/buffers bitwise, plus a fifth
    element, the ``{"ok", "grad_norm"}`` report."""
    guarded = health is not None and health.enabled
    limit = health.grad_norm_limit if guarded else None

    def step(topo, params, opt_state, buffers, data, generator=None):
        loss, grads, new_buffers, _ = model.train_step(
            topo, params, buffers, data, generator)
        new_params, new_opt_state = opt.apply(params, grads, opt_state)
        if not guarded:
            return loss, new_params, new_opt_state, new_buffers
        rep = health_check(loss, grads, new_buffers, grad_norm_limit=limit)
        ok = rep["ok"]
        new_params = tree_select(ok, new_params, params)
        new_opt_state = tree_select(ok, new_opt_state, opt_state)
        new_buffers = tree_select(ok, new_buffers, buffers)
        return loss, new_params, new_opt_state, new_buffers, rep

    return step


def train_pipegcn(pipeline, model_cfg: ModelConfig, pipe_cfg: PipeConfig,
                  epochs: int, lr: float = 0.01, seed: int = 0,
                  eval_every: int = 10,
                  log: Callable[[str], None] | None = None,
                  health: HealthConfig | None = None,
                  device="cuda") -> TrainResult:
    """Reference training loop on the sim backend (partitions as a leading
    tensor axis on one device). `device` must be the device the pipeline
    was built on. `health` — numerical guard policy; None means
    HealthConfig() (guards ON: non-finite steps are skipped with bitwise
    rollback and counted in TrainResult.anomalies)."""
    dev = resolve_device(device)
    topo = pipeline.topo
    if topo.send_idx.device.type != dev.type:
        raise ValueError(f"the pipeline lives on {topo.send_idx.device}, "
                         f"not on the requested device {dev}")
    if pipeline.split_spec() is not None:
        raise NotImplementedError("split-phase overlap is not ported "
                                  "(ROADMAP Queue 1 item 6)")
    model = PipeGCN(model_cfg, pipe_cfg)
    # Fail fast if the engine needs Topology fields the pipeline lacks ...
    model._agg_slice(topo)
    # ... or if the config explicitly declares another node layout.
    have = pipeline.layout
    if model_cfg.layout != "auto" and model_cfg.layout != have:
        raise ValueError(
            f"ModelConfig.layout={model_cfg.layout!r} but the pipeline "
            f"was built with layout={have!r}; pass the same layout to "
            "GraphDataPipeline.build (or use layout=\"auto\")")
    if log:
        n_coll = expected_boundary_collectives(model_cfg.num_layers,
                                               pipe_cfg.fused, train=True)
        sched = "fused-deferred" if pipe_cfg.fused else "per-layer"
        log(f"comm schedule: {sched} ({n_coll} boundary exchanges/train "
            f"step, local on the sim backend, L={model_cfg.num_layers})")
        why = "disabled" if pipe_cfg.overlap == "none" else "no feasible split"
        log(f"overlap schedule: unsplit ({why})")
        orders = model.layer_orders(topo, train=True)
        how = ("static FLOP model" if model_cfg.matmul_order == "auto"
               else "forced")
        log(f"matmul order ({how}, agg={model_cfg.agg}): "
            + " ".join(f"L{i}:{'PH.W' if o == 'aggregate-first' else 'P.HW'}"
                       for i, o in enumerate(orders)))
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
    step = make_train_step(model, opt, health=hc)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def fwd(p):
        return model.forward(topo, p, pipeline.val_data)[1]

    anomalies = {"skipped_steps": 0, "max_consecutive": 0}
    consec = 0
    last_metric, last_metric_epoch = None, -1
    history = {"loss": [], "val_acc": [], "test_acc": [], "epoch": []}
    t0 = time.perf_counter()
    for epoch in range(epochs):
        out = step(topo, params, opt_state, buffers, pipeline.train_data, gen)
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
