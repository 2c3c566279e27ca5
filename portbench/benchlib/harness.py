"""One run of one cell: build the cell's graph and hand it to the port,
warm up, time one ``train_pipegcn`` call, then judge what its first steps
produced against the reference and read the cell's metrics.

    set-up   generate the graph (numpy) -> GraphDataset -> GraphDataPipeline
             on the device -> two short train_pipegcn calls (the first
             builds every kernel, the second gives the epoch rate)
    window   train_pipegcn(epochs=E, eval_every=E): E from that rate, so
             the call lasts about `seconds`
    after    free the program's state, rebuild the partitioned graph with
             the benchmark's own substrate, run the reference's first three
             steps from the seed, compare

A ``trace=1`` run also records engine spans and a profiler session over
its window (at most TRACE_MAX_EPOCHS epochs), and reports the per-layer
metrics instead of the end-to-end ones.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import time

import numpy as np
import torch

from benchlib import reference, substrate, trace, work
from benchlib.graphgen import make_graph_data
from benchlib.spec import BENCH_DIR, REPO_ROOT, load_reader, resolve
from benchlib.tap import StepTap

TRACE_MAX_EPOCHS = 40
CHECK_STEPS = 3
TILE_ENGINES = ("blocksparse", "fused")   # the engines the rcm layout serves


def resolved_layout(traffic: dict) -> str:
    """The node layout a traffic mix asks for ("auto": rcm exactly when
    the engine consumes tiles, as the pipeline resolves it)."""
    lay = traffic["layout"]
    if lay == "auto":
        return "rcm" if traffic["agg"] in TILE_ENGINES else "natural"
    return lay


def _program_inputs(cfg: dict, traffic: dict, data, device):
    """The port's dataset, pipeline and configs for a cell."""
    from repro_torch.core.config import ModelConfig, PipeConfig
    from repro_torch.data.graph_pipeline import GraphDataPipeline
    from repro_torch.graph.csr import CSRGraph
    from repro_torch.graph.synthetic import GraphDataset
    g = data.graph
    ds = GraphDataset(
        name=cfg["name"],
        graph=CSRGraph(indptr=g.indptr, indices=g.indices,
                       weights=np.ones(g.num_edges, np.float32)),
        features=data.features, labels=data.labels,
        train_mask=data.train_mask, val_mask=data.val_mask,
        test_mask=data.test_mask, num_classes=data.num_classes,
        multilabel=data.multilabel)
    t0 = time.perf_counter()
    pipeline = GraphDataPipeline.build(
        ds, int(traffic["partitions"]), kind="sage",
        seed=int(cfg["partition_seed"]), agg=traffic["agg"],
        layout=traffic["layout"], device=device)
    _sync(device)
    pipeline_s = time.perf_counter() - t0
    mc = ModelConfig(kind="sage", feat_dim=int(cfg["feat_dim"]),
                     hidden=int(cfg["hidden"]),
                     num_layers=int(cfg["num_layers"]),
                     num_classes=int(cfg["num_classes"]),
                     dropout=float(cfg["dropout"]),
                     multilabel=bool(cfg["multilabel"]), agg=traffic["agg"],
                     matmul_order=traffic["matmul_order"],
                     layout=pipeline.layout)
    pc = dataclasses.replace(PipeConfig.named(traffic["variant"]),
                             wire=traffic["wire"],
                             overlap=traffic["overlap"])
    return pipeline, mc, pc, pipeline_s


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _train(pipeline, mc, pc, cfg, epochs, seed, device):
    from repro_torch.core.trainer import train_pipegcn
    return train_pipegcn(pipeline, mc, pc, epochs=epochs, lr=float(cfg["lr"]),
                         seed=seed, eval_every=epochs, log=None, health=None,
                         device=device)


def model_dict(cfg: dict) -> dict:
    return {k: cfg[k] for k in ("feat_dim", "hidden", "num_layers",
                                "num_classes", "dropout", "multilabel", "lr")}


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device="cuda", t_start: float | None = None,
             repo_root=REPO_ROOT, bench_dir=BENCH_DIR) -> tuple[dict, list]:
    """One run. Returns (the result object, the compared numbers as
    (name, value, limit))."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cell = resolve(workload, repo_root, bench_dir)
    cfg, traffic = cell.config, cell.traffic
    phases = {}
    mark = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        phases[name] = now - mark[0]
        mark[0] = now

    data = make_graph_data(cfg)
    lap("generate")
    pipeline, mc, pc, pipeline_s = _program_inputs(cfg, traffic, data, dev)
    lap("pipeline")

    # warm-up: build every kernel the window runs, then read the epoch rate
    _train(pipeline, mc, pc, cfg, 2, seed, dev)
    _sync(dev)
    lap("warm_up")
    _train(pipeline, mc, pc, cfg, 4, seed, dev)
    _sync(dev)
    lap("rate")
    epoch_s = phases["rate"] / 4
    epochs = max(CHECK_STEPS + 2, round(seconds / epoch_s))
    if traced:
        epochs = min(epochs, TRACE_MAX_EPOCHS)

    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    spans = prof = None
    if traced:
        from repro_torch.kernels.aggregate import ENGINES
        spans = trace.EngineSpans(ENGINES[traffic["agg"]])
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    try:
        with StepTap(CHECK_STEPS) as tap:
            setup_s = time.perf_counter() - t_start
            t0 = time.perf_counter()
            with (torch.profiler.record_function("portbench.window")
                  if traced else contextlib.nullcontext()):
                res = _train(pipeline, mc, pc, cfg, epochs, seed, dev)
                _sync(dev)
            window_s = time.perf_counter() - t0
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        if spans is not None:
            spans.remove()
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    prog = tap.outputs()
    failed = int(res.anomalies.get("skipped_steps", 0))
    agg_spans = spans.spans() if spans is not None else []
    del res, tap, pipeline
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    mark[0] = time.perf_counter()
    layout = substrate.build_layout(data.graph, int(traffic["partitions"]),
                                    resolved_layout(traffic),
                                    part_seed=int(cfg["partition_seed"]))
    lap("reference_layout")
    ref = reference.Reference(layout, data, model_dict(cfg), dev).run(
        seed, CHECK_STEPS)
    cmp = reference.compare(prog, ref)
    lap("reference_steps")
    checks = [(k, cmp[k], float(cell.limits[k])) for k in reference.COMPARED]
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)

    epoch_ms = window_s * 1e3 / epochs
    metrics = {}
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": 1,
                   "memory_peak_bytes": int(max(setup_peak, window_peak))}
    extra = {}
    if not traced:
        values = {"epoch_ms": epoch_ms, "peak_mem_gb": window_peak / 1e9,
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        dims = reference.layer_dims(model_dict(cfg))
        counts = work.graph_counts(layout)
        ctx = {"epochs": epochs, "window_s": window_s, "epoch_ms": epoch_ms,
               "pipeline_s": pipeline_s, "counts": counts, "dims": dims,
               "agg_spans": agg_spans, "device_events": [],
               "host_events": [], "busy_s": 0.0}
        if on_card:
            dev_ev, host_ev = trace.profile_events(prof)
            win = [(s, e) for n, s, e in host_ev if n == "portbench.window"]
            lo, hi = win[0] if win else (dev_ev[0][1], dev_ev[-1][2])
            dev_ev = [t for t in dev_ev if t[2] > lo and t[1] < hi]
            ctx.update(device_events=dev_ev, host_events=host_ev,
                       busy_s=trace.busy_ns(dev_ev) / 1e9)
            device_info.update(busy_s=ctx["busy_s"], window_s=window_s)
            extra["breakdown"] = {
                "device_ops": trace.top_device_ops(dev_ev),
                "idle_gaps": trace.idle_gaps(dev_ev, host_ev, (lo, hi))}
        for m in cell.per_layer:
            v = load_reader(m["name"], bench_dir)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        extra["traced_window"] = {"epochs": epochs, "epoch_ms": epoch_ms}
    result = {"correct": correct, "attempted": epochs, "failed": failed,
              "metrics": metrics, "device": device_info, **extra,
              "setup_phases_s": phases,
              "checks": {k: {"value": v, "limit": lim} for k, v, lim in checks}}
    return result, checks
