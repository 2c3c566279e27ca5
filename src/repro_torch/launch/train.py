"""Training launcher for the PyTorch port. Two workload kinds behind one
CLI, as in the JAX launcher (``repro.launch.train``):

  GCN full-graph training (the paper):
    python -m repro_torch.launch.train --workload gcn --dataset reddit-sim \\
        --partitions 4 --variant pipegcn --agg blocksparse --epochs 300

  Transformer LM training (the zoo's archs, reduced or full config):
    python -m repro_torch.launch.train --workload lm --arch qwen3-8b \\
        --reduced --steps 50 --batch 8 --seq 128

Takes every flag of the JAX launcher, with its names, types and defaults,
plus ``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch
versions of the kernels). The LM workload (`run_lm`, its loop `train_lm`)
launches none of the port's kernels, as JAX's launches no Pallas kernel:
the model is plain PyTorch, differentiated by autograd.

``--elastic`` (with ``--guard-exchange`` and a checkpoint directory)
arms the elastic runtime: a device whose exchanges all fall back
``--elastic-detect-after`` consecutive steps is declared lost, its
partitions are remapped onto the survivors from the last checkpoint, and
the run rejoins at a checkpoint boundary once the device is back.
Without ``--spmd``, ``--parts-per-device`` sets how many partitions one
device of the sim backend holds for it, as in the JAX launcher.

``--spmd --parts-per-device N`` trains on the torch.distributed backend,
one process per rank, each holding N partitions (``--partitions`` = ranks
× N). Start it with torchrun, which sets each process's rank:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --spmd \
        --parts-per-device 1 --dataset grid-sim --partitions 4 --agg blocksparse

NCCL on ``--device cuda`` (rank r on card r), gloo on ``--device cpu``.
Without torchrun it runs as a single rank.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import time

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.configs import get_arch
from repro_torch.core.config import ModelConfig, PipeConfig
from repro_torch.core.elastic import ElasticConfig
from repro_torch.core.faults import FaultPlan
from repro_torch.core.health import HealthConfig
from repro_torch.core.trainer import train_pipegcn
from repro_torch.data.graph_pipeline import GraphDataPipeline
from repro_torch.data.tokens import TokenStream
from repro_torch.device import (exact_f32_matmul, resolve_device,
                                synchronize)
from repro_torch.graph.synthetic import model_template
from repro_torch.launch.serve import add_stubs
from repro_torch.models.model import LM
from repro_torch.optim import adamw, linear_warmup_cosine


def init_distributed(device: str) -> str:
    """Join the default process group (NCCL for a CUDA device, gloo for the
    CPU) and return this rank's device. Under torchrun the rank and the
    rendezvous come from its environment; otherwise this process is the
    only rank, on a free port of 127.0.0.1. A CUDA run needs one card per
    rank on the host: it never shares a card between ranks."""
    import torch
    import torch.distributed as dist
    if "RANK" in os.environ:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        init = "env://"
    else:
        rank, world, local = 0, 1, 0
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            init = f"tcp://127.0.0.1:{sock.getsockname()[1]}"
    cuda = device.startswith("cuda")
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {device} requested but CUDA is not "
                               "available; pass --device cpu for gloo")
        if world > torch.cuda.device_count():
            raise RuntimeError(
                f"{world} ranks need {world} CUDA cards, this host has "
                f"{torch.cuda.device_count()}: NCCL ranks do not share a card")
        torch.cuda.set_device(local)
        device = f"cuda:{local}"
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init,
                            rank=rank, world_size=world)
    return device


def run_gcn(args) -> dict:
    log = print
    if args.spmd:
        import torch.distributed as dist
        args.device = init_distributed(args.device)
        if dist.get_rank() != 0:
            log = None
    try:
        return _run_gcn(args, log)
    finally:
        if args.spmd:
            dist.destroy_process_group()


def _run_gcn(args, log) -> dict:
    pipeline = GraphDataPipeline.build(args.dataset, args.partitions,
                                       kind=args.gcn_kind, seed=args.seed,
                                       agg=args.agg, layout=args.layout,
                                       device=args.device)
    tpl = model_template(args.dataset)
    mc = ModelConfig(kind=args.gcn_kind, feat_dim=pipeline.dataset.feat_dim,
                     hidden=args.hidden or tpl["hidden"],
                     num_layers=args.layers or tpl["num_layers"],
                     num_classes=pipeline.dataset.num_classes,
                     dropout=tpl["dropout"],
                     multilabel=pipeline.dataset.multilabel,
                     agg=args.agg, matmul_order=args.matmul_order,
                     layout=pipeline.layout)
    pc = dataclasses.replace(PipeConfig.named(args.variant, gamma=args.gamma),
                             fuse_exchange=not args.no_fuse_exchange,
                             overlap=args.overlap, wire=args.wire,
                             slice_boundary=args.slice_boundary,
                             guard_exchange=args.guard_exchange,
                             max_staleness=args.max_staleness)
    faults = None
    if args.fault_rate > 0.0:
        faults = FaultPlan(rate=args.fault_rate, rate_kind=args.fault_kind,
                           seed=args.fault_seed)
    health = HealthConfig(enabled=False) if args.no_health else None
    elastic = None
    if args.elastic:
        elastic = ElasticConfig(detect_after=args.elastic_detect_after,
                                warm_staleness=args.elastic_warm,
                                max_recoveries=args.elastic_max_recoveries,
                                rejoin=not args.elastic_no_rejoin,
                                parts_per_device=args.parts_per_device)
    res = train_pipegcn(pipeline, mc, pc, epochs=args.epochs,
                        lr=args.lr or tpl["lr"], seed=args.seed,
                        eval_every=args.eval_every, log=log,
                        health=health, device=args.device,
                        parts_per_device=(args.parts_per_device if args.spmd
                                          else None),
                        faults=faults, ckpt_dir=args.ckpt_dir,
                        checkpoint_every=args.ckpt_every,
                        resume=args.resume,
                        checkpoint_keep=args.ckpt_keep or None,
                        elastic=elastic)
    out = {"workload": "gcn", "dataset": args.dataset,
           "partitions": args.partitions, "variant": args.variant,
           "device": args.device, "agg": args.agg,
           "matmul_order": args.matmul_order, "layout": pipeline.layout,
           "fuse_exchange": pc.fuse_exchange, "overlap": pc.overlap,
           "wire": pc.wire, "slice_boundary": pc.slice_boundary,
           "spmd": args.spmd, "parts_per_device": args.parts_per_device,
           "guard_exchange": pc.guard_exchange, "fault_rate": args.fault_rate,
           "split_feasible": pipeline.split_spec() is not None,
           "elastic": bool(args.elastic), "anomalies": res.anomalies,
           "resumed_from": res.resumed_from, "recoveries": res.recoveries,
           "preempted": res.preempted, "final": res.final_metrics,
           "epochs_per_sec": res.epochs_per_sec, "history": res.history}
    if args.ckpt_dir and not args.ckpt_every and log:
        # legacy params-only export; with --ckpt-every the trainer already
        # wrote full-state step dirs into the same directory (one rank only)
        from repro_torch.checkpoint import save_checkpoint
        save_checkpoint(args.ckpt_dir, args.epochs, res.params)
    if log:
        shown = ("final", "epochs_per_sec") + (
            ("elastic", "recoveries") if args.elastic else ())
        log(json.dumps({k: out[k] for k in shown}, indent=1))
    return out


def lm_batch(batch: dict, lm: LM, device) -> dict:
    """A `TokenStream` batch (numpy tokens and labels) on `device`, with
    the zero audio / image stubs the arch reads as memory."""
    out = {k: torch.from_numpy(v).to(device, torch.int64)
           for k, v in batch.items()}
    return add_stubs(out, lm.cfg, out["tokens"].shape[0], lm.dtype, device)


def loss_and_grads(lm: LM, params, batch: dict):
    """(loss, gradient tree) of ``lm.loss_fn`` at `params` by autograd
    (``loss.backward()``); the gradient tree mirrors `params`, a leaf the
    loss does not reach getting zeros, as ``jax.grad`` gives it."""
    leaves, treespec = tree_flatten(params)
    leaves = [x.detach().requires_grad_() for x in leaves]
    loss = lm.loss_fn(tree_unflatten(leaves, treespec), batch)
    loss.backward()
    grads = [torch.zeros_like(x) if x.grad is None else x.grad
             for x in leaves]
    return loss.detach(), tree_unflatten(grads, treespec)


def train_lm(lm: LM, params, opt, stream, steps: int, log=print):
    """`steps` training steps of `lm` from `params` (a tree of tensors on
    one device) with the optimizer `opt` over the batches of `stream` (an
    iterator of `TokenStream` batches): JAX's `run_lm` loop. Each step
    takes the loss's gradient by autograd, then ``opt.apply``; every
    ``max(steps // 10, 1)`` steps it logs the loss. Returns (losses, final
    parameters, seconds of the loop, ended by a device sync)."""
    dev = tree_flatten(params)[0][0].device
    exact_f32_matmul()
    opt_state = opt.init(params)
    losses = []
    synchronize(dev)
    t0 = time.perf_counter()
    for i in range(steps):
        batch = lm_batch(next(stream), lm, dev)
        loss, grads = loss_and_grads(lm, params, batch)
        with torch.no_grad():
            params, opt_state = opt.apply(params, grads, opt_state)
        del grads           # not held through the next step's backward
        losses.append(float(loss))
        if log and i % max(steps // 10, 1) == 0:
            log(f"step {i:5d} loss {losses[-1]:.4f}")
    synchronize(dev)
    return losses, params, time.perf_counter() - t0


def run_lm(args) -> dict:
    """The LM workload: `args.arch` (reduced under `--reduced`) with
    parameters drawn from a generator seeded `args.seed` on the device,
    AdamW with warm-up and cosine decay and gradients clipped to norm 1,
    `args.steps` steps on `TokenStream` batches; JAX's result keys plus
    ``device``. `--ckpt-dir` saves the final parameters."""
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    lm = LM(cfg)
    params = lm.init_params(torch.Generator(dev).manual_seed(args.seed))
    opt = adamw(linear_warmup_cosine(args.lr or 3e-4, 10, args.steps),
                max_grad_norm=1.0)
    stream = iter(TokenStream(cfg.vocab_size, args.seq, args.batch,
                              seed=args.seed))
    losses, params, secs = train_lm(lm, params, opt, stream, args.steps,
                                    log=lambda m: print(m, flush=True))
    out = {"workload": "lm", "arch": args.arch, "reduced": args.reduced,
           "first_loss": losses[0], "last_loss": losses[-1],
           "steps_per_sec": args.steps / secs, "device": str(dev)}
    if args.ckpt_dir:
        from repro_torch.checkpoint import save_checkpoint
        save_checkpoint(args.ckpt_dir, args.steps, params)
    print(json.dumps(out, indent=1))
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", choices=["gcn", "lm"], default="gcn")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; cpu runs "
                         "the plain PyTorch versions of the kernels)")
    ap.add_argument("--dataset", default="reddit-sim")
    ap.add_argument("--partitions", type=int, default=4)
    ap.add_argument("--variant", default="pipegcn",
                    help="vanilla|pipegcn|pipegcn-g|pipegcn-f|pipegcn-gf")
    ap.add_argument("--gcn-kind", default="sage", choices=["sage", "gcn"])
    ap.add_argument("--agg", default="coo",
                    choices=["coo", "blocksparse", "fused"],
                    help="aggregation engine for the Eq. 3/4 SpMM "
                         "(blocksparse = the CUDA block-sparse kernels; "
                         "fused = those plus the fused aggregate+transform "
                         "kernels for aggregate-first layers)")
    ap.add_argument("--matmul-order", default="auto",
                    choices=["auto", "aggregate-first", "transform-first"],
                    help="layer contraction order for P·H·W; auto picks per "
                         "layer via the static FLOP model")
    ap.add_argument("--layout", default="auto",
                    choices=["auto", "natural", "rcm"],
                    help="intra-partition node layout; auto = rcm iff --agg "
                         "uses tiles")
    ap.add_argument("--no-fuse-exchange", action="store_true",
                    help="stale variants exchange per layer instead of one "
                         "packed exchange per direction")
    ap.add_argument("--no-health", action="store_true",
                    help="disable the numerical health guard")
    ap.add_argument("--gamma", type=float, default=0.95)
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--eval-every", type=int, default=20)
    ap.add_argument("--hidden", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--lr", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spmd", action="store_true",
                    help="train on the torch.distributed backend, one "
                         "process per rank (start with torchrun)")
    ap.add_argument("--parts-per-device", type=int, default=1,
                    help="partitions each rank holds under --spmd; without "
                         "it, partitions per device of the sim backend for "
                         "--elastic")
    ap.add_argument("--overlap", default="auto",
                    choices=["auto", "none", "split-phase"],
                    help="split-phase overlap schedule: auto = split where "
                         "feasible for the tile engines")
    ap.add_argument("--wire", default="f32",
                    choices=["f32", "bf16", "int8", "int4", "auto"],
                    help="boundary wire format (docs/wire-format.md): f32 "
                         "ships the payload as is, bf16 halves it, int8 / "
                         "int4 quantize it blockwise with f32 scales in the "
                         "payload; auto picks bf16 or int8 per layer by "
                         "wire bytes")
    ap.add_argument("--slice-boundary", action="store_true",
                    help="layers that run transform-first with F_out <= "
                         "F_in ship the post-transform rows (incompatible "
                         "with --overlap split-phase)")
    ap.add_argument("--guard-exchange", action="store_true",
                    help="per-row checksum on every boundary wire; a row "
                         "that fails keeps its stale buffer entry")
    ap.add_argument("--max-staleness", type=int, default=8,
                    help="abort once FIFO depth + consecutive fallbacks of "
                         "an exchange exceeds this (with --guard-exchange)")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="i.i.d. fault rate per (step, direction, layer, "
                         "partition pair) exchange")
    ap.add_argument("--fault-kind", default="drop",
                    choices=["drop", "corrupt", "delay"])
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (without --ckpt-every: a "
                         "params-only export at the end)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint the full training state every N epochs")
    ap.add_argument("--ckpt-keep", type=int, default=0,
                    help="keep only the newest N checkpoints (0 = all)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --ckpt-dir")
    ap.add_argument("--elastic", action="store_true",
                    help="elastic runtime: detect a lost device from the "
                         "guarded exchange, remap its partitions onto the "
                         "survivors from the last checkpoint, rejoin later "
                         "(needs --guard-exchange, --ckpt-dir, --ckpt-every)")
    ap.add_argument("--elastic-detect-after", type=int, default=2,
                    help="consecutive whole-device fallback steps that "
                         "declare a device lost")
    ap.add_argument("--elastic-warm", type=int, default=1,
                    help="es count stamped on the remapped exchanges")
    ap.add_argument("--elastic-max-recoveries", type=int, default=2)
    ap.add_argument("--elastic-no-rejoin", action="store_true",
                    help="stay on the survivors once a device is lost")
    # lm
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.workload == "gcn":
        return run_gcn(args)
    return run_lm(args)


if __name__ == "__main__":
    main()
