"""Training launcher for the PyTorch port (GCN full-graph training).

    python -m repro_torch.launch.train --workload gcn --dataset reddit-sim \\
        --partitions 4 --variant pipegcn --agg blocksparse --epochs 300

Takes every flag of the JAX launcher (``repro.launch.train``), with its
names, types and defaults, plus ``--device`` (default ``cuda``; ``cpu``
runs the plain PyTorch versions of the kernels). A flag of a feature the
port does not run yet, given away from its default, exits with an error
that names its ROADMAP item (`UNPORTED`).

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

from repro_torch.core.config import ModelConfig, PipeConfig
from repro_torch.core.health import HealthConfig
from repro_torch.core.trainer import train_pipegcn
from repro_torch.data.graph_pipeline import GraphDataPipeline
from repro_torch.graph.synthetic import model_template


# Flags of the JAX launcher whose features the port does not run yet, by
# the ROADMAP Queue 1 item that ports them. Each is refused when given away
# from its default.
UNPORTED = {
    8: ("boundary codecs and feature slicing",
        ("wire", "slice_boundary")),
    9: ("fault tolerance",
        ("guard_exchange", "max_staleness", "fault_rate", "fault_kind",
         "fault_seed", "ckpt_dir", "ckpt_every", "ckpt_keep", "resume")),
    10: ("elastic runtime",
         ("elastic", "elastic_detect_after", "elastic_warm",
          "elastic_max_recoveries", "elastic_no_rejoin")),
    12: ("the transformer LM workload",
         ("workload", "arch", "reduced", "steps", "batch", "seq")),
}


def unported_flags(args) -> list[str]:
    """The given flags that select features this port does not run, each
    with its ROADMAP item."""
    ap = parser()
    bad = []
    for item, (what, dests) in UNPORTED.items():
        for dest in dests:
            value = getattr(args, dest)
            if value != ap.get_default(dest):
                flag = "--" + dest.replace("_", "-")
                shown = flag if isinstance(value, bool) else f"{flag} {value}"
                bad.append(f"{shown} (ROADMAP Queue 1 item {item}: {what})")
    return bad


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
                             overlap=args.overlap)
    health = HealthConfig(enabled=False) if args.no_health else None
    res = train_pipegcn(pipeline, mc, pc, epochs=args.epochs,
                        lr=args.lr or tpl["lr"], seed=args.seed,
                        eval_every=args.eval_every, log=log,
                        health=health, device=args.device,
                        parts_per_device=(args.parts_per_device if args.spmd
                                          else None))
    out = {"workload": "gcn", "dataset": args.dataset,
           "partitions": args.partitions, "variant": args.variant,
           "device": args.device, "agg": args.agg,
           "matmul_order": args.matmul_order, "layout": pipeline.layout,
           "fuse_exchange": pc.fuse_exchange, "overlap": pc.overlap,
           "spmd": args.spmd, "parts_per_device": args.parts_per_device,
           "anomalies": res.anomalies, "final": res.final_metrics,
           "epochs_per_sec": res.epochs_per_sec, "history": res.history}
    if log:
        log(json.dumps({k: out[k] for k in ("final", "epochs_per_sec")},
                       indent=1))
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
                    help="partitions each rank holds under --spmd")
    ap.add_argument("--overlap", default="auto",
                    choices=["auto", "none", "split-phase"],
                    help="split-phase overlap schedule: auto = split where "
                         "feasible for the tile engines")
    # Flags of the JAX launcher whose features are not ported yet (UNPORTED):
    # accepted with the JAX names, types and defaults so that a JAX command
    # line parses, then refused by unported_flags.
    ap.add_argument("--wire", default="f32",
                    choices=["f32", "bf16", "int8", "int4", "auto"])
    ap.add_argument("--slice-boundary", action="store_true")
    ap.add_argument("--guard-exchange", action="store_true")
    ap.add_argument("--max-staleness", type=int, default=8)
    ap.add_argument("--fault-rate", type=float, default=0.0)
    ap.add_argument("--fault-kind", default="drop",
                    choices=["drop", "corrupt", "delay"])
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--elastic", action="store_true")
    ap.add_argument("--elastic-detect-after", type=int, default=2)
    ap.add_argument("--elastic-warm", type=int, default=1)
    ap.add_argument("--elastic-max-recoveries", type=int, default=2)
    ap.add_argument("--elastic-no-rejoin", action="store_true")
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-keep", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    bad = unported_flags(args)
    if bad:
        ap.error("not ported to repro_torch yet: " + "; ".join(bad))
    if args.parts_per_device != 1 and not args.spmd:
        ap.error("--parts-per-device needs --spmd")
    return run_gcn(args)


if __name__ == "__main__":
    main()
