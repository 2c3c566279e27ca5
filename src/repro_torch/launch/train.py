"""Training launcher for the PyTorch port (GCN full-graph training).

    python -m repro_torch.launch.train --workload gcn --dataset reddit-sim \\
        --partitions 4 --variant pipegcn --agg blocksparse --epochs 300

Takes the JAX launcher's gcn flags plus ``--device`` (default ``cuda``;
``cpu`` runs the plain PyTorch versions of the kernels). Flags of features
the port does not run yet exit with an error that names the ROADMAP item.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.core.config import ModelConfig, PipeConfig
from repro_torch.core.health import HealthConfig
from repro_torch.core.trainer import train_pipegcn
from repro_torch.data.graph_pipeline import GraphDataPipeline
from repro_torch.graph.synthetic import model_template


def unported_flags(args) -> list[str]:
    """The given flags that select features this port does not run."""
    bad = []
    if args.workload != "gcn":
        bad.append("--workload lm (the transformer LM workload is not ported)")
    if args.agg == "fused":
        bad.append("--agg fused (ROADMAP Queue 2: the fused kernel pair)")
    if args.spmd or args.parts_per_device != 1:
        bad.append("--spmd / --parts-per-device (ROADMAP Queue 1 item 7: "
                   "multi-GPU)")
    if args.overlap == "split-phase":
        bad.append("--overlap split-phase (ROADMAP Queue 1 item 6)")
    if args.wire != "f32" or args.slice_boundary:
        bad.append("--wire / --slice-boundary (ROADMAP Queue 1 item 8)")
    if (args.guard_exchange or args.fault_rate > 0.0 or args.elastic
            or args.ckpt_dir or args.ckpt_every or args.resume):
        bad.append("--guard-exchange / --fault-rate / --elastic / --ckpt-* / "
                   "--resume (ROADMAP Queue 1 item 9: fault tolerance)")
    return bad


def run_gcn(args) -> dict:
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
                        eval_every=args.eval_every, log=print,
                        health=health, device=args.device)
    out = {"workload": "gcn", "dataset": args.dataset,
           "partitions": args.partitions, "variant": args.variant,
           "device": args.device, "agg": args.agg,
           "matmul_order": args.matmul_order, "layout": pipeline.layout,
           "fuse_exchange": pc.fuse_exchange, "overlap": pc.overlap,
           "anomalies": res.anomalies, "final": res.final_metrics,
           "epochs_per_sec": res.epochs_per_sec, "history": res.history}
    print(json.dumps({k: out[k] for k in ("final", "epochs_per_sec")},
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
                         "(blocksparse = the CUDA block-sparse kernels)")
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
    # Flags of the JAX launcher whose features are not ported yet: accepted
    # so that a JAX command line parses, then refused by unported_flags.
    ap.add_argument("--spmd", action="store_true")
    ap.add_argument("--parts-per-device", type=int, default=1)
    ap.add_argument("--overlap", default="auto",
                    choices=["auto", "none", "split-phase"])
    ap.add_argument("--wire", default="f32",
                    choices=["f32", "bf16", "int8", "int4", "auto"])
    ap.add_argument("--slice-boundary", action="store_true")
    ap.add_argument("--guard-exchange", action="store_true")
    ap.add_argument("--fault-rate", type=float, default=0.0)
    ap.add_argument("--elastic", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    bad = unported_flags(args)
    if bad:
        ap.error("not ported to repro_torch yet: " + "; ".join(bad))
    return run_gcn(args)


if __name__ == "__main__":
    main()
