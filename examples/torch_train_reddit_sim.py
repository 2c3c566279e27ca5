"""End-to-end training on the PyTorch port (the paper's main experiment at
single-card scale): Reddit-sim, 4 partitions, all five methods of Tab. 4,
a few hundred epochs, with a checkpoint of the best model.

    PYTHONPATH=src python examples/torch_train_reddit_sim.py [--epochs 300]
    PYTHONPATH=src python examples/torch_train_reddit_sim.py --device cpu \\
        --epochs 20

The counterpart of examples/train_reddit_sim.py.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.core import ModelConfig, PipeConfig, train_pipegcn  # noqa: E402
from repro_torch.data import GraphDataPipeline  # noqa: E402
from repro_torch.graph.synthetic import make_dataset, model_template  # noqa: E402

VARIANTS = ("vanilla", "pipegcn", "pipegcn-g", "pipegcn-f", "pipegcn-gf")


def main(argv=None) -> list:
    """Train every variant; returns [(variant, final metrics, epochs/s)]."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--dataset", default="reddit-sim",
                    help="synthetic preset (graph/synthetic.py) to train")
    ap.add_argument("--partitions", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    ds = make_dataset(args.dataset, signal=0.45)   # non-trivial difficulty
    pipeline = GraphDataPipeline.build(ds, args.partitions, kind="sage",
                                       device=args.device)
    tpl = model_template(args.dataset)
    mc = ModelConfig(kind="sage", feat_dim=ds.feat_dim, hidden=tpl["hidden"],
                     num_layers=tpl["num_layers"],
                     num_classes=ds.num_classes, dropout=tpl["dropout"])
    print(f"{args.dataset}: {ds.num_nodes} nodes, {ds.graph.num_edges} edges, "
          f"{args.partitions} partitions, "
          f"halo nodes={int(pipeline.pg.halo_counts().sum())}, "
          f"padding={pipeline.pg.padding_ratio():.2f}, device={args.device}")

    best = None
    rows = []
    for variant in VARIANTS:
        res = train_pipegcn(pipeline, mc, PipeConfig.named(variant),
                            epochs=args.epochs, lr=tpl["lr"],
                            eval_every=max(args.epochs // 10, 1),
                            log=lambda s, v=variant: print(f"[{v}] {s}"),
                            device=args.device)
        rows.append((variant, res.final_metrics, res.epochs_per_sec))
        if best is None or res.final_metrics["test"] > best[1]:
            best = (variant, res.final_metrics["test"], res.params)
    print(f"\n{'variant':12s} {'test':>8s} {'val':>8s} {'epochs/s':>9s}")
    for variant, m, eps in rows:
        print(f"{variant:12s} {m['test']:8.4f} {m['val']:8.4f} {eps:9.2f}")
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, args.epochs, best[2])
        print(f"saved best ({best[0]}, test={best[1]:.4f}) to {args.ckpt_dir}")
    return rows


if __name__ == "__main__":
    main()
