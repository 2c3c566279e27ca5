"""Quickstart on the PyTorch port: full-graph GCN training, vanilla vs
PipeGCN vs PipeGCN-GF.

    PYTHONPATH=src python examples/torch_quickstart.py               # CUDA card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Trains GraphSAGE on a small synthetic community graph across 4 partitions
and prints the paper's Tab. 4-style comparison (same accuracy, pipelined
communication). The counterpart of examples/quickstart.py.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core import ModelConfig, PipeConfig, train_pipegcn  # noqa: E402
from repro_torch.data import GraphDataPipeline  # noqa: E402
from repro_torch.graph.synthetic import model_template  # noqa: E402


def main(epochs: int = 150, device: str = "cuda") -> dict:
    """Train the three variants for `epochs` epochs each on `device`;
    returns {variant: TrainResult}."""
    pipeline = GraphDataPipeline.build("small", num_parts=4, kind="sage",
                                       device=device)
    tpl = model_template("small")
    mc = ModelConfig(kind="sage", feat_dim=pipeline.dataset.feat_dim,
                     hidden=tpl["hidden"], num_layers=tpl["num_layers"],
                     num_classes=pipeline.dataset.num_classes,
                     dropout=tpl["dropout"])
    print(f"dataset=small nodes={pipeline.dataset.num_nodes} "
          f"partitions=4 halo={int(pipeline.pg.halo_counts().sum())} "
          f"boundary_bytes/layer="
          f"{pipeline.pg.boundary_bytes_per_layer(mc.hidden):,} "
          f"device={device}")
    print(f"{'variant':12s} {'test acc':>9s} {'val acc':>9s} {'epochs/s':>9s}")
    results = {}
    for variant in ("vanilla", "pipegcn", "pipegcn-gf"):
        res = train_pipegcn(pipeline, mc, PipeConfig.named(variant),
                            epochs=epochs, lr=tpl["lr"],
                            eval_every=min(50, epochs), device=device)
        print(f"{variant:12s} {res.final_metrics['test']:9.4f} "
              f"{res.final_metrics['val']:9.4f} {res.epochs_per_sec:9.2f}")
        results[variant] = res
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args()
    main(args.epochs, args.device)
