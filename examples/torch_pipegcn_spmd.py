"""The deployable SPMD path of the PyTorch port end to end: PipeGCN on the
torch.distributed backend with the partition count DECOUPLED from the
rank count — 8 graph partitions on 4 ranks (2 co-resident partitions each,
hierarchical boundary exchange), Adam training, and a check that every
rank's parameters equal the single-device sim backend's bitwise after
every step. The SPMD reductions sum the per-partition terms in global
partition order, as the sim backend does, so the two are bit-identical
(the JAX example allows a drift of 1e-4).

    PYTHONPATH=src python examples/torch_pipegcn_spmd.py --device cpu
    PYTHONPATH=src python examples/torch_pipegcn_spmd.py     # CUDA: NCCL

On the CPU the 4 ranks are gloo processes; on CUDA each rank holds one
card, with as many ranks (4, 2 or 1) as the host has cards. The
counterpart of examples/pipegcn_spmd.py.
"""
import argparse
import os
import sys

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
sys.path.insert(0, SRC)

PARTS = 8
RANKS = 4
EPOCHS = 60
JOIN_TIMEOUT_S = 600


def rank_main(rank: int, world: int, init: str, device: str,
              epochs: int) -> None:
    """One rank: train on its PARTS // world partitions and, in lockstep,
    the sim backend on all of them; assert equal parameters each step."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import (ModelConfig, PipeConfig, PipeGCN,
                                  make_train_step)
    from repro_torch.core.trainer import make_spmd_train_step
    from repro_torch.data import GraphDataPipeline
    from repro_torch.data.graph_pipeline import rank_view
    from repro_torch.optim import adam

    cuda = device.startswith("cuda")
    if cuda:
        torch.cuda.set_device(rank)
        device = f"cuda:{rank}"
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init,
                            rank=rank, world_size=world)
    try:
        n_local = PARTS // world
        pipeline = GraphDataPipeline.build("tiny", PARTS, kind="sage",
                                           device=device)
        ds = pipeline.dataset
        mc = ModelConfig(kind="sage", feat_dim=ds.feat_dim, hidden=32,
                         num_layers=2, num_classes=ds.num_classes,
                         dropout=0.0)
        model = PipeGCN(mc, PipeConfig.named("pipegcn-gf", gamma=0.5))
        opt = adam(0.01)
        params = model.init_params(
            torch.Generator(device=device).manual_seed(0))
        topo = rank_view(pipeline.topo, rank, n_local)
        data = rank_view(pipeline.train_data, rank, n_local)
        spmd_step = make_spmd_train_step(model, opt, n_local)
        sim_step = make_train_step(model, opt)
        spmd = [params, opt.init(params), model.init_buffers(topo)]
        sim = [params, opt.init(params), model.init_buffers(pipeline.topo)]
        if rank == 0:
            print(f"ranks: {world} ({'nccl' if cuda else 'gloo'}), "
                  f"partitions: {PARTS} ({n_local}/rank)", flush=True)
        for epoch in range(epochs):
            loss, *spmd = spmd_step(topo, *spmd, data)
            loss_s, *sim = sim_step(pipeline.topo, *sim, pipeline.train_data)
            same = all(torch.equal(spmd[0][k], sim[0][k]) for k in sim[0])
            assert same and torch.equal(loss, loss_s), \
                f"rank {rank}: SPMD and sim diverged at epoch {epoch}"
            if rank == 0 and epoch % 20 == 0:
                print(f"epoch {epoch:3d} loss {float(loss):.4f} "
                      f"(sim {float(loss_s):.4f})", flush=True)
        if rank == 0:
            _, logits = model.forward(pipeline.topo, spmd[0],
                                      pipeline.val_data)
            m = pipeline.metric(logits)
            print(f"final: test={m['test']:.4f} val={m['val']:.4f}; "
                  f"parameters bitwise equal to the sim backend's",
                  flush=True)
            print("SPMD == sim across full training  OK", flush=True)
    finally:
        dist.destroy_process_group()


def main(epochs: int = EPOCHS, device: str = "cuda") -> list:
    """Start the ranks as processes of this script; returns their exit
    codes (all 0 when SPMD equals sim at every step)."""
    world = RANKS
    if device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda needs a CUDA card; pass "
                               "--device cpu for gloo")
        world = next(w for w in (4, 2, 1) if w <= torch.cuda.device_count())
    from repro_torch.launch.mesh import run_ranks
    return [code for code, _ in run_ranks(
        lambda r, init: [sys.executable, os.path.abspath(__file__),
                         "--device", device, "--epochs", str(epochs),
                         "--rank", str(r), "--world", str(world),
                         "--init", init], world, JOIN_TIMEOUT_S)]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, one card per rank) or cpu (gloo)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=RANKS, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args.rank, args.world, args.init, args.device, args.epochs)
    else:
        codes = main(args.epochs, args.device)
        sys.exit(max(codes, key=abs))
