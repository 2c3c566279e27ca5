"""Split-phase schedule preflight: check that a split step issues each
boundary exchange BETWEEN the boundary- and interior-phase launches.

Builds the grid-tiny pipeline (a 4-neighbour lattice, the O(sqrt n)
boundary regime the split needs; rcm layout, blocksparse tiles, 4
partitions), then runs one step of each cell (variant, fused exchange,
train or eval) through a recording backend and asserts that the recorded
events — phase launches, exchange starts and waits — equal
`expected_split_events` and pass `check_overlap`
(`core/trace_utils.check_split_schedule`), on both backends:

  sim   the partitions as a leading axis of one device; its split step
        starts each exchange on a side stream and records it;
  spmd  the torch.distributed backend: on the CPU 4 gloo ranks of one
        partition each, started as processes of this module; on a CUDA
        card one NCCL rank holding the 4 partitions.

    python -m repro_torch.launch.check_schedule --device cpu
    python -m repro_torch.launch.check_schedule          # on the card

Exits nonzero on any mismatch.
"""
from __future__ import annotations

import argparse
import dataclasses
import socket
import sys

from repro_torch.launch.mesh import run_ranks

P = 4
CELLS = [
    # (variant, fuse_exchange, train)
    ("pipegcn", True, True),
    ("pipegcn", True, False),
    ("pipegcn", False, True),
    ("vanilla", True, True),
    ("vanilla", False, False),
]
JOIN_TIMEOUT_S = 300


def _pipeline(device: str):
    from repro_torch.data import GraphDataPipeline
    pipeline = GraphDataPipeline.build("grid-tiny", P, kind="sage",
                                       agg="blocksparse", layout="rcm",
                                       device=device)
    if pipeline.split_spec() is None:
        raise AssertionError("grid-tiny must admit a feasible split")
    return pipeline


def _model(pipeline, variant: str, fuse: bool, num_layers: int):
    from repro_torch.core import ModelConfig, PipeConfig, PipeGCN
    ds = pipeline.dataset
    mc = ModelConfig(kind="sage", feat_dim=ds.feat_dim, hidden=16,
                     num_layers=num_layers, num_classes=ds.num_classes,
                     dropout=0.0, agg="blocksparse",
                     matmul_order="aggregate-first", layout="rcm")
    pc = dataclasses.replace(PipeConfig.named(variant), fuse_exchange=fuse,
                             overlap="split-phase")
    return PipeGCN(mc, pc, split=pipeline.split_spec())


def check_cells(pipeline, backend_factory=None, topo=None, data=None,
                num_layers: int = 2, what: str = "sim", log=print) -> int:
    """Check every cell on the backend `backend_factory()` makes (default
    the sim backend) over `topo` / `data` (default the pipeline's); returns
    the number of cells checked. Raises AssertionError on a mismatch."""
    from repro_torch.core.trace_utils import check_split_schedule
    topo = pipeline.topo if topo is None else topo
    data = pipeline.train_data if data is None else data
    for variant, fuse, train in CELLS:
        model = _model(pipeline, variant, fuse, num_layers)
        backend = None if backend_factory is None else backend_factory()
        try:
            events = check_split_schedule(model, topo, data, train=train,
                                          backend=backend)
        except AssertionError as err:
            raise AssertionError(f"{what} ({variant}, fuse={fuse}, "
                                 f"train={train}): {err}") from None
        if log:
            log(f"[schedule OK] {what} {variant} fuse={fuse} train={train} "
                f"L={num_layers}: " + " ".join(_short(e) for e in events))
    return len(CELLS)


def _short(event) -> str:
    """S / W for an exchange's start / wait, Pb / Pi (Tb / Ti) for a
    forward (transpose) boundary / interior phase."""
    if isinstance(event, tuple):
        return ("P" if event[0] == "spmm_phased" else "T") + event[1][0]
    return {"exchange_start": "S", "exchange_wait": "W"}.get(event, event)


def _spmd_rank(rank: int, world: int, init: str, device: str) -> int:
    """One rank of the SPMD check: join the group, check every cell on this
    rank's partitions, leave the group."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.pipegcn import SpmdBackend
    from repro_torch.data.graph_pipeline import rank_view
    cuda = device.startswith("cuda")
    kw = {}
    if cuda:
        dev = torch.device(device)
        kw["device_id"] = torch.device("cuda", dev.index or 0)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init,
                            rank=rank, world_size=world, **kw)
    try:
        pipeline = _pipeline(device)
        n_local = P // world
        return check_cells(
            pipeline, lambda: SpmdBackend(n_local),
            rank_view(pipeline.topo, rank, n_local),
            rank_view(pipeline.train_data, rank, n_local),
            what=f"spmd rank {rank}/{world}", log=print if rank == 0 else None)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def check_spmd(device: str) -> int:
    """The SPMD check: 4 gloo ranks as processes on the CPU, one NCCL rank
    holding all 4 partitions in this process on a card."""
    if device.startswith("cuda"):
        return _spmd_rank(0, 1, f"tcp://127.0.0.1:{_free_port()}", device)
    codes = [code for code, _ in run_ranks(
        lambda r, init: [sys.executable, "-m",
                         "repro_torch.launch.check_schedule", "--device",
                         "cpu", "--rank", str(r), "--world", str(P),
                         "--init", init], P, JOIN_TIMEOUT_S)]
    if any(codes):
        raise AssertionError(f"spmd ranks exited with {codes}")
    return len(CELLS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions and gloo)")
    # one gloo rank of the CPU check (set by check_spmd)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=P, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            ap.error(f"--device {args.device}: CUDA is not available; pass "
                     "--device cpu")
    try:
        if args.rank is not None:
            _spmd_rank(args.rank, args.world, args.init, args.device)
            return 0
        n = check_cells(_pipeline(args.device)) + check_spmd(args.device)
    except AssertionError as err:
        print(f"[check_schedule FAILED] {err}", flush=True)
        return 1
    print(f"[check_schedule OK] {n} cells (sim, spmd) on {args.device}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
