"""Production-mesh dry-run for the PipeGCN core itself.

Port of the JAX package's ``repro.launch.dryrun_pipegcn``. The graph is
partitioned one partition per chip: the 16×16 pod mesh flattens to 256
partitions (the multi-pod mesh to 512). JAX lowers the shard_map'ed step
over abstract topology arrays sized from the paper's largest setting
(ogbn-papers100M scale per Tab. 3: 111M nodes / 3 layers / 48 hidden /
feat 128). Here rank 0 of a fake process group of 256 (512) ranks runs
one training step of its own partition on ``SpmdBackend``, over a seeded
synthetic topology at those sizes, on the COO engine (as JAX's dry-run
does: ``ModelConfig.agg = "coo"``, so none of the port's kernels runs).
Each boundary exchange is an ``all_to_all_single`` that the fake group
turns into a no-op, so the step's shapes, launches and memory are rank
0's production ones while its values mean nothing.

The result counts the step's boundary collectives (`RecordingBackend`)
against `expected_boundary_collectives` (2 fused, 2L-1 per layer), gives
the intended wire bytes by JAX's formula beside the bytes handed to the
exchange, and on the card the step time and peak memory.

Run: python -m repro_torch.launch.dryrun_pipegcn [--multi-pod]
         [--variant pipegcn-gf] [--device meta|cpu|cuda]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch.analysis.cost import _MetaGenerator
from repro_torch.core.config import ModelConfig, PipeConfig
from repro_torch.core.pipegcn import PipeGCN, ShardedData, SpmdBackend, Topology
from repro_torch.core.trace_utils import (CollectiveCounter, RecordingBackend,
                                          count_exchanges,
                                          expected_boundary_collectives)
from repro_torch.kernels.gcn_spmm import TILE, SplitSpec
from repro_torch.launch.dryrun import allocated, local_bytes, measure
from repro_torch.launch.mesh import (HBM_BW, NET_BW, PEAK_FLOPS_F32,
                                     fake_process_group)

# papers100M-scale per-partition sizing (111M nodes / 256 parts ≈ 434K inner;
# halo slots sized from METIS-like cut ratios at 0.4% per peer pair).
PROD = dict(max_inner=434_176, slot=2_048, max_nnz=6_553_600,
            feat_dim=128, hidden=48, num_layers=3, num_classes=172)
# Reddit-scale variant (Tab. 3 row 1) for the 2-pod mesh: smaller graph.
SMALL = dict(max_inner=1_024, slot=256, max_nnz=524_288,
             feat_dim=602, hidden=256, num_layers=4, num_classes=41)


def synthetic_split(sizes) -> SplitSpec:
    """Synthetic split spec mirroring what split_spec_from derives from a
    real rcm-layout graph: the boundary tail is the last row block, the
    transpose cut sits at the last full inner block. The COO engine's
    phased path only reads the row/col cuts, so the tile counts are
    placeholders (JAX's dry-run synthesizes the same spec)."""
    hb0 = sizes["max_inner"] // TILE
    return SplitSpec(row_tail=max(hb0 - 1, 1) * TILE, col_tail=hb0 * TILE,
                     fwd_bnd_tiles=1, t_bnd_tiles=1)


def synthetic_rank0(sizes, num_parts: int, device,
                    split: SplitSpec | None = None):
    """Rank 0's partition at `sizes` (leading partition axis of 1): a
    random padded-COO graph (seed 0) (rows uniform over the inner nodes,
    columns over inner + halo, weights uniform in [0, 2 / mean degree)),
    one full send block of `slot` rows per peer (from the boundary tail
    when `split` is given, as a real split's sends are), every node
    inner, and N(0, 1) features, uniform labels and all-true masks.
    Built on the host in numpy and moved to `device` (on ``meta`` only
    the shapes remain)."""
    rng = np.random.default_rng(0)
    mi, sl, nz = sizes["max_inner"], sizes["slot"], sizes["max_nnz"]
    combined = mi + num_parts * sl
    lo = split.row_tail if split is not None else 0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)[None]).to(device)

    topo = Topology(
        edge_row=t(rng.integers(0, mi, nz, dtype=np.int32)),
        edge_col=t(rng.integers(0, combined, nz, dtype=np.int32)),
        edge_w=t(rng.uniform(0, 2 * mi / nz, nz).astype(np.float32)),
        send_idx=t(rng.integers(lo, mi, (num_parts, sl), dtype=np.int32)),
        send_mask=t(np.ones((num_parts, sl), bool)),
        inner_mask=t(np.ones(mi, bool)))
    data = ShardedData(
        x=t(rng.standard_normal((mi, sizes["feat_dim"]), np.float32)),
        labels=t(rng.integers(0, sizes["num_classes"], mi, dtype=np.int32)),
        train_mask=t(np.ones(mi, bool)), eval_mask=t(np.ones(mi, bool)))
    return topo, data


def _step_cost(sizes, num_parts: int) -> tuple[float, float]:
    """Analytic FLOPs and HBM bytes of one rank's training step on the COO
    engine (aggregate-first, SAGE): per layer the SpMM over nnz edges,
    the dense transform of [z; h] and their backward (Alg. 1 stops the
    SpMM backward at layer 0). An explicit model, not a measurement."""
    mi, nz = sizes["max_inner"], sizes["max_nnz"]
    combined = mi + num_parts * sizes["slot"]
    dims = ([sizes["feat_dim"]] + [sizes["hidden"]] * (sizes["num_layers"] - 1)
            + [sizes["num_classes"]])
    flops = byts = 0.0
    for ell in range(sizes["num_layers"]):
        fin, fout = dims[ell], dims[ell + 1]
        spmm = 2.0 * nz * fin
        dense = 2.0 * mi * (2 * fin) * fout
        flops += spmm + 2 * dense + (spmm + dense if ell else 0.0)
        byts += 4.0 * (combined * fin + 3 * nz + mi * (2 * fin + fout)
                       + 2 * fin * fout) * (2 if ell else 1.5)
    return flops, byts


def dryrun_pipegcn(multi_pod: bool, variant: str = "pipegcn", sizes=None,
                   compress: bool = False, fuse: bool = True,
                   overlap: str = "auto", device: str = "cuda",
                   steps: int = 3) -> dict:
    """One training step of rank 0 of the production mesh's partitions
    (256, or 512 with `multi_pod`) under a fake process group (started
    here, destroyed on return). On a device the step runs once recorded,
    then `steps` more times timed, with the peak memory of those runs."""
    n = 512 if multi_pod else 256
    sizes = sizes or (SMALL if multi_pod else PROD)
    dev = torch.device(device)
    base = allocated(dev)
    mc = ModelConfig(kind="sage", feat_dim=sizes["feat_dim"],
                     hidden=sizes["hidden"], num_layers=sizes["num_layers"],
                     num_classes=sizes["num_classes"], dropout=0.0,
                     agg="coo")
    pc = dataclasses.replace(PipeConfig.named(variant),
                             compress_boundary=compress,
                             fuse_exchange=fuse, overlap=overlap)
    split = synthetic_split(sizes) if overlap == "split-phase" else None
    model = PipeGCN(mc, pc, split=split)
    topo, data = synthetic_rank0(sizes, n, dev, split=split)
    gen = (_MetaGenerator() if dev.type == "meta"
           else torch.Generator(dev).manual_seed(0))
    params = model.init_params(gen)
    buffers = model.init_buffers(topo)

    result = {"arch": f"pipegcn-{variant}", "multi_pod": multi_pod,
              "compress": compress, "fuse_exchange": pc.fuse_exchange,
              "chips": n, "sizes": sizes, "device": dev.type,
              "argument_size_in_bytes": local_bytes(
                  (topo, data, params, buffers))}
    with fake_process_group(n):
        rec = RecordingBackend(SpmdBackend(n_local=1))
        with CollectiveCounter() as cc:
            model.train_step(topo, params, buffers, data, gen, backend=rec)
        if dev.type == "cuda":
            backend = SpmdBackend(n_local=1)
            result.update(measure(lambda: model.train_step(
                topo, params, buffers, data, gen, backend=backend), dev,
                steps, base))
            result["bytes_per_device"] = result["peak_bytes"]
    # per-step boundary-collective count: recorded (schedule truth) + the
    # analytic 2 (fused) vs 2L-1 (per-layer) expectation
    result["boundary_collectives_per_step"] = count_exchanges(rec.events)
    result["boundary_collectives_expected"] = expected_boundary_collectives(
        mc.num_layers, pc.fused, train=True)
    result["overlap"] = pc.overlap
    if model._split_active() is not None:
        mi = sizes["max_inner"]
        result["overlap_phase_rows"] = {
            "row_tail": split.row_tail,
            "fwd_boundary_rows": mi - split.row_tail,
            "fwd_interior_rows": split.row_tail,
            "col_tail": split.col_tail,
            "t_boundary_rows": mi - split.col_tail + n * sizes["slot"],
        }
        # each phase is one COO scatter-add launch: an exchange between two
        # of them was issued mid-layer (JAX's event names)
        result["overlap_events"] = [
            "scatter-add" if isinstance(e, tuple) else "all_to_all"
            for e in rec.events if e != "exchange_wait"]
    coll = dict(cc.bytes)
    result["collective_counts_per_device"] = cc.counts
    result["collective_bytes_per_device"] = coll
    result["collective_total_bytes"] = int(sum(coll.values()))
    # intended wire bytes of the boundary exchanges (JAX's formula) beside
    # the bytes the step handed the exchange
    dims = [sizes["feat_dim"]] + [sizes["hidden"]] * (sizes["num_layers"] - 1)
    slots = n * sizes["slot"]
    fwd_w = sum(dims)
    bwd_w = sum(dims[1:])
    dtype_bytes = 2 if compress else 4
    result["boundary_wire_bytes"] = int(slots * (fwd_w + bwd_w) * dtype_bytes)
    result["recorded_wire_bytes"] = rec.wire_bytes
    flops, byts = _step_cost(sizes, n)
    result["flops_per_device"] = flops
    result["bytes_accessed_per_device"] = byts
    result["t_collective_wire"] = (result["boundary_wire_bytes"]
                                   + coll["all-reduce"]) / NET_BW
    result["t_compute"] = flops / PEAK_FLOPS_F32    # an f32 step, TF32 off
    result["t_memory"] = byts / HBM_BW
    result["t_collective"] = result["collective_total_bytes"] / NET_BW
    terms = {k: result[f"t_{k}"] for k in ("compute", "memory", "collective")}
    result["bottleneck"] = max(terms, key=terms.get)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variant", default="pipegcn")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--no-fuse", action="store_true",
                    help="per-layer blocking exchange (2L-1 collectives) "
                         "instead of the fused-deferred schedule (2)")
    ap.add_argument("--both", action="store_true",
                    help="also run the vanilla baseline for comparison")
    ap.add_argument("--overlap", default="auto",
                    choices=["auto", "none", "split-phase"],
                    help="split-phase overlap schedule: boundary phase, "
                         "issue exchange, interior phase behind it (the "
                         "dry-run synthesizes the split spec and reports "
                         "the phase sizes + collective positions)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (rank 0 on the card), meta (abstract) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    variants = [args.variant] + (["vanilla"] if args.both else [])
    results = []
    for v in variants:
        r = dryrun_pipegcn(args.multi_pod, v, compress=args.compress,
                           fuse=not args.no_fuse, overlap=args.overlap,
                           device=args.device)
        results.append(r)
        print(f"[pipegcn dryrun OK] variant={v} chips={r['chips']} "
              f"bottleneck={r['bottleneck']} "
              f"boundary_colls={r['boundary_collectives_per_step']} "
              f"overlap={r['overlap']} "
              f"coll={r['collective_total_bytes']:,}B "
              f"step_ms={r.get('step_ms')} peak={r.get('peak_bytes')}",
              flush=True)
        if "overlap_events" in r:
            print(f"  overlap schedule: phases {r['overlap_phase_rows']} "
                  f"events {' '.join('A' if e == 'all_to_all' else 'S' for e in r['overlap_events'])}",
                  flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print("wrote", args.out)
    return results


if __name__ == "__main__":
    main()
