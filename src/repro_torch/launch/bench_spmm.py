"""Time the spmm kernels on the card at the main paths' shapes, over work
items of several sizes (the schedule's chunk C).

    python -m repro_torch.launch.bench_spmm [--chunks 16,8,4,2]

Cases: spmm and spmm_t on reddit-sim P=4 (F = 16, 128, 256) and yelp-sim
P=4 (F = 24, 120, 512), and each phase of spmm_phased (F = 24, 120, 512)
and spmm_t_phased (F = 24, 512) on yelp-sim P=2 — the widths the main
paths launch them at. Each chunk size's schedule comes from
`Topology.with_schedules`; the times are CUDA-event means of 20 launches,
taken in turns (forward through the list, then back). Prints the card's
name and power limit, then one line per case. chip_smoke.py holds the
kernels against their plain versions at the shipped chunk size.
"""
from __future__ import annotations

import argparse
import subprocess

import torch

from repro_torch.data import GraphDataPipeline
from repro_torch.device import exact_f32_matmul
from repro_torch.kernels import gcn_spmm


def _event_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _cases(pipes, gen):
    """(label, pipeline key, fn(topology) -> kernel launch)."""
    out = []
    for key, widths in ((("reddit-sim", 4), (16, 128, 256)),
                        (("yelp-sim", 4), (24, 120, 512))):
        t = pipes[key].topo
        R, P = t.max_inner, t.num_parts
        C = R + t.halo_size
        for f in widths:
            h = torch.randn(P, C, f, device="cuda", generator=gen)
            dz = torch.randn(P, R, f, device="cuda", generator=gen)
            out.append((f"{key[0]} P={P} spmm F={f}", key,
                        lambda s, h=h, R=R: gcn_spmm.spmm(
                            s.tile_work, s.tile_items, s.tile_rows,
                            s.tile_cols, s.tile_vals, h, R)))
            out.append((f"{key[0]} P={P} spmm_t F={f}", key,
                        lambda s, dz=dz, C=C: gcn_spmm.spmm_t(
                            s.tile_t_work, s.tile_t_items, s.tile_t_out,
                            s.tile_t_in, s.tile_t_perm, s.tile_vals, dz, C)))
    key = ("yelp-sim", 2)
    t, sp = pipes[key].topo, pipes[key].split_spec()
    R = t.max_inner
    C = R + t.halo_size
    for f in (24, 120, 512):
        h = torch.randn(2, C, f, device="cuda", generator=gen)
        dz = torch.randn(2, R, f, device="cuda", generator=gen)
        for ph in ("boundary", "interior"):
            out.append((f"yelp-sim P=2 spmm_phased {ph} F={f}", key,
                        lambda s, h=h, ph=ph: gcn_spmm.spmm_phased(
                            s.tile_work, s.tile_items, s.tile_rows,
                            s.tile_cols, s.tile_vals, h, R, sp, ph)))
            if f != 120:
                out.append((f"yelp-sim P=2 spmm_t_phased {ph} F={f}", key,
                            lambda s, dz=dz, ph=ph: gcn_spmm.spmm_t_phased(
                                s.tile_t_work, s.tile_t_items, s.tile_t_out,
                                s.tile_t_in, s.tile_t_perm, s.tile_vals, dz,
                                C, sp, ph)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", default=str(gcn_spmm.SCHED_CHUNK),
                    help="comma-separated work-item sizes (tiles)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_spmm needs a CUDA card")
    exact_f32_matmul()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    pipes = {key: GraphDataPipeline.build(*key, kind="sage", agg="fused",
                                          layout="auto", device="cuda")
             for key in (("reddit-sim", 4), ("yelp-sim", 4), ("yelp-sim", 2))}
    chunks = [int(c) for c in args.chunks.split(",")]
    topos = {(key, c): p.topo.with_schedules(chunk=c)
             for key, p in pipes.items() for c in chunks}
    for label, key, kern in _cases(pipes, torch.Generator(
            device="cuda").manual_seed(0)):
        times = dict.fromkeys(chunks, 0.0)
        for c in chunks + chunks[::-1]:
            times[c] += _event_ms(lambda: kern(topos[key, c])) / 2
        print(f"{label}: " + "  ".join(
            f"C={c} {ms:.4f} ms" for c, ms in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
