"""The readings each cell's correctness limits are set from, in one
process per cell (the graph set-up is long, so it is paid once):

- the program's sound runs: the first three steps of ``train_pipegcn``
  from each of `--seeds` seeds, against the reference;
- the control: the reference with its dense products in TF32, against
  the reference, on `--control-seeds` seeds;
- the faults planted in the reference put in the program's place: half
  the training nodes left out of the loss, the boundary exchange left
  out; and a step that leaves the state unchanged (read without a run).

    python3 portbench/calibrate.py --workload <cell> [--seeds 14]
        [--control-seeds 4] [--out readings.json]

Needs a card; prints one JSON line per reading, and with `--out` writes
them all to that file.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(0, str(BENCH_DIR.parent / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=14)
    ap.add_argument("--control-seeds", type=int, default=4)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from benchlib import harness, reference, substrate
    from benchlib.graphgen import make_graph_data
    from benchlib.spec import resolve
    from benchlib.tap import StepTap
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = resolve(args.workload)
    cfg, traffic = cell.config, cell.traffic
    t = [time.perf_counter()]
    times = {}

    def lap(name):
        times[name] = time.perf_counter() - t[0]
        t[0] = time.perf_counter()

    data = make_graph_data(cfg)
    lap("generate")
    pipeline, mc, pc, _ = harness._program_inputs(cfg, traffic, data, dev)
    lap("pipeline")
    layout = substrate.build_layout(data.graph, int(traffic["partitions"]),
                                    harness.resolved_layout(traffic),
                                    part_seed=int(cfg["partition_seed"]))
    lap("reference_layout")
    ref = reference.Reference(layout, data, harness.model_dict(cfg), dev)
    # a second witness: the same reference in float64
    ref64 = reference.Reference(layout, data, harness.model_dict(cfg), dev,
                                dtype=torch.float64)
    lap("reference_init")
    rows = [{"workload": args.workload, "setup_s": times,
             "device": torch.cuda.get_device_name(0) if dev.type == "cuda"
             else "cpu"}]

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    def flips(prog, sound):
        """Elements whose first Adam update has another sign than the
        reference's, and the largest |g| / leaf rms among them."""
        n_flip, worst = 0, 0.0
        for k, g in sound["grads1"].items():
            gp = prog["grads1"][k].to(g.device)
            f = torch.sign(gp) != torch.sign(g)
            n_flip += int(f.sum())
            if f.any():
                rms = float(g.pow(2).mean().sqrt())
                worst = max(worst, float(g.abs()[f].max()) / max(rms, 1e-30))
        return {"sign_flips": n_flip, "flip_max_rel": worst}

    n = harness.CHECK_STEPS
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    for s in seeds:
        with StepTap(n) as tap:
            harness._train(pipeline, mc, pc, cfg, n, s, dev)
        prog = tap.outputs()
        sound = ref.run(s, n)
        cmp = reference.compare(prog, sound)
        cmp.pop("left_out")
        emit({"kind": "program", "seed": s, **cmp, **flips(prog, sound),
              "losses": prog["losses"]})
        wide = ref64.run(s, n)
        for kind, run in (("program_vs_f64", prog), ("reference_vs_f64", sound)):
            cmp = reference.compare(run, wide)
            cmp.pop("left_out")
            emit({"kind": kind, "seed": s, **cmp})
        if s == seeds[0]:
            frozen = dict(prog, params=prog["params0"])
            cmp = reference.compare(frozen, ref.run(s, n))
            cmp.pop("left_out")
            emit({"kind": "fault:state_unchanged", "seed": s, **cmp})
    for s in seeds[:args.control_seeds]:
        sound = ref.run(s, n)
        for kind, faults in (("control:tf32", ("tf32",)),
                             ("fault:half_batch", ("half_batch",)),
                             ("fault:no_exchange", ("no_exchange",))):
            bad = ref.run(s, n, faults)
            cmp = reference.compare(bad, sound)
            cmp.pop("left_out")
            emit({"kind": kind, "seed": s, **cmp, **flips(bad, sound)})
    summary = {}
    for kind in sorted({r["kind"] for r in rows[1:]}):
        sel = [r for r in rows[1:] if r["kind"] == kind]
        summary[kind] = {k: [min(r[k] for r in sel), max(r[k] for r in sel)]
                         for k in reference.COMPARED}
    emit({"summary": summary})
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
