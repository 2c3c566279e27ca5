"""The production dry-run's combos at reduced widths, one fake process group
per combo, in this process: the worker of the CPU guard in
tests/test_torch_dryrun_routes.py and of the card test in
tests/test_torch_cuda.py. No JAX.

  PYTHONPATH=src python tests/_dryrun_routes.py [--record] [--layers N]
      ARCH:SHAPE:MESH[:DEVICE] ...  (MESH 16x16 or 2x16x16; DEVICE meta,
                                     the default, or cuda: one timed step)

Prints one JSON object: for each combo its row (``dryrun_one``'s keys that
the tests read) or its ``error``; with ``--record``, every distinct
(aten op, arguments) that reached DTensor inside the step, forward and
backward, each DTensor argument as its shape and placements (a
``TorchDispatchMode`` entered inside the collective counter, so it sees
each op before DTensor turns it into local ops).
"""
import argparse
import json
import sys

KEYS = ("argument_size_in_bytes", "collective_counts_per_device",
        "collective_bytes_per_device", "collective_total_bytes",
        "peak_bytes", "step_ms", "bottleneck")


def reduced(cfg, layers: int = 0):
    """The combo's arch at reduced widths in bf16, with 32 heads (two per
    'model' shard, so the heads are sharded as at full size), cut to
    `layers` layers (all of them MoE layers in an MoE arch) where `layers`
    is nonzero; an SSD keeps its published chunk of 256 (at the reduced
    chunk of 8, train_4k's 512 chunks per sequence make the eager chunk
    loop most of the run)."""
    kw = {"ssm_chunk": cfg.ssm_chunk} if cfg.family == "ssm" else {
        "num_heads": 32}
    if layers:
        kw["num_layers"] = layers
        if cfg.num_experts:
            kw["first_dense_layers"] = 0
    return cfg.reduced(dtype="bfloat16", **kw)


def describe(a):
    """A JSON form of an op argument: a DTensor's shape and placements, a
    tensor's shape, a list's items, a number as it is, any other value's
    repr."""
    import torch
    from torch.distributed.tensor import DTensor
    if isinstance(a, DTensor):
        return {"shape": list(a.shape),
                "placements": [str(p) for p in a.placements]}
    if isinstance(a, torch.Tensor):
        return {"shape": list(a.shape)}
    if isinstance(a, (list, tuple)):
        return [describe(x) for x in a]
    return a if isinstance(a, (int, float, bool, type(None))) else repr(a)


def _flat(args):
    for a in args:
        if isinstance(a, (list, tuple)):
            yield from _flat(a)
        else:
            yield a


def run_combo(combo: str, record: bool, layers: int) -> tuple:
    """(row or error, the recorded pairs) of one ARCH:SHAPE:MESH[:DEVICE]
    combo."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    import repro_torch.launch.dryrun as dryrun

    seen = set()

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(isinstance(a, DTensor) for a in _flat(args)):
                seen.add(json.dumps([str(func), describe(args)]))
            return func(*args, **(kwargs or {}))

    full, build = dryrun.get_arch, dryrun._build_step

    def recorded(*a, **k):
        fn, fn_args = build(*a, **k)

        def run(*x):
            with Record():
                return fn(*x)
        return run, fn_args
    dryrun.get_arch = lambda arch: reduced(full(arch), layers)
    if record:
        dryrun._build_step = recorded
    arch, shape, mesh, *dev = combo.split(":")
    try:
        r = dryrun.dryrun_one(arch, shape, multi_pod=mesh == "2x16x16",
                              device=dev[0] if dev else "meta", steps=1)
        row = {k: r[k] for k in KEYS if k in r}
    except Exception as e:      # recorded, as the CLI's --all records it
        row = {"error": f"{type(e).__name__}: {e}"[:2000]}
    finally:
        dryrun.get_arch, dryrun._build_step = full, build
    return row, seen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("combos", nargs="+")
    ap.add_argument("--record", action="store_true")
    ap.add_argument("--layers", type=int, default=0)
    args = ap.parse_args(argv)
    done = [run_combo(c, args.record, args.layers) for c in args.combos]
    out = {"rows": {c: row for c, (row, _) in zip(args.combos, done)}}
    if args.record:
        seen = set().union(*(s for _, s in done))
        out["ops"] = [json.loads(s) for s in sorted(seen)]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
