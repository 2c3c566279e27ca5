"""Where a dry-run combo's collective bytes come from: one combo run
abstract (``--device meta``) as the dry-run runs it, with every collective
it issues charged to the innermost line of the model code
(``repro_torch/models/``, shardctx aside) on the Python stack when it was
issued, with the shardctx form it went through (a collective of the
backward has no model line: it is charged to the autograd node that
issues it).

  PYTHONPATH=src python scripts/dryrun_collectives_by_line.py \
      --arch deepseek-v2-236b --shape prefill_32k [--top 10] [--multi-pod]

Prints the combo's totals per collective type (equal to the dry-run's
row) and the lines that issue the most bytes, with their count and bytes
per type; the last line is the same as one JSON object.
"""
import argparse
import collections
import json
import os
import sys
import traceback


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)

    import torch

    import repro_torch.launch.dryrun as dryrun
    models = os.sep + os.path.join("repro_torch", "models") + os.sep
    sites = collections.defaultdict(lambda: [0, 0])     # (kind, line) -> n, B

    def site(stack) -> str:
        """The innermost model line on `stack`, with the shardctx form it
        went through, if any."""
        frames = [f for f in reversed(stack) if models in f.filename]
        form = next((f.name for f in frames if f.filename.endswith(
            "shardctx.py") and not f.name.startswith("__")), None)
        line = next((f"{f.filename.split(models)[-1]}:{f.lineno} {f.name}"
                     for f in frames if not f.filename.endswith(
                         "shardctx.py")), None)
        if line is None:
            node = torch._C._current_autograd_node()
            line = f"(backward: {node.name() if node else '?'})"
        return line + (f" via shardctx.{form}" if form else "")

    class ByLine(dryrun.CollectiveCounter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = dict(self.bytes)
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented:
                return out
            for kind, n in self.bytes.items():
                if n != before[kind]:
                    line = site(traceback.extract_stack())
                    sites[(kind, line)][0] += 1
                    sites[(kind, line)][1] += n - before[kind]
            return out

    dryrun.CollectiveCounter = ByLine
    r = dryrun.dryrun_one(args.arch, args.shape, device="meta",
                          multi_pod=args.multi_pod)
    print(f"{args.arch} {args.shape} {r['mesh']}: "
          f"{r['collective_total_bytes']} B in all; per type "
          f"{r['collective_counts_per_device']} "
          f"{r['collective_bytes_per_device']}")
    top = sorted(sites.items(), key=lambda kv: -kv[1][1])[:args.top]
    for (kind, line), (n, nbytes) in top:
        share = nbytes / max(r["collective_total_bytes"], 1)
        print(f"  {nbytes:>20} B {share:7.2%} {n:>6} x {kind:<18} {line}")
    print(json.dumps({
        "arch": args.arch, "shape": args.shape, "mesh": r["mesh"],
        "collective_total_bytes": r["collective_total_bytes"],
        "collective_counts_per_device": r["collective_counts_per_device"],
        "collective_bytes_per_device": r["collective_bytes_per_device"],
        "top": [{"kind": k, "line": line, "count": n, "bytes": b}
                for (k, line), (n, b) in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
