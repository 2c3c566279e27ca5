"""Times chip_smoke.py's LM phases ("serve" and "lm_train") for two
checkouts of the repo on one card, in turns A, B, B, A (or as --turns
says), each turn in a fresh process, so that a drift of the host over the
call falls on both.

  python3 scripts/ab_lm_phases.py ROOT_A ROOT_B [--out DIR] \
      [--phases serve,lm_train] [--turns ABBA]

Each turn imports chip_smoke.py and the port from its own checkout and
runs the two phases as chip_smoke.py's main runs them (f32 matmuls exact).
Every turn's whole output goes to DIR/ab_<A|B>_<turn>.txt (DIR defaults to
chiprun_out/); the lines that carry a time, and a table of them per
checkout and turn, go to standard output.
"""
import argparse
import os
import re
import subprocess
import sys

TURN = r"""
import os, sys, time
root = sys.argv[1]
sys.path[:0] = [root, os.path.join(root, "src")]
import chip_smoke
from repro_torch.device import exact_f32_matmul
exact_f32_matmul()
t0 = time.perf_counter()
for phase in sys.argv[2].split(","):
    getattr(chip_smoke, "phase_" + phase)()
print(f"turn took {time.perf_counter() - t0:.1f} s", flush=True)
"""

# (label, pattern whose first group is the number) of the times compared
TIMES = (
    ("qwen3-8b bf16 prefill ms", r"through serve_with .*prefill ([\d.]+) ms"),
    ("qwen3-8b bf16 decode ms/step", r"decode ([\d.]+) ms/step \("),
    ("qwen3-8b long-cache donated median ms",
     r'"donated": \{"median_ms": ([\d.]+)'),
    ("qwen3-8b x4 train step ms", r"median step of \d+ ([\d.]+) ms"),
    ("qwen3-8b x4 forward+backward ms", r"= forward \+ backward ([\d.]+)"),
    ("qwen3-8b x4 opt.apply ms", r"\+ opt\.apply ([\d.]+) ms"),
    ("qwen3-8b x4 tokens/s", r"in the optimizer\); ([\d.]+) tokens/s"),
    ("qwen3-8b decode kernels", r"one profiled step (\d+) kernels \+"),
    ("qwen3-8b decode device busy ms",
     r"kernels per layer\), device busy ([\d.]+) ms"),
    ("qwen3-8b x4 train device ops", r"one profiled step (\d+) device ops"),
    ("qwen3-8b x4 train device busy ms",
     r"device ops \+ \d+ copies, device busy ([\d.]+) ms"),
    ("serve phase s", r"serve: phase took ([\d.]+) s"),
    ("lm_train phase s", r"lm_train: phase took ([\d.]+) s"),
)
REDUCED = re.compile(r"serve reduced .*?: (\S+) serve prefill ([\d.]+) ms, "
                     r"decode ([\d.]+) ms/step")
MIXER_TRAIN = re.compile(r"lm_train .*?: (\S+) at its published widths.*?"
                         r"([\d.]+) ms per step")


def numbers(text: str) -> dict:
    out = {}
    for label, pat in TIMES:
        m = re.search(pat, text)
        if m:
            out[label] = float(m.group(1))
    for m in REDUCED.finditer(text):
        out[f"reduced {m.group(1)} decode ms/step"] = float(m.group(3))
    for m in MIXER_TRAIN.finditer(text):
        out[f"{m.group(1)} train ms/step"] = float(m.group(2))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root_a")
    ap.add_argument("root_b")
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--phases", default="serve,lm_train")
    ap.add_argument("--turns", default="ABBA")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    roots = {"A": os.path.abspath(args.root_a),
             "B": os.path.abspath(args.root_b)}
    runs = []
    for turn, label in enumerate(args.turns):
        proc = subprocess.run([sys.executable, "-c", TURN, roots[label],
                               args.phases],
                              capture_output=True, text=True,
                              cwd=roots[label])
        text = proc.stdout + proc.stderr
        path = os.path.join(args.out, f"ab_{label}_{turn}.txt")
        with open(path, "w") as f:
            f.write(text)
        print(f"turn {turn} {label} ({roots[label]}): rc {proc.returncode}, "
              f"output in {path}", flush=True)
        if proc.returncode != 0:
            print(text[-3000:])
            return 1
        runs.append((label, numbers(text)))
    keys = list(dict.fromkeys(k for _, r in runs for k in r))
    print(f"{'':44}" + "".join(f"{f'{lab}{i}':>12}"
                               for i, (lab, _) in enumerate(runs)))
    for k in keys:
        print(f"{k:44}" + "".join(f"{r.get(k, float('nan')):>12.3f}"
                                  for _, r in runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
