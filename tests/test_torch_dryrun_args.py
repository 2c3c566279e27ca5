"""The dry-run's argument bytes against the JAX package's (ROADMAP F6).

JAX's ``jax.jit`` drops the arguments a step does not use, and XLA's
memory analysis counts the rest; the port counts the argument leaves whose
storage some op of the step reads (`StepMemory`). So on every 16×16 row
the two agree to 4 bytes: the int32 scalar (decode's position, Adam's
step count) that JAX passes and the port keeps as a Python int. JAX's
rows are data here (tests/_dryrun_jax_rows.py); the card test holds all
40 (tests/test_torch_cuda.py ``-k dryrun_sweep``), this file a row where
arguments go unread, at full size, abstract, as rank 0 of a fake process
group in a subprocess, and `StepMemory`'s rules on plain tensors.
"""
import json
import os
import subprocess
import sys

import torch

import _torch_threads  # noqa: F401
from _dryrun_jax_rows import check_against_jax
from repro_torch.launch.dryrun import StepMemory, check_row

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TIMEOUT_S = 240

# a row whose step leaves arguments unread: starcoder2's prefill reads no
# label and stores its sliding-window caches whole (the last 4,096
# positions of the prompt, as JAX builds them anew), where a prefill
# without a window writes its caches by rows (read, as JAX's
# dynamic_update_slice reads them)
COMBOS = ("starcoder2-3b:prefill_32k",)

ROWS = """
import json, sys
from repro_torch.launch.dryrun import dryrun_one
print(json.dumps([dryrun_one(*c.split(":"), device="meta")
                  for c in sys.argv[1:]]))
"""


def test_step_memory_reads_and_live_bytes():
    args = {k: torch.ones(4, 8) for k in "abcde"}
    args["f"] = torch.ones(2, 4, 8)
    mem = StepMemory(args)
    with mem, mem.assignments():
        out = args["a"] * 2                     # read
        args["c"].copy_(out)                    # stored whole ...
        out = out + args["c"]                   # ... so this reads no arg
        args["d"][:, 0:2] = 1.0                 # an assignment: a read
        torch.zeros_like(args["e"])             # metadata only
        args["f"][0].copy_(out)                 # one layer stored ...
        out = out + args["f"][1]                # ... another read
        del out
    assert mem.read_leaves(args) == [True, False, False, True, False, True]
    mem = StepMemory({})
    with mem:
        x = torch.empty(1000)
        del x
        y = torch.empty(2000)
    assert mem.peak == 8000 and mem.live == 8000
    with mem:
        x = torch.empty(1000)
    assert mem.peak == 12000
    del x, y
    assert mem.live == 0


def test_argument_bytes_equal_jax_rows():
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", ROWS, *COMBOS],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rows = json.loads(proc.stdout.strip().splitlines()[-1])
    # JAX's argument bytes, less JAX's int32 scalar if the step reads one
    check_against_jax(rows, "16x16")
    for r in rows:
        check_row(r, 256)
        # the labels and the window caches' keys and values
        assert r["unused_argument_leaves"] == 3, r
        assert r["bytes_per_device"] >= r["argument_size_in_bytes"] > 0
