"""On a card: one short run of each cell through the benchmark's command,
correct and with its metrics. Skips without a card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import BENCH_DIR, REPO_ROOT

CELLS = [w["name"] for w in
         json.loads((REPO_ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell, trace, card):
    out = subprocess.run(
        [sys.executable, str(BENCH_DIR / "run.py"), "--workload", cell,
         "--seed", str(2**31 + 101), "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, cwd=REPO_ROOT, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert res["metrics"]
