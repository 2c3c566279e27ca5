"""What a run loads: nothing of the JAX side anywhere, and nothing of the
program in the reference."""
from __future__ import annotations

import json
import os
import subprocess
import sys

from conftest import BENCH_DIR, REPO_ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _top_level_after(code: str) -> set[str]:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(BENCH_DIR), str(REPO_ROOT / "src")]))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, env=env, cwd=REPO_ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_side(tiny_tree):
    mods = _top_level_after(
        "import runpy\n"
        f"runpy.run_path({str(BENCH_DIR / 'run.py')!r}, run_name='portbench')\n"
        "from benchlib import harness\n"
        f"harness.run_cell('tiny-sage3.p4-blocksparse', 5, 0.2, False, "
        f"device='cpu', repo_root=__import__('pathlib').Path({str(tiny_tree)!r}),"
        f" bench_dir=__import__('pathlib').Path({str(tiny_tree / 'portbench')!r}))")
    assert "repro_torch" in mods and "benchlib" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    mods = _top_level_after(
        "import benchlib.reference, benchlib.substrate, benchlib.graphgen, "
        "benchlib.work, benchlib.spec")
    assert not mods & (FORBIDDEN | {"repro_torch"}), mods


def test_run_without_a_card_fails_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        import pytest
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, str(BENCH_DIR / "run.py"), "--workload",
         "proteins-sage3.p4-coo", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=REPO_ROOT,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
