"""Shared fixtures of the benchmark's tests: the paths, and a small
benchmark tree (two tiny configurations under the real traffic mixes,
metric readers and limits) that runs on the CPU.

    PYTHONPATH=src python -m pytest -q portbench/tests
    PYTHONPATH=src python -m pytest -q -m cuda portbench/tests   # on a card
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO_ROOT = BENCH_DIR.parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(0, str(REPO_ROOT / "src"))

# name -> (configuration, traffic mix, the real cell whose limits it takes)
TINY = {
    "tiny-sage3": dict(kind="sage", num_layers=3, hidden=32, dropout=0.5,
                       lr=0.01, feat_dim=24, num_classes=4, multilabel=False,
                       num_nodes=1024, edges_per_node=30.0, degree_arg=36,
                       sbm_blocks=4, signal=0.8, rmat_frac=0.3, data_seed=0,
                       partition_seed=0),
    "tinyml-sage2": dict(kind="sage", num_layers=2, hidden=32, dropout=0.0,
                         lr=0.01, feat_dim=8, num_classes=12, multilabel=True,
                         num_nodes=1024, edges_per_node=30.0, degree_arg=36,
                         sbm_blocks=3, signal=0.5, rmat_frac=0.3, data_seed=0,
                         partition_seed=0),
}
TINY_CELLS = {
    "tiny-sage3.p4-blocksparse": ("tiny-sage3", "p4-blocksparse",
                                  "reddit-sage4.p4-blocksparse"),
    "tiny-sage3.p4-coo": ("tiny-sage3", "p4-coo", "proteins-sage3.p4-coo"),
    "tinyml-sage2.p4-coo": ("tinyml-sage2", "p4-coo", "proteins-sage3.p4-coo"),
}


def write_tree(root: Path, configs: dict, cells: dict) -> Path:
    """A benchmark tree under `root` (BENCHMARK.json + portbench/) with
    the real metrics and traffic mixes, the given configurations, and each
    cell's limits copied from the real cell it names."""
    bench = json.loads((REPO_ROOT / "BENCHMARK.json").read_text())
    pb = root / "portbench"
    for sub in ("metrics", "traffic"):
        shutil.copytree(BENCH_DIR / sub, pb / sub, dirs_exist_ok=True)
    (pb / "configs").mkdir(parents=True, exist_ok=True)
    (pb / "limits").mkdir(parents=True, exist_ok=True)
    bench["configs"] = []
    for name, cfg in configs.items():
        (pb / "configs" / f"{name}.json").write_text(
            json.dumps(dict(cfg, name=name)))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"portbench/configs/{name}.json",
                                 "reduced": [], "why": "test"})
    bench["workloads"] = []
    for name, (cfg, traffic, like) in cells.items():
        shutil.copy(BENCH_DIR / "limits" / f"{like}.json",
                    pb / "limits" / f"{name}.json")
        bench["workloads"].append({"name": name, "config": cfg,
                                   "traffic": traffic, "chips": 1,
                                   "why": "test"})
    for m in bench["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="session")
def tiny_tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("bench"), TINY, TINY_CELLS)


@pytest.fixture
def card():
    """Skips a test without a CUDA card (decided here, not at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
