"""Finding a cell's files by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own under the benchmark's folder:

    configs/<config>.json       the configuration as it is run
    traffic/<traffic>.json      the mix: engine, partitions, variant, wire,
                                matmul order, layout, overlap
    limits/<cell>.json          the limit of each number ``correct`` compares
    metrics/<metric>.py         a reader: ``read(ctx) -> float | None``

so a later change adds a cell, a configuration or a metric by adding
files and a ``BENCHMARK.json`` entry, and edits none.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO_ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list       # the BENCHMARK.json entries this cell reports
    per_layer: list
    chips: int


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(repo_root: Path = REPO_ROOT) -> dict:
    return _load_json(Path(repo_root) / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(workload: str, repo_root: Path = REPO_ROOT,
            bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `workload` with its configuration, traffic and limits,
    and the metrics it reports; raises KeyError / FileNotFoundError when a
    name or a file is missing."""
    bench = load_benchmark(repo_root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = _load_json(Path(repo_root) / configs[w["config"]]["file"])
    bench_dir = Path(bench_dir)
    return Cell(
        name=workload, config=cfg,
        traffic=_load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=_load_json(bench_dir / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)],
        chips=int(w["chips"]))


def load_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The `read` function of metrics/<name>.py."""
    path = Path(bench_dir) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
