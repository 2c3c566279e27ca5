"""Every cell of BENCHMARK.json resolves its files; a cell added only as
files is found; the file keeps to the benchmark's contract."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from benchlib import reference, spec
from conftest import BENCH_DIR, REPO_ROOT, write_tree

BENCH = json.loads((REPO_ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    c = spec.resolve(cell)
    assert c.config["name"] == cell.split(".")[0]
    assert set(c.limits) == set(reference.COMPARED)
    assert {m["name"] for m in c.end_to_end} >= {"epoch_ms", "setup_s"}
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.load_reader(m["name"]))


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        cfg = json.loads((REPO_ROOT / c["file"]).read_text())
        assert set(c["reduced"]) <= set(cfg), c["reduced"]


def test_a_cell_added_as_files_is_found(tmp_path):
    """A new configuration, traffic mix and limits file, plus entries in
    BENCHMARK.json, make a cell: no existing file changes."""
    cfg = json.loads((BENCH_DIR / "configs" / "proteins-sage3.json").read_text())
    cells = {"newcfg.p2-coo": ("newcfg", "p2-coo", "proteins-sage3.p4-coo")}
    root = write_tree(tmp_path, {"newcfg": dict(cfg, num_nodes=2048)}, cells)
    traffic = json.loads((BENCH_DIR / "traffic" / "p4-coo.json").read_text())
    (root / "portbench" / "traffic" / "p2-coo.json").write_text(
        json.dumps(dict(traffic, partitions=2)))
    c = spec.resolve("newcfg.p2-coo", root, root / "portbench")
    assert c.traffic["partitions"] == 2 and c.config["num_nodes"] == 2048
    with pytest.raises(KeyError):
        spec.resolve("missing.cell", root, root / "portbench")
    # a metric is a reader file found by its name
    shutil.copy(BENCH_DIR / "metrics" / "agg_ms.py",
                root / "portbench" / "metrics" / "agg_ms.copy.py")
    read = spec.load_reader("agg_ms.copy", root / "portbench")
    assert read({"agg_spans": [("spmm", {}, 0.5)], "epochs": 2}) == 250.0
