"""The frozen generator: deterministic, the port's recipe, and each
configuration's edges per node within 5%."""
from __future__ import annotations

import json

import numpy as np
import pytest

from benchlib.graphgen import make_graph_data
from conftest import BENCH_DIR, TINY

CONFIGS = sorted(p.stem for p in (BENCH_DIR / "configs").glob("*.json"))


def _same(a, b):
    for k in ("features", "labels", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    np.testing.assert_array_equal(a.graph.indptr, b.graph.indptr)
    np.testing.assert_array_equal(a.graph.indices, b.graph.indices)


@pytest.mark.parametrize("name", sorted(TINY))
def test_generator_is_deterministic(name):
    _same(make_graph_data(TINY[name]), make_graph_data(TINY[name]))


def test_generator_is_the_ports_recipe():
    """With one block per class the frozen copy builds the port's
    reddit-sim-style dataset bit for bit."""
    from repro_torch.graph.synthetic import _make_sim
    cfg = dict(TINY["tiny-sage3"])
    ds = _make_sim("t", num_nodes=cfg["num_nodes"],
                   num_classes=cfg["num_classes"], feat_dim=cfg["feat_dim"],
                   avg_degree=cfg["degree_arg"], signal=cfg["signal"],
                   seed=cfg["data_seed"], rmat_frac=cfg["rmat_frac"])
    ours = make_graph_data(cfg)
    np.testing.assert_array_equal(ds.graph.indptr, ours.graph.indptr)
    np.testing.assert_array_equal(ds.graph.indices, ours.graph.indices)
    np.testing.assert_array_equal(ds.features, ours.features)
    np.testing.assert_array_equal(ds.labels, ours.labels)
    np.testing.assert_array_equal(ds.train_mask, ours.train_mask)


@pytest.mark.parametrize("name", CONFIGS)
def test_configuration_hits_its_edges_per_node(name):
    cfg = json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())
    for key in ("source", "reduced", "assumed"):
        assert cfg[key], key
    d = make_graph_data(cfg)
    assert d.graph.num_nodes == cfg["num_nodes"]
    assert d.features.shape == (cfg["num_nodes"], cfg["feat_dim"])
    assert abs(d.edges_per_node / cfg["edges_per_node"] - 1) <= 0.05
    assert d.train_mask.sum() == int(0.6 * cfg["num_nodes"])
    if cfg["multilabel"]:
        assert d.labels.shape == (cfg["num_nodes"], cfg["num_classes"])
    else:
        assert d.labels.max() == cfg["num_classes"] - 1
