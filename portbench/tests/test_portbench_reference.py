"""The reference's substrate against the port's partitioned graph, and the
reference against the port's engines for the first steps at a tiny size."""
from __future__ import annotations

import numpy as np
import pytest

from benchlib import harness, reference, substrate
from benchlib.graphgen import make_graph_data
from conftest import TINY, TINY_CELLS


@pytest.mark.parametrize("layout", ["natural", "rcm"])
def test_substrate_is_the_ports_layout(layout):
    from repro_torch.graph.csr import CSRGraph, mean_normalized
    from repro_torch.graph.halo import build_partitioned_graph
    from repro_torch.graph.partition import partition_graph
    d = make_graph_data(TINY["tiny-sage3"])
    g = CSRGraph(d.graph.indptr, d.graph.indices,
                 np.ones(d.graph.num_edges, np.float32))
    part = partition_graph(g, 4, seed=0)
    pg = build_partitioned_graph(mean_normalized(g), part, 4, layout=layout)
    lay = substrate.build_layout(d.graph, 4, layout)
    np.testing.assert_array_equal(lay.part, part)
    np.testing.assert_array_equal(lay.local_of, pg.local_of)
    assert (lay.max_inner, lay.slot) == (pg.max_inner, pg.slot)
    for i in range(4):
        k = int(pg.edge_w[i].astype(bool).sum())
        np.testing.assert_array_equal(lay.edge_row[i], pg.edge_row[i, :k])
        np.testing.assert_array_equal(lay.edge_col[i], pg.edge_col[i, :k])
        np.testing.assert_array_equal(lay.edge_w[i], pg.edge_w[i, :k])
        # halo rows of partition i hold, in slot order, what j sends it
        for j in range(4):
            if i == j:
                continue
            at = pg.max_inner + j * pg.slot
            sent = pg.send_idx[j, i][pg.send_mask[j, i]]
            np.testing.assert_array_equal(
                lay.comb_src[i, at:at + len(sent)], j * pg.max_inner + sent)


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_reference_follows_the_ports_first_steps(cell, tiny_tree):
    result, checks = harness.run_cell(cell, 2**31 + 17, 0.3, False,
                                      device="cpu", repo_root=tiny_tree,
                                      bench_dir=tiny_tree / "portbench")
    assert result["correct"], checks
    for name, value, _ in checks:
        assert value < 1e-5, (name, value)
    assert result["attempted"] >= harness.CHECK_STEPS + 2
    assert set(result["metrics"]) == {"epoch_ms", "peak_mem_gb", "setup_s"}
    assert list(result)[-1] == "checks"


def test_control_fails_a_limit(tiny_tree):
    """The reference in TF32, put in the program's place, reads over at
    least one of the real cells' limits (the control; on the card it is
    read at each cell's own size by calibrate.py)."""
    import json
    from conftest import REPO_ROOT
    cfg = TINY["tiny-sage3"]
    d = make_graph_data(cfg)
    lay = substrate.build_layout(d.graph, 4, "rcm")
    ref = reference.Reference(lay, d, harness.model_dict(cfg), "cpu")
    for cell in ("reddit-sage4.p4-blocksparse", "proteins-sage3.p4-coo"):
        limits = json.loads(
            (REPO_ROOT / "portbench" / "limits" / f"{cell}.json").read_text())
        for seed in (1, 2, 3):
            cmp = reference.compare(ref.run(seed, 3, ("tf32",)), ref.run(seed, 3))
            assert any(cmp[k] > limits[k] for k in limits), (cell, seed, cmp)


def test_round_tf32_keeps_ten_mantissa_bits():
    import torch
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0000002])
    y = reference.round_tf32(x)
    assert y.tolist() == [1.0 + 2**-10, 1.0 + 2**-10, -3.0]


def test_a_step_that_updates_in_place_reads_correct(tiny_tree, monkeypatch):
    """The tap copies what it keeps: a program whose step writes the new
    parameters and moments into the tensors it was handed (as an in-place
    optimizer or a replayed CUDA graph does) is read as it was at each
    step."""
    import repro_torch.core.trainer as tr
    orig = tr.make_train_step

    def make(model, opt, health=None, backend=None):
        step = orig(model, opt, health, backend)

        def in_place(topo, params, opt_state, buffers, data, *rest):
            out = step(topo, params, opt_state, buffers, data, *rest)
            for k, v in out[1].items():
                params[k].copy_(v)
            for k, v in out[2].mu.items():
                opt_state.mu[k].copy_(v)
            state = out[2]._replace(mu=opt_state.mu)
            return (out[0], params, state) + tuple(out[3:])
        return in_place
    monkeypatch.setattr(tr, "make_train_step", make)
    result, checks = harness.run_cell("tiny-sage3.p4-blocksparse", 2**31 + 23,
                                      0.3, False, device="cpu",
                                      repo_root=tiny_tree,
                                      bench_dir=tiny_tree / "portbench")
    assert result["correct"], checks
