"""The work arithmetic against hand counts on a tiny graph."""
from __future__ import annotations

import numpy as np
import pytest

from benchlib import substrate, work
from benchlib.graphgen import coo_to_csr


def test_graph_counts_by_hand():
    # the path 0-1-2-3 in both directions (6 edges) cut into {0, 1} and
    # {2, 3}: combined rows [2 inner; 2 peers x 1 halo slot]; partition 0
    # reads node 2 from halo row 2 + 1·1 + 0 = 3, partition 1 node 1 from 2
    lay = substrate.Layout(
        num_parts=2, max_inner=2, slot=1, part=np.array([0, 0, 1, 1]),
        local_of=np.array([0, 1, 0, 1]), inner_count=np.array([2, 2]),
        comb_src=np.array([[0, 1, -1, 2], [2, 3, 1, -1]]),
        is_halo=np.array([[0, 0, 0, 1], [0, 0, 1, 0]], bool),
        edge_row=[np.array([0, 1, 1]), np.array([0, 0, 1])],
        edge_col=[np.array([1, 0, 3]), np.array([2, 1, 0])],
        edge_w=[np.ones(3, np.float32)] * 2)
    assert lay.combined == 4
    assert work.graph_counts(lay) == work.GraphCounts(nodes=4, edges=6,
                                                       rows=4, cols=6)


def test_substrate_cuts_a_path_where_the_counts_say():
    src = np.array([0, 1, 1, 2, 2, 3])
    dst = np.array([1, 0, 2, 1, 3, 2])
    lay = substrate.build_layout(coo_to_csr(src, dst, 4), 2, "natural",
                                 pad_multiple=1)
    c = work.graph_counts(lay)
    assert (c.nodes, c.edges) == (4, 6)
    # every node receives an edge; every edge's source is read once
    assert c.rows == 4
    assert c.cols == sum(len(np.unique(col)) for col in lay.edge_col)


def test_layer_flops_by_hand():
    n, e, fin, fout = 10, 30, 4, 2
    dense = 2 * n * fin * fout                        # 160
    # aggregate-first: fwd 2·e·fin + 2 dense, bwd 2 dense (+ 2 dense +
    # 2·e·fin past layer 0); transform-first: fwd 2·e·fout + 2 dense, bwd
    # 2·e·fout + 2 dense (+ 2 dense)
    assert work.layer_flops(fin, fout, n, e, first=True) == min(
        240 + 320 + 320, 120 + 320 + 120 + 320)
    assert work.layer_flops(fin, fout, n, e, first=False) == min(
        240 + 320 + 320 + 320 + 240, 120 + 320 + 120 + 320 + 320)
    counts = work.GraphCounts(nodes=n, edges=e, rows=n, cols=n)
    assert work.epoch_flops([(4, 2), (2, 3)], counts) == (
        work.layer_flops(4, 2, n, e, True) + work.layer_flops(2, 3, n, e, False))


def test_agg_call_work_by_hand():
    c = work.GraphCounts(nodes=4, edges=6, rows=4, cols=6)
    assert work.agg_call_work("spmm", c, 8) == (2 * 6 * 8,
                                                8 * 6 + 4 * 8 * (6 + 4))
    assert work.agg_call_work("spmm_t", c, 8) == work.agg_call_work("spmm", c, 8)
    flops, nbytes = work.agg_call_work("aggregate_transform", c, 8, 3)
    assert flops == 2 * 6 * 8 + 2 * 4 * 8 * 3
    assert nbytes == 8 * 6 + 4 * (8 * 6 + (3 + 8) * 4 + 8 * 3)
    _, no_z = work.agg_call_work("aggregate_transform", c, 8, 3, with_z=False)
    assert nbytes - no_z == 4 * 8 * 4
    flops, nbytes = work.agg_call_work("aggregate_transform_t", c, 8, 3)
    assert flops == 2 * 4 * 8 * 3 + 2 * 6 * 8
    assert nbytes == 8 * 6 + 4 * (3 * 4 + 8 * 6 + 8 * 3)
    # a pair of phases counts the product once
    assert work.agg_call_work("spmm_phased", c, 8, phase="interior") == (0, 0)
    assert work.agg_call_work("spmm_phased", c, 8, phase="boundary") == \
        work.agg_call_work("spmm", c, 8)


def test_bound_takes_the_longer_side():
    assert work.PEAK_F32_FLOPS == pytest.approx(165e12)
    assert work.bound_seconds(165e12, 0) == pytest.approx(1.0)
    assert work.bound_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert work.bound_seconds(165e12, 6.7e12) == pytest.approx(2.0)
