"""The port's kernel entry points (`repro_torch.kernels.ops`) against the
JAX package's (`repro.kernels.ops`, Pallas in interpret mode), on the CPU
in float64.

One partition's tile streams of a random sparse matrix (a few 128×128
tiles, F = 128, the JAX kernels' feature block) go through the six SpMM
entry points of both packages: equal output shapes, values within 1e-12
(a phase's own rows; the rest are unspecified in both). `build_tiles`,
`tile_density` and `split_overlap_report` equal JAX's exactly. The
schedules the entry points build equal the stacked topology's.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

jax.config.update("jax_enable_x64", True)

from repro.analysis.cost import \
    split_overlap_report as jsplit_overlap_report  # noqa: E402
from repro.graph import build_partitioned_graph as jbuild_pg  # noqa: E402
from repro.graph import make_dataset as jmake_dataset  # noqa: E402
from repro.graph import partition_graph as jpartition_graph  # noqa: E402
from repro.graph.csr import mean_normalized as jmean  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.analysis import split_overlap_report  # noqa: E402
from repro_torch.graph import (build_partitioned_graph,  # noqa: E402
                               make_dataset, partition_graph)
from repro_torch.graph.csr import mean_normalized  # noqa: E402
from repro_torch.kernels import gcn_spmm, ops  # noqa: E402

TOL = 1e-12
T = 128
R, C, F, FOUT = 2 * T, 4 * T, 128, 128


def _matrix(seed=0, density=0.01):
    """A (R, C) sparse matrix whose last column block is empty (its
    transpose run is one zero filler tile) as a COO triple, and its dense
    form."""
    rng = np.random.default_rng(seed)
    dense = ((rng.random((R, C)) < density)
             * rng.standard_normal((R, C))).astype(np.float32)
    dense[:, 3 * T:] = 0
    row, col = np.nonzero(dense)
    return (row, col, dense[row, col]), dense


@pytest.fixture(scope="module")
def streams():
    coo, _ = _matrix()
    tt = gcn_spmm.build_tile_topology(*coo, R, C)
    rng = np.random.default_rng(1)
    dense = {"h": rng.standard_normal((C, F)),
             "dz": rng.standard_normal((R, F)),
             "w": rng.standard_normal((F, FOUT)) / np.sqrt(F),
             "b": rng.standard_normal((1, FOUT)),
             "du": rng.standard_normal((R, FOUT))}
    return tt, dense


def _args(tt, dense, names, backend):
    """The entry point's array arguments in either package's form."""
    if backend == "jax":
        arr = lambda a: jnp.asarray(a)                       # noqa: E731
        vals = jnp.asarray(tt.vals.astype(np.float64))
    else:
        arr = lambda a: torch.from_numpy(np.asarray(a))       # noqa: E731
        vals = torch.from_numpy(tt.vals.astype(np.float64))
    pick = {"rows": tt.rows, "cols": tt.cols, "t_out": tt.t_out,
            "t_in": tt.t_in, "t_perm": tt.t_perm}
    return [vals if n == "vals" else arr(pick[n] if n in pick else dense[n])
            for n in names]


FWD = ("rows", "cols", "vals")
BWD = ("t_out", "t_in", "t_perm", "vals")


def _boundary_slots(stream, block):
    return int((np.asarray(stream) >= block).sum())


# name, array args, static args, rows of the output the phase owns
CASES = [
    ("spmm", FWD + ("h",), lambda tt: (R,), None),
    ("spmm_t", BWD + ("dz",), lambda tt: (C,), None),
    ("spmm_phased", FWD + ("h",),
     lambda tt: (R, _boundary_slots(tt.rows, 1), "boundary"), (T, R)),
    ("spmm_phased", FWD + ("h",),
     lambda tt: (R, _boundary_slots(tt.rows, 1), "interior"), (0, T)),
    ("spmm_t_phased", BWD + ("dz",),
     lambda tt: (C, _boundary_slots(tt.t_out, 2), "boundary"), (2 * T, C)),
    ("spmm_t_phased", BWD + ("dz",),
     lambda tt: (C, _boundary_slots(tt.t_out, 2), "interior"), (0, 2 * T)),
    ("spmm_fused", FWD + ("h", "w", "b"), lambda tt: (R,), None),
    ("spmm_fused", FWD + ("h", "w", "b"), lambda tt: (R, True, False), None),
    ("spmm_fused_t", BWD + ("du", "w"), lambda tt: (C,), None),
]


@pytest.mark.parametrize("name,names,static,owned", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_entry_point_matches_jax(streams, name, names, static, owned):
    tt, dense = streams
    st = static(tt)
    want = getattr(jops, name)(*_args(tt, dense, names, "jax"), *st)
    got = getattr(ops, name)(*_args(tt, dense, names, "torch"), *st)
    if name == "spmm_fused":
        assert (got[1] is None) == (want[1] is None)
        pairs = [(got[0], want[0])] + ([(got[1], want[1])]
                                       if want[1] is not None else [])
    else:
        pairs = [(got, want)]
    lo, hi = owned or (0, None)
    for g, w in pairs:
        assert tuple(g.shape) == tuple(w.shape)
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g[lo:hi].numpy(), np.asarray(w)[lo:hi],
                                   rtol=0, atol=TOL)
        if owned:    # the port's plain version poisons the other rows
            rest = torch.cat([g[:lo], g[hi:]])
            assert torch.isnan(rest).all()


def test_phases_reassemble_the_unsplit_product(streams):
    tt, dense = streams
    h = torch.from_numpy(dense["h"])
    vals = torch.from_numpy(tt.vals.astype(np.float64))
    n_bnd = _boundary_slots(tt.rows, 1)
    full = ops.spmm(tt.rows, tt.cols, vals, h, R)
    bnd = ops.spmm_phased(tt.rows, tt.cols, vals, h, R, n_bnd, "boundary")
    inr = ops.spmm_phased(tt.rows, tt.cols, vals, h, R, n_bnd, "interior")
    assert torch.equal(torch.cat([inr[:T], bnd[T:]]), full)


def test_a_cut_inside_a_run_is_refused(streams):
    tt, dense = streams
    h = torch.from_numpy(dense["h"])
    vals = torch.from_numpy(tt.vals.astype(np.float64))
    n_bnd = _boundary_slots(tt.rows, 1)
    with pytest.raises(ValueError, match="splits output block"):
        ops.spmm_phased(tt.rows, tt.cols, vals, h, R, n_bnd + 1, "boundary")
    with pytest.raises(ValueError, match="0 < n_bnd"):
        ops.spmm_phased(tt.rows, tt.cols, vals, h, R, 0, "boundary")


def test_entry_point_schedules_equal_the_stacked_ones(streams):
    """ops builds one partition's schedule from device-side nonzero flags;
    it equals `tile_schedules` of the same stream stacked, which reads the
    tiles on the host, and walks only the nonzero tiles."""
    tt, _ = streams
    vals = torch.from_numpy(tt.vals)
    stacked = gcn_spmm.tile_schedules(types.SimpleNamespace(
        rows=tt.rows[None], cols=tt.cols[None], vals=tt.vals[None],
        t_out=tt.t_out[None], t_in=tt.t_in[None], t_perm=tt.t_perm[None]),
        R, C)
    work, items = ops.forward_schedule(torch.from_numpy(tt.rows),
                                       tt.cols, vals, R)
    t_work, t_items = ops.transpose_schedule(tt.t_out, tt.t_in, tt.t_perm,
                                             vals, C)
    for key, got in (("work", work), ("items", items), ("t_work", t_work),
                     ("t_items", t_items)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), stacked[key], err_msg=key)
    nonzero = np.abs(tt.vals).max(axis=(1, 2)) > 0
    assert not nonzero.all()                    # the filler is skipped
    assert len(work[0]) == nonzero.sum()


def test_build_tiles_and_density_match_jax():
    coo, dense = _matrix(seed=4, density=0.02)
    for arg in (coo, dense):
        got = ops.build_tiles(arg, R, C)
        want = jops.build_tiles(arg, R, C)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()
        assert ops.tile_density(got[0], R, C) == jops.tile_density(want[0],
                                                                   R, C)
    tt, jtt = (m.build_tile_topology(*coo, R, C) for m in (ops, jops))
    for f in ("rows", "cols", "vals", "t_out", "t_in", "t_perm"):
        assert getattr(tt, f).tobytes() == getattr(jtt, f).tobytes(), f


@pytest.mark.parametrize("graph,parts", [("grid-tiny", 4), ("tiny", 4)])
def test_split_overlap_report_matches_jax(graph, parts):
    """Equal dicts on a graph with a split (grid-tiny, rcm) and [] on one
    without (tiny: ~every node is a boundary node)."""
    ds, jds = make_dataset(graph), jmake_dataset(graph)
    pg = build_partitioned_graph(mean_normalized(ds.graph),
                                 partition_graph(ds.graph, parts, seed=0),
                                 parts, layout="rcm")
    jpg = jbuild_pg(jmean(jds.graph), jpartition_graph(jds.graph, parts,
                                                       seed=0),
                    parts, layout="rcm")
    dims = [(ds.feat_dim, 16), (16, 16), (16, ds.num_classes)]
    got = split_overlap_report(pg, dims)
    assert got == jsplit_overlap_report(jpg, dims)
    assert bool(got) == (graph == "grid-tiny")
