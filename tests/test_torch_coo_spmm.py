"""The COO engine's segment kernel (`kernels/coo_spmm.py`,
`csrc/coo_spmm.cu`): its edge views on the CPU, and on the card the kernel
against the plain gather + ``index_add_`` version.

The views hold each partition's real edges stably sorted by output index
(row pointers and work items per output), leave out the zero-weight
padding slots past a partition's own edges, follow ``Topology.to`` and the
elastic remap (pad partitions get empty segments), and are built by
``topology_from`` for COO topologies on the card only. The card tests (marked ``cuda``, skipped without a card; no
JAX import) hold the kernel to the plain version at every width the main
paths use and at odd ones, across hub segments cut into many items, empty
rows, padding tails and pad partitions, and check the phased pair, run to
run determinism and the launch counters:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_coo_spmm.py
"""
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from repro_torch import spans
from repro_torch.core.elastic import ElasticPlan, remap_topology, unmap_topology
from repro_torch.core.pipegcn import topology_from
from repro_torch.data import GraphDataPipeline
from repro_torch.kernels import coo_spmm
from repro_torch.kernels.gcn_spmm import SplitSpec

VIEWS = coo_spmm.FWD_VIEW + coo_spmm.BWD_VIEW


def _random_coo(parts, rows, cols, nnz, seed=0, hub=0, pad=50):
    """(P, nnz + pad) padded COO slots: random edges (one zero-weight real
    edge among them), `hub` more edges into row 1 of partition 0, a
    zero-weight padding tail of `pad` slots at (0, 0) past each
    partition's edges (longer in the later partitions), and rows 0 and
    rows - 1 left without edges."""
    rng = np.random.default_rng(seed)
    n = nnz + hub + pad * parts
    er = np.zeros((parts, n), np.int32)
    ec = np.zeros((parts, n), np.int32)
    ew = np.zeros((parts, n), np.float32)
    for p in range(parts):
        k = nnz + (hub if p == 0 else 0) - p * 7
        r = rng.integers(2, rows - 1, k)
        if p == 0 and hub:
            r[-hub:] = 1
        er[p, :k] = r
        ec[p, :k] = rng.integers(0, cols, k)
        ew[p, :k] = rng.uniform(0.1, 1.0, k) * rng.choice([-1, 1], k)
        ew[p, k // 2] = 0.0             # a real edge of weight 0
    return (torch.from_numpy(er), torch.from_numpy(ec), torch.from_numpy(ew))


def _count(ew) -> np.ndarray:
    w = ew.numpy()
    return np.array([np.flatnonzero(r)[-1] + 1 if r.any() else 0 for r in w])


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_views_keep_each_outputs_edges_in_coo_order(direction):
    """Each output's segment holds exactly its real edges, in slot order
    (a stable sort), with pointers that run from 0 to the edge count."""
    er, ec, ew = _random_coo(3, 40, 90, 600)
    out_idx, in_idx, num_out = ((er, ec, 40) if direction == "fwd"
                                else (ec, er, 90))
    ptr, items, src, w = coo_spmm.segment_view(out_idx, in_idx, ew, num_out)
    count = _count(ew)
    assert ptr.dtype == items.dtype == src.dtype == torch.int32
    assert w.dtype == torch.float32 and src.shape == w.shape
    assert src.shape[1] == count.max()
    for p in range(3):
        assert ptr[p, 0] == 0 and ptr[p, -1] == count[p]
        assert bool((ptr[p, 1:] >= ptr[p, :-1]).all())
        for o in range(num_out):
            slots = np.flatnonzero(out_idx[p, :count[p]].numpy() == o)
            a, b = int(ptr[p, o]), int(ptr[p, o + 1])
            np.testing.assert_array_equal(src[p, a:b].numpy(),
                                          in_idx[p, slots].numpy())
            np.testing.assert_array_equal(w[p, a:b].numpy(),
                                          ew[p, slots].numpy())
        assert not src[p, count[p]:].any() and not w[p, count[p]:].any()


def test_views_leave_out_the_padding_tail_only():
    """The zero-weight slots past a partition's edges are left out; a real
    edge of weight 0 among them stays; an all-zero partition is empty."""
    er, ec, ew = _random_coo(3, 40, 90, 300)
    ew[2] = 0.0
    count = coo_spmm.real_edges(ew)
    assert count.tolist()[:2] == list(_count(ew)[:2]) and count[2] == 0
    ptr, items, src, w = coo_spmm.segment_view(er, ec, ew, 40)
    assert int(ptr[0, -1]) == 300 and int(ptr[1, -1]) == 293
    assert int((w[0, :300] == 0).sum()) == 1     # the real zero edge
    assert not ptr[2].any()
    assert torch.equal(items[2, :40, 0], torch.arange(40, dtype=torch.int32))
    assert not items[2, :40, 1:3].any() and bool((items[2, 40:, 0] == -1).all())


@pytest.mark.parametrize("chunk", [1, 4, 256])
def test_work_items_cut_segments_into_chunks(chunk):
    """Items cover every segment in order, at most `chunk` edges each, with
    their chunk number and count; an empty segment keeps one empty item;
    the pads at a partition's tail have row -1."""
    er, ec, ew = _random_coo(2, 30, 50, 400, hub=700)
    ptr, items, _, _ = coo_spmm.segment_view(er, ec, ew, 30, chunk)
    for p in range(2):
        it = items[p].long().numpy()
        real = it[it[:, 0] >= 0]
        assert (it[len(real):, 0] == -1).all()
        for r in range(30):
            mine = real[real[:, 0] == r]
            a, b = int(ptr[p, r]), int(ptr[p, r + 1])
            n = max(1, -(-(b - a) // chunk))
            assert len(mine) == n and (mine[:, 4] == n).all()
            np.testing.assert_array_equal(mine[:, 3], np.arange(n))
            assert mine[0, 1] == a and mine[-1, 2] == b
            np.testing.assert_array_equal(mine[1:, 1], mine[:-1, 2])
            assert ((mine[:, 2] - mine[:, 1]) <= chunk).all()
        assert (np.diff(real[:, 0]) >= 0).all()


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_views_items_sum_to_the_plain_product(direction):
    """The kernel's arithmetic over the views, emulated in float64 (each
    item's edges in order, the partials in chunk order), equals the plain
    gather + index_add_ version."""
    er, ec, ew = _random_coo(2, 30, 50, 500, hub=600)
    ew = ew.double()
    x = torch.randn(2, 50 if direction == "fwd" else 30, 3,
                    dtype=torch.float64, generator=torch.Generator()
                    .manual_seed(1))
    if direction == "fwd":
        ptr, items, src, w = coo_spmm.segment_view(er, ec, ew, 30, 64)
        want = coo_spmm.spmm_plain(er, ec, ew, x, 30)
    else:
        ptr, items, src, w = coo_spmm.segment_view(ec, er, ew, 50, 64)
        want = coo_spmm.spmm_t_plain(er, ec, ew, x, 50)
    got = torch.zeros_like(want)
    for p in range(2):
        for r, a, b, c, n in items[p].tolist():
            if r >= 0:
                got[p, r] += (w[p, a:b, None] * x[p, src[p, a:b].long()]).sum(0)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("f,vec,want", [
    (1, 4, (1, 1, 1)), (3, 1, (4, 1, 1)), (8, 4, (2, 1, 1)),
    (41, 1, (32, 2, 1)), (112, 4, (32, 1, 1)), (256, 4, (32, 2, 1)),
    (602, 1, (32, 4, 5)), (256, 2, (32, 4, 1)), (602, 2, (32, 4, 3)),
    (1024, 4, (32, 4, 2))])
def test_lanes_cover_the_width(f, vec, want):
    """(lanes a row, vectors a lane, slices) for F at a load width: the
    slices hold F, and no whole slice lies past it."""
    g, k, slices = coo_spmm.lanes(f, vec)
    assert (g, k, slices) == want
    assert slices * g * k * vec >= f > (slices - 1) * g * k * vec


@pytest.mark.parametrize("dtype,f,offset,want", [
    (torch.float32, 256, 0, 4), (torch.float32, 602, 0, 1),
    (torch.float32, 41, 0, 1), (torch.float32, 256, 2, 1),
    (torch.float32, 256, 4, 4), (torch.float64, 602, 0, 2),
    (torch.float64, 41, 0, 1), (torch.float64, 256, 1, 1)])
def test_load_width_follows_the_width_and_the_alignment(dtype, f, offset,
                                                        want):
    """The kernel loads 16 bytes where F and the pointers allow, else
    scalars (F = 602 in float32, F = 41); a tensor that starts `offset`
    elements into its storage, off a 16-byte boundary, takes scalars."""
    x = torch.zeros(3 * f + 8, dtype=dtype)[offset:offset + 3 * f]
    out = torch.zeros(2 * f, dtype=dtype)
    assert coo_spmm.load_width(f, x.view(3, f), out) == want
    g, k, slices = coo_spmm.lanes(f, want)
    assert slices * g * k * want >= f


def test_coo_topology_carries_views_and_a_tile_topology_none():
    """topology_from leaves the views out on the CPU, whose path reads
    none (on the card it builds them: the card tests' engine runs need
    them), and out of a tile topology; with_coo_views builds them
    (pointers over max_inner and combined outputs) equal from the COO and
    the tile topology; Topology.to(float64) converts their weights and
    keeps their ints."""
    p = GraphDataPipeline.build("grid-tiny", 4, agg="coo", device="cpu")
    assert all(getattr(p.topo, k) is None for k in VIEWS)
    topo = p.topo.with_coo_views()
    assert topo.coo_row_ptr.shape == (4, topo.max_inner + 1)
    assert topo.coo_col_ptr.shape == (4, topo.max_inner + topo.halo_size + 1)
    tiles = topology_from(p.pg, with_tiles=True, device="cpu")
    assert all(getattr(tiles, k) is None for k in VIEWS)
    built = tiles.with_coo_views()
    for k in VIEWS:
        assert torch.equal(getattr(built, k), getattr(topo, k)), k
    f64 = topo.to(torch.float64)
    assert f64.coo_w.dtype == f64.coo_t_w.dtype == torch.float64
    assert torch.equal(f64.coo_w, topo.coo_w.double())
    for k in ("coo_row_ptr", "coo_items", "coo_src", "coo_col_ptr",
              "coo_t_items", "coo_t_src"):
        assert getattr(f64, k) is getattr(topo, k)
    assert remap_topology(p.topo, ElasticPlan(4, 4, (0, 2, 3))).coo_items \
        is None


def test_elastic_remap_gives_pads_empty_segments():
    """remap_topology builds the views of the padded layout: the real
    partitions' forward views unchanged, their transpose views over the
    wider halo, each pad with no edges and one empty item per output;
    unmap_topology gives the original views back."""
    p = GraphDataPipeline.build("grid-tiny", 4, agg="coo", device="cpu")
    topo = p.topo.with_coo_views()
    plan = ElasticPlan(4, 4, (0, 2, 3))
    padded = remap_topology(topo, plan)
    n, real = padded.num_parts, plan.num_parts
    assert n > real
    for k in coo_spmm.FWD_VIEW:
        got, want = getattr(padded, k)[:real], getattr(topo, k)
        assert torch.equal(got[..., :want.shape[-1]] if k == "coo_src"
                           or k == "coo_w" else got, want), k
    assert padded.coo_col_ptr.shape == (n, padded.max_inner
                                        + padded.halo_size + 1)
    assert not padded.coo_row_ptr[real:].any()
    assert not padded.coo_col_ptr[real:].any()
    rows = torch.arange(topo.max_inner, dtype=torch.int32)
    assert bool((padded.coo_items[real:, :topo.max_inner, 0] == rows).all())
    back = unmap_topology(padded, plan)
    for k in VIEWS:
        assert torch.equal(getattr(back, k), getattr(topo, k)), k


# ----------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the COO kernel has no CPU mode")
    return torch.device("cuda")


def _card_graph(parts, rows=700, cols=2000, nnz=20000, hub=8700):
    """Random padded COO on the card with a hub row of `hub` edges in
    partition 0 (34 work items), empty rows and padding tails, and its
    views: (edges, forward view, transpose view)."""
    er, ec, ew = (t.cuda() for t in _random_coo(parts, rows, cols, nnz,
                                               hub=hub))
    v = coo_spmm.coo_views(er, ec, ew, rows, cols)
    return ((er, ec, ew), tuple(v[k] for k in coo_spmm.FWD_VIEW),
            tuple(v[k] for k in coo_spmm.BWD_VIEW))


def _rel(got, want) -> float:
    return float((got.double() - want).norm() / want.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [1, 4])
@pytest.mark.parametrize("f", [1, 3, 8, 41, 112, 256, 602])
def test_cuda_coo_kernel_matches_plain(f, parts):
    """Both directions on the card against the plain version: float32
    against plain float64 on the relative Frobenius norm, no worse than
    twice the plain float32 version's own reading and under 1e-5; float64
    against plain float64 at 1e-12; one launch a call, counted."""
    dev = _card()
    edges, fwd, bwd = _card_graph(parts)
    gen = torch.Generator(dev).manual_seed(f)
    x = torch.randn(parts, 2000, f, device=dev, generator=gen)
    dz = torch.randn(parts, 700, f, device=dev, generator=gen)
    e64 = edges[:2] + (edges[2].double(),)
    for name, view, inp, n, plain in (
            ("spmm", fwd, x, 700, coo_spmm.spmm_plain),
            ("spmm_t", bwd, dz, 2000, coo_spmm.spmm_t_plain)):
        call = getattr(coo_spmm, name)
        before = spans.counter("coo_spmm." + name)
        got = call(edges, view, inp, n)
        assert spans.counter("coo_spmm." + name) == before + 1
        want = plain(*e64, inp.double(), n)
        ref32 = _rel(plain(*edges, inp, n), want)
        err = _rel(got, want)
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        assert err <= max(2 * ref32, 1e-7) and err < 1e-5, (name, err, ref32)
        v64 = view[:3] + (view[3].double(),)
        got64 = call(e64, v64, inp.double(), n)
        torch.testing.assert_close(got64, want, rtol=1e-12, atol=1e-12)
        if name == "spmm":              # rows 0 and 699 have no edge
            assert not got[:, [0, n - 1]].any()


@pytest.mark.cuda
def test_cuda_coo_kernel_is_deterministic_and_phases_are_bitwise():
    """Two launches give the same bits; each phase's rows are bit-equal to
    the unsplit launch's and the others zero, in both directions."""
    dev = _card()
    edges, fwd, bwd = _card_graph(4)
    x = torch.randn(4, 2000, 256, device=dev)
    dz = torch.randn(4, 700, 256, device=dev)
    split = SplitSpec(row_tail=384, col_tail=1280, fwd_bnd_tiles=1,
                      t_bnd_tiles=1)
    for name, view, inp, n, tail in (("spmm", fwd, x, 700, 384),
                                     ("spmm_t", bwd, dz, 2000, 1280)):
        full = getattr(coo_spmm, name)(edges, view, inp, n)
        again = getattr(coo_spmm, name)(edges, view, inp, n)
        assert torch.equal(full, again), name
        phased = getattr(coo_spmm, name + "_phased")
        before = spans.counter(f"coo_spmm.{name}_phased")
        bnd = phased(edges, view, inp, n, split, "boundary")
        inr = phased(edges, view, inp, n, split, "interior")
        assert spans.counter(f"coo_spmm.{name}_phased") == before + 2
        assert torch.equal(bnd[:, tail:], full[:, tail:]), name
        assert torch.equal(inr[:, :tail], full[:, :tail]), name
        assert not bnd[:, :tail].any() and not inr[:, tail:].any(), name


@pytest.mark.cuda
def test_cuda_coo_kernel_on_pad_partitions_and_the_engine():
    """The COO engine on the card goes through the kernel, on a padded
    elastic layout too: pad partitions (and the pads' halo columns)
    aggregate to zero and the real partitions equal the unpadded launch
    bit for bit."""
    from repro_torch.kernels.aggregate import get_engine
    dev = _card()
    topo = GraphDataPipeline.build("grid-tiny", 4, agg="coo",
                                   device=dev).topo
    padded = remap_topology(topo, ElasticPlan(4, 4, (0, 2, 3)))
    eng = get_engine("coo")
    R, C = topo.max_inner, topo.max_inner + topo.halo_size
    n, Cp = padded.num_parts, padded.max_inner + padded.halo_size
    gen = torch.Generator(dev).manual_seed(3)
    h = torch.randn(4, C, 24, device=dev, generator=gen)
    hp = torch.randn(n, Cp, 24, device=dev, generator=gen)
    hp[:4, :C] = h
    before = spans.counter("coo_spmm.spmm"), spans.counter("coo_spmm.spmm_t")
    ts, tp = (tuple(getattr(t, k) for k in eng.fields) for t in (topo, padded))
    z, zp = eng.spmm(ts, h, R), eng.spmm(tp, hp, R)
    d, dp = eng.spmm_t(ts, z, C), eng.spmm_t(tp, zp, Cp)
    assert (spans.counter("coo_spmm.spmm"),
            spans.counter("coo_spmm.spmm_t")) == (before[0] + 2, before[1] + 2)
    want = coo_spmm.spmm_plain(topo.edge_row, topo.edge_col,
                               topo.edge_w.double(), h.double(), R)
    assert _rel(z, want) < 1e-6
    assert torch.equal(zp[:4], z) and not zp[4:].any()
    assert torch.equal(dp[:4, :C], d) and not dp[:4, C:].any()
    assert not dp[4:].any() and torch.isfinite(dp).all()


@pytest.mark.cuda
def test_cuda_coo_wrappers_refuse_what_the_kernel_does_not_take():
    """A CUDA tensor without views, or in a type the kernel is not built
    for, raises: nothing falls back to the plain version."""
    dev = _card()
    edges, fwd, _ = _card_graph(2, nnz=500, hub=0)
    x = torch.randn(2, 2000, 8, device=dev)
    with pytest.raises(ValueError, match="with_coo_views"):
        coo_spmm.spmm(edges, (None,) * 4, x, 700)
    with pytest.raises(ValueError, match="with_coo_views"):
        coo_spmm.spmm(edges, (), x, 700)
    with pytest.raises(TypeError, match="float32 or float64"):
        coo_spmm.spmm(edges, fwd, x.bfloat16(), 700)
    with pytest.raises(ValueError, match="inconsistent shapes"):
        coo_spmm.spmm(edges, fwd, x, 699)
