"""The spmm kernels' schedule and arithmetic, on the CPU.

The CUDA kernels (csrc/gcn_spmm.cu) walk only the nonzero tiles, from the
work lists and work items of `gcn_spmm.tile_schedule`, and multiply in
3×TF32 on the tensor cores. Neither runs here, so this file holds what
surrounds them to the streams the JAX package defines:

  * the schedule against the tile streams of tiny, grid-tiny (2, 4 and 8
    partitions, phase-aware padding) and random streams: every nonzero
    slot appears exactly once, in stream order, items of at most
    SCHED_CHUNK tiles, and a phase's items are the unsplit items of its
    blocks, which cover exactly the nonzero slots of the JAX stream slice;
  * a plain emulation of the kernels' schedule (per-item partials, summed
    in chunk order) equal to spmm_plain / spmm_t_plain (and the phased
    versions) at 1e-12 in float64;
  * a numpy emulation of the 3×TF32 arithmetic inside rtol = atol = 1e-5
    (the card tests' bar) at the longest nonzero run of the main paths,
    and 1×TF32 outside it.

The kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.data import GraphDataPipeline
from repro_torch.kernels import gcn_spmm, tf32

T = gcn_spmm.TILE
C = gcn_spmm.SCHED_CHUNK
STREAMS = ("rows", "cols", "vals", "t_out", "t_in", "t_perm")
GRAPHS = [("tiny", 2), ("tiny", 4), ("grid-tiny", 2), ("grid-tiny", 4),
          ("grid-tiny", 8)]
MAIN_PATHS = [("reddit-sim", 4), ("yelp-sim", 4), ("yelp-sim", 2),
              ("grid-sim", 4)]


def _random_streams(seed=0, parts=3, rows=3000, cols=5000, nnz=6000):
    """Random shards of 6000, 750 and 93 entries (empty output blocks and
    zero padding tiles); in the first, row block 1 reads all 40 column
    blocks and column block 2 is read by all 24 row blocks: runs of
    several items in both streams."""
    rng = np.random.default_rng(seed)
    tts = []
    for p in range(parts):
        k = max(nnz >> (3 * p), 1)
        r = rng.integers(0, rows, k)
        c = rng.integers(0, cols, k)
        if p == 0:
            r = np.concatenate([r, rng.integers(T, 2 * T, cols),
                                np.arange(rows)])
            c = np.concatenate([c, np.arange(cols),
                                rng.integers(2 * T, 3 * T, rows)])
        v = rng.standard_normal(len(r)).astype(np.float32)
        tts.append(gcn_spmm.build_tile_topology(r, c, v, rows, cols))
    n = max(t.n_tiles for t in tts)
    tts = [gcn_spmm.pad_tile_topology(t, n) for t in tts]
    st = {k: np.stack([getattr(t, k) for t in tts]) for k in STREAMS}
    return st, rows, cols


_PIPES = {}


def _pipeline(name, parts):
    if (name, parts) not in _PIPES:
        _PIPES[name, parts] = GraphDataPipeline.build(
            name, parts, kind="sage", agg="blocksparse", layout="auto",
            device="cpu")
    return _PIPES[name, parts]


def _case(case):
    """(numpy streams, output rows, output columns, split spec or None)."""
    if case == "random":
        st, rows, cols = _random_streams()
        return st, rows, cols, None
    tp = _pipeline(*case)
    topo = tp.topo
    st = {k: getattr(topo, "tile_" + k).numpy() for k in STREAMS}
    return (st, topo.max_inner, topo.max_inner + topo.halo_size,
            tp.split_spec())


def _stream_views(st, rows, cols):
    """Per stream: (out blocks (P, n), nonzero (P, n), tile (P, n), input
    block (P, n), output blocks) in stream order."""
    nz = np.abs(st["vals"]).max(axis=(-1, -2)) > 0
    perm = st["t_perm"].astype(np.int64)
    slots = np.broadcast_to(np.arange(st["rows"].shape[1]), st["rows"].shape)
    return {"": (st["rows"], nz, slots, st["cols"], -(-rows // T)),
            "t_": (st["t_out"], np.take_along_axis(nz, perm, 1), perm,
                   st["t_in"], -(-cols // T))}


CASES = GRAPHS + ["random"]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_schedule_walks_every_nonzero_tile_once_in_stream_order(case):
    st, rows, cols, _ = _case(case)
    sch = gcn_spmm.tile_schedules(SimpleNamespace(**st), rows, cols)
    full = gcn_spmm.tile_schedules(SimpleNamespace(**st), rows, cols,
                                   walk_all=True)
    for key, (out, nz, tile, in_blk, nb) in _stream_views(
            st, rows, cols).items():
        work, items = sch[key + "work"], sch[key + "items"]
        fwork, fitems = full[key + "work"], full[key + "items"]
        assert work.dtype == items.dtype == np.int32
        assert items.shape == fitems.shape
        for p in range(out.shape[0]):
            s_nz = np.flatnonzero(nz[p])           # nonzero slots, in order
            n_nz = len(s_nz)
            assert (work[p, :n_nz, 0] == tile[p, s_nz]).all()
            assert (work[p, :n_nz, 1] == in_blk[p, s_nz]).all()
            it = items[p][items[p, :, 0] >= 0]
            assert (items[p, len(it):, 0] == -1).all()   # pads at the tail
            r, lo, hi, c, n = it.T
            # contiguous, in order, each nonzero slot once, ≤ C per item
            assert lo[0] == 0 and hi[-1] == n_nz and (hi[:-1] == lo[1:]).all()
            assert (hi - lo <= C).all()
            assert (np.diff(r) >= 0).all() and set(r) == set(range(nb))
            for b in range(nb):
                mine = it[r == b]
                assert (mine[:, 3] == np.arange(len(mine))).all()
                assert (mine[:, 4] == len(mine)).all()
                # full chunks first; the run's tiles are its nonzero slots
                sizes = mine[:, 2] - mine[:, 1]
                assert (sizes[:-1] == C).all()
                run = s_nz[mine[0, 1]:mine[-1, 2]]
                assert (out[p, run] == b).all()
                assert len(run) == int(nz[p, out[p] == b].sum())
            # walking every slot: the same items, each holding the same
            # nonzero slots in order plus zero slots
            fit = fitems[p, :len(it)]
            assert (fit[:, [0, 3, 4]] == it[:, [0, 3, 4]]).all()
            n_slots = out.shape[1]
            assert fit[0, 1] == 0 and fit[-1, 2] == n_slots
            assert (fwork[p, :n_slots, 0] == tile[p]).all()
            for i in range(len(it)):
                walked = np.arange(fit[i, 1], fit[i, 2])
                assert (walked[nz[p, walked]] == s_nz[lo[i]:hi[i]]).all()


@pytest.mark.parametrize("case", GRAPHS, ids=str)
def test_topology_carries_the_schedules_of_its_streams(case):
    """topology_from attaches the schedules that Topology.with_schedules
    rebuilds from the topology's own streams; another chunk size or
    walk_all changes the schedule fields and nothing else."""
    topo = _pipeline(*case).topo
    sched = ("tile_work", "tile_items", "tile_t_work", "tile_t_items")
    again = topo.with_schedules()
    assert all(torch.equal(getattr(again, k), getattr(topo, k))
               for k in sched)
    for kw in (dict(chunk=1), dict(walk_all=True)):
        other = topo.with_schedules(**kw)
        assert all(getattr(other, k) is getattr(topo, k)
                   for k in topo._fields if k not in sched)
    full = topo.with_schedules(walk_all=True)
    assert full.tile_work.shape[1] == full.tile_t_work.shape[1] == \
        topo.tile_rows.shape[1]
    one = topo.with_schedules(chunk=1)
    for key in ("tile_items", "tile_t_items"):
        it = getattr(one, key).numpy()
        assert (it[..., 2] - it[..., 1]).max() == 1


@pytest.mark.parametrize("case", [g for g in GRAPHS if g[0] == "grid-tiny"],
                         ids=str)
def test_phase_items_are_the_unsplit_items_of_their_blocks(case):
    """A phase's block range selects a contiguous range of items (those of
    the unsplit launch for the same blocks) whose tiles are exactly the
    nonzero slots of the JAX package's stream slice of that phase."""
    st, rows, cols, sp = _case(case)
    assert sp is not None
    sch = gcn_spmm.tile_schedules(SimpleNamespace(**st), rows, cols)
    views = _stream_views(st, rows, cols)
    for key, tail, n_out, n_bnd in (("", sp.row_tail, rows, sp.fwd_bnd_tiles),
                                    ("t_", sp.col_tail, cols, sp.t_bnd_tiles)):
        _, nz, _, _, _ = views[key]
        items = sch[key + "items"]
        n = nz.shape[1]
        for phase in ("boundary", "interior"):
            b, e = gcn_spmm.phase_blocks(tail, n_out, phase)
            sl = gcn_spmm.phase_slots(n, n_bnd, phase)
            for p in range(nz.shape[0]):
                sel = np.flatnonzero((items[p, :, 0] >= b)
                                     & (items[p, :, 0] < e))
                assert (np.diff(sel) == 1).all()
                s_nz = np.flatnonzero(nz[p])
                walked = np.concatenate([s_nz[lo:hi] for lo, hi in
                                         items[p, sel, 1:3]])
                want = np.arange(sl.start, sl.stop)
                assert (walked == want[nz[p, want]]).all()


def _emulate(work, items, vals, x, num_out, transpose, blocks=None):
    """The kernels' schedule in plain torch: per item the sum of its tiles'
    products in work-list order, then each output block the sum of its
    items' partials in chunk order; NaN outside `blocks`."""
    P, f = x.shape[0], x.shape[2]
    nb = -(-num_out // T)
    b, e = (0, nb) if blocks is None else blocks
    xb = gcn_spmm._blocks(x, -(-x.shape[1] // T))
    out = torch.full((P, nb * T, f), float("nan"), dtype=x.dtype)
    for p in range(P):
        parts = {}
        for r, lo, hi, c, n in items[p]:
            if not b <= r < e:
                continue
            acc = torch.zeros(T, f, dtype=x.dtype)
            for t, blk in work[p, lo:hi]:
                a = vals[p, t].T if transpose else vals[p, t]
                acc = acc + a @ xb[p, blk]
            parts.setdefault(int(r), []).append(acc)
        for r, ps in parts.items():
            s = ps[0]
            for q in ps[1:]:
                s = s + q
            out[p, r * T:(r + 1) * T] = s
    return out[:, :num_out]


@pytest.mark.parametrize("walk_all", [False, True])
@pytest.mark.parametrize("case", [("tiny", 2), ("grid-tiny", 4), "random"],
                         ids=str)
def test_schedule_emulation_matches_plain(case, walk_all):
    """Per-item partials summed in chunk order equal the plain versions at
    1e-12 in float64, unsplit and (where a split exists) per phase."""
    st, rows, cols, sp = _case(case)
    sch = gcn_spmm.tile_schedules(SimpleNamespace(**st), rows, cols,
                                  walk_all=walk_all)
    t = {k: torch.from_numpy(v) for k, v in st.items()}
    vals = t["vals"].double()
    P = vals.shape[0]
    rng = np.random.default_rng(7)
    h = torch.from_numpy(rng.standard_normal((P, cols, 5)))
    dz = torch.from_numpy(rng.standard_normal((P, rows, 5)))
    z = _emulate(sch["work"], sch["items"], vals, h, rows, False)
    d = _emulate(sch["t_work"], sch["t_items"], vals, dz, cols, True)
    torch.testing.assert_close(
        z, gcn_spmm.spmm_plain(t["rows"], t["cols"], vals, h, rows),
        rtol=0, atol=1e-12)
    torch.testing.assert_close(
        d, gcn_spmm.spmm_t_plain(t["t_out"], t["t_in"], t["t_perm"], vals,
                                 dz, cols), rtol=0, atol=1e-12)
    if sp is None:
        return
    for phase in ("boundary", "interior"):
        zb = _emulate(sch["work"], sch["items"], vals, h, rows, False,
                      gcn_spmm.phase_blocks(sp.row_tail, rows, phase))
        want = gcn_spmm.spmm_phased_plain(t["rows"], t["cols"], vals, h,
                                          rows, sp, phase)
        torch.testing.assert_close(zb, want, rtol=0, atol=1e-12,
                                   equal_nan=True)
        db = _emulate(sch["t_work"], sch["t_items"], vals, dz, cols, True,
                      gcn_spmm.phase_blocks(sp.col_tail, cols, phase))
        want = gcn_spmm.spmm_t_phased_plain(t["t_out"], t["t_in"],
                                            t["t_perm"], vals, dz, cols, sp,
                                            phase)
        torch.testing.assert_close(db, want, rtol=0, atol=1e-12,
                                   equal_nan=True)


# ---------------------------------------------------------------------
# 3×TF32 arithmetic
# ---------------------------------------------------------------------

def _emulate_tf32(a, b, passes: int, chunk_k: int, stage_k: int = 32):
    """a (M, K) @ b (K, N) as the kernel computes it: the contraction cut
    into items of `chunk_k` (f32 partials summed in order); in an item,
    each `stage_k`-deep stage a chain of m16n8k8 steps on a fresh
    accumulator, whose 8 products are summed exactly and added with one
    rounding toward zero per step, and the stage partial added to the
    item's sum in round-to-nearest f32; passes = 3 takes lo·hi, hi·lo and
    hi·hi of the split operands (3×TF32: hi = cvt.rna(x), lo = x − hi read
    truncated), passes = 1 hi·hi only."""
    (ahi, alo), (bhi, blo) = tf32.split(a), tf32.split(b)
    terms = ([(alo, bhi), (ahi, blo), (ahi, bhi)] if passes == 3
             else [(ahi, bhi)])
    shape = (a.shape[0], b.shape[1])
    total = None
    for k0 in range(0, a.shape[1], chunk_k):
        acc = np.zeros(shape, np.float32)
        for s0 in range(k0, min(k0 + chunk_k, a.shape[1]), stage_k):
            part = np.zeros(shape, np.float32)
            for k in range(s0, min(s0 + stage_k, a.shape[1]), 8):
                for x, y in terms:
                    step = x[:, k:k + 8].astype(np.float64) @ y[k:k + 8]
                    part = tf32.toward_zero(part + step)
            acc = acc + part
        total = acc if total is None else total + acc
    return total


def _within_bar(got, exact, tol=1e-5):
    return bool(np.all(np.abs(got - exact) <= tol + tol * np.abs(exact)))


def _longest_run():
    """The row (forward) or column (transpose) block of the main paths'
    topologies with the most nonzero tiles: its tiles as one (128, 128·k)
    operand, in the kernel's order."""
    best = (0, None)
    for name, parts in MAIN_PATHS:
        topo = _pipeline(name, parts).topo
        vals = topo.tile_vals.numpy()
        for key, tr in (("", False), ("t_", True)):
            work = getattr(topo, f"tile_{key}work").numpy()
            items = getattr(topo, f"tile_{key}items").numpy()
            for p in range(items.shape[0]):
                live = items[p][items[p, :, 0] >= 0]
                for r in np.unique(live[:, 0]):
                    mine = live[live[:, 0] == r]
                    k = mine[-1, 2] - mine[0, 1]
                    if k > best[0]:
                        tiles = vals[p, work[p, mine[0, 1]:mine[-1, 2], 0]]
                        if tr:
                            tiles = tiles.transpose(0, 2, 1)
                        best = (k, np.concatenate(list(tiles), axis=1))
    return best


def test_3xtf32_keeps_the_f32_bar_at_the_longest_main_path_run():
    """At the longest nonzero run of reddit-sim, yelp-sim (P = 4, 2) and
    grid-sim, with N(0, 1) inputs at F = 64: 3×TF32 stays within rtol =
    atol = 1e-5 of the exact product; so does the same arithmetic on a
    synthetic run of 8064 terms of weight ~1/40 at 5% density, which
    1×TF32 misses."""
    k, a = _longest_run()
    assert k >= 60, k     # 66 tiles: reddit-sim P = 4, forward
    rng = np.random.default_rng(0)
    b = rng.standard_normal((a.shape[1], 64)).astype(np.float32)
    exact = a.astype(np.float64) @ b
    assert _within_bar(_emulate_tf32(a, b, 3, C * T), exact)
    syn = ((rng.random((T, 8064)) < 0.05)
           * rng.uniform(0.5, 1.5, (T, 8064)) / 40).astype(np.float32)
    b = rng.standard_normal((8064, 64)).astype(np.float32)
    exact = syn.astype(np.float64) @ b
    assert _within_bar(_emulate_tf32(syn, b, 3, C * T), exact)
    assert not _within_bar(_emulate_tf32(syn, b, 1, C * T), exact)
