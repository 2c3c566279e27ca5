"""The fused kernels' schedule and arithmetic, on the CPU.

The fused pair (csrc/gcn_spmm.cu, `fused_items_kernel`) aggregates on the
spmm kernels' work items (nonzero tiles only, per-item partials added in
chunk order), the transpose at F_out, and then multiplies each output
block by the layer weight in epilogue passes: u = z·w + b (ReLU'd when
asked) forward, and δcomb = (Pᵀ·du)·wᵀ, the reassociated Pᵀ·(du·wᵀ), for
the transpose. Both products run on the tensor cores, the aggregation in
3×TF32 and the epilogue in 4×TF32. Neither runs here, so this file
emulates them:

  * the schedule in float64 (per-item partials summed in chunk order, then
    the dense product per output block) against spmm_fused_plain /
    spmm_fused_t_plain at 1e-12, on tiny, grid-tiny and random streams
    (runs of several items, empty output blocks, zero padding tiles);
  * the arithmetic in numpy with kernels/tf32.py: the aggregation in
    3×TF32, 32-deep stages on fresh accumulators, the epilogue in 4×TF32,
    8-deep steps, each summed in f32, against the plain versions in
    float32 within
    gcn_spmm.assert_close_to_scale (the card tests' bar), and against the
    exact product at the widest main-path K (F_in = F_out = 512) over the
    longest nonzero run of the main paths, where 1×TF32 misses the bar.

The kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

from repro_torch.data import GraphDataPipeline
from repro_torch.kernels import gcn_spmm, tf32

T = gcn_spmm.TILE
STREAMS = ("rows", "cols", "vals", "t_out", "t_in", "t_perm")
MAIN_PATHS = [("reddit-sim", 4), ("yelp-sim", 4), ("yelp-sim", 2),
              ("grid-sim", 4)]


def _random_streams(seed=0, parts=3, rows=1500, cols=2500, nnz=3000):
    """Random shards of 3000, 375 and 46 entries (empty output blocks and
    zero padding tiles); in the first, row block 1 reads every column
    block and column block 2 is read by every row block: runs of several
    items in both streams."""
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
    return {k: np.stack([getattr(t, k) for t in tts]) for k in STREAMS}, \
        rows, cols


_PIPES = {}


def _pipeline(name, parts):
    if (name, parts) not in _PIPES:
        _PIPES[name, parts] = GraphDataPipeline.build(
            name, parts, kind="sage", agg="fused", layout="auto",
            device="cpu")
    return _PIPES[name, parts]


def _case(case):
    """(numpy streams, output rows, output columns, schedules)."""
    if case == "random":
        st, rows, cols = _random_streams()
    else:
        topo = _pipeline(*case).topo
        st = {k: getattr(topo, "tile_" + k).numpy() for k in STREAMS}
        rows, cols = topo.max_inner, topo.max_inner + topo.halo_size
    return st, rows, cols, gcn_spmm.tile_schedules(SimpleNamespace(**st),
                                                   rows, cols)


def _runs(work, items, vals, x, transpose, product):
    """The aggregation as the kernels schedule it, vals and x numpy: per
    partition and output block r, each work item's product(A, B) of its
    tiles side by side (transposed for Pᵀ) and the input blocks they read,
    stacked. Yields (p, r, [item partials in chunk order])."""
    xb = gcn_spmm._blocks(torch.from_numpy(x), -(-x.shape[1] // T)).numpy()
    for p in range(items.shape[0]):
        parts = {}
        for r, lo, hi, c, n in items[p]:
            if r < 0:
                continue
            if hi == lo:        # an output block without nonzero tiles
                part = np.zeros((T, x.shape[2]), x.dtype)
            else:
                part = product(
                    np.concatenate([vals[p, t].T if transpose else vals[p, t]
                                    for t, _ in work[p, lo:hi]], axis=1),
                    np.concatenate([xb[p, blk] for _, blk in work[p, lo:hi]],
                                   axis=0))
            parts.setdefault(int(r), []).append(part)
        yield from ((p, r, ps) for r, ps in parts.items())


def _emulate(work, items, vals, x, w, b, num_out, transpose, relu,
             agg_product, epi_product):
    """The fused kernel's result: each output block's aggregate (the item
    partials added in chunk order) times w (wᵀ for the transpose), + b,
    ReLU'd when `relu`."""
    x, w = x.numpy(), w.numpy()
    nb = -(-num_out // T)
    out = np.full((items.shape[0], nb * T, w.shape[0] if transpose
                   else w.shape[1]), np.nan, x.dtype)
    for p, r, ps in _runs(work, items, vals.numpy(), x, transpose,
                          agg_product):
        agg = ps[0]
        for q in ps[1:]:
            agg = agg + q
        res = epi_product(agg, w.T if transpose else w)
        if b is not None:
            res = res + b.numpy()
        if relu:
            res = np.maximum(res, 0)
        out[p, r * T:(r + 1) * T] = res
    return torch.from_numpy(out[:, :num_out])


def _f64(a, b):
    return a @ b


CASES = [("tiny", 2), ("grid-tiny", 4), "random"]


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_fused_schedule_emulation_matches_plain(case, relu):
    """Per-item partials in chunk order, then the dense product once per
    output block, equal spmm_fused_plain forward and spmm_fused_t_plain
    (Pᵀ·(du·wᵀ), here (Pᵀ·du)·wᵀ) at 1e-12 in float64."""
    st, rows, cols, sch = _case(case)
    t = {k: torch.from_numpy(v) for k, v in st.items()}
    vals = t["vals"].double()
    P = vals.shape[0]
    rng = np.random.default_rng(11)
    fin, fout = 24, 40
    h = torch.from_numpy(rng.standard_normal((P, cols, fin)))
    du = torch.from_numpy(rng.standard_normal((P, rows, fout)))
    w = torch.from_numpy(rng.standard_normal((fin, fout)) / np.sqrt(fin))
    b = torch.from_numpy(rng.standard_normal(fout))
    u = _emulate(sch["work"], sch["items"], vals, h, w, b, rows, False, relu,
                 _f64, _f64)
    want, _ = gcn_spmm.spmm_fused_plain(t["rows"], t["cols"], vals, h, w, b,
                                        rows, relu=relu, with_z=False)
    torch.testing.assert_close(u, want, rtol=0, atol=1e-12)
    d = _emulate(sch["t_work"], sch["t_items"], vals, du, w, None, cols,
                 True, False, _f64, _f64)
    want = gcn_spmm.spmm_fused_t_plain(t["t_out"], t["t_in"], t["t_perm"],
                                       vals, du, w, cols)
    torch.testing.assert_close(d, want, rtol=0, atol=1e-12)


# ---------------------------------------------------------------------
# 3×TF32 arithmetic
# ---------------------------------------------------------------------

def _tf32_product(a, b, passes=3, stage_k=32):
    """a (M, K) @ b (K, N) in float32 as ring_mma computes it. 3×TF32 (the
    aggregation): 32-deep stages, each on a fresh accumulator added to the
    running sum in round-to-nearest f32; in a stage, m16n8k8 steps whose 8
    products are summed exactly and added with one rounding toward zero,
    for the passes lo·hi, hi·lo, hi·hi of the split operands (hi =
    cvt.rna(x), lo = x − hi read truncated). 4×TF32 (the fused epilogue):
    lo rounded to nearest, the passes lo·lo, lo·hi, hi·lo, hi·hi, and each
    8-deep step on a fresh accumulator of its own, added in f32. 1×TF32:
    the epilogue's steps with hi·hi alone."""
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    four = passes == 4
    (ahi, alo), (bhi, blo) = tf32.split(a, four), tf32.split(b, four)
    terms = {1: [(ahi, bhi)], 3: [(alo, bhi), (ahi, blo), (ahi, bhi)],
             4: [(alo, blo), (alo, bhi), (ahi, blo), (ahi, bhi)]}[passes]
    step = passes != 3
    shape = (a.shape[0], b.shape[1])
    acc = np.zeros(shape, np.float32)
    for s0 in range(0, a.shape[1], stage_k):
        part = np.zeros(shape, np.float32)
        for k in range(s0, min(s0 + stage_k, a.shape[1]), 8):
            d = np.zeros(shape, np.float32) if step else part
            for x, y in terms:
                d = tf32.toward_zero(d + x[:, k:k + 8].astype(np.float64)
                                     @ y[k:k + 8])
            if step:
                acc = acc + d
            else:
                part = d
        if not step:
            acc = acc + part
    return acc


def _epilogue(a, b):
    return _tf32_product(a, b, passes=4)


@pytest.mark.parametrize("fin,fout", [(24, 40), (120, 16)])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_3xtf32_fused_emulation_keeps_the_f32_bar(case, fin, fout):
    """The kernels' arithmetic (3×TF32 aggregation in 32-deep stages on
    the work items, 4×TF32 epilogue in 8-deep steps) within
    assert_close_to_scale of the plain versions in float32, forward with
    ReLU and the reassociated transpose."""
    st, rows, cols, sch = _case(case)
    t = {k: torch.from_numpy(v) for k, v in st.items()}
    P = t["vals"].shape[0]
    rng = np.random.default_rng(fin + fout)
    h = torch.from_numpy(rng.standard_normal((P, cols, fin), np.float32))
    du = torch.from_numpy(rng.standard_normal((P, rows, fout), np.float32))
    w = torch.from_numpy((rng.standard_normal((fin, fout))
                          / np.sqrt(fin)).astype(np.float32))
    b = torch.from_numpy(0.1 * rng.standard_normal(fout, np.float32))
    u = _emulate(sch["work"], sch["items"], t["vals"], h, w, b, rows, False,
                 True, _tf32_product, _epilogue)
    want, _ = gcn_spmm.spmm_fused_plain(t["rows"], t["cols"], t["vals"], h,
                                        w, b, rows, relu=True, with_z=False)
    gcn_spmm.assert_close_to_scale(u, want, f"forward {case}")
    d = _emulate(sch["t_work"], sch["t_items"], t["vals"], du, w, None, cols,
                 True, False, _tf32_product, _epilogue)
    want = gcn_spmm.spmm_fused_t_plain(t["t_out"], t["t_in"], t["t_perm"],
                                       t["vals"], du, w, cols)
    gcn_spmm.assert_close_to_scale(d, want, f"transpose {case}")


def _longest_run():
    """The output block of the main paths' topologies, forward or
    transpose, with the most nonzero tiles: its tiles side by side (as the
    kernel contracts them: transposed for Pᵀ) and their number."""
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


def _within_scale(got, exact, tol=1e-5):
    """assert_close_to_scale's bar against the exact result."""
    scale = np.abs(exact).max()
    return bool(np.all(np.abs(got - exact) <= tol * scale
                       + tol * np.abs(exact)))


def test_3xtf32_fused_keeps_the_f32_bar_at_the_widest_k_and_longest_run():
    """At the longest nonzero run of the main paths (reddit-sim, yelp-sim P
    = 4 and 2, grid-sim) aggregated at F = 512 in items of SCHED_CHUNK
    tiles, then the epilogue at K = F_in = F_out = 512 (the widest main-path
    dense product, yelp-sim's hidden layers), with N(0, 1) inputs: the
    kernel's result (4×TF32 epilogue) stays within assert_close_to_scale's
    bar of the exact (P·h)·w + b, and so would a 3×TF32 epilogue; a 1×TF32
    epilogue on the same aggregate misses it."""
    k, a = _longest_run()
    assert k >= 60, k     # 66 tiles: reddit-sim P = 4, forward
    rng = np.random.default_rng(5)
    x = rng.standard_normal((a.shape[1], 512)).astype(np.float32)
    w = (rng.standard_normal((512, 512)) / np.sqrt(512)).astype(np.float32)
    b = (0.1 * rng.standard_normal(512)).astype(np.float32)
    items = [(c, min(c + gcn_spmm.SCHED_CHUNK * T, a.shape[1]))
             for c in range(0, a.shape[1], gcn_spmm.SCHED_CHUNK * T)]
    z = None
    for lo, hi in items:         # item partials, added in chunk order
        part = _tf32_product(a[:, lo:hi], x[lo:hi])
        z = part if z is None else z + part
    exact = (a.astype(np.float64) @ x) @ w + b
    assert _within_scale(_epilogue(z, w) + b, exact)
    assert _within_scale(_tf32_product(z, w, passes=3) + b, exact)
    assert not _within_scale(_tf32_product(z, w, passes=1) + b, exact)
