"""The port's CUDA kernels against their plain PyTorch versions on the card
(float32, ragged row counts and feature widths): the block-sparse SpMM
pair, the fused aggregate+transform pair and the phased SpMM launches of
the split-phase schedule; flash attention in float32 and bfloat16 at every
head width it is built for; the kernels/ops.py entry points on one
partition's streams; the sim backend's exchange on a side CUDA stream;
and the LM serve and training paths (no custom kernel) card against CPU.
Needs a CUDA card and nvcc; skips without a card. Imports no JAX, so it runs on a machine with
only the port's dependencies:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.kernels import gcn_spmm


def _random_streams(rows, cols, nnz, parts=3, seed=0):
    """Tile streams of `parts` random shards with nnz, nnz/8, nnz/64 entries:
    the sparser partitions carry zero padding tiles at their stream tails."""
    rng = np.random.default_rng(seed)
    tts = []
    for p in range(parts):
        nnz_p = max(nnz >> (3 * p), 1)
        r = rng.integers(0, rows, nnz_p)
        c = rng.integers(0, cols, nnz_p)
        v = rng.standard_normal(nnz_p).astype(np.float32)
        tts.append(gcn_spmm.build_tile_topology(r, c, v, rows, cols))
    n = max(t.n_tiles for t in tts)
    tts = [gcn_spmm.pad_tile_topology(t, n) for t in tts]
    return {k: np.stack([getattr(t, k) for t in tts])
            for k in ("rows", "cols", "vals", "t_out", "t_in", "t_perm")}


def _schedules(streams, rows, cols, walk_all=False):
    """The spmm kernels' schedules of stacked numpy streams, on the card."""
    sch = gcn_spmm.tile_schedules(SimpleNamespace(**streams), rows, cols,
                                  walk_all=walk_all)
    return {k: torch.from_numpy(v).cuda() for k, v in sch.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("f", [128, 256, 16, 4, 24, 120, 512])
def test_cuda_kernels_match_plain(f):
    """The CUDA kernels against their plain versions on the card, f32, at a
    ragged row count, with zero padding tiles at the stream tails: run
    with a card (see README)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    streams = _random_streams(300, 1000, 2000)
    nonzero = np.abs(streams["vals"]).max(axis=(-1, -2)) > 0
    assert not nonzero[:, -1].all()   # zero padding tiles, skipped
    dev = "cuda"
    st = {k: torch.from_numpy(v).to(dev) for k, v in streams.items()}
    sch = _schedules(streams, 300, 1000)
    parts = streams["rows"].shape[0]
    before = (spans.counter("gcn_spmm.spmm"), spans.counter("gcn_spmm.spmm_t"))
    h = torch.randn(parts, 1000, f, device=dev)
    dz = torch.randn(parts, 300, f, device=dev)
    z = gcn_spmm.spmm(sch["work"], sch["items"], st["rows"], st["cols"],
                      st["vals"], h, 300)
    d = gcn_spmm.spmm_t(sch["t_work"], sch["t_items"], st["t_out"],
                        st["t_in"], st["t_perm"], st["vals"], dz, 1000)
    torch.testing.assert_close(
        z, gcn_spmm.spmm_plain(st["rows"], st["cols"], st["vals"], h, 300),
        rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        d, gcn_spmm.spmm_t_plain(st["t_out"], st["t_in"], st["t_perm"],
                                 st["vals"], dz, 1000),
        rtol=1e-5, atol=1e-5)
    assert (spans.counter("gcn_spmm.spmm"), spans.counter("gcn_spmm.spmm_t")) == (
        before[0] + 1, before[1] + 1)


def _long_run_streams(parts=2, seed=0):
    """Shards of 330 × 330 blocks: row block 0 reads 320 column blocks and
    column block 1 is read by 320 row blocks (runs of 320+ slots in both
    streams), 5% dense tiles of weight ~1/40; blocks 320-329 are empty
    (zero filler tiles); the phase-aware padding puts zero tiles in the
    middle of both long runs (row block 0, column block 1)."""
    rng = np.random.default_rng(seed)
    n = 330 * 128
    tts = []
    for _ in range(parts):
        coo = []
        for rb, cb in [(0, c) for c in range(320)] + [(r, 1) for r in range(1, 320)]:
            mask = rng.random((128, 128)) < 0.05
            r, c = np.nonzero(mask)
            coo.append((rb * 128 + r, cb * 128 + c))
        r = np.concatenate([a for a, _ in coo])
        c = np.concatenate([b for _, b in coo])
        v = (rng.standard_normal(len(r)) / 40).astype(np.float32)
        tt = gcn_spmm.build_tile_topology(r, c, v, n, n)
        cut_f = int(np.searchsorted(tt.rows, 1))
        cut_t = int(np.searchsorted(tt.t_out, 2))
        tts.append(gcn_spmm.pad_tile_topology_phased(
            tt, 1, 2, cut_f + 5, tt.n_tiles - cut_f + 3, cut_t + 4,
            tt.n_tiles - cut_t + 4))
    assert len({t.n_tiles for t in tts}) == 1
    return n, {k: np.stack([getattr(t, k) for t in tts])
               for k in ("rows", "cols", "vals", "t_out", "t_in", "t_perm")}


@pytest.mark.cuda
@pytest.mark.parametrize("f", [4, 24, 512])
def test_cuda_kernels_walk_long_runs_and_skip_zero_tiles(f):
    """Runs of 320+ slots with zero tiles mid-stream and empty output
    blocks: the kernels match their plain versions at rtol = atol = 1e-5,
    the schedule walks exactly the nonzero tiles with no item longer than
    SCHED_CHUNK, and walking every slot (zero tiles too) gives the same
    result bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    n, streams = _long_run_streams()
    st = {k: torch.from_numpy(v).cuda() for k, v in streams.items()}
    sch = _schedules(streams, n, n)
    full = _schedules(streams, n, n, walk_all=True)
    nonzero = int((np.abs(streams["vals"]).max(axis=(-1, -2)) > 0).sum())
    for key in ("items", "t_items"):
        it = sch[key].cpu().numpy()
        live = it[..., 0] >= 0
        walked = (it[..., 2] - it[..., 1])[live]
        assert walked.sum() == nonzero and walked.max() <= gcn_spmm.SCHED_CHUNK
        assert np.array_equal(full[key].cpu().numpy()[..., [0, 3, 4]],
                              it[..., [0, 3, 4]])   # the same items
    x = torch.randn(2, n, f, device="cuda")
    for kern, plain, key in (
            (gcn_spmm.spmm, lambda: gcn_spmm.spmm_plain(
                st["rows"], st["cols"], st["vals"], x, n), ""),
            (gcn_spmm.spmm_t, lambda: gcn_spmm.spmm_t_plain(
                st["t_out"], st["t_in"], st["t_perm"], st["vals"], x, n),
             "t_")):
        streams_of = ((st["rows"], st["cols"], st["vals"]) if not key else
                      (st["t_out"], st["t_in"], st["t_perm"], st["vals"]))
        got = kern(sch[key + "work"], sch[key + "items"], *streams_of, x, n)
        again = kern(full[key + "work"], full[key + "items"], *streams_of, x,
                     n)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, plain(), rtol=1e-5, atol=1e-5)
        assert torch.equal(got, again)
        assert torch.all(got[:, 320 * 128:] == 0)    # the empty blocks


@pytest.mark.cuda
def test_cuda_wrapper_refuses_float64():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    streams = _random_streams(128, 256, 100, parts=1)
    st = {k: torch.from_numpy(v).cuda() for k, v in streams.items()}
    sch = _schedules(streams, 128, 256)
    h = torch.randn(1, 256, 8, device="cuda", dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        gcn_spmm.spmm(sch["work"], sch["items"], st["rows"], st["cols"],
                      st["vals"], h, 128)


def _card_streams(rows, cols, nnz, parts=3):
    """Device tile streams and spmm schedules of random shards."""
    streams = _random_streams(rows, cols, nnz, parts)
    st = {k: torch.from_numpy(v).cuda() for k, v in streams.items()}
    st.update(_schedules(streams, rows, cols))
    return st


@pytest.mark.cuda
@pytest.mark.parametrize("fin,fout", [(128, 256), (256, 16), (120, 24),
                                      (512, 512), (1024, 256)])
@pytest.mark.parametrize("relu,with_z", [(False, True), (True, False)])
def test_cuda_fused_kernel_matches_plain(fin, fout, relu, with_z):
    """spmm_fused against spmm_fused_plain on the card, f32, ragged rows
    and widths, with zero padding tiles at the stream tails; any F_in (1024
    included: the kernel keeps no z row block on chip); z bit-equal to
    spmm's, and a second launch bitwise equal to the first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    st = _card_streams(300, 1000, 2000)
    parts = st["rows"].shape[0]
    h = torch.randn(parts, 1000, fin, device="cuda")
    w = torch.randn(2 * fin, fout, device="cuda") / fin ** 0.5
    b = torch.randn(fout, device="cuda")
    before = spans.counter("gcn_spmm.spmm_fused")
    # w[:fin] is the row slice a SAGE layer passes
    args = (st["work"], st["items"], st["rows"], st["cols"], st["vals"], h,
            w[:fin], b, 300)
    u, z = gcn_spmm.spmm_fused(*args, relu=relu, with_z=with_z)
    torch.cuda.synchronize()
    pu, pz = gcn_spmm.spmm_fused_plain(*args[2:], relu=relu, with_z=with_z)
    assert spans.counter("gcn_spmm.spmm_fused") == before + 1
    gcn_spmm.assert_close_to_scale(u, pu)
    if with_z:
        gcn_spmm.assert_close_to_scale(z, pz)
        assert torch.equal(z, gcn_spmm.spmm(*args[:6], 300))
    else:
        assert z is None
    u2, z2 = gcn_spmm.spmm_fused(*args, relu=relu, with_z=with_z)
    assert torch.equal(u2, u) and (z2 is None or torch.equal(z2, z))


@pytest.mark.cuda
@pytest.mark.parametrize("fin,fout", [(256, 256), (256, 16), (120, 24),
                                      (512, 512)])
def test_cuda_fused_t_kernel_matches_plain(fin, fout):
    """spmm_fused_t against spmm_fused_t_plain on the card, and a second
    launch bitwise equal to the first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    st = _card_streams(300, 1000, 2000)
    parts = st["rows"].shape[0]
    du = torch.randn(parts, 300, fout, device="cuda")
    w = torch.randn(fin, fout, device="cuda") / fout ** 0.5
    before = spans.counter("gcn_spmm.spmm_fused_t")
    args = (st["t_work"], st["t_items"], st["t_out"], st["t_in"],
            st["t_perm"], st["vals"], du, w, 1000)
    d = gcn_spmm.spmm_fused_t(*args)
    torch.cuda.synchronize()
    assert spans.counter("gcn_spmm.spmm_fused_t") == before + 1
    gcn_spmm.assert_close_to_scale(d, gcn_spmm.spmm_fused_t_plain(*args[2:]))
    assert torch.equal(gcn_spmm.spmm_fused_t(*args), d)


@pytest.mark.cuda
@pytest.mark.parametrize("fin,fout", [(24, 4), (512, 512)])
def test_cuda_fused_kernels_walk_long_runs(fin, fout):
    """The fused pair on runs of 320+ slots (far longer than SCHED_CHUNK
    tiles) with zero tiles mid-stream and empty output blocks: within
    assert_close_to_scale of the plain versions, z bit-equal to spmm's,
    and the schedules that walk every slot (zero tiles too) bit-equal to
    the nonzero ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    n, streams = _long_run_streams()
    st = {k: torch.from_numpy(v).cuda() for k, v in streams.items()}
    sch = _schedules(streams, n, n)
    full = _schedules(streams, n, n, walk_all=True)
    h = torch.randn(2, n, fin, device="cuda")
    w = torch.randn(fin, fout, device="cuda") / fin ** 0.5
    b = torch.randn(fout, device="cuda")
    du = torch.randn(2, n, fout, device="cuda")
    fwd = (st["rows"], st["cols"], st["vals"], h, w, b, n)
    u, z = gcn_spmm.spmm_fused(sch["work"], sch["items"], *fwd)
    u_all, z_all = gcn_spmm.spmm_fused(full["work"], full["items"], *fwd)
    torch.cuda.synchronize()
    pu, pz = gcn_spmm.spmm_fused_plain(*fwd)
    gcn_spmm.assert_close_to_scale(u, pu)
    gcn_spmm.assert_close_to_scale(z, pz)
    assert torch.equal(z, gcn_spmm.spmm(sch["work"], sch["items"], *fwd[:4],
                                        n))
    assert torch.equal(u_all, u) and torch.equal(z_all, z)
    assert torch.all(u[:, 320 * 128:] == b)          # the empty blocks
    bwd = (st["t_out"], st["t_in"], st["t_perm"], st["vals"], du, w, n)
    d = gcn_spmm.spmm_fused_t(sch["t_work"], sch["t_items"], *bwd)
    d_all = gcn_spmm.spmm_fused_t(full["t_work"], full["t_items"], *bwd)
    torch.cuda.synchronize()
    gcn_spmm.assert_close_to_scale(d, gcn_spmm.spmm_fused_t_plain(*bwd))
    assert torch.equal(d_all, d)
    assert torch.all(d[:, 320 * 128:] == 0)


@pytest.mark.cuda
def test_cuda_fused_wrappers_refuse_what_the_kernels_do_not_take():
    """float64 and a non-contiguous (transposed) weight."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    st = _card_streams(128, 256, 100, parts=1)
    fwd = (st["work"], st["items"], st["rows"], st["cols"], st["vals"])
    bwd = (st["t_work"], st["t_items"], st["t_out"], st["t_in"],
           st["t_perm"], st["vals"])
    h = torch.randn(1, 256, 8, device="cuda")
    w = torch.randn(8, 8, device="cuda")
    b = torch.zeros(8, device="cuda")
    du = torch.randn(1, 128, 8, device="cuda")
    with pytest.raises(TypeError, match="float32"):
        gcn_spmm.spmm_fused(*fwd, h.double(), w, b, 128)
    with pytest.raises(TypeError, match="float32"):
        gcn_spmm.spmm_fused(*fwd, h, w.double(), b.double(), 128)
    with pytest.raises(TypeError, match="float32"):
        gcn_spmm.spmm_fused_t(*bwd, du.double(), w, 256)
    with pytest.raises(ValueError, match="contiguous"):
        gcn_spmm.spmm_fused(*fwd, h, w.T, b, 128)
    with pytest.raises(ValueError, match="contiguous"):
        gcn_spmm.spmm_fused_t(*bwd, du, w.T, 256)


def _split_pipeline():
    """grid-tiny, 4 partitions, rcm: a real graph with a split-phase spec."""
    from repro_torch.data import GraphDataPipeline
    tp = GraphDataPipeline.build("grid-tiny", 4, agg="blocksparse",
                                 layout="rcm", device="cuda")
    assert tp.split_spec() is not None
    return tp.topo, tp.split_spec()


@pytest.mark.cuda
@pytest.mark.parametrize("f", [16, 64, 72])
def test_cuda_phased_kernels_match_plain(f):
    """spmm_phased / spmm_t_phased against their plain versions on the
    card: in-phase rows within rtol = atol = 1e-5, written into a NaN
    output (every in-phase row finite, every other row still NaN), and
    the two phases reassemble the unsplit kernel's output bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    topo, sp = _split_pipeline()
    P, R = topo.num_parts, topo.max_inner
    C = R + topo.halo_size
    fwd = (topo.tile_work, topo.tile_items, topo.tile_rows,
           topo.tile_cols, topo.tile_vals)
    bwd = (topo.tile_t_work, topo.tile_t_items, topo.tile_t_out,
           topo.tile_t_in, topo.tile_t_perm, topo.tile_vals)
    h = torch.randn(P, C, f, device="cuda")
    dz = torch.randn(P, R, f, device="cuda")
    cases = (
        (gcn_spmm.spmm_phased, gcn_spmm.spmm_phased_plain, fwd, h, R,
         sp.row_tail, gcn_spmm.spmm(*fwd, h, R)),
        (gcn_spmm.spmm_t_phased, gcn_spmm.spmm_t_phased_plain, bwd, dz, C,
         sp.col_tail, gcn_spmm.spmm_t(*bwd, dz, C)))
    for kern, plain, args, x, rows, tail, full in cases:
        got = {}
        for phase in ("boundary", "interior"):
            own = slice(tail, None) if phase == "boundary" else slice(0, tail)
            other = slice(0, tail) if phase == "boundary" else slice(tail, None)
            out = torch.full((P, rows, f), float("nan"), device="cuda")
            before = spans.counter("gcn_spmm." + kern.__name__)
            got[phase] = kern(*args, x, rows, sp, phase, out=out)
            torch.cuda.synchronize()
            assert spans.counter("gcn_spmm." + kern.__name__) == before + 1
            assert got[phase].data_ptr() == out.data_ptr()
            assert torch.isfinite(out[:, own]).all()
            assert torch.isnan(out[:, other]).all()
            want = plain(*args[2:], x, rows, sp, phase)
            torch.testing.assert_close(out[:, own], want[:, own], rtol=1e-5,
                                       atol=1e-5)
        whole = torch.cat([got["interior"][:, :tail],
                           got["boundary"][:, tail:]], dim=1)
        assert torch.equal(whole, full)


@pytest.mark.cuda
def test_cuda_phased_wrappers_refuse_empty_or_out_of_range_blocks():
    """An empty phase or a block range off the grid is refused by the
    wrapper, and by the C entry point itself (cudaErrorInvalidValue)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    topo, sp = _split_pipeline()
    R = topo.max_inner
    fwd = (topo.tile_work, topo.tile_items, topo.tile_rows,
           topo.tile_cols, topo.tile_vals)
    h = torch.randn(topo.num_parts, R + topo.halo_size, 16, device="cuda")
    for bad in (sp._replace(row_tail=0), sp._replace(row_tail=R + 128)):
        with pytest.raises(ValueError, match="strictly inside"):
            gcn_spmm.spmm_phased(*fwd, h, R, bad, "interior")
    nrb = -(-R // 128)
    for blocks in ((2, 2), (3, 1), (-1, 2), (0, nrb + 1)):
        with pytest.raises(RuntimeError, match="cudaError"):
            gcn_spmm._launch_spmm(False, fwd[0], fwd[1], fwd[4], h, R,
                                  blocks, "spmm_phased")
    with pytest.raises(ValueError, match="out must be"):
        gcn_spmm.spmm_phased(*fwd, h, R, sp, "boundary",
                             out=torch.empty(1, device="cuda"))


@pytest.mark.cuda
def test_cuda_side_stream_exchange_equals_the_transpose():
    """The sim backend's exchange on a side stream: ordered after the
    producer of the payload, waited on by the compute stream, equal to the
    synchronous transpose; the payload may be freed before the wait."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.pipegcn import SimBackend
    be = SimBackend()
    x = torch.randn(4, 4, 300, 96, device="cuda")
    want = (x * 2).transpose(0, 1).contiguous()
    for _ in range(3):
        s = x * 2                    # produced on the compute stream
        handle = be.start_exchange(s)
        del s                        # record_stream keeps its memory safe
        torch.randn(4096, 4096, device="cuda").sum()   # other work
        got = handle.wait()
        assert torch.equal(got, want)
    payloads = [x[..., :32] * 1, x[..., 32:] * 1]
    recv = be.start_fused_exchange(payloads).wait()
    assert [torch.equal(r, p.transpose(0, 1)) for r, p in
            zip(recv, payloads)] == [True, True]


@pytest.mark.cuda
def test_cuda_device_spans_of_a_traced_run():
    """Under a profiler session a split-phase run on the card records the
    device spans: each span's device seconds positive, the side stream's
    copies among the exchange's, a nested engine call counted once (the
    outer span), the counters exact; untraced, no device span; under CUDA
    graph capture no span at all."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core import ModelConfig, PipeConfig, train_pipegcn
    from repro_torch.data import GraphDataPipeline
    tp = GraphDataPipeline.build("grid-tiny", 4, agg="blocksparse",
                                 device="cuda")
    ds = tp.dataset
    mc = ModelConfig(kind="sage", feat_dim=ds.feat_dim, hidden=64,
                     num_layers=3, num_classes=ds.num_classes, dropout=0.5,
                     agg="blocksparse", layout=tp.layout)

    def run():
        return train_pipegcn(tp, mc, PipeConfig.named("pipegcn"), epochs=4,
                             eval_every=4, log=None, device="cuda")

    res = run()
    assert spans.last_run()["device_s"] == {}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        res = run()
    last = spans.last_run()
    n_eval = len(res.history["epoch"])
    assert last["epochs"] == 4
    dev = last["device_s"]
    assert {"repro.opt", "repro.exchange", "repro.agg.spmm_phased",
            "repro.agg.spmm_t_phased"} <= set(dev)
    assert all(s > 0 for s in dev.values()), dev
    assert {e for _, e, _ in last["spans"]} == {0, 1, 2, 3}
    assert sum(n == "repro.opt" for n, _, _ in last["spans"]) == 4
    # the split starts every exchange on the side stream: 2 per fused train
    # step, L per (vanilla) eval forward
    copies = last["counters"]["exchange.side_copies"]
    assert copies == 4 * 2 + n_eval * 3
    # per train step 2 phases per layer forward, 2 per layer > 0 backward;
    # per eval forward 2 per layer
    assert last["counters"]["gcn_spmm.spmm_phased"] == (4 + n_eval) * 2 * 3
    assert last["counters"]["gcn_spmm.spmm_t_phased"] == 4 * 2 * 2
    # per train step the verdict, the select, the finite check's upload and
    # Adam's two uploads per leaf (w and b of 3 layers); per evaluation the
    # metric and the loss; and the closing synchronize
    assert last["counters"]["sync.host"] == 4 * (3 + 2 * 6) + n_eval * 2 + 1

    graph = torch.cuda.CUDAGraph()
    x = torch.zeros(8, device="cuda")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with torch.cuda.graph(graph):
            inner = spans.span("repro.test", device=True)
            y = x + 1
    assert inner is spans.span("repro.off")      # the shared null context
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, torch.ones(8, device="cuda"))


# (B, S, T, H, K, causal, window, block): the CPU sweep's GQA groups and
# masks (tests/test_torch_attention.py), a ragged S and T (not multiples of
# the kernel's 64-row tiles), T > S, and T < S with rows that have no
# unmasked key (queries 227 on: the mean of v)
FLASH_CARD_CASES = [
    (1, 256, 256, 4, 4, True, 0, 128),
    (2, 256, 256, 4, 2, True, 192, 128),
    (1, 512, 512, 4, 1, True, 100, 128),
    (1, 384, 384, 8, 2, False, 0, 128),
    (1, 512, 512, 8, 2, False, 192, 128),
    (2, 96, 160, 2, 1, True, 40, 32),
    (1, 128, 384, 4, 2, True, 0, 128),
    (1, 512, 128, 4, 2, False, 100, 128),
]
FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_matches_plain(d, dtype):
    """flash_attention against flash_attention_plain on the card, one
    launch per call: f32 within rtol = atol = 2e-5, bf16 within atol 5e-2
    (the JAX kernel tests' bars) and every bf16 row within
    fa.BF16_ROW_REL of its norm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.device import exact_f32_matmul
    from repro_torch.kernels import flash_attention as fa
    exact_f32_matmul()
    rng = np.random.default_rng(d)
    for case in FLASH_CARD_CASES:
        b, s, t, h, kh, causal, window, blk = case
        q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", dtype)
            for shape in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d)))
        before = spans.counter("flash_attention.flash_attention")
        got = fa.flash_attention(q, k, v, causal=causal, window=window,
                                 q_block=blk, kv_block=blk)
        torch.cuda.synchronize()
        assert spans.counter("flash_attention.flash_attention") == before + 1
        assert got.dtype == dtype and got.shape == (b, s, h, d)
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, q_block=blk,
                                        kv_block=blk)
        rtol = 2e-5 if dtype == torch.float32 else 0
        torch.testing.assert_close(got, want, rtol=rtol,
                                   atol=FLASH_ATOL[dtype],
                                   msg=lambda m, c=case: f"{c}: {m}")
        if dtype == torch.bfloat16:
            fa.assert_rows_close(got, want, fa.BF16_ROW_REL, str(case))


@pytest.mark.cuda
def test_cuda_flash_attention_reads_strided_inputs():
    """q, k, v as slices of one packed (B, S, H + 2K, d) projection: the
    kernel reads them through their strides, bit-equal to contiguous
    copies; so are inputs whose rows are not 16-byte aligned (copied by the
    wrapper before the launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import flash_attention as fa
    packed = torch.randn(2, 192, 8 + 2 * 2, 128, device="cuda")
    q, k, v = packed[:, :, :8], packed[:, :, 8:10], packed[:, :, 10:]
    assert not q.is_contiguous()
    got = fa.flash_attention(q, k, v, window=64, q_block=64, kv_block=64)
    want = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              window=64, q_block=64, kv_block=64)
    assert torch.equal(got, want)
    flat = torch.randn(packed.numel() + 1, device="cuda")
    shifted = flat[1:].view(packed.shape)   # rows 4 bytes off alignment
    assert shifted.data_ptr() % 16
    q, k, v = shifted[:, :, :8], shifted[:, :, 8:10], shifted[:, :, 10:]
    got = fa.flash_attention(q, k, v, window=64, q_block=64, kv_block=64)
    want = fa.flash_attention(q.clone(), k.clone(), v.clone(), window=64,
                              q_block=64, kv_block=64)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_what_the_kernel_does_not_take():
    """A head dim it is not built for, float64, mixed dtypes, a strided
    head dim axis, and a negative window (refused by the C entry point)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import flash_attention as fa
    x = torch.randn(1, 128, 2, 64, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        y = torch.randn(1, 128, 2, 48, device="cuda")
        fa.flash_attention(y, y, y, q_block=64, kv_block=64)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention(x.double(), x.double(), x.double(), q_block=64,
                           kv_block=64)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention(x, x.bfloat16(), x, q_block=64, kv_block=64)
    with pytest.raises(ValueError, match="contiguous"):
        z = torch.randn(1, 128, 2, 128, device="cuda")[..., ::2]
        fa.flash_attention(z, z, z, q_block=64, kv_block=64)
    with pytest.raises(RuntimeError, match="cudaError"):
        fa.flash_attention(x, x, x, window=-1, q_block=64, kv_block=64)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_long_run_matches_plain(d, dtype):
    """A long causal run, S = T = 4096 (H = 2, K = 1): every q tile walks
    up to 4096 keys through the ring, at the bars of
    test_cuda_flash_attention_matches_plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.device import exact_f32_matmul
    from repro_torch.kernels import flash_attention as fa
    exact_f32_matmul()
    rng = np.random.default_rng(1000 + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to("cuda", dtype)
        for shape in ((1, 4096, 2, d), (1, 4096, 1, d), (1, 4096, 1, d)))
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    rtol = 2e-5 if dtype == torch.float32 else 0
    torch.testing.assert_close(got, want, rtol=rtol, atol=FLASH_ATOL[dtype])
    if dtype == torch.bfloat16:
        fa.assert_rows_close(got, want, fa.BF16_ROW_REL, f"d={d}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_is_deterministic(dtype):
    """Two launches on one input give bitwise-equal outputs (no atomics, a
    fixed summation order), with masks on every path: causal with a
    window, ragged S and T."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(0)
    for d in (64, 128, 256):
        q = torch.randn(1, 1000, 8, d, device="cuda", generator=gen).to(dtype)
        k, v = (torch.randn(1, 1000, 2, d, device="cuda",
                            generator=gen).to(dtype) for _ in range(2))
        a = fa.flash_attention(q, k, v, causal=True, window=300, q_block=8,
                               kv_block=8)
        b = fa.flash_attention(q, k, v, causal=True, window=300, q_block=8,
                               kv_block=8)
        assert torch.equal(a, b), d


@pytest.mark.cuda
@pytest.mark.parametrize("f", [16, 128])
def test_cuda_ops_entry_points_match_plain_and_the_stacked_launch(f):
    """kernels/ops.py's six entry points on one partition's streams launch
    the kernels once each (two per phased pair), match the plain versions
    and equal partition 0 of the stacked wrappers' launch bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import ops
    streams = _random_streams(300, 1000, 2000)
    st = {k: torch.from_numpy(v).cuda() for k, v in streams.items()}
    sch = _schedules(streams, 300, 1000)
    fwd0 = [st[k][0] for k in ("rows", "cols", "vals")]
    bwd0 = [st[k][0] for k in ("t_out", "t_in", "t_perm", "vals")]
    fwd = [sch["work"], sch["items"]] + [st[k] for k in ("rows", "cols",
                                                         "vals")]
    bwd = [sch["t_work"], sch["t_items"]] + [
        st[k] for k in ("t_out", "t_in", "t_perm", "vals")]
    parts = streams["rows"].shape[0]
    h = torch.randn(parts, 1000, f, device="cuda")
    dz = torch.randn(parts, 300, f, device="cuda")
    w = torch.randn(f, 24, device="cuda") / f ** 0.5
    b = torch.randn(24, device="cuda")
    du = torch.randn(parts, 300, 24, device="cuda")
    cut = int((streams["rows"][0] >= 1).sum())      # rows from block 1 on
    sp = gcn_spmm.SplitSpec(128, 128, cut, cut)
    before = {k: spans.counter("gcn_spmm." + k) for k in (
        "spmm", "spmm_t", "spmm_fused", "spmm_fused_t", "spmm_phased")}
    got = {"spmm": ops.spmm(*fwd0, h[0], 300),
           "spmm_t": ops.spmm_t(*bwd0, dz[0], 1000),
           "spmm_fused": ops.spmm_fused(*fwd0, h[0], w, b, 300)[0],
           "spmm_fused_t": ops.spmm_fused_t(*bwd0, du[0], w, 1000),
           "spmm_phased": ops.spmm_phased(*fwd0, h[0], 300, cut,
                                          "boundary")[128:]}
    after = {k: spans.counter("gcn_spmm." + k) for k in before}
    assert all(after[k] == before[k] + 1 for k in before), (before, after)
    stacked = {"spmm": gcn_spmm.spmm(*fwd, h, 300),
               "spmm_t": gcn_spmm.spmm_t(*bwd, dz, 1000),
               "spmm_fused": gcn_spmm.spmm_fused(*fwd, h, w, b, 300)[0],
               "spmm_fused_t": gcn_spmm.spmm_fused_t(*bwd, du, w, 1000),
               "spmm_phased": gcn_spmm.spmm_phased(
                   *fwd, h, 300, sp, "boundary")[:, 128:]}
    plain_fwd = [st[k][:1] for k in ("rows", "cols", "vals")]
    plain_bwd = [st[k][:1] for k in ("t_out", "t_in", "t_perm", "vals")]
    plain = {"spmm": gcn_spmm.spmm_plain(*plain_fwd, h[:1], 300)[0],
             "spmm_t": gcn_spmm.spmm_t_plain(*plain_bwd, dz[:1], 1000)[0],
             "spmm_fused": gcn_spmm.spmm_fused_plain(*plain_fwd, h[:1], w, b,
                                                     300)[0][0],
             "spmm_fused_t": gcn_spmm.spmm_fused_t_plain(*plain_bwd, du[:1],
                                                         w, 1000)[0],
             "spmm_phased": gcn_spmm.spmm_plain(*plain_fwd, h[:1],
                                                300)[0][128:]}
    for k, g in got.items():
        assert torch.equal(g, stacked[k][0]), k
        if k.startswith("spmm_fused"):
            gcn_spmm.assert_close_to_scale(g, plain[k], k)
        else:
            torch.testing.assert_close(g, plain[k], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-moe-1b-a400m",
                                  "mamba2-780m", "recurrentgemma-2b"])
def test_cuda_serve_matches_the_cpu(arch):
    """The LM serve path on the card against the same port on the CPU from
    the same parameters (drawn on the card): prefill logits and 3 decode
    steps' logits within 1e-4 relative, and serve_with's greedy tokens
    equal. The serve path launches no custom kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the serve path runs on it")
    from repro_torch.device import exact_f32_matmul
    from repro_torch.launch.serve import serve_with
    from torch.utils._pytree import tree_map
    from repro_torch.configs import get_arch
    from repro_torch.models.model import LM
    exact_f32_matmul()
    lm = LM(get_arch(arch).reduced())
    card = lm.init_params(torch.Generator("cuda").manual_seed(0))
    host = tree_map(lambda x: x.cpu(), card)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, lm.cfg.vocab_size, (2, 12))
    logits = {}
    for dev, params in (("cuda", card), ("cpu", host)):
        caches = lm.init_caches(2, 16, device=dev)
        out, caches = lm.prefill(params, {"tokens": torch.from_numpy(
            toks).to(dev)}, caches)
        seen = [out[..., :lm.cfg.vocab_size].cpu()]
        for i in range(3):
            out, caches = lm.decode_step(params, torch.from_numpy(
                toks[:, i:i + 1]).to(dev), caches, 12 + i)
            seen.append(out[..., :lm.cfg.vocab_size].cpu())
        logits[dev] = seen
    for got, want in zip(logits["cuda"], logits["cpu"]):
        assert float((got - want).norm() / want.norm()) < 1e-4
    assert (serve_with(lm, card, 2, 12, 4)["sample_output"]
            == serve_with(lm, host, 2, 12, 4)["sample_output"])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-moe-1b-a400m"])
def test_cuda_lm_loss_and_gradients_match_the_cpu(arch):
    """The LM training loss and its gradients (autograd through the plain
    model; no custom kernel) on the card against the same port on the CPU
    from the same parameters (drawn on the card), one dense and one MoE
    arch, reduced, f32: the loss and every gradient leaf within 1e-5
    relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the training path runs on it")
    from torch.utils._pytree import tree_leaves, tree_map
    from repro_torch.configs import get_arch
    from repro_torch.device import exact_f32_matmul
    from repro_torch.launch.train import loss_and_grads
    from repro_torch.models.model import LM
    exact_f32_matmul()
    lm = LM(get_arch(arch).reduced())
    card = lm.init_params(torch.Generator("cuda").manual_seed(0))
    host = tree_map(lambda x: x.cpu(), card)
    toks = np.random.default_rng(0).integers(0, lm.cfg.vocab_size, (2, 16))
    seen = {}
    for dev, params in (("cuda", card), ("cpu", host)):
        t = torch.from_numpy(toks).to(dev)
        seen[dev] = loss_and_grads(lm, params, {
            "tokens": t, "labels": torch.roll(t, -1, 1)})
    (loss, grads), (want_loss, want_grads) = seen["cuda"], seen["cpu"]
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    pairs = list(zip(tree_leaves(grads), tree_leaves(want_grads)))
    assert len(pairs) == len(tree_leaves(host))
    for got, want in pairs:
        assert got.is_cuda
        assert float((got.cpu() - want).norm()) <= 1e-5 * float(want.norm())


DRYRUN = """
import json
import repro_torch.launch.dryrun as dryrun
from repro_torch.launch.dryrun_pipegcn import dryrun_pipegcn
out = {"gcn": dryrun_pipegcn(True, device="cuda", steps=1),
       "gcn_layer": dryrun_pipegcn(True, fuse=False, device="cuda", steps=1)}
full = dryrun.get_arch    # the production mesh at reduced widths, in bf16
dryrun.get_arch = lambda arch: full(arch).reduced(dtype="bfloat16")
for dev in ("meta", "cuda"):
    out["lm_" + dev] = dryrun.dryrun_one("qwen3-8b", "train_4k", device=dev,
                                         steps=1)
print(json.dumps(out))
"""


@pytest.mark.cuda
def test_cuda_dryrun_card_mode():
    """The dry-run's card mode, rank 0 of a fake process group (started in a
    subprocess): PipeGCN at SMALL on the 2×16×16 mesh (512 partitions),
    fused and per layer, with the expected boundary collectives and JAX's
    wire bytes; a reduced qwen3-8b train_4k step on 16×16 with the argument
    bytes and the collectives (count and bytes of each type) of its
    abstract (meta) run, with its peak memory and step time measured."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the dry-run's card mode")
    import json
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", DRYRUN], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    small = {"max_inner": 1_024, "slot": 256, "feat_dim": 602, "hidden": 256,
             "num_layers": 4}
    for key, want in (("gcn", 2), ("gcn_layer", 7)):
        r = out[key]
        assert r["sizes"]["max_inner"] == small["max_inner"]
        assert r["boundary_collectives_per_step"] == want
        assert r["boundary_collectives_expected"] == want
        dims = [small["feat_dim"]] + [small["hidden"]] * 3
        wire = 512 * small["slot"] * (sum(dims) + sum(dims[1:])) * 4
        assert r["boundary_wire_bytes"] == r["recorded_wire_bytes"] == wire
        assert r["peak_bytes"] >= r["argument_size_in_bytes"] > 0
        assert r["step_ms"] > 0
    meta, card = out["lm_meta"], out["lm_cuda"]
    assert card["argument_size_in_bytes"] == meta["argument_size_in_bytes"]
    # the card's step issues the collectives its abstract run counted, each
    # of the same size; a tensor-parallel step gathers and reduces
    for key in ("collective_counts_per_device", "collective_bytes_per_device"):
        assert card[key] == meta[key], (key, card[key], meta[key])
    counts = card["collective_counts_per_device"]
    assert counts["all-gather"] > 0
    assert counts["all-reduce"] + counts["reduce-scatter"] > 0
    assert card["collective_total_bytes"] == sum(
        card["collective_bytes_per_device"].values())
    assert card["peak_bytes"] >= card["argument_size_in_bytes"]
    assert card["step_ms"] > 0


# The combos torch 2.11's DTensor refused before shardctx routed the ops
# (tests/test_torch_dryrun_routes.py lists the refused pairs)
REFUSED_COMBOS = (
    "deepseek-v2-236b:train_4k:16x16", "granite-moe-1b-a400m:train_4k:16x16",
    "mamba2-780m:train_4k:16x16", "deepseek-v2-236b:decode_32k:16x16",
    "deepseek-v2-236b:train_4k:2x16x16",
    "granite-moe-1b-a400m:train_4k:2x16x16", "mamba2-780m:train_4k:2x16x16",
    "deepseek-v2-236b:decode_32k:2x16x16",
    "deepseek-v2-236b:prefill_32k:2x16x16",
    "granite-moe-1b-a400m:prefill_32k:2x16x16",
    "granite-moe-1b-a400m:decode_32k:2x16x16",
)


def _dryrun_routes(combos, timeout=900) -> dict:
    import json
    import os
    import subprocess
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(here, "..", "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, os.path.join(
        here, "_dryrun_routes.py"), *combos], capture_output=True, text=True,
        env=env, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])["rows"]


@pytest.mark.cuda
def test_cuda_dryrun_refused_combos_run():
    """The 11 dry-run combos that torch 2.11's DTensor refused (4 on 16×16,
    7 on 2×16×16) at reduced widths, abstract (meta), each rank 0 of a fake
    process group in a subprocess (4 side by side): every combo gives a row
    with no error, its argument bytes and collective table. Run on the card
    machine's torch, this is where a release whose DTensor refuses a new op
    on the dry-run's path shows first."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card machine's torch: the refusals were its")
    from concurrent.futures import ThreadPoolExecutor
    groups = [REFUSED_COMBOS[i::4] for i in range(4)]
    with ThreadPoolExecutor(4) as ex:
        rows = {k: v for out in ex.map(_dryrun_routes, groups)
                for k, v in out.items()}
    assert sorted(rows) == sorted(REFUSED_COMBOS)
    errs = {k: v["error"][:400] for k, v in rows.items() if "error" in v}
    assert not errs, errs
    for combo, r in rows.items():
        assert r["argument_size_in_bytes"] > 0, combo
        assert r["collective_total_bytes"] == sum(
            r["collective_bytes_per_device"].values()) > 0, combo


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-780m"])
def test_cuda_dryrun_card_mode_routed(arch):
    """A reduced train_4k step on 16×16 that runs the routed forms (MoE's
    index and its backward; the SSD's cumsum and its backward) as rank 0
    on the card: the argument bytes and the collectives (count and bytes
    of each type) of its abstract (meta) run, with its peak memory and
    step time measured."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the dry-run's card mode")
    rows = _dryrun_routes([f"{arch}:train_4k:16x16:meta",
                           f"{arch}:train_4k:16x16:cuda"])
    meta, card = rows[f"{arch}:train_4k:16x16:meta"], \
        rows[f"{arch}:train_4k:16x16:cuda"]
    assert "error" not in meta and "error" not in card, (meta, card)
    assert card["argument_size_in_bytes"] == meta["argument_size_in_bytes"]
    for key in ("collective_counts_per_device", "collective_bytes_per_device"):
        assert card[key] == meta[key], (key, card[key], meta[key])
    assert card["collective_counts_per_device"]["all-gather"] > 0
    assert card["peak_bytes"] >= card["argument_size_in_bytes"]
    assert card["step_ms"] > 0


def _dryrun_env():
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(here, "..", "src"), os.environ.get("PYTHONPATH", "")]))


@pytest.mark.cuda
def test_cuda_dryrun_sweep(tmp_path):
    """``--all --device meta`` on both meshes under the card machine's
    torch, one process each, side by side (~4 min): 80 of 80 rows pass
    JAX's artifact gates (`check_rows`) and hold to JAX's rows
    (`check_against_jax`, with JAX's rows as data:
    tests/_dryrun_jax_rows.py): every row's collectives counted, its
    argument bytes JAX's or the int32 scalar fewer, an MoE row at least one
    all-reduce of its (tokens, d_model) output per MoE layer, the seven
    rows of ROADMAP F5 at most 4× JAX's collective bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card machine's torch: the rows are its")
    import json
    import subprocess
    import sys
    from _dryrun_jax_rows import check_against_jax
    from repro_torch.launch.dryrun import check_rows
    procs = {}
    for mesh in ("16x16", "2x16x16"):
        out = tmp_path / f"{mesh}.json"
        procs[mesh] = (out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--device", "meta", "--out", str(out)]
            + (["--multi-pod"] if mesh == "2x16x16" else []),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
            env=_dryrun_env()))
    for mesh, (out, proc) in procs.items():
        _, err = proc.communicate(timeout=1200)
        assert proc.returncode == 0, err[-4000:]
        rows = json.loads(out.read_text())
        check_rows(rows, 512 if mesh == "2x16x16" else 256)
        check_against_jax(rows, mesh)


BYTES = """
import json, sys
from repro_torch.launch.dryrun import dryrun_one
arch, shape = sys.argv[1:3]
meta = dryrun_one(arch, shape, device="meta")
card = dryrun_one(arch, shape, device="cuda", steps=1)
print(json.dumps({"meta": meta, "card": card}))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("arch,shape", [
    ("qwen3-8b", "train_4k"), ("qwen3-8b", "prefill_32k"),
    ("qwen3-8b", "decode_32k"), ("qwen3-8b", "long_500k"),
    ("granite-moe-1b-a400m", "train_4k"), ("mamba2-780m", "train_4k")])
def test_cuda_dryrun_bytes_per_device(arch, shape):
    """The abstract run's bytes per device (arguments + the peak of the
    step's own storages, `StepMemory`) within 15% of the card's allocator
    peak on the six combos the card runs (the MoE arch under global
    routing, which fits); the card run's own count equals the abstract
    one's (~30–80 s each)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the dry-run's card mode")
    import json
    import subprocess
    import sys
    proc = subprocess.run([sys.executable, "-c", BYTES, arch, shape],
                          capture_output=True, text=True, env=_dryrun_env(),
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    meta, card = out["meta"], out["card"]
    assert card["argument_size_in_bytes"] == meta["argument_size_in_bytes"]
    ratio = meta["bytes_per_device"] / card["peak_bytes"]
    assert abs(ratio - 1) <= 0.15, (arch, shape, ratio)
    assert card["bytes_per_device"] >= card["argument_size_in_bytes"] > 0
