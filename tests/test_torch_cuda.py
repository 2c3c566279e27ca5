"""The port's CUDA kernels against their plain PyTorch versions on the card
(float32, ragged row counts and feature widths): the block-sparse SpMM
pair, the fused aggregate+transform pair and the phased SpMM launches of
the split-phase schedule; flash attention in float32 and bfloat16 at every
head width it is built for; and the sim backend's exchange on a side CUDA
stream. Needs a CUDA card and nvcc; skips without a card. Imports no JAX, so it runs on a machine with
only the port's dependencies:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

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
    live = gcn_spmm.live_lengths(streams["vals"])
    assert (live < streams["rows"].shape[1]).any()   # padding gets skipped
    dev = "cuda"
    st = {k: torch.from_numpy(v).to(dev) for k, v in streams.items()}
    sch = _schedules(streams, 300, 1000)
    parts = streams["rows"].shape[0]
    before = (gcn_spmm.spmm.launches, gcn_spmm.spmm_t.launches)
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
    assert (gcn_spmm.spmm.launches, gcn_spmm.spmm_t.launches) == (
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
    """Device tile streams, run pointers, live lengths and spmm schedules
    of random shards."""
    streams = _random_streams(rows, cols, nnz, parts)
    st = {k: torch.from_numpy(v).cuda() for k, v in streams.items()}
    st["row_ptr"] = torch.from_numpy(gcn_spmm.run_pointers(
        streams["rows"], -(-rows // 128))).cuda()
    st["col_ptr"] = torch.from_numpy(gcn_spmm.run_pointers(
        streams["t_out"], -(-cols // 128))).cuda()
    st["live"] = torch.from_numpy(gcn_spmm.live_lengths(streams["vals"])).cuda()
    st["t_live"] = torch.from_numpy(gcn_spmm.live_lengths(
        streams["vals"], streams["t_perm"])).cuda()
    st.update(_schedules(streams, rows, cols))
    return st


@pytest.mark.cuda
@pytest.mark.parametrize("fin,fout", [(128, 256), (256, 16), (120, 24),
                                      (512, 512)])
@pytest.mark.parametrize("relu,with_z", [(False, True), (True, False)])
def test_cuda_fused_kernel_matches_plain(fin, fout, relu, with_z):
    """spmm_fused against spmm_fused_plain on the card, f32, ragged rows
    and widths, with zero padding tiles past the live lengths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    st = _card_streams(300, 1000, 2000)
    parts = st["rows"].shape[0]
    h = torch.randn(parts, 1000, fin, device="cuda")
    w = torch.randn(2 * fin, fout, device="cuda") / fin ** 0.5
    b = torch.randn(fout, device="cuda")
    before = gcn_spmm.spmm_fused.launches
    # w[:fin] is the row slice a SAGE layer passes
    u, z = gcn_spmm.spmm_fused(st["row_ptr"], st["live"], st["rows"],
                               st["cols"], st["vals"], h, w[:fin], b, 300,
                               relu=relu, with_z=with_z)
    torch.cuda.synchronize()
    pu, pz = gcn_spmm.spmm_fused_plain(st["rows"], st["cols"], st["vals"], h,
                                       w[:fin], b, 300, relu=relu,
                                       with_z=with_z)
    assert gcn_spmm.spmm_fused.launches == before + 1
    gcn_spmm.assert_close_to_scale(u, pu)
    if with_z:
        gcn_spmm.assert_close_to_scale(z, pz)
    else:
        assert z is None


@pytest.mark.cuda
@pytest.mark.parametrize("fin,fout", [(256, 256), (256, 16), (120, 24),
                                      (512, 512)])
def test_cuda_fused_t_kernel_matches_plain(fin, fout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    st = _card_streams(300, 1000, 2000)
    parts = st["rows"].shape[0]
    du = torch.randn(parts, 300, fout, device="cuda")
    w = torch.randn(fin, fout, device="cuda") / fout ** 0.5
    before = gcn_spmm.spmm_fused_t.launches
    d = gcn_spmm.spmm_fused_t(st["col_ptr"], st["t_live"], st["t_out"],
                              st["t_in"], st["t_perm"], st["vals"], du, w,
                              1000)
    torch.cuda.synchronize()
    assert gcn_spmm.spmm_fused_t.launches == before + 1
    gcn_spmm.assert_close_to_scale(d, gcn_spmm.spmm_fused_t_plain(
        st["t_out"], st["t_in"], st["t_perm"], st["vals"], du, w, 1000))


@pytest.mark.cuda
def test_cuda_fused_wrappers_refuse_what_the_kernels_do_not_take():
    """float64, a non-contiguous (transposed) weight, F_in > 512."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    st = _card_streams(128, 256, 100, parts=1)
    fwd = (st["row_ptr"], st["live"], st["rows"], st["cols"], st["vals"])
    bwd = (st["col_ptr"], st["t_live"], st["t_out"], st["t_in"],
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
    with pytest.raises(ValueError, match="512"):
        gcn_spmm.spmm_fused(*fwd, torch.randn(1, 256, 520, device="cuda"),
                            torch.randn(520, 8, device="cuda"), b, 128)


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
            before = kern.launches
            got[phase] = kern(*args, x, rows, sp, phase, out=out)
            torch.cuda.synchronize()
            assert kern.launches == before + 1
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
        before = fa.flash_attention.launches
        got = fa.flash_attention(q, k, v, causal=causal, window=window,
                                 q_block=blk, kv_block=blk)
        torch.cuda.synchronize()
        assert fa.flash_attention.launches == before + 1
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
