"""The port's CUDA kernels against their plain PyTorch versions on the card
(float32, ragged row counts and feature widths). Needs a CUDA card and
nvcc; skips without a card. Imports no JAX, so it runs on a machine with
only the port's dependencies:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
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


@pytest.mark.cuda
@pytest.mark.parametrize("f", [128, 256, 16])
def test_cuda_kernels_match_plain(f):
    """The CUDA kernels against their plain versions on the card, f32, at a
    ragged row count: run with a card (see README)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    streams = _random_streams(300, 1000, 2000)
    dev = "cuda"
    st = {k: torch.from_numpy(v).to(dev) for k, v in streams.items()}
    rp = torch.from_numpy(gcn_spmm.run_pointers(streams["rows"], 3)).to(dev)
    cp = torch.from_numpy(gcn_spmm.run_pointers(streams["t_out"], 8)).to(dev)
    live = gcn_spmm.live_lengths(streams["vals"])
    t_live = gcn_spmm.live_lengths(streams["vals"], streams["t_perm"])
    assert (live < streams["rows"].shape[1]).any()   # padding gets skipped
    live, t_live = torch.from_numpy(live).to(dev), torch.from_numpy(t_live).to(dev)
    parts = streams["rows"].shape[0]
    before = (gcn_spmm.spmm.launches, gcn_spmm.spmm_t.launches)
    h = torch.randn(parts, 1000, f, device=dev)
    dz = torch.randn(parts, 300, f, device=dev)
    z = gcn_spmm.spmm(rp, live, st["rows"], st["cols"], st["vals"], h, 300)
    d = gcn_spmm.spmm_t(cp, t_live, st["t_out"], st["t_in"], st["t_perm"],
                        st["vals"], dz, 1000)
    torch.testing.assert_close(
        z, gcn_spmm.spmm_plain(st["rows"], st["cols"], st["vals"], h, 300),
        rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        d, gcn_spmm.spmm_t_plain(st["t_out"], st["t_in"], st["t_perm"],
                                 st["vals"], dz, 1000),
        rtol=1e-5, atol=1e-5)
    assert (gcn_spmm.spmm.launches, gcn_spmm.spmm_t.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_cuda_wrapper_refuses_float64():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    streams = _random_streams(128, 256, 100, parts=1)
    st = {k: torch.from_numpy(v).cuda() for k, v in streams.items()}
    rp = torch.from_numpy(gcn_spmm.run_pointers(streams["rows"], 1)).cuda()
    live = torch.from_numpy(gcn_spmm.live_lengths(streams["vals"])).cuda()
    h = torch.randn(1, 256, 8, device="cuda", dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        gcn_spmm.spmm(rp, live, st["rows"], st["cols"], st["vals"], h, 128)
