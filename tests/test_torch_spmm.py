"""The port's block-sparse SpMM and aggregation engines against the JAX
package's, in float64 (the plain PyTorch versions on the CPU; the JAX
Pallas kernels in interpret mode). The CUDA kernels are held against
their plain versions on the card by tests/test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

jax.config.update("jax_enable_x64", True)

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.aggregate import get_engine as jget_engine  # noqa: E402
from repro.kernels.gcn_spmm import build_tile_topology as jbuild  # noqa: E402
from repro.kernels.gcn_spmm import pad_tile_topology as jpad  # noqa: E402
from repro_torch import spans  # noqa: E402
from repro_torch.kernels import gcn_spmm  # noqa: E402
from repro_torch.kernels.aggregate import get_engine  # noqa: E402

TOL = 1e-12


def _random_shards(rows, cols, nnz, parts=3, seed=0):
    """Per-partition random COO (with duplicates and explicit zeros) and
    the JAX tile streams padded to a common length."""
    rng = np.random.default_rng(seed)
    coo, tts = [], []
    for _ in range(parts):
        r = rng.integers(0, rows, nnz)
        c = rng.integers(0, cols, nnz)
        v = rng.standard_normal(nnz).astype(np.float32)
        v[::17] = 0.0
        coo.append((r, c, v))
        tts.append(jbuild(r, c, v, rows, cols))
    n = max(t.n_tiles for t in tts)
    tts = [jpad(t, n) for t in tts]
    return coo, tts


def _stack(tts, field):
    return np.stack([getattr(t, field) for t in tts])


@pytest.mark.parametrize("rows,cols", [(256, 384), (200, 700), (131, 300)])
def test_tile_extraction_bitwise(rows, cols):
    coo, jtts = _random_shards(rows, cols, 900)
    for (r, c, v), jt in zip(coo, jtts):
        tt = gcn_spmm.pad_tile_topology(
            gcn_spmm.build_tile_topology(r, c, v, rows, cols), jt.n_tiles)
        for field in ("rows", "cols", "vals", "t_out", "t_in", "t_perm"):
            a, b = getattr(jt, field), getattr(tt, field)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field


@pytest.mark.parametrize("rows,cols,f", [(256, 384, 128), (200, 700, 20),
                                         (131, 300, 16)])
def test_plain_spmm_matches_jax_kernels(rows, cols, f):
    """Ragged feature widths (20, 16) and ragged row counts (200, 131 rows;
    700, 300 combined columns) against the JAX kernels on zero-padded
    inputs, per partition, in float64."""
    _, tts = _random_shards(rows, cols, 900)
    rng = np.random.default_rng(1)
    h = rng.standard_normal((len(tts), cols, f))
    dz = rng.standard_normal((len(tts), rows, f))
    nrb, ncb = -(-rows // 128), -(-cols // 128)
    fp = -(-f // 128) * 128
    st = {k: torch.from_numpy(_stack(tts, k))
          for k in ("rows", "cols", "vals", "t_out", "t_in", "t_perm")}
    z = gcn_spmm.spmm(None, None, st["rows"], st["cols"], st["vals"],
                      torch.from_numpy(h), rows)
    d = gcn_spmm.spmm_t(None, None, st["t_out"], st["t_in"], st["t_perm"],
                        st["vals"], torch.from_numpy(dz), cols)
    assert z.shape == (len(tts), rows, f) and d.shape == (len(tts), cols, f)
    for p, tt in enumerate(tts):
        vals = jnp.asarray(tt.vals, jnp.float64)
        hp = np.zeros((ncb * 128, fp))
        hp[:cols, :f] = h[p]
        jz = jops.spmm(tt.rows, tt.cols, vals, jnp.asarray(hp), nrb * 128)
        np.testing.assert_allclose(z[p].numpy(), np.asarray(jz)[:rows, :f],
                                   rtol=0, atol=TOL)
        dzp = np.zeros((nrb * 128, fp))
        dzp[:rows, :f] = dz[p]
        jd = jops.spmm_t(tt.t_out, tt.t_in, tt.t_perm, vals, jnp.asarray(dzp),
                         ncb * 128)
        np.testing.assert_allclose(d[p].numpy(), np.asarray(jd)[:cols, :f],
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize("direction", ["spmm", "spmm_t"])
def test_coo_engine_matches_jax(direction):
    rows, cols, f, nnz = 150, 420, 24, 1000
    rng = np.random.default_rng(2)
    parts = 3
    er = rng.integers(0, rows, (parts, nnz)).astype(np.int32)
    ec = rng.integers(0, cols, (parts, nnz)).astype(np.int32)
    ew = rng.standard_normal((parts, nnz)).astype(np.float32)
    ew[:, -50:] = 0.0                       # padded edges
    n_in = cols if direction == "spmm" else rows
    n_out = rows if direction == "spmm" else cols
    x = rng.standard_normal((parts, n_in, f))
    out = getattr(get_engine("coo"), direction)(
        (torch.from_numpy(er), torch.from_numpy(ec), torch.from_numpy(ew)),
        torch.from_numpy(x), n_out)
    jeng = jget_engine("coo")
    for p in range(parts):
        ref = getattr(jeng, direction)(
            (jnp.asarray(er[p]), jnp.asarray(ec[p]),
             jnp.asarray(ew[p], jnp.float64)), jnp.asarray(x[p]), n_out)
        np.testing.assert_allclose(out[p].numpy(), np.asarray(ref), rtol=0,
                                   atol=TOL)


def test_cpu_wrappers_use_plain_versions_and_count_no_launch():
    _, tts = _random_shards(256, 384, 500)
    st = {k: torch.from_numpy(_stack(tts, k))
          for k in ("rows", "cols", "vals", "t_out", "t_in", "t_perm")}
    before = (spans.counter("gcn_spmm.spmm"), spans.counter("gcn_spmm.spmm_t"))
    h = torch.randn(len(tts), 384, 32, dtype=torch.float32)
    z = gcn_spmm.spmm(None, None, st["rows"], st["cols"], st["vals"], h, 256)
    zp = gcn_spmm.spmm_plain(st["rows"], st["cols"], st["vals"], h, 256)
    assert torch.equal(z, zp)
    assert (spans.counter("gcn_spmm.spmm"), spans.counter("gcn_spmm.spmm_t")) == before
