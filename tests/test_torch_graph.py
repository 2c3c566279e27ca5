"""The port's numpy graph substrate builds the JAX package's arrays bit for
bit: datasets, partitions, padded shards, tile streams, and every Topology
and ShardedData tensor of the data pipeline. The run pointers the CUDA
kernels walk are consistent with the sorted streams they index."""
import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from repro.data import GraphDataPipeline as JPipeline  # noqa: E402
from repro.graph import make_dataset as jmake_dataset  # noqa: E402
from repro.graph import partition_graph as jpartition  # noqa: E402
from repro_torch.data import GraphDataPipeline  # noqa: E402
from repro_torch.graph import make_dataset, partition_graph  # noqa: E402
from repro_torch.kernels.gcn_spmm import TILE  # noqa: E402


def _bitwise(a, b, what):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("name", ["tiny", "grid-tiny", "small"])
def test_dataset_and_partition_bitwise(name):
    jd, td = jmake_dataset(name), make_dataset(name)
    for f in ("features", "labels", "train_mask", "val_mask", "test_mask"):
        _bitwise(getattr(jd, f), getattr(td, f), f)
    for f in ("indptr", "indices", "weights"):
        _bitwise(getattr(jd.graph, f), getattr(td.graph, f), f)
    _bitwise(jpartition(jd.graph, 4, seed=0), partition_graph(td.graph, 4, seed=0),
             "partition")


@pytest.mark.parametrize("dataset", ["tiny", "grid-tiny"])
@pytest.mark.parametrize("layout", ["natural", "rcm"])
def test_pipeline_arrays_bitwise(dataset, layout):
    jp = JPipeline.build(dataset, 4, kind="sage", agg="blocksparse",
                         layout=layout)
    tp = GraphDataPipeline.build(dataset, 4, kind="sage", agg="blocksparse",
                                 layout=layout, device="cpu")
    assert tp.layout == jp.layout == layout
    for f in jp.topo._fields:
        _bitwise(getattr(jp.topo, f), getattr(tp.topo, f), f"topo.{f}")
    for split in ("train_data", "val_data", "test_data"):
        for f in jp.train_data._fields:
            _bitwise(getattr(getattr(jp, split), f),
                     getattr(getattr(tp, split), f), f"{split}.{f}")
    for f in ("perm", "inv_perm", "part_of", "local_of", "halo_owner_mask"):
        _bitwise(getattr(jp.pg, f), getattr(tp.pg, f), f"pg.{f}")


@pytest.mark.parametrize("dataset", ["tiny", "grid-tiny"])
@pytest.mark.parametrize("layout", ["natural", "rcm"])
def test_run_pointers_index_the_streams(dataset, layout):
    tp = GraphDataPipeline.build(dataset, 4, agg="blocksparse", layout=layout,
                                 device="cpu")
    topo = tp.topo
    nrb = -(-topo.max_inner // TILE)
    ncb = -(-(topo.max_inner + topo.halo_size) // TILE)
    n = topo.tile_rows.shape[1]
    for ptr, stream, nb in ((topo.tile_row_ptr, topo.tile_rows, nrb),
                            (topo.tile_col_ptr, topo.tile_t_out, ncb)):
        ptr, stream = ptr.numpy(), stream.numpy()
        assert ptr.shape == (topo.num_parts, nb + 1) and ptr.dtype == np.int32
        assert (ptr[:, 0] == 0).all() and (ptr[:, -1] == n).all()
        assert (np.diff(ptr, axis=1) >= 1).all()    # ≥1 tile per output block
        for p in range(topo.num_parts):
            for b in range(nb):
                assert (stream[p, ptr[p, b]:ptr[p, b + 1]] == b).all()
    # live lengths: every nonzero tile lies before them, in both streams
    nonzero = topo.tile_vals.abs().amax(dim=(-1, -2)).numpy() > 0
    t_nonzero = np.take_along_axis(nonzero, topo.tile_t_perm.numpy().astype(np.int64), 1)
    for live, nz in ((topo.tile_live.numpy(), nonzero),
                     (topo.tile_t_live.numpy(), t_nonzero)):
        for p in range(topo.num_parts):
            assert nz[p, live[p] - 1] and not nz[p, live[p]:].any()


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GraphDataPipeline.build("tiny", 2)
