"""The port's boundary wire codecs against the JAX package's, on the CPU.

- The encoded wire of every format (f32, bf16, int8, int4) equals the JAX
  wire byte for byte, and its decode equals JAX's bitwise, in f32 and f64,
  at widths from 0 to 512 with all-zero rows and all-zero scale blocks.
- `byteify` / `unbyteify` give the JAX bytes and round-trip; a mixed
  bf16 + uint8 pack through the sim backend equals the per-layer exchange.
- The wire pricing (`wire_bytes_per_row`, `choose_wire_formats`) equals
  JAX's.
- The bytes one train step hands the exchange (`step_wire_bytes`) equal
  the JAX package's traced all_to_all bytes on the tiny pipeline for every
  codec configuration of its own byte test, and on reddit-sim P = 4 the
  figures recorded in benchmarks/baselines/BENCH_8.json.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

jax.config.update("jax_enable_x64", True)

from repro.analysis import cost as jcost  # noqa: E402
from repro.core import codec as jcodec  # noqa: E402
from repro.core.config import ModelConfig as JModelConfig  # noqa: E402
from repro.core.config import PipeConfig as JPipeConfig  # noqa: E402
from repro.core.pipegcn import PipeGCN as JPipeGCN  # noqa: E402
from repro.core.trace_utils import traced_step_wire_bytes  # noqa: E402
from repro.data import GraphDataPipeline as JPipeline  # noqa: E402
from repro.launch.mesh import make_partition_mesh  # noqa: E402
from repro_torch.analysis import cost  # noqa: E402
from repro_torch.core import codec  # noqa: E402
from repro_torch.core import ModelConfig, PipeConfig, PipeGCN  # noqa: E402
from repro_torch.core.pipegcn import SimBackend  # noqa: E402
from repro_torch.core.trace_utils import (RecordingBackend,  # noqa: E402
                                          step_wire_bytes)
from repro_torch.data import GraphDataPipeline  # noqa: E402
from repro_torch.graph.synthetic import model_template  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
P = 4
WIDTHS = (1, 3, 4, 16, 120, 127, 128, 129, 256, 512)
DTYPES = {"f32": (np.float32, torch.float32),
          "f64": (np.float64, torch.float64)}


def _payload(f: int, dtype, seed: int = 0):
    """(2, 3, 6, f) payload with an all-zero row, an all-zero leading
    scale block in every row of one partition, and rows of very different
    magnitudes."""
    rng = np.random.default_rng(seed + f)
    x = rng.standard_normal((2, 3, 6, f))
    x *= 10.0 ** rng.integers(-4, 3, size=(2, 3, 6, 1))
    x[0, 1, 2] = 0.0
    x[1, :, :, :min(f, 8)] = 0.0
    return x.astype(dtype)


def _bytes(a):
    """The raw bytes of a numpy array (bf16 included), flat."""
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _tbytes(t):
    """The raw bytes of a tensor (bf16 included), flat."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


CODEC_CASES = ([(w, f, dt, 128) for w in jcodec.WIRE_FORMATS
                for f in WIDTHS for dt in DTYPES]
               + [(w, f, "f32", 8) for w in ("int8", "int4")
                  for f in (3, 16, 129)]
               + [(w, 0, "f32", 128) for w in jcodec.WIRE_FORMATS])


@pytest.mark.parametrize("wire,f,dtype,block", CODEC_CASES)
def test_codec_matches_jax_bytes(wire, f, dtype, block):
    """encode gives the JAX wire's bytes (and dtype and shape), decode
    gives JAX's payload bitwise, and the widths agree with the pricing."""
    npd, td = DTYPES[dtype]
    x = _payload(f, npd)
    jc, tc = jcodec.make_codec(wire, block), codec.make_codec(wire, block)
    # eager, not jitted: compiled, XLA turns amax / qmax into amax times
    # the f32 reciprocal of qmax, one ulp off the spec's scale in some
    # blocks (docs/wire-format.md §2.1 and the eager JAX codec divide)
    jwire = jc.encode(jnp.asarray(x))
    twire = tc.encode(torch.from_numpy(x))
    assert twire.shape == jwire.shape == x.shape[:-1] + (tc.wire_width(f),)
    assert str(twire.dtype).split(".")[-1] == str(jwire.dtype)
    np.testing.assert_array_equal(_tbytes(twire), _bytes(np.asarray(jwire)))
    jdec = np.asarray(jax.jit(lambda w: jc.decode(w, f, npd))(jwire))
    tdec = tc.decode(twire, f, td)
    assert tdec.dtype == td
    np.testing.assert_array_equal(_tbytes(tdec), _bytes(jdec))
    assert tc.wire_bytes(f) == jc.wire_bytes(f)
    if wire != "f32" or dtype == "f32":
        assert tc.wire_width(f) * twire.element_size() == \
            cost.wire_bytes_per_row(wire, f, block)
    if wire in ("int8", "int4") and f:
        # zeros round-trip exactly; the error is at most half a step
        assert not tdec[0, 1, 2].any()
        amax = np.abs(x).reshape(-1, f).max(-1)
        err = np.abs(tdec.numpy() - x).reshape(-1, f).max(-1)
        assert (err <= amax / (2 * tc.qmax) + 1e-6 * amax).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.uint8])
def test_byteify_matches_jax_and_round_trips(dtype):
    rng = np.random.default_rng(3)
    src = rng.uniform(0.0, 200.0, (2, 4, 5, 7))
    t = torch.from_numpy(src).to(dtype)
    jdt = {torch.float32: jnp.float32, torch.float64: jnp.float64,
           torch.bfloat16: jnp.bfloat16, torch.uint8: jnp.uint8}[dtype]
    j = jnp.asarray(src).astype(jdt) if dtype != torch.uint8 else \
        jnp.asarray(t.numpy())
    tb, tit, tdt = codec.byteify(t)
    jb, jit_, _ = jcodec.byteify(j)
    assert (tit, tdt) == (jit_, dtype) and tb.dtype == torch.uint8
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    # a column slice of a packed byte buffer is misaligned: still exact
    packed = torch.cat([torch.zeros(2, 4, 5, 3, dtype=torch.uint8), tb], -1)
    back = codec.unbyteify(packed[..., 3:], tit, tdt)
    assert back.dtype == dtype and torch.equal(back, t)


def test_mixed_plan_pack_equals_per_layer():
    """A mixed bf16 + uint8 plan (wire="auto" on a 4-wide payload beside
    16-wide ones) byte-planarizes into one uint8 exchange, started or
    blocking, and lands bitwise what per-layer exchanges land."""
    rng = np.random.default_rng(5)
    codecs = [codec.make_codec(w) for w in
              cost.choose_wire_formats([16, 16, 4])]
    assert [c.name for c in codecs] == ["int8", "int8", "bf16"]
    wires = [c.encode(torch.from_numpy(rng.standard_normal((P, P, 3, f))))
             for c, f in zip(codecs, (16, 16, 4))]
    rec = RecordingBackend(SimBackend())
    per_layer = [rec.exchange(w) for w in wires]
    rec.events.clear()
    rec.wire_bytes = 0
    packed = codec.fused_exchange_encoded(rec, wires)
    started = codec.start_fused_exchange_encoded(rec, wires).wait()
    assert rec.events == ["exchange", "exchange_start", "exchange_wait"]
    assert rec.wire_bytes == 2 * sum(w.numel() * w.element_size()
                                     for w in wires)
    for a, b, c in zip(per_layer, packed, started):
        assert a.dtype == b.dtype == c.dtype
        assert torch.equal(a, b) and torch.equal(a, c)
    # a homogeneous plan keeps its dtype in the pack
    same = [wires[0], wires[1]]
    assert all(r.dtype == torch.uint8
               for r in codec.fused_exchange_encoded(rec, same))


def test_wire_pricing_matches_jax():
    for wire in jcodec.WIRE_FORMATS:
        for f in range(0, 300, 7):
            for block in (1, 8, 64, 128, 256):
                assert cost.wire_bytes_per_row(wire, f, block) == \
                    jcost.wire_bytes_per_row(wire, f, block)
    for block in (8, 128):
        widths = list(range(0, 70)) + [120, 127, 128, 129, 256, 512]
        assert cost.choose_wire_formats(widths, block=block) == \
            jcost.choose_wire_formats(widths, block=block)
        assert cost.choose_wire_formats(
            widths, ("int4", "bf16", "int8"), block) == \
            jcost.choose_wire_formats(widths, ("int4", "bf16", "int8"), block)
    assert cost.DEFAULT_FLOPS_PER_WIRE_BYTE == \
        jcost.DEFAULT_FLOPS_PER_WIRE_BYTE
    with pytest.raises(ValueError):
        codec.make_codec("fp8")


@pytest.fixture(scope="module")
def tiny():
    return (JPipeline.build("tiny", num_parts=P, kind="sage"),
            GraphDataPipeline.build("tiny", P, kind="sage", device="cpu"))


def _models(ds, pipe_kw):
    pipe_kw = dict(pipe_kw)
    cfg = dict(kind="sage", feat_dim=ds.feat_dim, hidden=16, num_layers=3,
               num_classes=ds.num_classes, dropout=0.0,
               matmul_order=pipe_kw.pop("matmul_order", "aggregate-first"))
    jpc = dataclasses.replace(JPipeConfig.named("pipegcn"),
                              fuse_exchange=True, **pipe_kw)
    tpc = dataclasses.replace(PipeConfig.named("pipegcn"),
                              fuse_exchange=True, **pipe_kw)
    return JPipeGCN(JModelConfig(**cfg), jpc), PipeGCN(ModelConfig(**cfg),
                                                       tpc)


# every configuration of the JAX package's test_traced_wire_bytes_match_formula
# (plus its f32 baseline)
BYTE_CASES = [
    {},
    {"wire": "bf16"},
    {"wire": "int8"},
    {"wire": "int4"},
    {"wire": "int8", "wire_block": 8},
    {"wire": "auto"},
    {"wire": "int8", "slice_boundary": True,
     "matmul_order": "transform-first", "overlap": "none"},
]


@pytest.mark.parametrize("pipe_kw", BYTE_CASES)
def test_step_wire_bytes_match_jax_traced_bytes(tiny, pipe_kw):
    jp, tp = tiny
    jmodel, tmodel = _models(tp.dataset, pipe_kw)
    mesh = make_partition_mesh(P, parts_per_device=P)
    want = traced_step_wire_bytes(jmodel, mesh, jp.topo, jp.train_data)
    assert step_wire_bytes(tmodel, tp.topo, tp.train_data) == want
    assert tmodel.payload_widths(tp.topo) == jmodel.payload_widths(jp.topo)


def test_reddit_sim_step_bytes_match_bench_8():
    """The bytes of one fused-exchange train step on reddit-sim P = 4 (the
    published model, GraphSAGE) under each wire equal the JAX package's
    recorded figures: 34,432 boundary rows × 6,656 / 3,328 / 1,716 / 884
    bytes."""
    with open(os.path.join(ROOT, "benchmarks", "baselines",
                           "BENCH_8.json")) as f:
        want = json.load(f)["meta"]["wire_bytes"]
    pipe = GraphDataPipeline.build("reddit-sim", P, kind="sage",
                                   device="cpu")
    tpl = model_template("reddit-sim")
    mc = ModelConfig(kind="sage", feat_dim=pipe.dataset.feat_dim,
                     hidden=tpl["hidden"], num_layers=tpl["num_layers"],
                     num_classes=pipe.dataset.num_classes, dropout=0.0)
    for wire in ("f32", "bf16", "int8", "int4"):
        model = PipeGCN(mc, dataclasses.replace(
            PipeConfig.named("pipegcn"), fuse_exchange=True, wire=wire))
        got = step_wire_bytes(model, pipe.topo, pipe.train_data)
        assert got == want[wire]["bytes"], (wire, got, want[wire])
