"""The port's production dry-run against the JAX package's, on the CPU.

- Spec parity: for all ten full configs, ``LM.param_specs()`` and
  ``cache_specs(True / False)`` equal JAX's ``PartitionSpec`` trees leaf
  for leaf (JAX's spec functions need no devices).
- Shard parity: one subprocess runs the JAX dry-run's argument builder
  standalone (512 forced host devices, ``eval_shape`` only) and prints the
  per-device shard shape of every leaf of the step's arguments for every
  mesh × arch × input shape × layout; a second prints rank 0's local
  shapes of the port's ``meta`` DTensors on fake process groups of 256
  and 512 ranks (tests/_dryrun_shards.py). They must be equal, and so must
  ``variant_for`` and ``_active_params``. The JAX side also lowers and
  compiles one combo, whose argument and collective bytes must equal JAX's
  rows as the port's tests have them (tests/_dryrun_jax_rows.py, data for
  the card, which has no JAX).
- The PipeGCN dry-run at reduced sizes on the production world sizes
  (fake groups, in a subprocess): boundary collectives equal
  ``expected_boundary_collectives`` (2 fused, 2L-1 per layer), the bytes
  handed to the exchange equal JAX's wire-byte formula, and the
  split-phase events place each exchange between two phase launches.
- ``dryrun_one`` abstract (``meta``) through its CLI, in a subprocess:
  its row passes JAX's artifact gates (`check_row`) and carries JAX's
  memory keys.

Every fake process group is started in a subprocess: one left in an xdist
worker would change the world size every later test there sees.
"""
import json
import os
import subprocess
import sys

import pytest
from jax.sharding import PartitionSpec
from torch.utils._pytree import tree_flatten_with_path

import _dryrun_shards
import _torch_threads  # noqa: F401
from _dryrun_jax_rows import ARGUMENT_BYTES, COLLECTIVE_BYTES
from repro.configs import ARCH_IDS
from repro.configs import get_arch as jax_arch
from repro.models.model import LM as JaxLM
from repro_torch.configs import get_arch
from repro_torch.launch.dryrun import check_row
from repro_torch.models.model import LM
from repro_torch.models.shardctx import (NamedSharding, P, constrain,
                                         placements, sharding_rules)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TIMEOUT_S = 240


def _env(jax: bool) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    if jax:
        env["JAX_PLATFORMS"] = "cpu"
    return env


def _key(path) -> tuple:
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


def _jax_specs(tree) -> dict:
    import jax
    return {_key(p): tuple(s) for p, s in jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]}


def _port_specs(tree) -> dict:
    return {_key(p): tuple(s) for p, s in tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_trees_equal_jax(arch):
    jlm, lm = JaxLM(jax_arch(arch)), LM(get_arch(arch))
    assert _port_specs(lm.param_specs()) == _jax_specs(jlm.param_specs())
    for shard_kv in (True, False):
        assert (_port_specs(lm.cache_specs(shard_kv))
                == _jax_specs(jlm.cache_specs(shard_kv)))


def test_shard_shapes_equal_jax():
    script = os.path.join(HERE, "_dryrun_shards.py")
    procs = {side: subprocess.Popen(
        [sys.executable, script, side], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_env(side == "jax"), cwd=HERE)
        for side in ("jax", "torch")}
    out = {}
    for side, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=TIMEOUT_S)
        assert proc.returncode == 0, stderr[-4000:]
        out[side] = json.loads(stdout.strip().splitlines()[-1])
    jax_out, port = out["jax"], out["torch"]
    key = _dryrun_shards.JAX_ROW
    assert jax_out.pop("jax_row") == {
        "argument_size_in_bytes": ARGUMENT_BYTES["16x16"][key],
        "collective_total_bytes": COLLECTIVE_BYTES["16x16"][key]}
    # 2 meshes × 10 archs × 4 shapes × (default, fsdp; opt for 2 MoE archs)
    assert sum(k[0] in "01" for k in jax_out) == 2 * 4 * (10 * 2 + 2)
    assert port.keys() == jax_out.keys()
    bad = [k for k in jax_out if port[k] != jax_out[k]]
    assert not bad, [(k, jax_out[k], port[k]) for k in bad[:3]]
    leaves = sum(len(v) for v in jax_out.values() if isinstance(v, dict))
    assert leaves > 10_000


class _Mesh:
    """A mesh's dim names: all `placements` reads."""

    def __init__(self, *names):
        self.mesh_dim_names = names


def test_spec_placements():
    from torch.distributed.tensor import Replicate, Shard
    m2, m3 = _Mesh("data", "model"), _Mesh("pod", "data", "model")
    assert placements(P(None, "model"), m2) == (Replicate(), Shard(1))
    assert placements(P("data", None, "model"), m2) == (Shard(0), Shard(2))
    assert placements(P(), m2) == (Replicate(), Replicate())
    assert placements(P(("pod", "data"), None, "model"), m3) == (
        Shard(0), Shard(0), Shard(2))
    assert placements(P(("data", "model")), m2) == (Shard(0), Shard(0))
    with pytest.raises(ValueError, match="order"):
        placements(P(("model", "data")), m2)
    with pytest.raises(ValueError, match="twice"):
        placements(P("model", "model"), m2)
    assert repr(P(None, "model")) == "P(None, 'model')"
    assert P("data", None) == ("data", None)


def test_rules_accepted_and_plain_tensors_pass():
    import torch
    x = torch.ones(2, 3)
    rules = {"residual": NamedSharding(_Mesh("data", "model"),
                                       P("data", None))}
    with sharding_rules(rules):
        assert constrain(x, "residual") is x
        assert constrain(x, "logits") is x
    assert constrain(x, "residual") is x


PIPEGCN = """
import json, sys
from repro_torch.core.trace_utils import expected_split_events
from repro_torch.launch.dryrun_pipegcn import dryrun_pipegcn
sizes = dict(max_inner=768, slot=4, max_nnz=6144, feat_dim=24, hidden=16,
             num_layers=3, num_classes=5)
out = []
for mp, kw in [(False, {}), (False, dict(fuse=False)),
               (False, dict(variant="vanilla")),
               (False, dict(overlap="split-phase")),
               (False, dict(compress=True)),
               (True, dict(fuse=False, overlap="split-phase")),
               (True, dict(device="meta"))]:
    r = dryrun_pipegcn(mp, sizes=sizes, device=kw.pop("device", "cpu"), **kw)
    ev = None
    if "overlap_events" in r:
        ev = ["all_to_all" if e == "exchange_start" else "scatter-add"
              for e in expected_split_events(3, r["fuse_exchange"] and
                                             r["arch"] != "pipegcn-vanilla")
              if e != "exchange_wait"]
    out.append(dict(r, expected_events=ev, kw=kw))
print(json.dumps(out))
"""


def _jax_wire_bytes(sizes, chips, compress) -> int:
    """The JAX dry-run's intended wire bytes (dryrun_pipegcn.py:162-169)."""
    dims = [sizes["feat_dim"]] + [sizes["hidden"]] * (sizes["num_layers"] - 1)
    slots = chips * sizes["slot"]
    return int(slots * (sum(dims) + sum(dims[1:])) * (2 if compress else 4))


def test_pipegcn_dryrun_collectives_and_wire_bytes():
    proc = subprocess.run([sys.executable, "-c", PIPEGCN],
                          capture_output=True, text=True, env=_env(False),
                          cwd=ROOT, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    runs = json.loads(proc.stdout.strip().splitlines()[-1])
    expect = [2, 5, 5, 2, 2, 5, 2]     # fused 2, per-layer / vanilla 2L-1
    assert [r["boundary_collectives_per_step"] for r in runs] == expect
    for r in runs:
        assert r["boundary_collectives_expected"] == \
            r["boundary_collectives_per_step"]
        assert r["chips"] == (512 if r["multi_pod"] else 256)
        # the exchanges the counter saw are the recorded ones
        assert (r["collective_counts_per_device"]["all-to-all"]
                == r["boundary_collectives_per_step"])
        wire = _jax_wire_bytes(r["sizes"], r["chips"], r["compress"])
        assert r["boundary_wire_bytes"] == wire
        assert r["recorded_wire_bytes"] == wire
        assert r["bottleneck"] in ("compute", "memory", "collective")
        if r["expected_events"] is not None:
            assert r["overlap_events"] == r["expected_events"]
            rows = r["overlap_phase_rows"]
            assert rows["fwd_boundary_rows"] + rows["fwd_interior_rows"] \
                == r["sizes"]["max_inner"]
    assert [("overlap_events" in r) for r in runs] == [
        False, False, False, True, False, True, False]


def test_dryrun_cli_abstract(tmp_path):
    out = tmp_path / "dry.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-8b", "--shape", "long_500k", "--device", "meta", "--out",
         str(out)], capture_output=True, text=True, env=_env(False),
        cwd=ROOT, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "[dryrun OK ]" in proc.stdout
    (r,) = json.loads(out.read_text())
    assert (r["arch"], r["shape"], r["mode"], r["variant"], r["mesh"],
            r["chips"], r["device"]) == ("qwen3-8b", "long_500k", "decode",
                                         "sw4096", "16x16", 256, "meta")
    assert r["while_mult"] == 1
    assert r["collective_total_bytes"] == sum(
        r["collective_bytes_per_device"].values()) > 0
    assert sum(r["collective_counts_per_device"].values()) > 0
    assert r["argument_size_in_bytes"] > 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert "step_ms" not in r and "peak_bytes" not in r
    # JAX's artifact gates, and its memory keys: arguments + temporaries
    check_row(r, 256)
    assert r["unused_argument_leaves"] == 0
    assert r["bytes_per_device"] == (r["argument_size_in_bytes"]
                                     + r["temp_size_in_bytes"])
    assert r["temp_size_in_bytes"] > 0
