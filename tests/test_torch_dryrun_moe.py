"""The MoE archs' dry-run collectives against the JAX package's (ROADMAP F5).

DTensor's own layouts made the port's MoE rows 3–15× JAX's: the combine's
``y[gi, top_i, at]`` gathered the expert outputs, sharded on the expert
dim over 'model', whole on every rank. `shardctx.take` now reads such a
dim as a partial sum (each rank the entries of its own experts), so the
combine's weighted sum over the k choices stays a partial sum and one
reduction of the (tokens, d_model) output remains, as GSPMD lowers JAX's
scatter-add. In one subprocess (a fake process group of 256 ranks, the
16×16 mesh, abstract):

- at reduced widths (32 experts, two per 'model' shard), `apply_moe` with
  capacity routing under autograd and dropless without: no all-gather
  over 'model' as large as one rank's share of the expert outputs, and
  the output a partial sum over 'model' whose reduction is one
  all-reduce of this rank's (tokens, d_model) rows;
- granite-moe-1b-a400m prefill_32k at full size: at most 4× JAX's
  collective bytes and at least one all-reduce of its (tokens, d_model)
  output per MoE layer (`check_against_jax`: JAX's rows are data,
  tests/_dryrun_jax_rows.py), its argument bytes JAX's, and JAX's
  artifact gates. The train combos and
  deepseek-v2 (whose prefill this torch cannot run: its DTensor refuses
  the blockwise attention's view on a length-sharded query) are held on
  the card (tests/test_torch_cuda.py ``-k dryrun_sweep``, chip_smoke
  phase "dryrun").
"""
import json
import os
import subprocess
import sys

import _torch_threads  # noqa: F401
from _dryrun_jax_rows import ARGUMENT_BYTES, F5, check_against_jax
from repro_torch.launch.dryrun import check_row

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TIMEOUT_S = 240

MOE = """
import json, traceback
import torch
from repro_torch.analysis.cost import _MetaGenerator
from repro_torch.configs import get_arch
from repro_torch.core.trace_utils import CollectiveCounter
from repro_torch.launch.dryrun import dryrun_one
from repro_torch.launch.mesh import fake_process_group, make_production_mesh
from repro_torch.launch.specs import batch_axes, sharded, with_sharding
from repro_torch.models import moe
from repro_torch.models.shardctx import P, dtensor_ops, reduce_partial

class Log(CollectiveCounter):
    # every collective as (kind, mesh dim, bytes, innermost moe.py line)
    def __init__(self, groups):
        super().__init__()
        self.groups, self.log = groups, []
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = dict(self.bytes)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        for kind, n in self.bytes.items():
            if n != before[kind]:
                dim = next((d for d, g in self.groups.items() if g in args),
                           None)
                line = next((f.name for f in reversed(traceback.extract_stack())
                             if f.filename.endswith("moe.py")), None)
                self.log.append((kind, dim, n - before[kind], line))
        return out

B, S = 32, 64
cfg = get_arch("granite-moe-1b-a400m").reduced(
    num_experts=32, experts_per_tok=8, dtype="bfloat16")
out = {}
with fake_process_group(256):
    mesh = make_production_mesh(device_type="cpu")
    groups = {d: mesh.get_group(d).group_name for d in mesh.mesh_dim_names}
    shapes = moe.init_moe(_MetaGenerator(), cfg, torch.bfloat16)
    params = with_sharding(shapes, moe.moe_spec(cfg), mesh, "meta")
    for dropless in (False, True):
        x = sharded((B, S, cfg.d_model), torch.bfloat16,
                    P(batch_axes(mesh), None, None), mesh, "meta")
        grad = not dropless
        with torch.set_grad_enabled(grad), dtensor_ops():
            x.requires_grad_(grad)
            with Log(groups) as fwd:
                y, _ = moe.apply_moe(params, cfg, x, dropless=dropless)
            placements = [str(p) for p in y.placements]
            with Log(groups) as red:
                y = reduce_partial(y)
            bwd = Log(groups)
            if grad:
                with bwd:
                    y.float().sum().backward()
        t = B * S
        cap = moe.capacity(cfg, t, dropless)
        out[str(dropless)] = dict(
            log=fwd.log + bwd.log, reduce=red.log, placements=placements,
            local_out=t // 16 * cfg.d_model * 2,
            expert_share=cfg.num_experts * cap * cfg.d_model * 2 // 16)
out["row"] = dryrun_one("granite-moe-1b-a400m", "prefill_32k", device="meta")
print(json.dumps(out))
"""


def test_moe_collectives():
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", MOE], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for dropless in ("False", "True"):
        r = out[dropless]
        # the expert outputs keep their expert dim sharded over 'model':
        # no gather there of anything their size (the indices it gathers
        # are a hundredth of it)
        big = [c for c in r["log"] if c[0] == "all-gather"
               and c[1] == "model" and c[2] >= r["expert_share"]]
        assert not big, (dropless, big)
        assert any(c[3] == "_combine" for c in r["log"]), r["log"]
        # the output: partial sums over 'model', reduced once, this rank's
        # (tokens / 16, d_model) rows
        assert r["placements"] == ["S(0)", "P(sum)"], r
        assert r["reduce"] == [["all-reduce", "model", r["local_out"],
                                None]], r["reduce"]
    row = out["row"]
    check_row(row, 256)
    key = (row["arch"], row["shape"])
    # at most 4x JAX's collective bytes (an F5 row), at least one
    # all-reduce of the (tokens, d_model) output per MoE layer
    assert key + ("16x16",) in F5
    check_against_jax([row], "16x16")
    assert row["argument_size_in_bytes"] == ARGUMENT_BYTES["16x16"][key]
    assert row["bytes_per_device"] >= row["argument_size_in_bytes"] > 0
