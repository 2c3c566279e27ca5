"""The port's training step + Adam against the JAX package's jitted step,
the health guard's rollback, and the command line on the CPU."""
import ast
import json
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from repro.core.config import ModelConfig as JModelConfig  # noqa: E402
from repro.core.config import PipeConfig as JPipeConfig  # noqa: E402
from repro.core.health import HealthConfig as JHealthConfig  # noqa: E402
from repro.core.pipegcn import PipeGCN as JPipeGCN  # noqa: E402
from repro.core.trainer import make_jitted_train_step  # noqa: E402
from repro.data import GraphDataPipeline as JPipeline  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch.core import (HealthConfig, ModelConfig, PipeConfig,  # noqa: E402
                              PipeGCN, make_train_step, params_from_jax,
                              train_pipegcn)
from repro_torch.data import GraphDataPipeline  # noqa: E402
from repro_torch.launch.train import UNPORTED, main, parser  # noqa: E402
from repro_torch.optim import adam  # noqa: E402


@pytest.mark.parametrize("agg", ["coo", "blocksparse"])
@pytest.mark.parametrize("guarded", [False, True])
def test_adam_steps_match_jax(agg, guarded):
    """5 steps of PipeGCN + Adam from the same float64 parameters: Adam's
    moments and update are float32 in both packages, so the parameters
    and the losses agree to 1e-6 (one f32 rounding of the update)."""
    jp = JPipeline.build("tiny", 4, kind="sage", agg=agg)
    tp = GraphDataPipeline.build("tiny", 4, kind="sage", agg=agg, device="cpu")
    ds = tp.dataset
    cfg = dict(kind="sage", feat_dim=ds.feat_dim, hidden=32, num_layers=2,
               num_classes=ds.num_classes, dropout=0.0, agg=agg,
               matmul_order="auto")
    jmodel = JPipeGCN(JModelConfig(**cfg), JPipeConfig.named("pipegcn"))
    tmodel = PipeGCN(ModelConfig(**cfg), PipeConfig.named("pipegcn"))
    jtopo = jax.tree.map(
        lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x,
        jp.topo)
    jdata = jp.train_data._replace(x=jp.train_data.x.astype(jnp.float64))
    ttopo = tp.topo.to(torch.float64)
    tdata = tp.train_data._replace(x=tp.train_data.x.to(torch.float64))
    jparams = jmodel.init_params(jax.random.PRNGKey(3), dtype=jnp.float64)
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                              "cpu")
    jopt, topt = jadam(0.01), adam(0.01)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    jbufs = jmodel.init_buffers(jtopo, dtype=jnp.float64)
    tbufs = tmodel.init_buffers(ttopo, dtype=torch.float64)
    jstep = make_jitted_train_step(jmodel, jopt,
                                   JHealthConfig() if guarded else None)
    tstep = make_train_step(tmodel, topt, HealthConfig() if guarded else None)
    for t in range(5):
        jout = jstep(jtopo, jparams, jstate, jbufs, jdata,
                     jax.random.PRNGKey(t))
        tout = tstep(ttopo, tparams, tstate, tbufs, tdata)
        jloss, jparams, jstate, jbufs = jout[:4]
        tloss, tparams, tstate, tbufs = tout[:4]
        if guarded:
            assert bool(jout[4]["ok"]) and bool(tout[4]["ok"])
        assert abs(float(jloss) - float(tloss)) < 1e-6, t
        for k in jparams:
            assert tparams[k].dtype == torch.float64
            np.testing.assert_allclose(tparams[k].numpy(),
                                       np.asarray(jparams[k]), rtol=0,
                                       atol=1e-6, err_msg=f"step {t} {k}")
    assert tstate.step == int(jstate.step) == 5


def test_health_guard_rolls_back_a_poisoned_step():
    tp = GraphDataPipeline.build("tiny", 2, device="cpu")
    ds = tp.dataset
    model = PipeGCN(ModelConfig(feat_dim=ds.feat_dim, hidden=8, num_layers=2,
                                num_classes=ds.num_classes, dropout=0.0),
                    PipeConfig.named("pipegcn"))
    params = model.init_params(torch.Generator().manual_seed(0))
    opt = adam(0.01)
    state = opt.init(params)
    bufs = model.init_buffers(tp.topo)
    x = tp.train_data.x.clone()
    x[0, 0, 0] = float("nan")
    step = make_train_step(model, opt, HealthConfig())
    loss, new_params, new_state, new_bufs, rep = step(
        tp.topo, params, state, bufs, tp.train_data._replace(x=x))
    assert not bool(rep["ok"]) and not math.isfinite(float(loss))
    for k in params:
        assert torch.equal(new_params[k], params[k])
    assert new_state.step == 0
    for a, b in zip(new_bufs["feat"] + new_bufs["grad"],
                    bufs["feat"] + bufs["grad"]):
        assert torch.equal(a, b)


def test_cli_trains_on_cpu(capsys):
    out = main(["--device", "cpu", "--dataset", "tiny", "--epochs", "3",
                "--agg", "blocksparse", "--eval-every", "1"])
    printed = capsys.readouterr().out
    final = json.loads(printed[printed.index("\n{") + 1:])
    assert set(final) == {"final", "epochs_per_sec"}
    vals = list(final["final"].values()) + [final["epochs_per_sec"]]
    assert all(math.isfinite(v) for v in vals) and final["epochs_per_sec"] > 0
    assert len(out["history"]["loss"]) == 3
    assert all(math.isfinite(v) for v in out["history"]["loss"])
    assert "matmul order (static FLOP model, agg=blocksparse)" in printed


def test_cli_trains_fused_on_cpu(capsys):
    """--agg fused runs on the CPU through the plain versions of the fused
    kernels and logs the fused engine's train and eval orders."""
    out = main(["--device", "cpu", "--dataset", "tiny", "--epochs", "2",
                "--agg", "fused", "--matmul-order", "aggregate-first",
                "--eval-every", "1"])
    printed = capsys.readouterr().out
    assert out["agg"] == "fused"
    assert len(out["history"]["loss"]) == 2
    assert all(math.isfinite(v) for v in out["history"]["loss"])
    assert "matmul order (forced, agg=fused): L0:PH.W" in printed
    assert "eval matmul order (forced, agg=fused)" in printed


def _jax_launcher_flags() -> dict:
    """Every flag of the JAX launcher (src/repro/launch/train.py) with its
    default, read from the text of its add_argument("--...") calls, so
    that JAX is not imported: store_true flags default to False."""
    text = (Path(__file__).resolve().parents[1] / "src" / "repro" / "launch"
            / "train.py").read_text()
    flags = {}
    for call in text.split("ap.add_argument(")[1:]:
        head = call.split("help=")[0]
        flag = re.match(r'"(--[\w-]+)"', head).group(1)
        default = re.search(r'default=("[^"]*"|[-\w.]+)', head)
        flags[flag] = (False if 'action="store_true"' in head
                       else ast.literal_eval(default.group(1)))
    return flags


# (flag, value or None for a store_true flag, ROADMAP Queue 1 item)
UNPORTED_CASES = [
    ("--wire", "bf16", 8), ("--slice-boundary", None, 8),
    ("--guard-exchange", None, 9), ("--max-staleness", "4", 9),
    ("--fault-rate", "0.1", 9), ("--fault-kind", "corrupt", 9),
    ("--fault-seed", "3", 9), ("--ckpt-dir", "ckpts", 9),
    ("--ckpt-every", "2", 9), ("--ckpt-keep", "2", 9), ("--resume", None, 9),
    ("--elastic", None, 10), ("--elastic-detect-after", "3", 10),
    ("--elastic-warm", "0", 10), ("--elastic-max-recoveries", "1", 10),
    ("--elastic-no-rejoin", None, 10),
    ("--workload", "lm", 12), ("--arch", "starcoder2-3b", 12),
    ("--reduced", None, 12), ("--steps", "10", 12), ("--batch", "2", 12),
    ("--seq", "64", 12),
]


def test_cli_parses_every_jax_launcher_flag():
    """The port's parser defines every flag of the JAX launcher with the
    same default; the flags it does not run are exactly UNPORTED_CASES."""
    flags = _jax_launcher_flags()
    assert len(flags) >= 41, sorted(flags)
    ap = parser()
    for flag, default in flags.items():
        dest = flag[2:].replace("-", "_")
        assert ap.get_default(dest) == default, (flag, default)
    unported = {"--" + d.replace("_", "-")
                for _, dests in UNPORTED.values() for d in dests}
    assert unported == {f for f, _, _ in UNPORTED_CASES}
    assert unported <= set(flags)


@pytest.mark.parametrize("flag,value,item", UNPORTED_CASES)
def test_cli_refuses_unported_flags(capsys, flag, value, item):
    """Each unported flag away from its default exits 2 with "not
    ported" and its own ROADMAP item."""
    with pytest.raises(SystemExit) as err:
        main(["--device", "cpu", "--dataset", "tiny", flag]
             + ([value] if value is not None else []))
    assert err.value.code == 2
    msg = capsys.readouterr().err
    assert "not ported" in msg and flag in msg
    assert f"ROADMAP Queue 1 item {item}:" in msg
    assert msg.count("item ") == 1


def test_cli_runs_a_jax_command_line_at_defaults(capsys):
    """Every JAX launcher flag given at its default parses, triggers no
    refusal, and trains (2 epochs of tiny on the CPU)."""
    argv = []
    for flag, default in _jax_launcher_flags().items():
        if default is not False and default is not None:
            argv += [flag, str(default)]
    out = main(argv + ["--device", "cpu", "--dataset", "tiny", "--epochs",
                       "2", "--eval-every", "1"])
    assert len(out["history"]["loss"]) == 2
    assert all(math.isfinite(v) for v in out["history"]["loss"])


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    tp = GraphDataPipeline.build("tiny", 2, device="cpu")
    ds = tp.dataset
    mc = ModelConfig(feat_dim=ds.feat_dim, hidden=8, num_layers=2,
                     num_classes=ds.num_classes, dropout=0.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_pipegcn(tp, mc, PipeConfig(), epochs=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--dataset", "tiny", "--epochs", "1"])
