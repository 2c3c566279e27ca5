"""The port's training step + Adam against the JAX package's jitted step,
the health guard's rollback, and the command line on the CPU (the GCN
workload, and the LM workload's flags, result keys and checkpoint)."""
import ast
import dataclasses
import json
import math
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

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
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.train import main, parser, train_lm  # noqa: E402
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


# (argv, the boundary-wire log line): the wire codecs and feature slicing on
# grid-tiny P = 4 (a split exists there), a mixed auto plan among them
WIRE_CLI_CASES = [
    (["--wire", "int8", "--agg", "blocksparse"],
     "boundary wire: L0:int8x16 L1:int8x16"),
    (["--wire", "auto", "--slice-boundary", "--agg", "blocksparse"],
     "boundary wire: L0:int8x16 L1:bf16x4s (s = sliced to the "
     "post-transform width)"),
    (["--wire", "bf16", "--overlap", "split-phase", "--agg", "blocksparse"],
     "boundary wire: L0:bf16x16 L1:bf16x16"),
]


@pytest.mark.parametrize("argv,wire_line", WIRE_CLI_CASES)
def test_cli_trains_with_wire_codecs(capsys, argv, wire_line):
    """--wire and --slice-boundary train on the CPU, log the JAX trainer's
    boundary-wire line, and land in the final JSON as in the JAX
    launcher's."""
    out = main(["--device", "cpu", "--dataset", "grid-tiny", "--partitions",
                "4", "--epochs", "2", "--eval-every", "1"] + argv)
    printed = capsys.readouterr().out
    assert wire_line + "\n" in printed
    assert out["wire"] == argv[1]
    assert out["slice_boundary"] == ("--slice-boundary" in argv)
    assert len(out["history"]["loss"]) == 2
    assert all(math.isfinite(v) for v in out["history"]["loss"])
    if "split-phase" in argv:
        assert "overlap schedule: split-phase" in printed


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


def _jax_result_keys(runner: str = "run_gcn") -> set:
    """The keys of the dict the JAX launcher's `runner` (run_gcn or run_lm)
    returns, read from the text of its `out = {...}` literal, so that JAX
    is not imported."""
    text = (Path(__file__).resolve().parents[1] / "src" / "repro" / "launch"
            / "train.py").read_text()
    literal = text.split(f"def {runner}(")[1].split("out = {", 1)[1]
    return set(re.findall(r'"(\w+)":', literal.split("}", 1)[0]))


def test_cli_result_has_every_jax_result_key(capsys):
    """F3: the port's CLI result has every key of the JAX launcher's
    `run_gcn` result (split_feasible included), plus its own `device`."""
    keys = _jax_result_keys()
    assert {"split_feasible", "history", "final", "anomalies"} <= keys
    assert len(keys) >= 24, sorted(keys)
    for dataset, feasible in (("grid-tiny", True), ("tiny", False)):
        out = main(["--device", "cpu", "--dataset", dataset, "--epochs", "1",
                    "--agg", "blocksparse", "--eval-every", "1"])
        assert keys <= set(out), sorted(keys - set(out))
        assert set(out) - keys == {"device"}
        assert out["split_feasible"] is feasible
    capsys.readouterr()


def test_cli_parses_every_jax_launcher_flag():
    """The port's parser defines every flag of the JAX launcher with the
    same default, and refuses none of them: the refusal table is gone."""
    flags = _jax_launcher_flags()
    assert len(flags) >= 41, sorted(flags)
    ap = parser()
    for flag, default in flags.items():
        dest = flag[2:].replace("-", "_")
        assert ap.get_default(dest) == default, (flag, default)
    assert {"--workload", "--arch", "--reduced", "--steps", "--batch",
            "--seq"} <= set(flags)
    assert not hasattr(train_cli, "UNPORTED")
    assert not hasattr(train_cli, "unported_flags")


# The LM workload on the CPU: a GCN-side run on tiny and the reduced LM at
# a small batch, so each run takes well under a second
LM_BASE = ["--device", "cpu", "--dataset", "tiny", "--epochs", "1",
           "--eval-every", "1", "--workload", "lm", "--reduced", "--steps",
           "2", "--batch", "2", "--seq", "16"]


def _without(argv, flag, takes_value=True):
    i = argv.index(flag)
    return argv[:i] + argv[i + 1 + takes_value:]


def _lm_run(capsys, argv):
    out = main(argv)
    printed = capsys.readouterr().out
    steps = [line for line in printed.splitlines() if line.startswith("step")]
    return out, steps, printed


def _small_full(real):
    """A stand-in for an arch's full config that its reduced() still cuts
    (d_ff 320 → 256, vocabulary 600 → 512), so --reduced acts on the CPU."""
    def get_arch(arch):
        return dataclasses.replace(real(arch).reduced(), d_ff=320,
                                   vocab_size=600)
    return get_arch


# (flag, value or None for a store_true flag): each LM flag of the JAX
# launcher, run with and without it on top of LM_BASE
LM_FLAG_CASES = [("--workload", "lm"), ("--arch", "starcoder2-3b"),
                 ("--reduced", None), ("--steps", "3"), ("--batch", "3"),
                 ("--seq", "24")]


@pytest.mark.parametrize("flag,value", LM_FLAG_CASES)
def test_cli_lm_flags_act_as_in_jax(capsys, monkeypatch, flag, value):
    """Each LM flag changes the result or the printed step lines as the
    JAX launcher's does: --workload lm runs run_lm instead of run_gcn,
    --arch picks the model, --reduced cuts its config, --steps the step
    count (one "step" line each, as max(steps // 10, 1) = 1), --batch and
    --seq the TokenStream batches, and with them the losses."""
    if flag == "--reduced":
        monkeypatch.setattr(train_cli, "get_arch",
                            _small_full(train_cli.get_arch))
    if flag not in LM_BASE:
        with_argv, without_argv = LM_BASE + [flag, value], LM_BASE
    elif value is None or flag == "--workload":
        with_argv = LM_BASE
        without_argv = _without(LM_BASE, flag, value is not None)
    else:
        with_argv = _without(LM_BASE, flag) + [flag, value]
        without_argv = LM_BASE
    out, steps, _ = _lm_run(capsys, with_argv)
    base, base_steps, base_printed = _lm_run(capsys, without_argv)
    assert out["workload"] == "lm" and out["device"] == "cpu"
    assert all(math.isfinite(out[k]) for k in ("first_loss", "last_loss"))
    if flag == "--workload":
        assert base["workload"] == "gcn" and not base_steps
        assert "matmul order" in base_printed and len(steps) == 2
        return
    assert out["reduced"] is True
    assert base["reduced"] is (flag != "--reduced")
    if flag == "--arch":
        assert (out["arch"], base["arch"]) == ("starcoder2-3b", "qwen3-8b")
    if flag == "--steps":
        assert len(steps) == 3 and steps[:2] == base_steps
        assert out["first_loss"] == base["first_loss"]
        assert out["last_loss"] != base["last_loss"]
        return
    assert len(steps) == len(base_steps) == 2
    assert out["first_loss"] != base["first_loss"]


def test_cli_lm_result_has_every_jax_result_key(capsys):
    """The LM result has exactly the keys of the JAX launcher's `run_lm`
    result plus `device`, and prints it whole as JSON, as JAX does."""
    keys = _jax_result_keys("run_lm")
    assert keys == {"workload", "arch", "reduced", "first_loss", "last_loss",
                    "steps_per_sec"}
    out, steps, printed = _lm_run(capsys, LM_BASE)
    assert set(out) == keys | {"device"}
    assert json.loads(printed[printed.index("\n{") + 1:]) == out
    assert out["steps_per_sec"] > 0
    assert steps == [f"step {i:5d} loss {v:.4f}" for i, v in
                     ((0, out["first_loss"]), (1, out["last_loss"]))]


def test_cli_lm_ckpt_dir_saves_the_final_parameters(capsys, tmp_path):
    """--ckpt-dir saves the final parameters at step --steps, as JAX's
    run_lm does; they restore leaf for leaf, bit-equal to the same run
    through train_lm."""
    from repro_torch.checkpoint import latest_step, restore_checkpoint
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStream
    from repro_torch.models.model import LM
    from repro_torch.optim import adamw, linear_warmup_cosine
    ckpt = str(tmp_path / "lm")
    main(LM_BASE + ["--ckpt-dir", ckpt, "--seed", "2"])
    capsys.readouterr()
    assert latest_step(ckpt) == 2
    lm = LM(get_arch("qwen3-8b").reduced())
    params = lm.init_params(torch.Generator().manual_seed(2))
    _, want, _ = train_lm(lm, params, adamw(linear_warmup_cosine(
        3e-4, 10, 2), max_grad_norm=1.0), iter(TokenStream(
            lm.cfg.vocab_size, 16, 2, seed=2)), 2, log=None)
    got = restore_checkpoint(ckpt, None, want)
    leaves, want_leaves = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(leaves) == len(want_leaves) > 0
    for a, b in zip(leaves, want_leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)


# (flag, its value or None for a store_true flag, the flags it needs): the
# item 9 flags, each run on tiny with what makes it act
ITEM9_CASES = [
    ("--guard-exchange", None, []),
    ("--max-staleness", "4", ["--guard-exchange", "--fault-rate", "0.3"]),
    ("--fault-rate", "0.3", ["--guard-exchange"]),
    ("--fault-kind", "corrupt", ["--guard-exchange", "--fault-rate", "0.3"]),
    ("--fault-seed", "3", ["--guard-exchange", "--fault-rate", "0.3"]),
    ("--ckpt-dir", "CKPT", []),
    ("--ckpt-every", "1", ["--ckpt-dir", "CKPT"]),
    ("--ckpt-keep", "1", ["--ckpt-dir", "CKPT", "--ckpt-every", "1"]),
    ("--resume", None, ["--ckpt-dir", "CKPT"]),
]


@pytest.mark.parametrize("flag,value,extra", ITEM9_CASES)
def test_cli_runs_item9_flags(capsys, tmp_path, flag, value, extra):
    """Each fault-tolerance flag trains 2 epochs of tiny on the CPU and
    drives its field of the final JSON (or its checkpoint files)."""
    from repro_torch.checkpoint import latest_step
    from repro_torch.core.faults import FaultPlan
    from repro_torch.graph.synthetic import model_template
    ckpt = str(tmp_path / "ckpt")
    argv = [flag] + ([value] if value is not None else []) + extra
    argv = [ckpt if a == "CKPT" else a for a in argv]
    base = ["--device", "cpu", "--dataset", "tiny", "--epochs", "2",
            "--eval-every", "1"]
    if flag == "--resume":
        main(base[:-4] + ["--epochs", "1", "--ckpt-dir", ckpt,
                          "--ckpt-every", "1"])
        capsys.readouterr()
    out = main(base + argv)
    printed = capsys.readouterr().out
    assert all(math.isfinite(v) for v in out["history"]["loss"])
    assert out["guard_exchange"] == ("--guard-exchange" in argv)
    rate = float(argv[argv.index("--fault-rate") + 1]) \
        if "--fault-rate" in argv else 0.0
    assert out["fault_rate"] == rate
    assert not out["preempted"]
    if out["guard_exchange"]:
        assert out["anomalies"]["exchange_fallbacks"] >= (rate > 0)
    if rate:
        seed = int(value) if flag == "--fault-seed" else 0
        layers = model_template("tiny")["num_layers"]
        n = FaultPlan(rate=rate, seed=seed).compile(2, layers, 4).drop_np.sum()
        assert f"fault injection: {n} faulted exchange sites" in printed
    if flag == "--max-staleness":
        es = out["anomalies"]["max_effective_staleness"]
        assert f"es {es}/4" in printed and es <= 4
    if flag == "--fault-kind":
        assert out["anomalies"]["exchange_fallbacks"] > 0
    if flag == "--ckpt-dir":           # the params-only export
        assert latest_step(ckpt) == 2
    if flag == "--ckpt-every":
        assert sorted(os.listdir(ckpt)) == ["step_00000001",
                                            "step_00000002"]
    if flag == "--ckpt-keep":
        assert os.listdir(ckpt) == ["step_00000002"]
    if flag == "--resume":
        assert out["resumed_from"] == 1
        assert out["history"]["epoch"] == [1]
    else:
        assert out["resumed_from"] is None


# (flag, its value or None for a store_true flag, the ElasticConfig field
# it sets and the value it gets): the item 10 flags, and --parts-per-device
# without --spmd, which sets the sim backend's device size
ELASTIC_CASES = [
    ("--elastic", None, "enabled", True),
    ("--elastic-detect-after", "3", "detect_after", 3),
    ("--elastic-warm", "0", "warm_staleness", 0),
    ("--elastic-max-recoveries", "1", "max_recoveries", 1),
    ("--elastic-no-rejoin", None, "rejoin", False),
    ("--parts-per-device", "2", "parts_per_device", 2),
]


def _recording_trainer(monkeypatch, faults=None):
    """Wrap the launcher's train_pipegcn: record its keyword arguments and
    (when given) run it under the fault plan `faults`."""
    import repro_torch.launch.train as launcher
    seen = {}

    def train(*args, **kw):
        seen.update(kw)
        if faults is not None:
            kw["faults"] = faults
        return train_pipegcn(*args, **kw)

    monkeypatch.setattr(launcher, "train_pipegcn", train)
    return seen


@pytest.mark.parametrize("flag,value,field,want", ELASTIC_CASES)
def test_cli_runs_item10_flags(capsys, monkeypatch, tmp_path, flag, value,
                               field, want):
    """Each elastic flag trains 2 epochs of tiny on the CPU (with
    --elastic, --guard-exchange and checkpoints) and reaches the trainer's
    ElasticConfig with its value; the final JSON says "elastic": true and
    counts the recoveries."""
    seen = _recording_trainer(monkeypatch)
    argv = ["--device", "cpu", "--dataset", "tiny", "--epochs", "2",
            "--eval-every", "1", "--guard-exchange", "--elastic",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    if flag != "--elastic":
        argv += [flag] + ([value] if value is not None else [])
    out = main(argv)
    printed = capsys.readouterr().out
    ec = seen["elastic"]
    assert getattr(ec, field) == want
    assert seen["parts_per_device"] is None      # the sim backend
    assert out["elastic"] is True and out["recoveries"] == 0
    assert out["anomalies"]["device_losses"] == []
    assert '"elastic": true' in printed
    assert all(math.isfinite(v) for v in out["history"]["loss"])


def test_cli_elastic_drill_prints_the_jax_lines(capsys, monkeypatch,
                                                tmp_path):
    """The launcher under --elastic --guard-exchange --ckpt-every 4, with
    device 2 down for steps [5, 9) set through the API, recovers and
    rejoins, printing the JAX launcher's recovery and rejoin lines (the
    JAX trainer prints these two for this plan: tests/test_torch_elastic.py
    compares the trainers' lines)."""
    from repro_torch.core import FaultPlan, device_down_site
    _recording_trainer(monkeypatch, FaultPlan(sites=(device_down_site(
        step=5, device=2, until=9),)))
    out = main(["--device", "cpu", "--dataset", "tiny", "--partitions", "4",
                "--epochs", "12", "--eval-every", "4", "--guard-exchange",
                "--elastic", "--ckpt-every", "4", "--ckpt-dir",
                str(tmp_path)])
    printed = capsys.readouterr().out
    assert out["recoveries"] == 1 and out["anomalies"]["rejoins"] == 1
    assert [ln for ln in printed.splitlines()
            if ln.startswith(("device ", "rejoin:"))] == [
        "device 2 lost at epoch 6: remapped 4 partitions onto survivors "
        "[0, 1, 3] (2/device, 2 pad), restored checkpoint step 4, resuming "
        "at epoch 4",
        "rejoin: scaled back up to 4 devices at checkpoint step 12 "
        "(3 partitions warm-marked)"]
    assert '"recoveries": 1' in printed


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
