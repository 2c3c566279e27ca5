"""The five torch examples run on the CPU, in process and briefly: each
`main` takes its epoch (or step, or token) count and the device. The SPMD example
starts 4 gloo ranks holding 2 of 8 partitions each and asserts SPMD ==
sim bitwise after every step."""
import importlib.util
import math
import os

import torch

import _torch_threads  # noqa: F401

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quickstart(capsys):
    res = _example("torch_quickstart").main(epochs=2, device="cpu")
    assert list(res) == ["vanilla", "pipegcn", "pipegcn-gf"]
    assert all(math.isfinite(r.history["loss"][-1]) for r in res.values())
    assert "test acc" in capsys.readouterr().out


def test_train_reddit_sim_with_checkpoint(tmp_path, capsys):
    """The reddit-sim driver's every path (five variants, the best model's
    checkpoint) on the tiny preset, 2 epochs."""
    rows = _example("torch_train_reddit_sim").main(
        ["--device", "cpu", "--dataset", "tiny", "--epochs", "2",
         "--ckpt-dir", str(tmp_path)])
    assert [r[0] for r in rows] == ["vanilla", "pipegcn", "pipegcn-g",
                                    "pipegcn-f", "pipegcn-gf"]
    from repro_torch.checkpoint import latest_step
    assert latest_step(str(tmp_path)) == 2
    assert "saved best" in capsys.readouterr().out


def test_pipegcn_spmd_equals_sim_bitwise(capfd):
    codes = _example("torch_pipegcn_spmd").main(epochs=3, device="cpu")
    out = capfd.readouterr().out
    assert codes == [0, 0, 0, 0], out
    assert "ranks: 4 (gloo), partitions: 8 (2/rank)" in out
    assert "SPMD == sim across full training  OK" in out


def test_stale_halo_transformer(capsys):
    res = _example("torch_stale_halo_transformer").main(steps=3,
                                                        device="cpu")
    assert set(res) == {"sync", "stale", "stale+EMA"}
    assert all(len(v) == 3 and all(map(math.isfinite, v))
               for v in res.values())
    assert "final-loss gap vs sync" in capsys.readouterr().out


def test_serve_decode(capsys):
    """Reduced archs through serve at temperature 0.8: the dense, MoE and
    SSM mixers and the encoder-decoder."""
    for arch in ("qwen3-8b", "granite-moe-1b-a400m", "mamba2-780m",
                 "whisper-large-v3"):
        res = _example("torch_serve_decode").main(arch, gen=3, device="cpu",
                                                  batch=2, prompt_len=8)
        assert res["arch"] == arch and res["device"] == "cpu"
        assert len(res["sample_output"]) == 3
        assert math.isfinite(res["decode_tok_per_s"])
    assert "sample_output: [" in capsys.readouterr().out
