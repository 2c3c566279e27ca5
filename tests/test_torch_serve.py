"""The port's serving module (``launch/serve.py``) against the JAX
package's, on the CPU: the result's keys, the prompts, and with the JAX
parameters carried over, the greedy tokens of serve_with equal to JAX's
serve on reduced qwen3-8b, granite-moe-1b-a400m and mamba2-780m; temperature
sampling deterministic per seed; no card, no CUDA run; the CLI's JSON."""
import json

import jax
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

jax.config.update("jax_enable_x64", True)

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model  # noqa: E402

BATCH, PROMPT, GEN = 2, 10, 6


def _recorded_prompts(monkeypatch, lm_cls, calls):
    """Record the tokens each prefill of lm_cls is given."""
    prefill = lm_cls.prefill

    def recording(self, params, batch, caches, **kw):
        calls.append(np.asarray(batch["tokens"]))
        return prefill(self, params, batch, caches, **kw)
    monkeypatch.setattr(lm_cls, "prefill", recording)


def test_result_keys_and_prompts_equal_jax(monkeypatch):
    """The port's result has every key of JAX's plus ``device``; both
    serve calls prefill the same prompts (JAX's jit is lifted for the call
    so its prefill sees concrete tokens)."""
    jcalls, calls = [], []
    _recorded_prompts(monkeypatch, jmodel.LM, jcalls)
    _recorded_prompts(monkeypatch, model.LM, calls)
    with monkeypatch.context() as m:
        m.setattr(jax, "jit", lambda fn, **kw: fn)
        want = jserve.serve("qwen3-8b", True, BATCH, PROMPT, 2, seed=3)
    got = serve.serve("qwen3-8b", True, BATCH, PROMPT, 2, seed=3,
                      device="cpu")
    assert set(got) >= set(want) | {"device"}
    assert got["device"] == "cpu"
    assert {k: got[k] for k in ("arch", "batch", "prompt_len",
                                "gen_tokens")} == \
        {k: want[k] for k in ("arch", "batch", "prompt_len", "gen_tokens")}
    assert len(jcalls) == len(calls) == 1
    assert jcalls[0].shape == (BATCH, PROMPT)
    np.testing.assert_array_equal(calls[0], jcalls[0])


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-moe-1b-a400m",
                                  "mamba2-780m"])
def test_greedy_tokens_equal_jax_from_carried_params(arch):
    """JAX's serve draws its parameters from PRNGKey(seed); the same
    parameters carried into the port give the same greedy tokens."""
    seed = 1
    jlm = jmodel.LM(jconfigs.get_arch(arch).reduced())
    nump = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(seed)))
    want = jserve.serve(arch, True, BATCH, PROMPT, GEN, seed=seed)
    lm = model.LM(configs.get_arch(arch).reduced())
    got = serve.serve_with(lm, model.lm_params_from_jax(nump, "cpu"), BATCH,
                           PROMPT, GEN, seed=seed)
    assert len(got["sample_output"]) == GEN
    assert got["sample_output"] == want["sample_output"]


def test_temperature_sampling_is_deterministic_per_seed():
    run = [serve.serve("qwen3-8b", True, BATCH, PROMPT, 8, temperature=0.8,
                       seed=s, device="cpu")["sample_output"]
           for s in (0, 0, 1)]
    assert run[0] == run[1]
    assert run[0] != run[2]


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal needs its absence")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.serve("qwen3-8b", True, BATCH, PROMPT, 2)


def test_main_prints_the_json(capsys):
    out = serve.main(["--arch", "mamba2-780m", "--reduced", "--batch", "2",
                      "--prompt-len", "9", "--gen", "3", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(out))
    assert printed["arch"] == "mamba2-780m" and printed["gen_tokens"] == 3
    assert len(printed["sample_output"]) == 3
