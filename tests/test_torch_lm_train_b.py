"""The port's LM training loop (``launch/train.py`` `train_lm`) against the
JAX launcher's `run_lm` loop, one case per assigned architecture, reduced,
in float64 (x64 on, as in the other test_torch_* files).

From the JAX parameters (constant leaves perturbed) carried over with
lm_params_from_jax, 3 steps of adamw(linear_warmup_cosine(3e-4, 10, 3),
max_grad_norm=1.0) on the same `TokenStream` batches with the zero audio
/ image stubs: the port's `train_lm` against the loop of
src/repro/launch/train.py (a jitted value_and_grad + opt.apply step),
written out here. Every loss and every final parameter leaf within 1e-5
in relative Frobenius norm of JAX's; the loop logs JAX's step lines. Both
packages compute the update in f32, as JAX's optimizer does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

jax.config.update("jax_enable_x64", True)

from repro import configs as jconfigs  # noqa: E402
from repro.data import TokenStream as JTokenStream  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import linear_warmup_cosine as jschedule  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.launch.train import train_lm  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.optim import adamw, linear_warmup_cosine  # noqa: E402
from _torch_lm_common import close, perturbed  # noqa: E402

STEPS, BATCH, SEQ = 3, 2, 16


def _jax_run_lm(jlm, params, stream, steps):
    """JAX's run_lm loop (src/repro/launch/train.py) from `params`."""
    cfg = jlm.cfg
    opt = jadamw(jschedule(3e-4, 10, steps), max_grad_norm=1.0)
    opt_state = opt.init(params)

    def add_stubs(batch, b):
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        if cfg.is_encdec:
            batch["audio_embed"] = jnp.zeros(
                (b, cfg.num_audio_frames, cfg.d_model), jlm.dtype)
        if cfg.num_image_tokens:
            batch["image_embed"] = jnp.zeros(
                (b, cfg.num_image_tokens, cfg.d_model), jlm.dtype)
        return batch

    @jax.jit
    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(jlm.loss_fn)(params, batch)
        params, opt_state = opt.apply(params, grads, opt_state)
        return loss, params, opt_state

    losses = []
    for _ in range(steps):
        loss, params, opt_state = step(params, opt_state,
                                       add_stubs(next(stream), BATCH))
        losses.append(float(loss))
    return losses, params


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_adamw_loop_matches_jax(arch):
    jcfg = jconfigs.get_arch(arch).reduced(dtype="float64")
    cfg = configs.get_arch(arch).reduced(dtype="float64")
    jlm, lm = jmodel.LM(jcfg), model.LM(cfg)
    nump = perturbed(jlm.init_params(jax.random.PRNGKey(0)),
                     np.random.default_rng(0))
    jlosses, jparams = _jax_run_lm(
        jlm, jax.tree.map(jnp.asarray, nump),
        iter(JTokenStream(cfg.vocab_size, SEQ, BATCH, seed=0)), STEPS)
    lines = []
    losses, params, secs = train_lm(
        lm, model.lm_params_from_jax(nump, "cpu"),
        adamw(linear_warmup_cosine(3e-4, 10, STEPS), max_grad_norm=1.0),
        iter(TokenStream(cfg.vocab_size, SEQ, BATCH, seed=0)), STEPS,
        log=lines.append)
    assert secs > 0 and len(losses) == STEPS
    assert lines == [f"step {i:5d} loss {losses[i]:.4f}"
                     for i in range(STEPS)]
    for got, want in zip(losses, jlosses):
        close(np.float64(got), np.float64(want))
    got, want = jax.tree.leaves(params), jax.tree.leaves(jparams)
    assert len(got) == len(want) == len(jax.tree.leaves(nump))
    for g, w in zip(got, want):
        assert str(g.dtype) == "torch." + str(w.dtype)
        close(g, w)
