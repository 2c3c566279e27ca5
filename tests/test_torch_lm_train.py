"""The port's LM training loss and its gradients (``LM.loss_fn`` under
autograd) against the JAX package's ``jax.value_and_grad(lm.loss_fn)``,
one case per assigned architecture, reduced, in float64 (x64 on, as in the
other test_torch_* files).

(a) The JAX parameters (every constant leaf perturbed so that biases, norm
    scales and gates matter) carried over with lm_params_from_jax, one
    batch (tokens, next-token labels and numpy-seeded audio frames or
    image tokens where the arch reads them): the loss and every gradient
    leaf within 1e-5 in relative Frobenius norm of JAX's (the CE is f32 in
    both packages, as are the mixers' casts); the key bias of an attention
    without RoPE or qk-norm (whisper), whose exact gradient is 0 (the
    softmax cancels it), is held to rounding noise in both packages;
(c) remat: the loss and every gradient bit for bit equal with cfg.remat
    on (each layer under torch.utils.checkpoint, which then runs once per
    layer) and off; under no_grad nothing is checkpointed;
(d) JAX's own property (tests/test_models_smoke.py): from the port's own
    init, two adam(1e-3) steps on one batch lower the loss;
(e) blockwise_attention (JAX's q_step / kv_step online softmax) at
    q_block = kv_block = 8, causal and windowed: the gradients of q, k and
    v within 1e-5 of JAX's.

The 3-step AdamW loop against JAX's is in tests/test_torch_lm_train_b.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

jax.config.update("jax_enable_x64", True)

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch.train import loss_and_grads  # noqa: E402
from repro_torch.models import attention, model  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from _torch_lm_common import close, perturbed  # noqa: E402

B, S = 2, 16


def _batch(cfg, rng, b=B, s=S):
    """Tokens, next-token labels and, where the arch reads them,
    numpy-seeded audio frames or image tokens (numpy, for both packages)."""
    tokens = rng.integers(0, cfg.vocab_size, (b, s))
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if cfg.is_encdec:
        batch["audio_embed"] = rng.standard_normal(
            (b, cfg.num_audio_frames, cfg.d_model))
    if cfg.num_image_tokens:
        batch["image_embed"] = rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.d_model))
    return batch


def _torch_batch(batch, dtype=torch.float64):
    return {k: (torch.from_numpy(v) if v.dtype.kind == "i"
                else torch.from_numpy(v).to(dtype))
            for k, v in batch.items()}


def _leaves(tree):
    """The leaves in JAX's order (dict keys sorted), as JAX flattens."""
    return jax.tree.leaves(tree)


# ------------------------------------------------------------- (a) vs JAX

@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_loss_and_gradients_match_jax(arch):
    jcfg = jconfigs.get_arch(arch).reduced(dtype="float64")
    cfg = configs.get_arch(arch).reduced(dtype="float64")
    jlm, lm = jmodel.LM(jcfg), model.LM(cfg)
    rng = np.random.default_rng(0)
    nump = perturbed(jlm.init_params(jax.random.PRNGKey(0)), rng)
    batch = _batch(cfg, rng)
    jloss, jgrads = jax.jit(jax.value_and_grad(jlm.loss_fn))(
        jax.tree.map(jnp.asarray, nump),
        {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = loss_and_grads(lm, model.lm_params_from_jax(nump, "cpu"),
                                 _torch_batch(batch))
    assert loss.dtype == torch.float32 and np.isfinite(float(loss))
    close(loss, jloss)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    got = dict(zip(paths, _leaves(grads)))
    want = dict(zip(paths, _leaves(jgrads)))
    assert len(got) == len(_leaves(grads)) == len(_leaves(nump))
    for path in paths:
        g, w = got[path], want[path]
        assert tuple(g.shape) == w.shape
        assert str(g.dtype) == "torch." + str(w.dtype)
        if path.endswith("['bk']") and not (cfg.use_rope or cfg.qk_norm):
            # no RoPE and no qk-norm: the key bias adds q·bk to every score
            # of a query, which the softmax cancels, so its exact gradient
            # is 0 and both packages give rounding noise: each within 1e-6
            # of the same layer's wk gradient in norm
            scale = np.linalg.norm(want[path[:-len("['bk']")] + "['wk']"])
            for noise in (np.linalg.norm(g.numpy()), np.linalg.norm(w)):
                assert noise <= 1e-6 * scale, (path, noise, scale)
            continue
        close(g, w)
        # a leaf the loss does not reach (whisper's ungated cross-attention
        # keeps an unused gate) has a zero gradient in both packages
        assert (float(g.abs().max()) > 0) == bool(np.abs(w).max() > 0), path


# ------------------------------------------------------------- (c) remat

@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-236b",
                                  "mamba2-780m", "recurrentgemma-2b",
                                  "granite-moe-1b-a400m", "whisper-large-v3",
                                  "llama-3.2-vision-11b"])
def test_remat_changes_no_bit(arch, monkeypatch):
    base = configs.get_arch(arch).reduced()
    assert not base.remat
    calls = []
    real = model.checkpoint

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(model, "checkpoint", counting)
    rng = np.random.default_rng(1)
    batch = _torch_batch(_batch(base, rng), torch.float32)
    params = model.LM(base).init_params(torch.Generator().manual_seed(0))
    runs = {}
    for remat in (False, True):
        lm = model.LM(dataclasses.replace(base, remat=remat))
        calls.clear()
        runs[remat] = loss_and_grads(lm, params, batch)
        layers = base.num_layers + (base.encoder_layers if base.is_encdec
                                    else 0)
        assert len(calls) == (layers if remat else 0), (remat, len(calls))
        calls.clear()
        with torch.no_grad():
            lm.loss_fn(params, batch)
        assert not calls
    assert torch.equal(runs[True][0], runs[False][0])
    for a, b in zip(_leaves(runs[True][1]), _leaves(runs[False][1])):
        assert torch.equal(a, b)


# ------------------------------------- (d) the JAX smoke test's property

@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_two_adam_steps_on_one_batch_lower_the_loss(arch):
    cfg = configs.get_arch(arch).reduced()
    lm = model.LM(cfg)
    params = lm.init_params(torch.Generator().manual_seed(0))
    batch = _torch_batch(_batch(cfg, np.random.default_rng(0)),
                         torch.float32)
    opt = adam(1e-3)
    state = opt.init(params)
    losses = []
    for _ in range(2):
        loss, grads = loss_and_grads(lm, params, batch)
        with torch.no_grad():
            params, state = opt.apply(params, grads, state)
        losses.append(float(loss))
    assert all(np.isfinite(losses)), losses
    assert losses[1] < losses[0], losses


# ------------------------------------------ (e) blockwise attention grads

@pytest.mark.parametrize("causal,window", [(True, 0), (True, 12),
                                           (False, 0)])
def test_blockwise_attention_gradients_match_jax(causal, window):
    rng = np.random.default_rng(4)
    b, s, h, k, hd = 2, 32, 4, 2, 16
    q = rng.standard_normal((b, s, h, hd))
    kk = rng.standard_normal((b, s, k, hd))
    v = rng.standard_normal((b, s, k, hd))
    w = rng.standard_normal((b, s, h, hd))

    def jloss(q, kk, v):
        out = jattn.blockwise_attention(q, kk, v, jnp.arange(s), causal,
                                        window, q_block=8, kv_block=8)
        return jnp.sum(out * w)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(q, kk, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, kk, v))
    out = attention.blockwise_attention(tq, tk, tv, torch.arange(s), causal,
                                        window, q_block=8, kv_block=8)
    (out * torch.from_numpy(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        assert bool(torch.isfinite(got).all())
        close(got, want)
