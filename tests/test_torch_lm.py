"""The port's LM (``models/model.py``) against the JAX package's, one case
per assigned architecture, reduced, in float64 (x64 on, as in the other
test_torch_* files).

(a) The JAX parameters (every constant leaf perturbed so that biases, norm
    scales and gates matter) carried over with lm_params_from_jax:
    forward_logits (capacity and dropless), prefill logits and every cache
    leaf, then 3 decode_steps' logits and caches, each within 1e-5 in
    relative Frobenius norm of JAX's (the mixers cast to f32 in both
    packages); the port's own init_params and init_caches have JAX's
    trees leaf for leaf (paths, shapes, dtypes);
(b) the port's own property, as tests/test_models_decode.py holds JAX to
    it: prefill + decode reproduce the full forward (prefill 2e-4; decode
    3e-3 of the logits' max-abs scale), and starcoder2-3b's ring cache
    stays exact through 20 decode steps that wrap it; the donated caches
    (written in place) equal the copying default's, bit for bit;
(c) the padded vocabulary's logits masked to -1e30, and the layer specs and
    groups of all ten full configs equal to JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

jax.config.update("jax_enable_x64", True)

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import model  # noqa: E402
from _torch_lm_common import close, perturbed  # noqa: E402

B, S = 2, 12


def _batch(cfg, rng, b, s):
    """Tokens and, where the arch reads them, numpy-seeded audio frames or
    image tokens (numpy, shared by both packages)."""
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))}
    if cfg.is_encdec:
        batch["audio_embed"] = rng.standard_normal(
            (b, cfg.num_audio_frames, cfg.d_model))
    if cfg.num_image_tokens:
        batch["image_embed"] = rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.d_model))
    return batch


def _paths(tree):
    """(key path, shape, dtype name) of every leaf, in JAX's order."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        dtype = str(leaf.dtype).replace("torch.", "")
        out.append((jax.tree_util.keystr(path), tuple(leaf.shape), dtype))
    return out


def _close_trees(got, want):
    assert _paths(got) == _paths(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        close(g, w)


# ------------------------------------------------------------- (a) vs JAX

@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_lm_matches_jax(arch):
    jcfg = jconfigs.get_arch(arch).reduced(dtype="float64")
    cfg = configs.get_arch(arch).reduced(dtype="float64")
    jlm, lm = jmodel.LM(jcfg), model.LM(cfg)
    rng = np.random.default_rng(0)
    jparams = jlm.init_params(jax.random.PRNGKey(0))
    assert _paths(lm.init_params(torch.Generator().manual_seed(0))) == \
        _paths(jparams)
    nump = perturbed(jparams, rng)
    jp = jax.tree.map(jnp.asarray, nump)
    tp = model.lm_params_from_jax(nump, "cpu")
    _close_trees(tp, jp)

    batch = _batch(cfg, rng, B, S)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    forward = jax.jit(jlm.forward_logits, static_argnames="moe_dropless")
    for dropless in (False, True):
        jl, jaux = forward(jp, jb, moe_dropless=dropless)
        tl, aux = lm.forward_logits(tp, tb, moe_dropless=dropless)
        close(tl, jl)
        close(aux, jaux)

    jc = jlm.init_caches(B, S + 8)
    tc = lm.init_caches(B, S + 8, device="cpu")
    assert _paths(tc) == _paths(jc)
    jl, jc = jax.jit(jlm.prefill)(jp, jb, jc)
    tl, tc = lm.prefill(tp, tb, tc)
    close(tl, jl)
    _close_trees(tc, jc)
    # JAX's caches carried into the port serve the same first step
    carried = model.lm_caches_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    _close_trees(carried, jc)

    decode = jax.jit(jlm.decode_step, static_argnums=3)
    first = None
    for i in range(3):
        nxt = rng.integers(0, cfg.vocab_size, (B, 1))
        jl, jc = decode(jp, jnp.asarray(nxt), jc, S + i)
        tl, tc = lm.decode_step(tp, torch.from_numpy(nxt), tc, S + i)
        close(tl, jl)
        _close_trees(tc, jc)
        first = first or (nxt, jl)
    tl, _ = lm.decode_step(tp, torch.from_numpy(first[0]), carried, S)
    close(tl, first[1])


# --------------------------------------------- (b) the port's own property

def _forward_last(lm, params, batch):
    logits, _ = lm.forward_logits(params, batch, moe_dropless=True)
    return logits[:, -1]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_prefill_decode_match_full_forward(arch):
    cfg = configs.get_arch(arch).reduced()
    lm = model.LM(cfg)
    rng = np.random.default_rng(1)
    params = lm.init_params(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, rng, 2, 16).items()}
    for k in ("audio_embed", "image_embed"):
        if k in batch:
            batch[k] = batch[k].float()
    caches = lm.init_caches(2, 16 + 3 + 8, device="cpu")
    last, caches = lm.prefill(params, batch, caches)
    torch.testing.assert_close(last[:, 0], _forward_last(lm, params, batch),
                               atol=2e-4, rtol=2e-4)
    toks = batch["tokens"]
    for i in range(3):
        nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)))
        logits, caches = lm.decode_step(params, nxt, caches, 16 + i)
        toks = torch.cat([toks, nxt], 1)
        full = _forward_last(lm, params, dict(batch, tokens=toks))
        err = float((logits[:, 0] - full).abs().max()
                    / (full.abs().max() + 1e-9))
        assert err < 3e-3, (arch, i, err)


def test_ring_buffer_wraparound():
    """Decode past the window: ring cache slots wrap and stay exact."""
    cfg = configs.get_arch("starcoder2-3b").reduced()      # window 16
    assert cfg.sliding_window == 16
    lm = model.LM(cfg)
    rng = np.random.default_rng(2)
    params = lm.init_params(torch.Generator().manual_seed(1))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 16)))
    caches = lm.init_caches(1, 64, device="cpu")
    assert caches[0]["kv"]["k"].shape[2] == 16    # ring sized to window
    _, caches = lm.prefill(params, {"tokens": toks}, caches)
    for i in range(20):                            # wraps slot 0 repeatedly
        nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 1)))
        logits, caches = lm.decode_step(params, nxt, caches, 16 + i)
        toks = torch.cat([toks, nxt], 1)
    full = _forward_last(lm, params, {"tokens": toks})
    scale = float(full.abs().max()) + 1e-9
    assert float((logits[:, 0] - full).abs().max()) / scale < 3e-3


@pytest.mark.parametrize("arch", ["qwen3-8b", "starcoder2-3b",
                                  "deepseek-v2-236b", "mamba2-780m",
                                  "recurrentgemma-2b", "whisper-large-v3",
                                  "llama-3.2-vision-11b"])
def test_donated_caches_are_written_in_place(arch):
    """prefill and decode_step with donate=True give the copying default's
    logits and caches bit for bit, written into the given cache tensors
    (starcoder2-3b's 18-token prompt fills its 16-slot ring); the default
    leaves the caches it was given as they were."""
    cfg = configs.get_arch(arch).reduced()
    lm = model.LM(cfg)
    rng = np.random.default_rng(3)
    params = lm.init_params(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(cfg, rng, 2, 18).items()}
    for k in ("audio_embed", "image_embed"):
        if k in batch:
            batch[k] = batch[k].float()
    given = lm.init_caches(2, 24, device="cpu")
    own = lm.init_caches(2, 24, device="cpu")
    ptrs = [x.data_ptr() for x in jax.tree.leaves(own)]

    def same(a, b):
        assert all(torch.equal(x, y) for x, y in zip(jax.tree.leaves(a),
                                                     jax.tree.leaves(b)))

    want, caches = lm.prefill(params, batch, given)
    same(given, lm.init_caches(2, 24, device="cpu"))
    got, own = lm.prefill(params, batch, own, donate=True)
    assert torch.equal(got, want)
    same(own, caches)
    for i in range(3):
        nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)))
        before = jax.tree.map(torch.clone, caches)
        want, new = lm.decode_step(params, nxt, caches, 18 + i)
        same(caches, before)
        caches = new
        got, own = lm.decode_step(params, nxt, own, 18 + i, donate=True)
        assert torch.equal(got, want)
        same(own, caches)
    assert [x.data_ptr() for x in jax.tree.leaves(own)] == ptrs


# ---------------------------------------------------- (c) vocab and specs

def test_padded_vocab_logits_masked():
    cfg = configs.get_arch("qwen3-8b").reduced(vocab_size=500)
    assert cfg.padded_vocab == 512
    lm = model.LM(cfg)
    params = lm.init_params(torch.Generator().manual_seed(0))
    toks = torch.arange(10)[None] * 37
    logits, _ = lm.forward_logits(params, {"tokens": toks})
    assert logits.shape == (1, 10, 512)
    assert bool((logits[..., 500:] == -1e30).all())
    assert bool((logits[..., :500] > -1e3).all())


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_layer_specs_and_groups_of_full_configs_equal_jax(arch):
    specs = model.decoder_layer_specs(configs.get_arch(arch))
    jspecs = jmodel.decoder_layer_specs(jconfigs.get_arch(arch))
    assert [tuple(s) for s in specs] == [tuple(s) for s in jspecs]
    assert [(tuple(s), n) for s, n in model.group_specs(specs)] == \
        [(tuple(s), n) for s, n in jmodel.group_specs(jspecs)]
    lm, jlm = model.LM(configs.get_arch(arch)), jmodel.LM(
        jconfigs.get_arch(arch))
    assert [(tuple(s), n) for s, n in lm.encoder_groups] == \
        [(tuple(s), n) for s, n in jlm.encoder_groups]
