"""The port's stale-halo windowed-attention model against the JAX
package's `repro.models.halo`, on the CPU in float64.

The four checks of tests/test_halo.py run on the port at their bars (sync
over 4 shards == one unsharded sequence; the first stale step stores the
fresh halos and uses zeros; the second consumes the first's; training
learns and stale stays near sync), and each output is held against the
JAX model's on the same parameters (carried by `params_from_jax`) and
tokens.

The cross-package bar is HALO_TOL, not the GCN step's 1e-12: both models
take RoPE's cos / sin and the masked softmax in float32 (the JAX model
casts its scores to f32 whatever the input dtype), and XLA's float32
cos, sin and exp differ from PyTorch's by one ulp on a few percent of
inputs, which moves the float64 logits by ~5e-8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

jax.config.update("jax_enable_x64", True)

from repro.models import halo as jhalo  # noqa: E402
from repro_torch.models import halo  # noqa: E402

SHARDS, B, S = 4, 2, 32
HALO_TOL = 1e-6

# the JAX model's forward, jitted as its train step is (one compile per
# config instead of one per operation)
jforward = jax.jit(jhalo.forward, static_argnums=1)


def _cfg(**kw):
    base = dict(window=16, vocab=32, d_model=32, num_heads=2, num_layers=2)
    base.update(kw)
    return jhalo.HaloConfig(**base), halo.HaloConfig(**base)


def _params(jcfg, seed=0):
    """JAX float64 parameters, with a nonzero relative bias so that it
    counts, and the same as tensors."""
    jp = jhalo.init_params(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    for ell in range(jcfg.num_layers):
        rb = jp[f"l{ell}"]["rb"]
        jp[f"l{ell}"]["rb"] = jnp.asarray(0.3 * rng.standard_normal(rb.shape))
    return jp, halo.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (SHARDS, B, S)).astype(np.int64)


def _bufs(jcfg, cfg, shards=SHARDS, s=S):
    return (jhalo.init_halo_buffers(jcfg, s, B, shards, dtype=jnp.float64),
            halo.init_halo_buffers(cfg, s, B, shards, dtype=torch.float64,
                                   device="cpu"))


def _close(got, want, tol=HALO_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=tol)


def _bufs_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("k", "v"):
            _close(g[k], w[k])


POS0 = np.arange(SHARDS) * S


def test_halo_buffers_default_to_the_card():
    """Like every entry point of the port, the halo state lands on the
    card unless the caller asks for the CPU, and asking for the card
    without one raises."""
    _, cfg = _cfg()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            halo.init_halo_buffers(cfg, S, B, SHARDS)
        return
    bufs = halo.init_halo_buffers(cfg, S, B, SHARDS)
    assert all(t.is_cuda for b in bufs for t in b.values())


def test_sharded_sync_equals_unsharded_and_jax():
    jcfg, cfg = _cfg(stale=False)
    jp, tp = _params(jcfg)
    toks = _tokens(cfg.vocab)
    jb, tb = _bufs(jcfg, cfg)
    logits4, _ = halo.forward(tp, cfg, torch.from_numpy(toks), tb,
                              torch.from_numpy(POS0))
    jlogits4, _ = jforward(jp, jcfg, jnp.asarray(toks), jb,
                                jnp.asarray(POS0))
    _close(logits4, jlogits4)
    full = toks.transpose(1, 0, 2).reshape(1, B, SHARDS * S)
    _, tb1 = _bufs(jcfg, cfg, shards=1, s=SHARDS * S)
    logits1, _ = halo.forward(tp, cfg, torch.from_numpy(full), tb1,
                              torch.zeros(1, dtype=torch.int64))
    got = logits4.permute(1, 0, 2, 3).reshape(1, B, SHARDS * S, cfg.vocab)
    _close(got, logits1.numpy(), tol=2e-5)      # tests/test_halo.py's bar


def test_stale_first_step_uses_zero_halo():
    jcfg, cfg = _cfg(stale=True)
    jp, tp = _params(jcfg)
    toks = _tokens(cfg.vocab)
    jb, tb = _bufs(jcfg, cfg)
    out, new = halo.forward(tp, cfg, torch.from_numpy(toks), tb,
                            torch.from_numpy(POS0))
    jout, jnew = jforward(jp, jcfg, jnp.asarray(toks), jb,
                               jnp.asarray(POS0))
    _close(out, jout)
    _bufs_close(new, jnew)
    assert float(new[0]["k"][1:].abs().max()) > 0
    assert torch.equal(new[0]["k"][0], torch.zeros_like(new[0]["k"][0]))
    assert not any(b["k"].requires_grad for b in new)


@pytest.mark.parametrize("smooth", [False, True])
def test_stale_second_step_consumes_first(smooth):
    jcfg, cfg = _cfg(stale=True, smooth=smooth)
    jp, tp = _params(jcfg)
    toks = torch.from_numpy(_tokens(cfg.vocab))
    pos0 = torch.from_numpy(POS0)
    jb, tb = _bufs(jcfg, cfg)
    _, b1 = halo.forward(tp, cfg, toks, tb, pos0)
    out2, b2 = halo.forward(tp, cfg, toks, b1, pos0)
    _, jb1 = jforward(jp, jcfg, jnp.asarray(toks.numpy()), jb,
                           jnp.asarray(POS0))
    jout2, jb2 = jforward(jp, jcfg, jnp.asarray(toks.numpy()), jb1,
                               jnp.asarray(POS0))
    _close(out2, jout2)
    _bufs_close(b2, jb2)
    if not smooth:
        # the step-2 stale output uses the step-1 halos == the sync halos
        sync = halo.HaloConfig(**{**cfg.__dict__, "stale": False})
        out_sync, _ = halo.forward(tp, sync, toks, tb, pos0)
        _close(out2, out_sync.numpy(), tol=2e-5)


def test_training_matches_jax_and_learns():
    """6 Adam steps of the sim train step against the JAX package's
    (jitted) on the same float64 parameters and tokens: losses, halo
    buffers and parameters within HALO_TOL; then the stale model keeps
    learning over 40 steps and ends near the sync model, the JAX test's
    parity band."""
    losses = {}
    for stale in (False, True):
        jcfg, cfg = _cfg(stale=stale, vocab=16)
        jp, tp = _params(jcfg, seed=1)
        jb, tb = _bufs(jcfg, cfg)
        jinit, jstep = jhalo.make_sim_train_step(jcfg, SHARDS, lr=5e-3)
        init, step = halo.make_sim_train_step(cfg, SHARDS, lr=5e-3)
        jst, st = jinit(jp), init(tp)
        pos0 = torch.from_numpy(POS0)
        rng = np.random.default_rng(1)
        ls = []
        for t in range(40):
            base = rng.integers(0, cfg.vocab, (B, SHARDS * S))
            toks = base.reshape(B, SHARDS, S).transpose(1, 0, 2)
            loss, tp, st, tb = step(tp, st, torch.from_numpy(toks),
                                    torch.from_numpy(toks), tb, pos0)
            ls.append(float(loss))
            if t < 6:
                jl, jp, jst, jb = jstep(jp, jst, jnp.asarray(toks),
                                        jnp.asarray(toks), jb,
                                        jnp.asarray(POS0))
                assert abs(float(loss) - float(jl)) < HALO_TOL, (stale, t)
                _bufs_close(tb, jb)
                for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
                    _close(a, b, tol=1e-5)
        losses[stale] = ls
    assert losses[True][-1] < losses[True][0]          # learns
    assert abs(losses[True][-1] - losses[False][-1]) < 0.3   # parity band
