"""The port's optimizer library against the JAX package's, on the CPU.

The same float32 parameters and gradients (numpy, seeded) go through
`repro.optim` and `repro_torch.optim` for 20 steps: the three schedules,
`global_norm`, `clip_by_global_norm`, Adam with a schedule, clipping and
both weight-decay modes (coupled decay adds nothing, as in JAX), AdamW and
SGD with and without momentum, on flat and nested dicts, within 1e-6
relative. `adam(lr)` with a float rate, as the trainer calls it, keeps the
arithmetic it had: a hand-written Adam step equals it bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

from repro import optim as joptim
from repro_torch import optim

REL = 1e-6
STEPS = 20

SCHEDULES = [("constant", (0.01,)), ("cosine", (0.05, 15, 0.1)),
             ("warmup_cosine", (0.05, 4, 18, 0.1))]


def _schedule(lib, name, args):
    fn = {"constant": lib.constant_schedule, "cosine": lib.cosine_schedule,
          "warmup_cosine": lib.linear_warmup_cosine}[name]
    return fn(*args)


def _tree(rng, nested: bool):
    t = {"w0": rng.standard_normal((6, 5)).astype(np.float32),
         "b0": rng.standard_normal(5).astype(np.float32)}
    if nested:
        t["l1"] = {"wq": rng.standard_normal((5, 4)).astype(np.float32),
                   "rb": {"bias": rng.standard_normal(3).astype(np.float32)}}
    return t


def _to_jax(t):
    return jax.tree.map(jnp.asarray, t)


def _to_torch(t):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in t.items()}


def _assert_close(jt, tt, what):
    if isinstance(jt, dict):
        assert set(jt) == set(tt), what
        for k in jt:
            _assert_close(jt[k], tt[k], f"{what}/{k}")
        return
    got, want = tt.numpy(), np.asarray(jt)
    assert got.dtype == want.dtype == np.float32, (what, got.dtype,
                                                   want.dtype)
    np.testing.assert_allclose(got, want, rtol=REL,
                               atol=REL * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("name,args", SCHEDULES)
def test_schedules_match_jax(name, args):
    js, ts = _schedule(joptim, name, args), _schedule(optim, name, args)
    for step in range(1, 25):
        got = ts(step)
        assert got.dtype == torch.float32 and got.dim() == 0
        want = float(js(jnp.asarray(step, jnp.int32)))
        assert abs(float(got) - want) <= REL * abs(want) + 1e-12, (step,
                                                                   got, want)


@pytest.mark.parametrize("nested", [False, True])
def test_global_norm_and_clipping_match_jax(nested):
    tree = _tree(np.random.default_rng(3), nested)
    jn = joptim.global_norm(_to_jax(tree))
    tn = optim.global_norm(_to_torch(tree))
    assert abs(float(tn) - float(jn)) <= REL * float(jn)
    for max_norm in (0.5, 1e3):      # clipped, and left alone
        jc, jnorm = joptim.clip_by_global_norm(_to_jax(tree), max_norm)
        tc, tnorm = optim.clip_by_global_norm(_to_torch(tree), max_norm)
        assert abs(float(tnorm) - float(jnorm)) <= REL * float(jnorm)
        _assert_close(jc, tc, f"clip {max_norm}")


OPTIMIZERS = [
    ("adam", dict(), "constant"),
    ("adam", dict(), "warmup_cosine"),
    ("adam", dict(max_grad_norm=0.5), "cosine"),
    ("adam", dict(weight_decay=0.1), "constant"),            # coupled: no-op
    ("adam", dict(weight_decay=0.1, decoupled=True), "cosine"),
    ("adamw", dict(weight_decay=0.05, max_grad_norm=1.0), "warmup_cosine"),
    ("sgd", dict(), "constant"),
    ("sgd", dict(momentum=0.9), "cosine"),
    ("sgd", dict(momentum=0.9, max_grad_norm=0.5), "warmup_cosine"),
]


@pytest.mark.parametrize("nested", [False, True])
@pytest.mark.parametrize("kind,kw,sched", OPTIMIZERS)
def test_optimizer_matches_jax_over_20_steps(kind, kw, sched, nested):
    args = dict(SCHEDULES)[sched]
    jopt = getattr(joptim, kind)(_schedule(joptim, sched, args), **kw)
    topt = getattr(optim, kind)(_schedule(optim, sched, args), **kw)
    assert topt.name == jopt.name
    rng = np.random.default_rng(11)
    p = _tree(rng, nested)
    jp, tp = _to_jax(p), _to_torch(p)
    js, ts = jopt.init(jp), topt.init(tp)
    for t in range(STEPS):
        g = _tree(rng, nested)
        jp, js = jopt.apply(jp, _to_jax(g), js)
        tp, ts = topt.apply(tp, _to_torch(g), ts)
        _assert_close(jp, tp, f"{kind} {kw} step {t}")
        _assert_close(js.mu, ts.mu, f"{kind} mu step {t}")
        _assert_close(js.nu, ts.nu, f"{kind} nu step {t}")
        assert ts.step == int(js.step) == t + 1


def test_coupled_weight_decay_is_a_no_op():
    """As in JAX, coupled decay leaves the update as plain Adam's."""
    rng = np.random.default_rng(5)
    p, g = _to_torch(_tree(rng, True)), _to_torch(_tree(rng, True))
    plain, coupled = optim.adam(0.01), optim.adam(0.01, weight_decay=0.3)
    a, _ = plain.apply(p, g, plain.init(p))
    b, _ = coupled.apply(p, g, coupled.init(p))
    assert all(torch.equal(x, y) for x, y in
               zip(optim.optimizers._leaves(a), optim.optimizers._leaves(b)))


def test_float_rate_adam_is_the_trainers_arithmetic():
    """adam(lr) with a float: each step equals Adam written out with a
    Python-float rate, bitwise, over flat dicts as the trainer passes
    them, float32 and float64 parameters."""
    rng = np.random.default_rng(7)
    for dtype in (torch.float32, torch.float64):
        p = {k: v.to(dtype) for k, v in _to_torch(_tree(rng, False)).items()}
        opt = optim.adam(0.01)
        state = opt.init(p)
        m = {k: torch.zeros_like(v, dtype=torch.float32) for k, v in p.items()}
        v2 = {k: torch.zeros_like(x) for k, x in m.items()}
        ref = dict(p)
        for step in range(1, 6):
            g = {k: v.to(dtype) for k, v in _to_torch(_tree(rng, False)).items()}
            p, state = opt.apply(p, g, state)
            f32 = torch.float32
            b1t = 1 - torch.tensor(0.9, dtype=f32) ** torch.tensor(step, dtype=f32)
            b2t = 1 - torch.tensor(0.999, dtype=f32) ** torch.tensor(step,
                                                                     dtype=f32)
            for k in ref:
                g32 = g[k].to(f32)
                m[k] = 0.9 * m[k] + (1 - 0.9) * g32
                v2[k] = 0.999 * v2[k] + (1 - 0.999) * torch.square(g32)
                delta = (m[k] / b1t) / (torch.sqrt(v2[k] / b2t) + 1e-8)
                ref[k] = (ref[k].to(f32) - 0.01 * delta).to(dtype)
                assert torch.equal(p[k], ref[k]), (dtype, step, k)
                assert p[k].dtype == dtype
