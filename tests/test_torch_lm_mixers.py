"""The port's LM mixers and MoE FFN against the JAX package's, on the same
numpy-seeded inputs, parameters carried over from the JAX init functions.

(a) RG-LRU: full-sequence forward (with the decode cache it returns), the
    decode recurrence step by step, and the log-depth scan against a
    sequential loop;
(b) SSD: forward on a ragged tail (19 tokens, chunk 8) and on 24 (with the
    decode cache it returns), the state continuation (forward cache ==
    decode cache), decode steps; at chunk 256 the gradients the port keeps
    finite where JAX's are NaN in f32;
(c) MLA: self-attention, and decode from an empty cache with the full
    cache and with a ring (sliding window 8, 12 steps: the slots wrap);
(d) MoE: the block and grouped dispatch, with capacity and dropless; the
    router's and the capacity selection's indices equal to JAX's top_k
    before any value is compared, on inputs with tied scores;
(e) shardctx: no rules pass through, rules raise.

The JAX mixers cast the gates, the SSD state and the attention scores to
f32 even in float64 (x64 is on, as in the other test_torch_* files), so
the bar is 1e-5 in relative Frobenius norm.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

import _torch_threads  # noqa: F401

jax.config.update("jax_enable_x64", True)

from repro import configs as jconfigs  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import ssd as jssd  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import mla, moe, rglru, shardctx, ssd  # noqa: E402
from repro_torch.models.model import lm_params_from_jax  # noqa: E402
from _torch_lm_common import close, perturbed  # noqa: E402

def carried(jinit, arch, seed=0, **overrides):
    """(JAX config, port config, JAX params, port params) of one mixer in
    float64 from the JAX init function."""
    jcfg = jconfigs.get_arch(arch).reduced(dtype="float64", **overrides)
    cfg = configs.get_arch(arch).reduced(dtype="float64", **overrides)
    nump = perturbed(jinit(jax.random.PRNGKey(seed), jcfg, jnp.float64),
                     np.random.default_rng(seed + 100))
    return (jcfg, cfg, jax.tree.map(jnp.asarray, nump),
            lm_params_from_jax(nump, "cpu"))


def jit(fn, *static):
    """fn jitted with the config (argument 1) and `static` names static:
    one compile per shape instead of one per primitive."""
    return jax.jit(fn, static_argnums=1, static_argnames=static)


def _u(rng, b, s, d, scale=0.3):
    u = scale * rng.standard_normal((b, s, d))
    return jnp.asarray(u), torch.from_numpy(u)


def _close_tree(got, want):
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        close(g, w)


# ------------------------------------------------------------ (a) RG-LRU

def test_rglru_forward_matches_jax():
    jcfg, cfg, jp, tp = carried(jrglru.init_rglru, "recurrentgemma-2b")
    ju, tu = _u(np.random.default_rng(1), 2, 13, cfg.d_model)
    jy, js = jit(jrglru.rglru_forward)(jp, jcfg, ju)
    y, c = rglru.rglru_forward(tp, cfg, tu)
    assert c["state"].dtype == torch.float32   # stays f32, as in JAX
    close(y, jy)
    close(c["state"], js)
    # the conv window JAX's prefill projects again from the layer input
    close(c["conv"], (ju @ jp["in_rec"])[:, -(cfg.conv1d_width - 1):])


def test_rglru_decode_matches_jax():
    jcfg, cfg, jp, tp = carried(jrglru.init_rglru, "recurrentgemma-2b", 1)
    jc = jrglru.init_rglru_cache(jcfg, 2, jnp.float64)
    c = rglru.init_rglru_cache(cfg, 2, torch.float64, device="cpu")
    ju, tu = _u(np.random.default_rng(2), 2, 6, cfg.d_model)
    decode = jit(jrglru.rglru_decode)
    for t in range(6):
        jy, jc = decode(jp, jcfg, ju[:, t:t + 1], jc)
        y, c = rglru.rglru_decode(tp, cfg, tu[:, t:t + 1], c)
        close(y, jy)
        _close_tree(c, jc)


@pytest.mark.parametrize("length", [1, 7, 16, 37])
def test_rglru_scan_matches_a_sequential_loop(length):
    """The log-depth scan against h_t = a_t h_{t-1} + b_t one step at a
    time, in float64 (to rounding), and the port's forward (outputs and
    its decode cache: state and conv window) against its own decode
    recurrence at the JAX test's bars."""
    rng = np.random.default_rng(length)
    a = torch.from_numpy(rng.uniform(0.2, 1.0, (2, length, 5)))
    b = torch.from_numpy(rng.standard_normal((2, length, 5)))
    h, want = torch.zeros(2, 5, dtype=torch.float64), []
    for t in range(length):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    close(rglru.linear_scan(a, b), torch.stack(want, 1).numpy(), tol=1e-12)

    cfg = configs.get_arch("recurrentgemma-2b").reduced()
    p = rglru.init_rglru(torch.Generator().manual_seed(0), cfg, torch.float32)
    u = torch.from_numpy(0.3 * rng.standard_normal((2, length, cfg.d_model))
                         ).float()
    y_par, c_par = rglru.rglru_forward(p, cfg, u)
    cache = rglru.init_rglru_cache(cfg, 2, torch.float32, device="cpu")
    ys = []
    for t in range(length):
        y_t, cache = rglru.rglru_decode(p, cfg, u[:, t:t + 1], cache)
        ys.append(y_t)
    torch.testing.assert_close(y_par, torch.cat(ys, 1), atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(c_par["state"], cache["state"], atol=1e-4,
                               rtol=1e-3)
    # a sequence shorter than the conv window leaves fewer rows, as in JAX
    torch.testing.assert_close(c_par["conv"], cache["conv"][:, -length:],
                               atol=1e-4, rtol=1e-3)


# --------------------------------------------------------------- (b) SSD

@pytest.mark.parametrize("length", [19, 24])
def test_ssd_forward_matches_jax(length):
    """19 tokens pad a ragged tail to 24 (chunk 8, dt = 0 on the pad);
    24 fill three chunks."""
    jcfg, cfg, jp, tp = carried(jssd.init_ssd, "mamba2-780m", 2)
    assert cfg.ssm_chunk == 8
    ju, tu = _u(np.random.default_rng(3), 2, length, cfg.d_model)
    jy, js = jit(jssd.ssd_forward)(jp, jcfg, ju)
    y, c = ssd.ssd_forward(tp, cfg, tu)
    assert c["state"].dtype == torch.float32
    close(y, jy)
    close(c["state"], js)
    # the conv window JAX's prefill projects again from the layer input
    xbc = jssd._split_proj(jp, jcfg, ju)[1]
    close(c["conv"], xbc[:, -(cfg.ssm_conv - 1):])


def test_ssd_ragged_tail_and_state_continuation():
    """The port's own properties, at the JAX tests' bars: the first 19
    outputs of a 19-token input equal those of the same input padded by
    the caller to 24; the forward's outputs and final cache (state and
    conv window) equal the decode recurrence's, token by token."""
    cfg = configs.get_arch("mamba2-780m").reduced()
    p = ssd.init_ssd(torch.Generator().manual_seed(2), cfg, torch.float32)
    rng = np.random.default_rng(4)
    u = torch.from_numpy(0.3 * rng.standard_normal((1, 24, cfg.d_model))
                         ).float()
    y19, _ = ssd.ssd_forward(p, cfg, u[:, :19])
    u24 = torch.cat([u[:, :19], torch.zeros(1, 5, cfg.d_model)], 1)
    y24, _ = ssd.ssd_forward(p, cfg, u24)
    torch.testing.assert_close(y19, y24[:, :19], atol=1e-5, rtol=0)

    y_par, c_par = ssd.ssd_forward(p, cfg, u)
    cache = ssd.init_ssd_cache(cfg, 1, torch.float32, device="cpu")
    ys = []
    for t in range(24):
        y_t, cache = ssd.ssd_decode(p, cfg, u[:, t:t + 1], cache)
        ys.append(y_t)
    torch.testing.assert_close(y_par, torch.cat(ys, 1), atol=3e-4, rtol=3e-3)
    for k in ("state", "conv"):
        torch.testing.assert_close(c_par[k], cache[k], atol=3e-4, rtol=3e-3)


def test_ssd_decode_matches_jax():
    jcfg, cfg, jp, tp = carried(jssd.init_ssd, "mamba2-780m", 3)
    jc = jssd.init_ssd_cache(jcfg, 2, jnp.float64)
    c = ssd.init_ssd_cache(cfg, 2, torch.float64, device="cpu")
    ju, tu = _u(np.random.default_rng(5), 2, 6, cfg.d_model)
    decode = jit(jssd.ssd_decode)
    for t in range(6):
        jy, jc = decode(jp, jcfg, ju[:, t:t + 1], jc)
        y, c = ssd.ssd_decode(tp, cfg, tu[:, t:t + 1], c)
        close(y, jy)
        _close_tree(c, jc)


def test_ssd_gradients_finite_at_a_long_chunk_where_jax_is_nan():
    """A known divergence (ROADMAP Queue 3): at mamba2-780m's published
    chunk of 256 the intra-chunk decay's exponent above the diagonal (the
    masked entries) passes the f32 exp range, so JAX's where(causal,
    exp(rel), 0) has NaN gradients in f32 (0 · inf). The port takes
    exp(where(causal, rel, -inf)): the same forward, finite gradients. In
    f32: the forward within 1e-5 of JAX's, JAX's gradients NaN (in the
    float64 model too: dt and the decay are f32 in both packages), the
    port's finite. The port's float64 gradients of the parameters and the
    input at chunk 256 are held within 1e-5 of JAX's on the first 48
    tokens (a ragged tail: the decay's exponent stays inside the f32 range,
    so JAX's are finite)."""
    jcfg, cfg, jp, tp = carried(jssd.init_ssd, "mamba2-780m", 4,
                                ssm_chunk=256)
    rng = np.random.default_rng(6)
    ju, tu = _u(rng, 1, 256, cfg.d_model, scale=1.0)
    w = rng.standard_normal((1, 256, cfg.d_model))

    def jloss(p, u):
        return jnp.sum(jssd.ssd_forward(p, jcfg, u)[0] * w)

    def grads(p, u):
        p = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
        u = u.detach().clone().requires_grad_()
        y = ssd.ssd_forward(p, cfg, u)[0]
        (y * torch.from_numpy(w).to(u.dtype)).sum().backward()
        return y.detach(), [p[k].grad for k in sorted(p)] + [u.grad]

    jgrad = jax.jit(jax.value_and_grad(
        lambda p, u: (jloss(p, u), jssd.ssd_forward(p, jcfg, u)[0]),
        argnums=(0, 1), has_aux=True))
    (_, jy32), jg32 = jgrad(*jax.tree.map(
        lambda a: a.astype(jnp.float32), (jp, ju)))
    assert not all(bool(jnp.all(jnp.isfinite(g)))
                   for g in jax.tree.leaves(jg32))
    y32, g32 = grads(*tree_map(lambda t: t.float(), (tp, tu)))
    assert all(bool(torch.isfinite(g).all()) for g in g32)
    close(y32, jy32)
    _, jg = jgrad(jp, ju)
    assert not all(bool(jnp.all(jnp.isfinite(g)))
                   for g in jax.tree.leaves(jg))
    w = w[:, :48]
    _, jg = jgrad(jp, ju[:, :48])
    _, g = grads(tp, tu[:, :48])
    for got, want in zip(g, jax.tree.leaves(jg)):
        assert bool(jnp.all(jnp.isfinite(want)))
        close(got, want)


# --------------------------------------------------------------- (c) MLA

def test_mla_self_attention_matches_jax():
    jcfg, cfg, jp, tp = carried(jmla.init_mla, "deepseek-v2-236b", 4)
    ju, tu = _u(np.random.default_rng(6), 2, 20, cfg.d_model, 1.0)
    pos = np.arange(20)
    want = jit(jmla.mla_self_attention)(jp, jcfg, ju, jnp.asarray(pos))
    got = mla.mla_self_attention(tp, cfg, tu, torch.from_numpy(pos))
    close(got, want)


@pytest.mark.parametrize("window", [0, 8])
def test_mla_decode_matches_jax(window):
    """12 decode steps from an empty cache: the full cache (every slot up
    to pos valid), and a ring of 8 slots (the slots wrap at step 8)."""
    jcfg, cfg, jp, tp = carried(jmla.init_mla, "deepseek-v2-236b", 5,
                                sliding_window=window)
    jc = jmla.init_mla_cache(jcfg, 2, 12, jnp.float64)
    c = mla.init_mla_cache(cfg, 2, 12, torch.float64, device="cpu")
    assert c["c_kv"].shape[1] == (window or 12)
    ju, tu = _u(np.random.default_rng(7), 2, 12, cfg.d_model, 1.0)
    decode = jit(jmla.mla_decode)
    for t in range(12):
        jy, jc = decode(jp, jcfg, ju[:, t:t + 1], jc, t)
        y, c = mla.mla_decode(tp, cfg, tu[:, t:t + 1], c, t)
        close(y, jy)
        _close_tree(c, jc)


# --------------------------------------------------------------- (d) MoE

def _tied_tokens(rng, t, d):
    """t tokens of which every third repeats the one before it: equal
    router scores, and equal combine weights for the capacity top-C."""
    x = rng.standard_normal((t, d))
    x[2::3] = x[1::3][:len(x[2::3])]
    return x


def test_moe_routing_and_capacity_indices_equal_jax():
    jcfg = jconfigs.get_arch("granite-moe-1b-a400m").reduced(dtype="float64")
    cfg = configs.get_arch("granite-moe-1b-a400m").reduced(dtype="float64")
    rng = np.random.default_rng(8)
    x = _tied_tokens(rng, 30, cfg.d_model)
    router = 0.02 * rng.standard_normal((cfg.d_model, cfg.num_experts))
    router[:, 3] = router[:, 1]                 # tied experts in every row
    k = cfg.experts_per_tok
    jprobs = jax.nn.softmax((jnp.asarray(x) @ router).astype(jnp.float32))
    jw, ji = jax.lax.top_k(jprobs, k)
    probs, w, i = moe.route(torch.from_numpy(x), torch.from_numpy(router), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert (np.asarray(ji) == 1).any() and not (np.asarray(ji) == 3).all()
    close(probs, jprobs)

    jw = jw / jnp.maximum(jw.sum(-1, keepdims=True), 1e-9)
    close(w, jw)
    combine = np.zeros((30, cfg.num_experts), np.float32)
    np.put_along_axis(combine, np.asarray(ji), np.asarray(jw), axis=-1)
    for dropless in (False, True):
        cap = moe.capacity(cfg, 30, dropless)
        score = jnp.where(combine.T > 0, combine.T, -1.0)
        jsw, jst = jax.lax.top_k(score, cap)
        sw, st = moe.select(torch.from_numpy(combine), cap)
        np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
        np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))


@pytest.mark.parametrize("arch,groups", [("granite-moe-1b-a400m", 1),
                                         ("granite-moe-1b-a400m", 3),
                                         ("deepseek-v2-236b", 1),
                                         ("deepseek-v2-236b", 2)])
@pytest.mark.parametrize("dropless", [False, True])
def test_apply_moe_matches_jax(arch, groups, dropless):
    """The block (1 group) and grouped dispatch, capacity and dropless,
    deepseek with its shared expert; on tied tokens."""
    jcfg, cfg, jp, tp = carried(jmoe.init_moe, arch, 6, moe_groups=groups)
    rng = np.random.default_rng(9)
    x = _tied_tokens(rng, 2 * 18, cfg.d_model).reshape(2, 18, cfg.d_model)
    jy, jaux = jit(jmoe.apply_moe, "dropless")(jp, jcfg, jnp.asarray(x),
                                              dropless=dropless)
    y, aux = moe.apply_moe(tp, cfg, torch.from_numpy(x), dropless=dropless)
    close(y, jy)
    close(aux, jaux)


# ----------------------------------------------------------- (e) shardctx

def test_sharding_rules_refuse_rules():
    """Rules hold for the enclosed calls and are reset after, and a plain
    tensor passes every rule unchanged (tests/test_torch_dryrun*.py run
    them on DTensors)."""
    x = torch.ones(3)
    with shardctx.sharding_rules(None):
        assert shardctx.constrain(x, "residual") is x
    rules = {"residual": shardctx.NamedSharding(None, shardctx.P("data"))}
    with shardctx.sharding_rules(rules):
        assert shardctx._RULES.get() is rules
        assert shardctx.constrain(x, "residual") is x
    assert shardctx._RULES.get() is None
