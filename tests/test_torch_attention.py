"""The port's flash-attention slice against the JAX package's, on the same
numpy-seeded inputs.

(a) flash_attention_plain against the JAX Pallas kernel (interpret mode, as
    tests/test_kernels.py runs it), at the JAX tests' bars: atol 2e-5 in
    f32, 5e-2 in bf16; GQA groups 1, 2, 4 and MQA, d 32 and 64, causal and
    not, windows 0, 100 and 192, blocks of 128, and rows without any
    unmasked key (T < S), where both give the mean of v;
(b) the oracles mha_ref and spmm_ref, and blockwise_attention, against the
    JAX ones;
(c) the attention layer on the reduced qwen3-8b, starcoder2-3b and
    recurrentgemma-2b configs, parameters carried over with
    attention_params_from_jax: self_attention on the dense path and on the
    blockwise path, gated cross_attention, prefill_attention plus 4
    decode_attention steps with full and ring caches;
(d) the shared layers (norms, RoPE, MLPs, embeddings), the configs
    field by field, and ops.attention on the CPU (the plain version,
    bitwise, with no kernel launch).
The JAX layer casts its scores to f32 even in float64 (x64 is on, as in the
other test_torch_* files), so the layer bar is 1e-5, not the 1e-12 of the
GCN step. The CUDA kernel is held against flash_attention_plain on the
card by tests/test_torch_cuda.py.
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
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import spans  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import attention, layers  # noqa: E402

ATOL = {"float32": 2e-5, "bfloat16": 5e-2}    # tests/test_kernels.py's bars
LAYER_TOL = 1e-5      # scores in f32 in both packages, whatever the inputs
ARCHS = ("qwen3-8b", "starcoder2-3b", "recurrentgemma-2b")


def _qkv(rng, b, s, t, h, kh, d):
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, t, kh, d)).astype(np.float32),
            rng.standard_normal((b, t, kh, d)).astype(np.float32))


def _torch(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x)).to(dtype)


# --------------------------------------------------- (a) the kernel's body

# (B, S, T, H, K, d, causal, window): every GQA group, both head widths,
# both mask kinds, every window
FLASH_CASES = [
    (1, 256, 256, 4, 4, 32, True, 0),        # group 1
    (2, 256, 256, 4, 2, 64, True, 192),      # group 2
    (1, 512, 512, 4, 1, 32, True, 100),      # MQA
    (1, 384, 384, 8, 2, 64, False, 0),       # group 4
    (1, 512, 512, 8, 2, 32, False, 192),
    (2, 256, 256, 2, 1, 64, False, 100),
    (1, 512, 512, 4, 4, 64, True, 0),
    (1, 128, 384, 4, 2, 32, True, 0),        # T > S
]


@pytest.mark.parametrize("b,s,t,h,kh,d,causal,window", FLASH_CASES)
def test_flash_plain_matches_jax_kernel(b, s, t, h, kh, d, causal, window):
    rng = np.random.default_rng(s + t + h + kh + d + window + causal)
    q, k, v = _qkv(rng, b, s, t, h, kh, d)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window, q_block=128,
                             kv_block=128))
    got = fa.flash_attention_plain(_torch(q), _torch(k), _torch(v),
                                   causal=causal, window=window, q_block=128,
                                   kv_block=128)
    assert got.dtype == torch.float32 and got.shape == (b, s, h, d)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL["float32"],
                               rtol=0)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 100)])
def test_flash_plain_matches_jax_kernel_bf16(causal, window):
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 1, 256, 256, 4, 2, 64)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    want = np.asarray(jflash(*jb, causal=causal, window=window, q_block=128,
                             kv_block=128), np.float32)
    tb = [_torch(x).to(torch.bfloat16) for x in (q, k, v)]
    got = fa.flash_attention_plain(*tb, causal=causal, window=window,
                                   q_block=128, kv_block=128)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=ATOL["bfloat16"], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_rows_without_unmasked_keys_average_v(dtype):
    """S = 512 queries over T = 128 keys, window 100, not causal: queries
    227 on have no key inside their window. Masked scores are -1e30, not
    -inf, so those rows get the mean of v over all T keys, in the JAX
    kernel and in the port."""
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 1, 512, 128, 4, 2, 32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(jflash(*[jnp.asarray(x, jd) for x in (q, k, v)],
                             causal=False, window=100, q_block=128,
                             kv_block=128), np.float32)
    tq, tk, tv = (_torch(x).to(td) for x in (q, k, v))
    got = fa.flash_attention_plain(tq, tk, tv, causal=False, window=100,
                                   q_block=128, kv_block=128).float().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL[dtype], rtol=0)
    dead = slice(128 + 100 - 1, None)
    mean_v = tv.float().mean(dim=1)                    # (1, K, d)
    expect = mean_v.repeat_interleave(2, dim=1)[:, None]   # (1, 1, H, d)
    np.testing.assert_allclose(got[:, dead], np.broadcast_to(
        expect.numpy(), got[:, dead].shape), atol=ATOL[dtype], rtol=0)
    assert np.abs(got[:, :dead.start] - got[:, dead.start:dead.start + 1]
                  ).max() > 0.1                        # the live rows differ


def test_flash_wrapper_keeps_the_divisibility_checks():
    """S % q_block and T % kv_block must be 0, as the JAX kernel asserts."""
    x = torch.zeros(1, 200, 2, 32)
    with pytest.raises(AssertionError):
        jflash(jnp.zeros((1, 200, 2, 32)), jnp.zeros((1, 200, 2, 32)),
               jnp.zeros((1, 200, 2, 32)), q_block=128, kv_block=128)
    with pytest.raises(ValueError, match="multiples"):
        fa.flash_attention(x, x, x, q_block=128, kv_block=128)
    with pytest.raises(ValueError, match="multiples"):
        ops.attention(x[:, :128], x, x, q_block=128, kv_block=128)
    with pytest.raises(ValueError, match="multiples"):
        fa.flash_attention_plain(x[:, :128], x[:, :128], x[:, :128],
                                 q_block=96, kv_block=128)


def test_ops_attention_on_the_cpu_is_the_plain_version():
    """ops.attention on CPU tensors: the plain version, bitwise, and no
    kernel launch counted."""
    rng = np.random.default_rng(11)
    q, k, v = (_torch(x) for x in _qkv(rng, 1, 256, 256, 4, 2, 32))
    before = spans.counter("flash_attention.flash_attention")
    got = ops.attention(q, k, v, causal=True, window=100, q_block=128,
                        kv_block=128)
    want = fa.flash_attention_plain(q, k, v, causal=True, window=100,
                                    q_block=128, kv_block=128)
    assert torch.equal(got, want)
    assert spans.counter("flash_attention.flash_attention") == before


# ------------------------------------------------------------ (b) oracles

@pytest.mark.parametrize("causal,window,shift", [(True, 0, 0), (True, 24, 0),
                                                 (False, 0, 0),
                                                 (True, 16, 40)])
def test_mha_ref_matches_jax(causal, window, shift):
    """Dense GQA oracle, float64 inputs, with explicit positions (queries
    shifted by `shift`, as a prefill continuing a cache sees them)."""
    rng = np.random.default_rng(shift + window)
    q = rng.standard_normal((2, 48, 4, 16))
    k = rng.standard_normal((2, 96, 2, 16))
    v = rng.standard_normal((2, 96, 2, 16))
    pos = np.arange(48) + shift
    want = np.asarray(jref.mha_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window, positions=jnp.asarray(pos)))
    got = ref.mha_ref(_torch(q, torch.float64), _torch(k, torch.float64),
                      _torch(v, torch.float64), causal=causal, window=window,
                      positions=torch.from_numpy(pos))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, atol=LAYER_TOL,
                               rtol=LAYER_TOL)


def test_spmm_ref_matches_jax():
    rng = np.random.default_rng(2)
    n, tile, f = 7, 128, 24
    rows = np.array([0, 0, 1, 2, 2, 2, 3], np.int32)
    cols = rng.integers(0, 3, n).astype(np.int32)
    vals = rng.standard_normal((n, tile, tile)).astype(np.float32)
    h = rng.standard_normal((3 * tile, f)).astype(np.float32)
    want = np.asarray(jref.spmm_ref(jnp.asarray(rows), jnp.asarray(cols),
                                    jnp.asarray(vals), jnp.asarray(h),
                                    4 * tile))
    got = ref.spmm_ref(torch.from_numpy(rows), torch.from_numpy(cols),
                       torch.from_numpy(vals), torch.from_numpy(h), 4 * tile)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("causal,window,dtype", [
    (True, 0, "float64"), (True, 100, "float32"), (False, 0, "float64"),
    (False, 192, "float32")])
def test_blockwise_attention_matches_jax(causal, window, dtype):
    rng = np.random.default_rng(window + causal)
    q, k, v = (x.astype(dtype) for x in _qkv(rng, 2, 512, 512, 4, 2, 32))
    pos = np.arange(512)
    want = np.asarray(jattn.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        causal, window, q_block=128, kv_block=128))
    td = getattr(torch, dtype)
    got = attention.blockwise_attention(
        _torch(q, td), _torch(k, td), _torch(v, td), torch.from_numpy(pos),
        causal, window, q_block=128, kv_block=128)
    assert got.dtype == td
    np.testing.assert_allclose(got.numpy(), want, atol=LAYER_TOL,
                               rtol=LAYER_TOL)


def test_flash_plain_matches_blockwise_attention():
    """The kernel's body against the layer's blockwise path (the serving
    oracle), as tests/test_kernels.py holds the Pallas kernel."""
    rng = np.random.default_rng(4)
    q, k, v = (_torch(x) for x in _qkv(rng, 1, 512, 512, 4, 2, 64))
    a = fa.flash_attention_plain(q, k, v, causal=True, window=100,
                                 q_block=128, kv_block=128)
    b = attention.blockwise_attention(q, k, v, torch.arange(512), True, 100,
                                      q_block=128, kv_block=128)
    torch.testing.assert_close(a, b, atol=ATOL["float32"], rtol=0)


# ------------------------------------------------------ (c) the layer

def _layer(arch, seed=0, cross=False, **overrides):
    """The JAX layer of the reduced config (float64), with random biases,
    norm scales and gate so every parameter matters; returns the JAX
    config, the port config, the numpy params and both packages' params."""
    jcfg = jconfigs.get_arch(arch).reduced(**overrides)
    cfg = configs.get_arch(arch).reduced(**overrides)
    jp = jattn.init_attention(jax.random.PRNGKey(seed), jcfg, jnp.float64,
                              cross=cross)
    rng = np.random.default_rng(seed + 100)
    nump = {}
    for name, val in jp.items():
        a = np.asarray(val)
        if name in ("bq", "bk", "bv"):
            a = 0.1 * rng.standard_normal(a.shape)
        elif name in ("qnorm", "knorm"):
            a = 1.0 + 0.1 * rng.standard_normal(a.shape)
        elif name == "gate":
            a = np.asarray(0.7)
        nump[name] = a
    return (jcfg, cfg, {k: jnp.asarray(v) for k, v in nump.items()},
            attention.attention_params_from_jax(nump, "cpu"))


def _x(rng, b, s, d):
    return rng.standard_normal((b, s, d))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=LAYER_TOL, rtol=LAYER_TOL)


def test_attention_params_from_jax_keep_every_field():
    jcfg, cfg, jp, tp = _layer("starcoder2-3b", cross=True)
    assert set(tp) == set(jp) == {"wq", "wk", "wv", "wo", "bq", "bk", "bv",
                                  "gate"}
    for name in jp:
        assert tp[name].dtype == torch.float64
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(jp[name]))
    jq = jattn.init_attention(jax.random.PRNGKey(0), jconfigs.get_arch(
        "qwen3-8b").reduced(), jnp.bfloat16)
    tq = attention.attention_params_from_jax(
        {k: np.asarray(v) for k, v in jq.items()}, "cpu")
    assert tq["qnorm"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tq["wq"].float().numpy(),
                                  np.asarray(jq["wq"], np.float32))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("causal", [True, False])
def test_self_attention_dense_path_matches_jax(arch, causal):
    jcfg, cfg, jp, tp = _layer(arch)
    rng = np.random.default_rng(1)
    x = _x(rng, 2, 64, jcfg.d_model)
    pos = np.arange(64)
    want = jattn.self_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                causal=causal)
    got = attention.self_attention(tp, cfg, torch.from_numpy(x),
                                   torch.from_numpy(pos), causal=causal)
    assert got.shape == (2, 64, cfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_self_attention_blockwise_path_matches_jax(arch):
    """S = 5120 > BLOCKWISE_THRESHOLD and a multiple of Q_BLOCK: both
    packages take the blockwise path (narrow widths: d_model 64, 2 heads)."""
    s = 5120
    assert s > attention.BLOCKWISE_THRESHOLD and s % attention.Q_BLOCK == 0
    jcfg, cfg, jp, tp = _layer(arch, d_model=64, num_heads=2, num_kv_heads=1,
                               head_dim=16)
    rng = np.random.default_rng(2)
    x = _x(rng, 1, s, 64)
    pos = np.arange(s)
    want = jattn.self_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = attention.self_attention(tp, cfg, torch.from_numpy(x),
                                   torch.from_numpy(pos))
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attention_gated_matches_jax(arch):
    jcfg, cfg, jp, tp = _layer(arch, cross=True)
    rng = np.random.default_rng(3)
    x, mem = _x(rng, 2, 20, jcfg.d_model), _x(rng, 2, 12, jcfg.d_model)
    for gated in (False, True):
        want = jattn.cross_attention(jp, jcfg, jnp.asarray(x),
                                     jnp.asarray(mem), gated=gated)
        got = attention.cross_attention(tp, cfg, torch.from_numpy(x),
                                        torch.from_numpy(mem), gated=gated)
        _close(got, want)


# arch -> prompt length: qwen3-8b has no window (full cache); starcoder2-3b
# (reduced window 16) prefills 24 tokens into the ring layout; recurrentgemma-2b
# (window 16) prefills 14, and its decode steps wrap the ring at 16
DECODE_PROMPTS = {"qwen3-8b": 20, "starcoder2-3b": 24, "recurrentgemma-2b": 14}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    jcfg, cfg, jp, tp = _layer(arch)
    s, steps = DECODE_PROMPTS[arch], 4
    rng = np.random.default_rng(5)
    x = _x(rng, 2, s, jcfg.d_model)
    pos = np.arange(s)
    jcache = jattn.init_kv_cache(jcfg, 2, s + steps, jnp.float64)
    cache = attention.init_kv_cache(cfg, 2, s + steps, torch.float64,
                                    device="cpu")
    ring = bool(cfg.sliding_window) and cache["k"].shape[1] < s + steps
    assert ring == (arch != "qwen3-8b")
    want, jcache = jattn.prefill_attention(jp, jcfg, jnp.asarray(x),
                                           jnp.asarray(pos), jcache)
    got, cache = attention.prefill_attention(tp, cfg, torch.from_numpy(x),
                                             torch.from_numpy(pos), cache)
    _close(got, want)
    for name in ("k", "v"):
        _close(cache[name], jcache[name])
    for step in range(steps):
        xt = _x(rng, 2, 1, jcfg.d_model)
        want, jcache = jattn.decode_attention(jp, jcfg, jnp.asarray(xt),
                                              jcache, s + step)
        got, cache = attention.decode_attention(tp, cfg, torch.from_numpy(xt),
                                                cache, s + step)
        _close(got, want)
        for name in ("k", "v"):
            _close(cache[name], jcache[name])


# -------------------------------------------- (d) layers, configs, entry

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_and_rope_match_jax(kind):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 10, 3, 32))
    p = {"scale": rng.standard_normal(32), "bias": rng.standard_normal(32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _close(layers.apply_norm(tp, torch.from_numpy(x), kind),
           jlayers.apply_norm(jp, jnp.asarray(x), kind))
    _close(layers.rms_head_norm(tp["scale"], torch.from_numpy(x)),
           jlayers.rms_head_norm(jp["scale"], jnp.asarray(x)))
    pos = np.arange(10) + 1000
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    np.testing.assert_array_equal(layers.rope_freqs(64, 1e4),
                                  jlayers.rope_freqs(64, 1e4))
    np.testing.assert_array_equal(layers.sinusoidal_positions(12, 16),
                                  jlayers.sinusoidal_positions(12, 16))
    init = layers.init_norm(torch.float32, 8, kind, device="cpu")
    jinit = jlayers.init_norm(jnp.float32, 8, kind)
    assert {k: v.tolist() for k, v in init.items()} == {
        k: np.asarray(v).tolist() for k, v in jinit.items()}


@pytest.mark.parametrize("act,bias", [("swiglu", False), ("geglu", True),
                                      ("gelu", True)])
def test_mlp_and_embeddings_match_jax(act, bias):
    jp = jlayers.init_mlp(jax.random.PRNGKey(0), jnp.float64, 16, 40, act,
                          bias)
    rng = np.random.default_rng(8)
    p = {k: np.asarray(v) + (0.1 * rng.standard_normal(np.shape(v))
                             if k.startswith("b") else 0)
         for k, v in jp.items()}
    x = rng.standard_normal((3, 5, 16))
    _close(layers.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), act),
           jlayers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), act))
    gen = torch.Generator().manual_seed(0)
    tp = layers.init_mlp(gen, torch.float32, 16, 40, act, bias)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    table = rng.standard_normal((50, 16))
    tokens = np.array([[3, 0, 49], [7, 7, 1]])
    emb = layers.apply_embed({"table": torch.from_numpy(table)},
                             torch.from_numpy(tokens))
    jemb = jlayers.apply_embed({"table": jnp.asarray(table)},
                               jnp.asarray(tokens))
    np.testing.assert_array_equal(emb.numpy(), np.asarray(jemb))
    head = {"w": rng.standard_normal((16, 50))}
    for tie in (True, False):
        _close(layers.unembed_logits({"table": torch.from_numpy(table)},
                                     {"w": torch.from_numpy(head["w"])},
                                     emb, tie),
               jlayers.unembed_logits({"table": jnp.asarray(table)},
                                      {"w": jnp.asarray(head["w"])}, jemb,
                                      tie))
    e = layers.init_embed(gen, torch.float32, 50, 16)["table"]
    assert e.shape == (50, 16) and 0.01 < float(e.std()) < 0.03


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_equal_the_jax_configs(arch):
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    port, jax_cfg = configs.get_arch(arch), jconfigs.get_arch(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_cfg)
    assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(
        jax_cfg.reduced())
    for prop in ("resolved_head_dim", "padded_vocab", "is_encdec",
                 "attention_free", "d_inner", "ssm_nheads"):
        assert getattr(port, prop) == getattr(jax_cfg, prop), prop
    assert port.layer_kinds() == jax_cfg.layer_kinds()


def test_config_registry_refuses_unknown_ids_and_keeps_input_shapes():
    from repro.models.config import INPUT_SHAPES as JSHAPES
    from repro_torch.models import INPUT_SHAPES
    with pytest.raises(KeyError):
        configs.get_arch("gpt-5")
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()}


def test_init_attention_shapes_match_jax():
    for arch in ARCHS:
        cfg = configs.get_arch(arch).reduced()
        jp = jattn.init_attention(jax.random.PRNGKey(0),
                                  jconfigs.get_arch(arch).reduced(),
                                  jnp.float32, cross=True)
        tp = attention.init_attention(torch.Generator().manual_seed(0), cfg,
                                      torch.float32, cross=True)
        assert {k: tuple(v.shape) for k, v in tp.items()} == {
            k: tuple(v.shape) for k, v in jp.items()}
        for name in ("bq", "bk", "bv", "qnorm", "knorm", "gate"):
            if name in jp:
                np.testing.assert_array_equal(tp[name].numpy(),
                                              np.asarray(jp[name]))
