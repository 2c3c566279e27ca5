"""The flash-attention kernel's arithmetic, on the CPU.

csrc/flash_attention.cu multiplies on the tensor cores: bf16 inputs with
mma.sync m16n8k16 (f32 accumulation, p rounded to bf16 once before p·v),
f32 inputs in 3×TF32 with mma.sync m16n8k8. Neither runs here, so this
file emulates the kernel's arithmetic in numpy, one head at a time, tile by
tile as the kernel walks the keys, and holds it to flash_attention_plain:

  * f32: q·kᵀ as one chain of 3×TF32 steps over the head dim (each step
    rounded toward zero, the worse of the tensor cores' roundings), the
    masks and the online softmax in f32 (exp2 of the scores in log2 units,
    a masked score -1e30), and each kv tile's p·v in 3×TF32 on a fresh
    accumulator added to acc·alpha in f32: within rtol = atol = 2e-5 (the
    card's bar) at S = T = 2048, d = 128 and 256, causal and windowed,
    while 1×TF32 (hi·hi only) misses that bar;
  * bf16: q·kᵀ of bf16 inputs summed in f32, p rounded to bf16 once:
    every row within BF16_ROW_REL of its norm.

The kernel itself is held against flash_attention_plain on the card by
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import tf32

LOG2E = 1.4426950408889634
BK = 64        # keys per tile: the longest p·v chain the kernel's tiles take
S_LEN = 2048
F32_BAR = 2e-5


def _emulate(q, k, v, causal: bool, window: int, passes: int,
             bf16: bool = False):
    """One head as the kernel computes it: q (S, d), k and v (T, d) float32
    (bf16 values when bf16) -> (S, d) float32."""
    s_len, d = q.shape
    t_len = k.shape[0]
    c = np.float32(LOG2E / np.sqrt(d))
    if bf16:   # bf16 products are exact in f32; the sum is f32
        scores = (q.astype(np.float64) @ k.T.astype(np.float64)).astype(
            np.float32)
    else:
        scores = tf32.mma_chain(np.zeros((s_len, t_len), np.float32), q,
                                k.T, passes)
    rows = np.arange(s_len)[:, None]
    m = np.full(s_len, -np.inf, np.float32)
    l = np.zeros(s_len, np.float32)
    acc = np.zeros((s_len, d), np.float32)
    for k0 in range(0, t_len, BK):
        cols = np.arange(k0, min(k0 + BK, t_len))[None, :]
        x = scores[:, k0:k0 + BK] * c
        masked = np.zeros(x.shape, bool)
        if causal:
            masked |= cols > rows
        if window:
            masked |= rows - cols >= window
        x = np.where(masked, np.float32(-1e30), x)
        m_new = np.maximum(m, x.max(axis=1))
        alpha = np.exp2(m - m_new)
        p = np.exp2(x - m_new[:, None])
        l = l * alpha + p.sum(axis=1, dtype=np.float32)
        vt = v[k0:k0 + BK]
        if bf16:
            pb = torch.from_numpy(p).bfloat16().float().numpy()
            fresh = (pb.astype(np.float64) @ vt).astype(np.float32)
        else:
            fresh = tf32.mma_chain(np.zeros((s_len, d), np.float32), p, vt,
                                   passes)
        acc = acc * alpha[:, None] + fresh
        m = m_new
    return acc / np.maximum(l, np.float32(1e-30))[:, None]


def _inputs(d: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((S_LEN, d)).astype(np.float32)
            for _ in range(3)]


def _plain(q, k, v, causal, window, dtype=torch.float32):
    t = [torch.from_numpy(x)[None, :, None].to(dtype) for x in (q, k, v)]
    return fa.flash_attention_plain(*t, causal=causal, window=window)[0, :, 0]


def _within(got, want, tol=F32_BAR):
    return bool(np.all(np.abs(got - want) <= tol + tol * np.abs(want)))


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 512)])
def test_3xtf32_flash_keeps_the_f32_bar(d, causal, window):
    """3×TF32 with a fresh p·v fragment per kv tile stays within rtol =
    atol = 2e-5 of flash_attention_plain over 2048 keys; 1×TF32 does
    not."""
    q, k, v = _inputs(d, seed=d + window)
    want = _plain(q, k, v, causal, window).numpy()
    got = _emulate(q, k, v, causal, window, passes=3)
    assert np.isfinite(got).all()
    assert _within(got, want), float(np.abs(got - want).max())
    one = _emulate(q, k, v, causal, window, passes=1)
    assert not _within(one, want), float(np.abs(one - want).max())


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 512)])
def test_bf16_flash_rounds_p_once_within_the_row_bar(causal, window):
    """bf16 inputs, f32 sums, p rounded to bf16 once before p·v, the
    output in bf16: every row within BF16_ROW_REL of its norm against
    flash_attention_plain on the same bf16 inputs."""
    q, k, v = (torch.from_numpy(x).bfloat16().float().numpy()
               for x in _inputs(128, seed=7))
    want = _plain(q, k, v, causal, window, torch.bfloat16)
    got = torch.from_numpy(_emulate(q, k, v, causal, window, passes=3,
                                    bf16=True)).bfloat16()
    assert fa.assert_rows_close(got, want, fa.BF16_ROW_REL) < fa.BF16_ROW_REL
