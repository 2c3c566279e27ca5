"""Flash attention: blockwise online-softmax GQA attention with causal and
sliding-window masks — the prefill hot path.

Port of the JAX package's ``repro.kernels.flash_attention``. On a CUDA
tensor `flash_attention` launches a hand-written CUDA kernel for Hopper's
tensor cores (``csrc/flash_attention.cu``: bf16 mma.sync for bf16, 3×TF32
for f32), which replaces the Pallas kernel
``flash_attention``; on a CPU tensor it runs `flash_attention_plain`, the
plain PyTorch version, which walks the (q_block, kv_block) grid as the
Pallas kernel's body does. Nothing falls back from one to the other.

q is (B, S, H, d) and k, v are (B, T, K, d) with H % K == 0: query head h
reads kv head h // (H/K), so no repeated k or v is built. Positions are the
indices; a masked score is -1e30 (not -inf), so a query row without any
unmasked key gets the mean of v over all T keys, as in the JAX package.
Scores, softmax and the accumulator are f32; in bf16 the probabilities are
rounded to bf16 before the p·v product. The counter
``flash_attention.flash_attention`` (`repro_torch.spans`) counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import spans

DEFAULT_Q_BLOCK = 512
DEFAULT_KV_BLOCK = 512
NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)     # the head widths the CUDA kernel is built for
_DTYPES = {torch.float32: "flash_attention_f32",
           torch.bfloat16: "flash_attention_bf16"}


# bf16 bar of the kernel against flash_attention_plain, per output row
BF16_ROW_REL = 1e-2


def assert_rows_close(got, want, rel: float, what: str = "") -> float:
    """In every row (all indices but the last), ||got - want|| <= rel ·
    ||want|| over the last axis, in f32. The bf16 bar: rounding p and the
    output to bf16 moves a row by a few 1e-3 of its norm, while a row of an
    8192-long causal attention has |out| ~ sqrt(keys it weighs / position),
    often below 0.05, so an absolute bar would hide a lost key tile or a
    wrong kv head there. Returns the largest row's ratio."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all(), f"{what}: non-finite values"
    err = torch.linalg.vector_norm(got - want, dim=-1)
    norm = torch.linalg.vector_norm(want, dim=-1)
    bad = err > rel * norm
    if bad.any():
        i = tuple(int(j) for j in bad.nonzero()[0])
        raise AssertionError(
            f"{what}: {int(bad.sum())} rows off by more than {rel} of their "
            f"norm; row {i}: {float(err[i]):.3g} vs norm {float(norm[i]):.3g}")
    return float((err / norm.clamp(min=1e-30)).max())


def _check_blocks(s: int, t: int, q_block: int, kv_block: int):
    """The JAX kernel's grid condition: S % q_block == 0, T % kv_block == 0."""
    if s % q_block or t % kv_block:
        raise ValueError(f"flash_attention: S {s} and T {t} must be multiples "
                         f"of q_block {q_block} and kv_block {kv_block}")


def flash_attention_plain(q, k, v, causal: bool = True, window: int = 0,
                          q_block: int = DEFAULT_Q_BLOCK,
                          kv_block: int = DEFAULT_KV_BLOCK) -> torch.Tensor:
    """The Pallas kernel's body in PyTorch, block by block: per q block, the
    running max m (from -inf), sum l (from 0) and accumulator over the kv
    blocks; s = (q·kᵀ in f32)·scale, masked scores -1e30, alpha =
    exp(m_prev − m_new), p cast to v's dtype before p·v, out = acc /
    max(l, 1e-30) in q's dtype. All batches and heads at once."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    _check_blocks(s, t, q_block, kv_block)
    g = h // kh
    scale = 1.0 / (d ** 0.5)
    f32 = torch.float32
    qg = q.reshape(b, s, kh, g, d).permute(0, 2, 3, 1, 4)   # (B, K, G, S, d)
    kg = k.permute(0, 2, 1, 3)[:, :, None]                  # (B, K, 1, T, d)
    vg = v.permute(0, 2, 1, 3)[:, :, None]
    pos = torch.arange(max(s, t), device=q.device)
    out = torch.empty(b, kh, g, s, d, dtype=q.dtype, device=q.device)
    for q0 in range(0, s, q_block):
        qb = qg[..., q0:q0 + q_block, :].to(f32)
        qpos = pos[q0:q0 + q_block, None]
        m = torch.full((b, kh, g, q_block), float("-inf"), dtype=f32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, kh, g, q_block, d, dtype=f32, device=q.device)
        for k0 in range(0, t, kv_block):
            kb = kg[..., k0:k0 + kv_block, :].to(f32)
            vb = vg[..., k0:k0 + kv_block, :]
            sc = (qb @ kb.transpose(-1, -2)) * scale
            kpos = pos[None, k0:k0 + kv_block]
            mask = torch.ones(q_block, kv_block, dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= kpos <= qpos
            if window:
                mask &= qpos - kpos < window
            sc = torch.where(mask, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = (acc * alpha[..., None]
                   + p.to(v.dtype).to(f32) @ vb.to(f32))
            m = m_new
        out[..., q0:q0 + q_block, :] = (
            acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)


def _check_args(q, k, v):
    """Device, dtype, shape and stride checks before a kernel launch."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q (B, S, H, d) and k, v "
                         f"(B, T, K, d), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)} (same B and d, H % K == 0)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the CUDA kernel takes head dim "
                         f"{HEAD_DIMS}, got {d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: the CUDA kernel takes float32 or "
                        f"bfloat16 q, k, v of one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q, k, v must be on {q.device}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("flash_attention: the last (head dim) axis of q, k "
                         "and v must be contiguous")


def _aligned(x):
    """x itself when each of its rows starts 16-byte aligned (the kernel
    stages rows in 16-byte chunks), else a contiguous copy of it."""
    es = x.element_size()
    if x.data_ptr() % 16 == 0 and all(st * es % 16 == 0
                                      for st in x.stride()[:3]):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _library(defines: tuple[str, ...] = ()):
    """The kernel's library: the shipped build, or a variant with other
    compile-time tile sizes (``defines``, launch/bench_attention.py)."""
    from repro_torch.kernels._build import load
    lib = load("flash_attention", defines)
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for fn in _DTYPES.values():
            getattr(lib, fn).argtypes = (
                [vp] * 4 + [ci] * 6 + [ctypes.POINTER(ctypes.c_longlong),
                                       ctypes.c_float, ci, ci, vp])
            getattr(lib, fn).restype = ci
        lib._argtypes_set = True
    return lib


def launch(lib, q, k, v, causal: bool, window: int) -> torch.Tensor:
    """One launch of the kernel in ``lib`` on checked CUDA inputs; rows
    that are not 16-byte aligned are copied first. Counts nothing."""
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    b, s, h, d = q.shape
    out = torch.empty(b, s, h, d, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    code = getattr(lib, _DTYPES[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
        k.shape[1], h, k.shape[2], d, strides, 1.0 / (d ** 0.5), int(causal),
        int(window), torch.cuda.current_stream(q.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"flash_attention: CUDA launch failed with "
                           f"cudaError {code}")
    return out


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    q_block: int = DEFAULT_Q_BLOCK,
                    kv_block: int = DEFAULT_KV_BLOCK) -> torch.Tensor:
    """q: (B, S, H, d), k/v: (B, T, K, d) with H % K == 0 -> (B, S, H, d).

    S % q_block == 0 and T % kv_block == 0 (ValueError otherwise), as the
    JAX package asserts. On CUDA: float32 or bfloat16, d in HEAD_DIMS, the
    last axis contiguous (other strides are read as they are; an input whose
    rows are not 16-byte aligned is copied first), one kernel launch; the
    kernel tiles as it likes (the blocks change only the rounding)."""
    _check_blocks(q.shape[1], k.shape[1], q_block, kv_block)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_block=q_block, kv_block=kv_block)
    _check_args(q, k, v)
    out = launch(_library(), q, k, v, causal, window)
    spans.count("flash_attention.flash_attention")
    return out

