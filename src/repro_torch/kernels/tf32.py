"""numpy emulation of the tensor cores' TF32 arithmetic, for the CPU tests.

The CUDA kernels multiply f32 operands in 3×TF32 (``mma.sync`` with
``.tf32`` operands): each operand x is split into hi = cvt.rna.tf32(x) and
lo = x − hi, which the tensor cores read truncated to TF32, and an f32
accumulator takes lo·hi, hi·lo and hi·hi. None of that runs on the CPU, so
the tests emulate it with these three roundings.
"""
from __future__ import annotations

import numpy as np


def rna(x):
    """float32 -> TF32 (10 mantissa bits), rounded to nearest with ties
    away from zero: cvt.rna.tf32.f32."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def truncate(x):
    """The tf32 value the tensor cores read from f32 bits: the low 13
    mantissa bits dropped."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def toward_zero(x64):
    """float64 -> float32 rounded toward zero: the worse of the roundings
    the tensor cores' f32 accumulation may apply."""
    bits = np.ascontiguousarray(x64, np.float64).view(np.uint64)
    # the low 29 of float64's 52 mantissa bits dropped: the f32 value
    # toward zero, exact in the conversion (normal f32 range)
    return (bits & np.uint64(~((1 << 29) - 1) & (2**64 - 1))).view(
        np.float64).astype(np.float32)


def split(x, lo_rounded: bool = False):
    """The 3×TF32 split of an f32 array: (hi, lo) as the tensor cores read
    them; lo rounded to nearest (a second cvt.rna) when `lo_rounded`, as
    the fused kernels' 4×TF32 epilogue splits."""
    hi = rna(x)
    return hi, (rna if lo_rounded else truncate)(x - hi)


def mma_chain(acc, a, b, passes: int, k_step: int = 8):
    """acc (M, N) f32 plus a (M, K) @ b (K, N) as chained m16n8k8 steps:
    per k_step-deep step, each pass's products summed exactly and added to
    the accumulator with one rounding toward zero. passes = 3 takes lo·hi,
    hi·lo and hi·hi of the split operands (3×TF32), passes = 1 hi·hi."""
    (ahi, alo), (bhi, blo) = split(a), split(b)
    terms = ([(alo, bhi), (ahi, blo), (ahi, bhi)] if passes == 3
             else [(ahi, bhi)])
    for k in range(0, a.shape[1], k_step):
        for x, y in terms:
            acc = toward_zero(acc + x[:, k:k + k_step].astype(np.float64)
                              @ y[k:k + k_step])
    return acc
