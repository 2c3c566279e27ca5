"""Device helpers shared by every layer of the port: where an entry point
runs, and the f32 setting of the dense products."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. The default is the card; asking
    for CUDA without one raises — the port never drops to the CPU unless
    the caller passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' to run the port on the CPU")
    return dev


def synchronize(device: torch.device):
    """Wait for the work queued on `device` (a no-op on the CPU), so a host
    clock read after it times the device's work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def exact_f32_matmul():
    """Keep the dense products in full float32 on the card (no TF32): the
    JAX package computes them in f32, and the port's kernels keep f32
    accuracy (f32 FMA, or 3×TF32 on the tensor cores in the spmm pair);
    plain TF32 would not."""
    torch.backends.cuda.matmul.allow_tf32 = False
