"""Device time of the dense products' kernels (GEMM kernels by name), in
ms per epoch."""
from benchlib.trace import GEMM_KERNEL


def read(ctx):
    ns = sum(e - s for name, s, e in ctx["device_events"]
             if GEMM_KERNEL.search(name))
    if not ns:
        return None
    return ns / 1e6 / ctx["epochs"]
