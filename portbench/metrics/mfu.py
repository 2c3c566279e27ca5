"""Model FLOPs of an epoch (forward and Alg. 1 backward, the cheaper
matmul order per layer, real edges and rows) over the traced epoch time,
as a share of 3xTF32's 165 TFLOP/s, in %."""
from benchlib import work


def read(ctx):
    flops = work.epoch_flops(ctx["dims"], ctx["counts"])
    return 100.0 * flops / (ctx["epoch_ms"] / 1e3) / work.PEAK_F32_FLOPS
