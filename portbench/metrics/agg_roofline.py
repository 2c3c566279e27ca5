"""The aggregation engine's calls against their roofline: the sum of each
call's bound (its real edges' FLOPs at 165 TFLOP/s or its bytes at
3.35 TB/s, whichever is longer) over the sum of their measured times, in %."""
from benchlib import work


def read(ctx):
    spans = ctx["agg_spans"]
    measured = sum(s for _, _, s in spans)
    if not spans or measured <= 0:
        return None
    bound = 0.0
    for method, w, _ in spans:
        flops, nbytes = work.agg_call_work(
            method, ctx["counts"], w["fin"], w.get("fout"),
            w.get("with_z", True), w.get("phase"))
        bound += work.bound_seconds(flops, nbytes)
    if bound <= 0:
        return None
    return 100.0 * bound / measured
