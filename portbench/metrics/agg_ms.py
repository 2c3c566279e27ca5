"""Device time of the outermost aggregation-engine calls (CUDA events
around each), in ms per epoch."""


def read(ctx):
    if not ctx["agg_spans"]:
        return None
    return 1e3 * sum(s for _, _, s in ctx["agg_spans"]) / ctx["epochs"]
