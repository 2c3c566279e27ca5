"""Device time of the boundary exchange, in ms per epoch: the program's
own ``repro.exchange`` spans (CUDA events around the gather, encode,
exchange or its start, wait, decode, unpack and buffer update, and around
the side stream's copy, ``repro_torch.spans.last_run()``), summed over the
streams they ran on."""


def read(ctx):
    try:
        from repro_torch import spans
    except ImportError:
        return None
    run = spans.last_run()
    if not run or run["epochs"] != ctx["epochs"]:
        return None
    seconds = run["device_s"].get("repro.exchange")
    if seconds is None:
        return None
    return 1e3 * seconds / run["epochs"]
