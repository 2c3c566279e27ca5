"""Bytes handed to the boundary exchange, in MB (1e6 bytes) per epoch: the
program's counter ``exchange.bytes`` over the window's run
(``repro_torch.spans.last_run()``), training steps and evaluations."""


def read(ctx):
    try:
        from repro_torch import spans
    except ImportError:
        return None
    run = spans.last_run()
    if not run or run["epochs"] != ctx["epochs"]:
        return None
    nbytes = run["counters"].get("exchange.bytes")
    if nbytes is None:
        return None
    return nbytes / run["epochs"] / 1e6
