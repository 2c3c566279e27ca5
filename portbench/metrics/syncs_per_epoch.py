"""Host waits on the card per epoch: the program's counter ``sync.host``
over the window's run (``repro_torch.spans.last_run()``), one per read of
a device value, synchronize or blocking upload from the host in the
training loop."""


def read(ctx):
    try:
        from repro_torch import spans
    except ImportError:
        return None
    run = spans.last_run()
    if not run or run["epochs"] != ctx["epochs"]:
        return None
    syncs = run["counters"].get("sync.host")
    if syncs is None:
        return None
    return syncs / run["epochs"]
