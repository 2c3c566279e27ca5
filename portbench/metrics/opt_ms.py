"""Device time of the optimizer, in ms per epoch: the program's own
``repro.opt`` span (CUDA events around Adam's update in each training
step of the window's run, ``repro_torch.spans.last_run()``), which counts
Adam's kernels and the card's waits for their launches."""


def read(ctx):
    try:
        from repro_torch import spans
    except ImportError:
        return None
    run = spans.last_run()
    if not run or run["epochs"] != ctx["epochs"]:
        return None
    seconds = run["device_s"].get("repro.opt")
    if seconds is None:
        return None
    return 1e3 * seconds / run["epochs"]
