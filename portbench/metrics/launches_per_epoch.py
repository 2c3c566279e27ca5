"""Device kernels and copies in the traced window, per epoch."""


def read(ctx):
    if not ctx["device_events"]:
        return None
    return len(ctx["device_events"]) / ctx["epochs"]
