"""What a ``--trace 1`` run records and how it is reduced: spans around the
aggregation engine's calls, and the profiler's device and host events.

Nothing here is installed in a ``--trace 0`` run.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict

import torch

ENGINE_METHODS = ("spmm", "spmm_t", "aggregate_transform",
                  "aggregate_transform_t", "spmm_phased", "spmm_t_phased")
GEMM_KERNEL = re.compile(r"gemm|cutlass|xmma|cublas", re.IGNORECASE)


class EngineSpans:
    """CUDA events around each outermost call into one aggregation engine
    (``repro_torch.kernels.aggregate.ENGINES[name]``), with the widths the
    work arithmetic needs. Installed on the engine instance and removed by
    `remove`."""

    def __init__(self, engine):
        self.engine = engine
        self.calls = []          # (method, widths, start event, end event)
        self._depth = 0
        for name in ENGINE_METHODS:
            setattr(engine, name, self._wrap(name, getattr(engine, name)))

    def _wrap(self, name, fn):
        def call(*args, **kw):
            if self._depth:
                return fn(*args, **kw)
            self._depth += 1
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            try:
                with torch.profiler.record_function("portbench.agg." + name):
                    start.record()
                    out = fn(*args, **kw)
                    end.record()
            finally:
                self._depth -= 1
            self.calls.append((name, _widths(name, args, kw), start, end))
            return out
        return call

    def remove(self):
        for name in ENGINE_METHODS:
            self.engine.__dict__.pop(name, None)

    def spans(self) -> list:
        """[(method, widths, seconds)] once the device has finished."""
        torch.cuda.synchronize()
        return [(m, w, s.elapsed_time(e) / 1e3) for m, w, s, e in self.calls]


def _widths(name, args, kw) -> dict:
    x = args[1]
    if name == "aggregate_transform":
        return {"fin": x.shape[-1], "fout": args[2].shape[-1],
                "with_z": kw.get("with_z", args[6] if len(args) > 6 else True)}
    if name == "aggregate_transform_t":
        return {"fin": args[2].shape[0], "fout": x.shape[-1]}
    if name.endswith("_phased"):
        return {"fin": x.shape[-1], "phase": args[4] if len(args) > 4
                else kw["phase"]}
    return {"fin": x.shape[-1]}


def _ns(e, what):
    f = getattr(e, what + "_ns", None)
    return f() if f is not None else getattr(e, what + "_us")() * 1000


def profile_events(prof):
    """(device events, host events) of a finished ``torch.profiler``
    session, each a list of (name, start_ns, end_ns) sorted by start."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        item = (e.name(), start, start + _ns(e, "duration"))
        if e.device_type() == DeviceType.CUDA:
            # record_function ranges are mirrored on the device's track as
            # annotations; only kernels, copies and sets ran there
            if not e.is_user_annotation():
                dev.append(item)
        elif e.device_type() == DeviceType.CPU:
            host.append(item)
    dev.sort(key=lambda t: t[1])
    host.sort(key=lambda t: t[1])
    return dev, host


def merged(intervals):
    """Union of (start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_ns(dev) -> int:
    return sum(e - s for s, e in merged((s, e) for _, s, e in dev))


def top_device_ops(dev, n: int = 10):
    """[[kernel or copy name, seconds]] of the `n` that took most time."""
    tot = defaultdict(int)
    for name, s, e in dev:
        tot[name] += e - s
    return [[k, v / 1e9] for k, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(dev, host, window, n: int = 10, look_back: int = 400):
    """[[what the host was doing, seconds]]: the device's idle time inside
    `window` (start_ns, end_ns), summed by the innermost host event that
    covers the middle of each gap ("host: between ops" where none does)."""
    lo, hi = window
    busy = [(max(s, lo), min(e, hi)) for s, e in
            merged((s, e) for _, s, e in dev) if e > lo and s < hi]
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    starts = [s for _, s, _ in host]
    tot = defaultdict(int)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "host: between ops"
        for k in range(i, max(i - look_back, -1), -1):
            if host[k][2] >= mid:
                name = host[k][0]
                break
        tot[name] += b - a
    return [[k, v / 1e9] for k, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
