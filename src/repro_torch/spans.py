"""Spans and counters of the port: what its training path records about
itself, for a profiler session and for whoever reads `last_run()`.

One facility for the whole package; it imports nothing of it, so ``core/``,
``kernels/`` and ``data/`` all record through it.

  span(name, device=False)  a named range on the profiler's clock
                            (``torch.profiler.record_function``), opened
                            only while a ``torch.profiler`` session records;
                            otherwise one shared null context, for the cost
                            of one flag read. With ``device=True`` it also
                            records a pair of CUDA events on the current
                            stream, kept with the span's name and the epoch,
                            and resolved when `last_run()` is read. A device
                            span opened inside another one on the same
                            stream records no events of its own, so nested
                            calls count their device time once. Nothing is
                            recorded while a CUDA graph is being captured.
  count(name, n=1)          an always-on add to a process-wide counter.
  sync(site)                a host wait on the card: ``count("sync.host")``
                            and ``span("repro.sync." + site)``.
  run                       decorator of a training entry point
                            (``train_pipegcn``): snapshots the counters on
                            entry, and on return `last_run()` gives
                            ``{"epochs", "counters", "device_s", "spans"}``:
                            the epochs the run began, each counter's change
                            over the run, the device seconds per span name
                            and every device span as (name, epoch, seconds).
                            Device time covers only spans recorded while a
                            profiler session was on.
  enter(name, epoch=None)   the running entry point's current phase span
                            ("repro.run.setup", then "repro.epoch" once per
                            epoch); each call closes the one before, `leave`
                            closes the last.

The span names (``repro.*``) and counters are listed, each with the
metric that reads it, in PERF.md §3.
"""
from __future__ import annotations

import contextlib
import functools

import torch
import torch.autograd.profiler as _autograd_profiler

_NULL = contextlib.nullcontext()
_FLAG = hasattr(_autograd_profiler, "_is_profiler_enabled")

_counters: dict = {}
_events: list = []        # (name, epoch, start event, end event)
_open_streams: set = set()
_run = None
_last = None


def tracing() -> bool:
    """Whether a profiler session is recording (spans are recorded)."""
    if _FLAG:
        return _autograd_profiler._is_profiler_enabled
    return torch._C._autograd._profiler_enabled()


def _capturing() -> bool:
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


class _Span:
    __slots__ = ("name", "device", "_range", "_dev")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device
        self._range = self._dev = None

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        if self.device and torch.cuda.is_initialized():
            stream = torch.cuda.current_stream()
            if stream.cuda_stream not in _open_streams:
                _open_streams.add(stream.cuda_stream)
                start = torch.cuda.Event(enable_timing=True)
                start.record(stream)
                self._dev = (stream, start)
        return self

    def __exit__(self, *exc):
        if self._dev is not None:
            stream, start = self._dev
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            _open_streams.discard(stream.cuda_stream)
            _events.append((self.name, None if _run is None else _run.epoch,
                            start, end))
        self._range.__exit__(*exc)
        return False


def span(name: str, device: bool = False):
    """A context manager: the range `name` while a profiler session
    records, else a shared null context."""
    if not tracing() or _capturing():
        return _NULL
    return _Span(name, device)


def count(name: str, n=1):
    """Add `n` to the counter `name`."""
    _counters[name] = _counters.get(name, 0) + n


def counter(name: str):
    """The counter `name` (0 if never counted)."""
    return _counters.get(name, 0)


def sync(site: str):
    """A host wait on the card at `site`: counts ``sync.host`` and returns
    the span ``repro.sync.<site>`` to wrap the wait in."""
    _counters["sync.host"] = _counters.get("sync.host", 0) + 1
    return span("repro.sync." + site)


class _Run:
    def __init__(self):
        self.start = dict(_counters)
        self.epochs = 0
        self.epoch = None
        self._span = None

    def enter(self, name: str, epoch: int | None = None):
        self.leave()
        if epoch is not None:
            self.epoch = epoch
            self.epochs += 1
        s = span(name)
        if s is not _NULL:
            s.__enter__()
            self._span = s

    def leave(self):
        s, self._span = self._span, None
        if s is not None:
            s.__exit__(None, None, None)

    def result(self) -> dict:
        delta = {k: v - self.start.get(k, 0) for k, v in _counters.items()
                 if v != self.start.get(k, 0)}
        out = {"epochs": self.epochs, "counters": delta,
               "_events": list(_events)}
        _events.clear()
        return out


def run(fn):
    """Decorate a training entry point: its counters, epochs and device
    spans become `last_run()` when it returns."""

    @functools.wraps(fn)
    def call(*args, **kw):
        global _run, _last
        outer = _run
        r = _run = _Run()
        _events.clear()
        try:
            out = fn(*args, **kw)
        finally:
            r.leave()
            _run = outer
        _last = r.result()
        return out

    return call


def enter(name: str, epoch: int | None = None):
    """Close the running entry point's phase span and open `name` (an epoch
    when `epoch` is given); no-op outside a `run`."""
    if _run is not None:
        _run.enter(name, epoch)


def leave():
    """Close the running entry point's phase span."""
    if _run is not None:
        _run.leave()


def last_run() -> dict | None:
    """What the last `run` that returned recorded (see the module's
    docstring); None before any. Reading it the first time waits for the
    card once to resolve the device spans."""
    if _last is None:
        return None
    events = _last.pop("_events", None)
    if events is not None:
        if events:
            torch.cuda.synchronize()
        _last["spans"] = [(n, e, s.elapsed_time(t) / 1e3)
                          for n, e, s, t in events]
        device_s = {}
        for n, _, sec in _last["spans"]:
            device_s[n] = device_s.get(n, 0.0) + sec
        _last["device_s"] = device_s
    return _last
