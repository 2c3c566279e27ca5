"""The readers of the program's own spans and counters (``opt_ms``,
``exchange_ms``, ``wire_mb_per_epoch``, ``syncs_per_epoch``) on a synthetic
run: the value, and None without the span or counter, for another run
than the window's, and for a program without ``repro_torch.spans``."""
from __future__ import annotations

import sys

import pytest

from benchlib import spec

CTX = {"epochs": 4}
RUN = {"epochs": 4,
       "counters": {"exchange.bytes": 10_000_000, "sync.host": 9},
       "device_s": {"repro.opt": 0.002, "repro.exchange": 0.006},
       "spans": []}
WANT = {"opt_ms": 0.5, "exchange_ms": 1.5, "wire_mb_per_epoch": 2.5,
        "syncs_per_epoch": 2.25}
SOURCE = {"opt_ms": ("device_s", "repro.opt"),
          "exchange_ms": ("device_s", "repro.exchange"),
          "wire_mb_per_epoch": ("counters", "exchange.bytes"),
          "syncs_per_epoch": ("counters", "sync.host")}


@pytest.fixture
def last(monkeypatch):
    from repro_torch import spans

    def set_run(run):
        monkeypatch.setattr(spans, "_last", run)

    return set_run


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_the_last_run(name, last):
    last(dict(RUN))
    assert spec.load_reader(name)(CTX) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_is_none_without_its_span_or_counter(name, last):
    group, key = SOURCE[name]
    run = dict(RUN, **{group: {k: v for k, v in RUN[group].items()
                               if k != key}})
    last(run)
    assert spec.load_reader(name)(CTX) is None
    last(dict(RUN, epochs=5))          # another run than the window's
    assert spec.load_reader(name)(CTX) is None
    last(None)
    assert spec.load_reader(name)(CTX) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_is_none_for_a_program_without_spans(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    import repro_torch
    monkeypatch.delattr(repro_torch, "spans", raising=False)
    assert spec.load_reader(name)(CTX) is None
