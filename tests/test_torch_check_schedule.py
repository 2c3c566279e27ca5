"""The port's split-phase schedule preflight on the CPU.

`python -m repro_torch.launch.check_schedule --device cpu` checks the JAX
launcher's five cells (src/repro/launch/check_schedule.py) on grid-tiny,
on the sim backend and on 4 gloo ranks, and exits 0; a recorder that
starts each exchange one event early makes it exit nonzero, and
`check_split_schedule` raises on it. The cells and the event sequences
are the JAX package's.
"""
import os
import subprocess
import sys

import pytest

import _torch_threads  # noqa: F401

from repro.core.trace_utils import \
    expected_split_events as jexpected_split_events
from repro.launch import check_schedule as jcheck
from repro_torch.core import trace_utils
from repro_torch.launch import check_schedule

ROOT = os.path.join(os.path.dirname(__file__), "..")


def test_cells_are_the_jax_launchers():
    assert check_schedule.CELLS == jcheck.CELLS
    assert check_schedule.P == jcheck.P
    for variant, fuse, train in check_schedule.CELLS:
        fused = fuse and variant != "vanilla"
        ours = trace_utils.expected_split_events(2, fused, train=train)
        jev = jexpected_split_events(2, fused, train=train)
        assert [("A" if e == "exchange_start" else "P") for e in ours
                if e != "exchange_wait"] == [
            "A" if e == "all_to_all" else "P" for e in jev]


def test_cli_passes_on_both_backends():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.check_schedule",
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[check_schedule OK] 10 cells (sim, spmd) on cpu" in out.stdout
    assert out.stdout.count("[schedule OK] sim") == 5
    assert out.stdout.count("[schedule OK] spmd rank 0/4") == 5


class _EarlyStart(trace_utils.RecordingBackend):
    """Records each exchange start before the phase launch that precedes
    it: a misplaced event."""

    def start_exchange(self, s):
        handle = super().start_exchange(s)
        ev = self.events
        if len(ev) >= 2 and isinstance(ev[-2], tuple):
            ev[-2], ev[-1] = ev[-1], ev[-2]
        return handle


def test_a_misplaced_event_fails(monkeypatch, capsys):
    monkeypatch.setattr(trace_utils, "RecordingBackend", _EarlyStart)
    # the sim cells fail before any gloo rank is started
    assert check_schedule.main(["--device", "cpu"]) == 1
    assert "[check_schedule FAILED]" in capsys.readouterr().out
    pipeline = check_schedule._pipeline("cpu")
    model = check_schedule._model(pipeline, "pipegcn", True, 2)
    with pytest.raises(AssertionError, match="schedule mismatch"):
        trace_utils.check_split_schedule(model, pipeline.topo,
                                         pipeline.train_data)
