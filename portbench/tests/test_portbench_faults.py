"""A run whose timed path is broken underneath reads ``correct`` false:
the harness's look for a card is skipped and the rest of a run is driven
on the CPU at a tiny size, under the real cells' limits, once for each
fault a training cell can have."""
from __future__ import annotations

import pytest
import torch

from benchlib import harness
from conftest import TINY_CELLS


def _state_unchanged(mp):
    import repro_torch.core.trainer as tr
    orig = tr.make_train_step

    def make(model, opt, health=None, backend=None):
        step = orig(model, opt, health, backend)

        def frozen(topo, params, opt_state, buffers, data, *rest):
            out = step(topo, params, opt_state, buffers, data, *rest)
            return (out[0], params, opt_state) + tuple(out[3:])
        return frozen
    mp.setattr(tr, "make_train_step", make)


def _half_batch(mp):
    from repro_torch.core.pipegcn import PipeGCN
    orig = PipeGCN._loss

    def loss(self, backend, logits, data):
        m = data.train_mask
        keep = torch.cumsum(m.reshape(-1).long(), 0).reshape(m.shape)
        half = m & (keep <= int(m.sum()) // 2)
        return orig(self, backend, logits, data._replace(train_mask=half))
    mp.setattr(PipeGCN, "_loss", loss)


def _no_exchange(mp):
    from repro_torch.core.pipegcn import SimBackend
    mp.setattr(SimBackend, "exchange", lambda self, s: torch.zeros_like(s))


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "no_exchange": _no_exchange}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["tiny-sage3.p4-blocksparse",
                                  "tinyml-sage2.p4-coo"])
def test_broken_timed_path_is_not_correct(cell, fault, tiny_tree,
                                          monkeypatch):
    assert cell in TINY_CELLS
    FAULTS[fault](monkeypatch)
    result, checks = harness.run_cell(cell, 2**31 + 29, 0.3, False,
                                      device="cpu", repo_root=tiny_tree,
                                      bench_dir=tiny_tree / "portbench")
    assert result["correct"] is False, checks
