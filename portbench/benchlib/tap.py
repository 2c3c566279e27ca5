"""Keeps what the timed call's own first training steps produced, for the
comparison with the reference.

``train_pipegcn`` builds its step with ``make_train_step`` from its own
module; `StepTap` wraps the steps built while it is installed and keeps
copies of what the first `n` steps produced: each loss, the parameters the
first step started from, the optimizer's first moments after it, and the
parameters after step `n`. They are copies (a few MB, queued on the
step's stream in the first `n` steps), so a program that updates its
parameters or its optimizer state in place, or replays them from static
buffers, is read as it was at each step; the host reads them only after
the window has closed.
"""
from __future__ import annotations

import repro_torch.core.trainer as trainer
from repro_torch.optim.optimizers import OptState

ADAM_B1 = 0.9      # Adam's first-moment decay in the program's trainer


def _copy(tree: dict) -> dict:
    return {k: v.detach().clone() for k, v in tree.items()}


class StepTap:
    def __init__(self, n: int = 3):
        self.n = n
        self.losses = []
        self.params0 = None
        self.state1 = None
        self.params = None
        self._live = {}
        self._orig = trainer.make_train_step

    def __enter__(self):
        orig = self._orig

        def make(model, opt, health=None, backend=None):
            return self._wrap(orig(model, opt, health, backend))

        trainer.make_train_step = make
        return self

    def __exit__(self, *exc):
        trainer.make_train_step = self._orig
        return False

    def _wrap(self, step):
        def tapped(topo, params, opt_state, buffers, data, *rest):
            k = len(self.losses)
            if k == 0:
                self.params0 = _copy(params)
            out = step(topo, params, opt_state, buffers, data, *rest)
            if k < self.n:
                if k == 0:
                    self.state1 = out[2]._replace(mu=_copy(out[2].mu))
                self.losses.append(out[0].detach().clone())
                if k == self.n - 1:
                    self.params = _copy(out[1])
            self._live = out[1]
            return out
        return tapped

    def outputs(self) -> dict:
        """The kept steps as the comparison takes them (on the host)."""
        if len(self.losses) < self.n or not isinstance(self.state1, OptState):
            raise RuntimeError(
                f"the step tap saw {len(self.losses)} of {self.n} training "
                "steps: train_pipegcn no longer builds its step through "
                "repro_torch.core.trainer.make_train_step")
        live = {v.data_ptr() for v in self._live.values()}
        kept = [*self.params0.values(), *self.params.values(),
                *self.state1.mu.values()]
        if any(v.data_ptr() in live for v in kept):
            raise RuntimeError("the step tap's copies share memory with the "
                               "live parameters")
        cpu = lambda t: {k: v.detach().float().cpu() for k, v in t.items()}
        return {"losses": [float(x) for x in self.losses],
                "params0": cpu(self.params0),
                "grads1": {k: v / (1 - ADAM_B1)
                           for k, v in cpu(self.state1.mu).items()},
                "params": cpu(self.params)}
