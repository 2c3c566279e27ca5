"""Schedule accounting for the PipeGCN step: which exchanges a step issues,
and where they sit between the phase launches of the split-phase schedule.

Port of the JAX package's ``repro.core.trace_utils``. The JAX package
traces a step to a jaxpr and counts its collectives there; an eager
PyTorch step has no trace, so a backend wrapper records the step's events
as they happen instead:

  "exchange"                      a blocking exchange (the unsplit step)
  "exchange_start"                an exchange started (the split step)
  "exchange_wait"                 ... and waited on
  ("spmm_phased", phase)          a forward phase launch
  ("spmm_t_phased", phase)        a transpose phase launch

The fused deferred exchange issues 2 exchanges per training step (one
packed exchange per direction), the per-layer schedule 2L-1; the split
schedule keeps the count and only moves each exchange between the phases.

The backend wrapper also counts the bytes it hands the exchange
(`RecordingBackend.wire_bytes`): the port's counterpart of the JAX
package's ``traced_wire_bytes``, which sums the operand bytes of every
all_to_all in the traced step. `step_wire_bytes` gives that figure for one
training step.

`CollectiveCounter` counts the collectives of any eager program as they
are dispatched (the dry-run's counterpart of the JAX package's
``collective_bytes``, which parses them out of partitioned HLO).

The port's spans and counters (`repro_torch.spans`, re-exported here:
`span`, `count`, `counter`, `sync`, `last_run`) are what the
training path records about itself while it runs, in every run rather
than in a recorded step: a ``repro.*`` range per step phase, exchange,
optimizer, health verdict, host sync and evaluation on the profiler's
clock while a ``torch.profiler`` session records, device seconds for the
device spans, and always-on counters (``exchange.bytes`` equals
`step_wire_bytes` per training step; ``sync.host``, the kernels' launches,
``pipeline.<phase>_s``). `RecordingBackend` stays the schedule and JAX
parity checker.
"""
from __future__ import annotations

from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.pipegcn import _ExchangeBase
from repro_torch.spans import (count, counter, last_run,  # noqa: F401
                               span, sync)

EXCHANGES = ("exchange", "exchange_start")


class _RecordedWait:
    def __init__(self, handle, events):
        self._handle, self._events = handle, events

    def wait(self):
        self._events.append("exchange_wait")
        return self._handle.wait()


class RecordingBackend(_ExchangeBase):
    """Wraps a backend and records the step's schedule events in
    `events`, and in `wire_bytes` the bytes (numel × element size) of
    every tensor it forwards to an exchange; every sync point is forwarded
    to `inner` unchanged."""

    def __init__(self, inner):
        self.inner = inner
        self.events: list = []
        self.wire_bytes = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def note(self, event):
        self.events.append(event)

    def exchange(self, s):
        self.events.append("exchange")
        self.wire_bytes += s.numel() * s.element_size()
        return self.inner.exchange(s)

    def start_exchange(self, s):
        self.events.append("exchange_start")
        self.wire_bytes += s.numel() * s.element_size()
        return _RecordedWait(self.inner.start_exchange(s), self.events)


def step_wire_bytes(model, topo, data, train: bool = True) -> int:
    """Bytes one training (or eval) step of `model` hands the exchange, on
    a recording sim backend from the seed-0 parameters and zero buffers:
    every partition's sends, the figure the JAX package's
    ``traced_step_wire_bytes`` gives on a mesh of one device holding all
    partitions. It depends only on shapes and the wire codecs."""
    import torch
    from repro_torch.core.pipegcn import SimBackend
    rec = RecordingBackend(SimBackend())
    gen = torch.Generator(device=data.x.device).manual_seed(0)
    params = model.init_params(gen, dtype=data.x.dtype)
    buffers = model.init_buffers(topo, dtype=data.x.dtype)
    with torch.no_grad():
        model._step_impl(rec, topo, params, buffers, data, gen, train=train)
    return rec.wire_bytes


def count_exchanges(events) -> int:
    """Boundary exchanges issued in an event list (blocking or started)."""
    return sum(e in EXCHANGES for e in events)


def expected_boundary_collectives(num_layers: int, fused: bool,
                                  train: bool = True) -> int:
    """The exchange count of the two communication schedules: per layer,
    L forward + (L-1) backward = 2L-1 per training step (L at eval);
    fused-deferred, 1 packed forward + 1 packed backward = 2 (1 at eval);
    a 1-layer model has no gradient sends."""
    L = num_layers
    if fused:
        fwd, bwd = 1, (1 if L > 1 else 0)
    else:
        fwd, bwd = L, L - 1
    return fwd + (bwd if train else 0)


def expected_split_events(num_layers: int, fused: bool,
                          train: bool = True) -> list:
    """The event sequence of a split-phase step on a tile engine (the JAX
    package's `expected_split_events`, with the waits placed).

    Forward, per-layer schedule: layer 0's exchange (its payload is x) is
    started and waited on before the loop; then each layer runs [boundary
    phase, start of the next layer's exchange (if any), interior phase,
    its wait]. Fused schedule: the one packed exchange starts once the
    last payload is gathered, between layer L-2's phases (before the loop
    when L == 1), and is waited on at the end of the forward. The
    backward mirrors it with the transpose phases down to layer 1 (Alg. 1
    stops at layer 0), the fused exchange starting between layer 1's
    phases and waited on at the end of the backward."""
    L = num_layers
    S, W = "exchange_start", "exchange_wait"
    ev: list = []
    if fused and L == 1:
        ev += [S]
    if not fused:
        ev += [S, W]
    for ell in range(L):
        ev += [("spmm_phased", "boundary")]
        starts = (ell == L - 2) if fused else (ell < L - 1)
        if starts:
            ev += [S]
        ev += [("spmm_phased", "interior")]
        if starts and not fused:
            ev += [W]
    if fused:
        ev += [W]
    if not train:
        return ev
    for ell in reversed(range(1, L)):
        starts = (not fused) or ell == 1
        ev += [("spmm_t_phased", "boundary")]
        if starts:
            ev += [S]
        ev += [("spmm_t_phased", "interior")]
        if starts:
            ev += [W]
    return ev


def check_overlap(events) -> None:
    """Assert the overlap property of a split-phase event list: every
    exchange started after a phase launch sits between a boundary and an
    interior phase, and is waited on after that interior phase."""
    for i, e in enumerate(events):
        if e != "exchange_start" or not any(
                isinstance(x, tuple) for x in events[:i]):
            continue
        before, after = events[i - 1], events[i + 1]
        if not (isinstance(before, tuple) and before[1] == "boundary"
                and isinstance(after, tuple) and after[1] == "interior"
                and before[0] == after[0]):
            raise AssertionError(f"exchange start {i} is not between a "
                                 f"boundary and an interior phase: {events}")
        rest = events[i:]
        if rest.count("exchange_wait") < rest.count("exchange_start"):
            raise AssertionError(f"exchange start {i} is never waited on "
                                 f"after its interior phase: {events}")


def check_split_schedule(model, topo, data, train: bool = True,
                         backend=None) -> list:
    """Run one split-phase step of `model` (a training step, or with
    train=False the eval pass of the same pipeline configuration) through a
    RecordingBackend around `backend` (default the sim backend), from the
    seed-0 parameters and zero buffers, and assert that its events equal
    `expected_split_events` and pass `check_overlap`: every exchange sits
    between a boundary and an interior phase as scheduled. Returns the
    recorded events."""
    import torch
    from repro_torch.core.pipegcn import SimBackend
    from repro_torch.device import exact_f32_matmul
    if model._split_active() is None:
        raise ValueError("the model runs no split-phase step (no split "
                         "spec, or overlap disabled for its engine)")
    rec = RecordingBackend(SimBackend() if backend is None else backend)
    gen = torch.Generator(device=data.x.device).manual_seed(0)
    params = model.init_params(gen, dtype=data.x.dtype)
    buffers = model.init_buffers(topo, dtype=data.x.dtype)
    exact_f32_matmul()
    with torch.no_grad():
        model._step_impl(rec, topo, params, buffers, data, gen, train=train)
    expected = expected_split_events(model.model.num_layers, model.pipe.fused,
                                     train=train)
    if rec.events != expected:
        raise AssertionError(f"split-phase schedule mismatch:\n  recorded "
                             f"{rec.events}\n  expected {expected}")
    check_overlap(rec.events)
    return rec.events


# ---------------------------------------------------------------- collectives

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")

# op name (functional, autograd-functional and in-place c10d ops) -> the
# JAX package's HLO name of the collective
_COLLECTIVE_KIND = {
    **dict.fromkeys(("all_reduce", "all_reduce_", "all_reduce_coalesced",
                     "all_reduce_coalesced_", "allreduce_",
                     "allreduce_coalesced_"), "all-reduce"),
    **dict.fromkeys(("all_gather_into_tensor", "all_gather_into_tensor_out",
                     "all_gather_into_tensor_coalesced", "allgather_",
                     "_allgather_base_", "allgather_coalesced_",
                     "allgather_into_tensor_coalesced_"), "all-gather"),
    **dict.fromkeys(("reduce_scatter_tensor", "reduce_scatter_tensor_coalesced",
                     "reduce_scatter_", "_reduce_scatter_base_",
                     "reduce_scatter_tensor_coalesced_"), "reduce-scatter"),
    **dict.fromkeys(("all_to_all_single", "alltoall_base_", "alltoall_",
                     "shard_dim_alltoall"), "all-to-all"),
    **dict.fromkeys(("send", "recv_"), "collective-permute"),
}
# (DTensor redistributes Shard(i) -> Shard(j) by its own op,
# ``_dtensor::shard_dim_alltoall``, an all-to-all)
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "c10d", "_dtensor")


def _nbytes(x) -> int:
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return x.numel() * x.element_size() if hasattr(x, "numel") else 0


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives issued while it is active (``with
    CollectiveCounter() as c:``), and their payload bytes per device, under
    the JAX package's names (`COLLECTIVE_OPS`): `counts[kind]`,
    `bytes[kind]`.

    It sees every ``torch.distributed`` collective as it is dispatched: the
    functional ones that DTensor's redistributions issue, DTensor's own
    all-to-all (``_dtensor::shard_dim_alltoall``, Shard(i) -> Shard(j)) and
    the in-place c10d ones (``all_to_all_single``, ``all_reduce``, ...). A
    collective's bytes are those of its result, as the JAX package counts
    the result type of an HLO collective: an all-gather's gathered tensor,
    a reduce-scatter's shard. The ops counted are the ones that ran, one by
    one, so a layer loop counts each of its layers: no correction like
    JAX's `while_mult` (an HLO loop body counted once) is needed. Works on
    ``meta`` tensors and under the fake process group, where the
    collectives move nothing."""

    def __init__(self):
        super().__init__()
        self.counts = dict.fromkeys(COLLECTIVE_OPS, 0)
        self.bytes = dict.fromkeys(COLLECTIVE_OPS, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if DTensor in types:
            # a mode runs before tensor subclasses: let DTensor turn the op
            # into local ops and collectives first, which come back here
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        kind = (_COLLECTIVE_KIND.get(func._overloadpacket.__name__)
                if func.namespace in _COLLECTIVE_NAMESPACES else None)
        if kind is not None:
            self.counts[kind] += 1
            # functional ops return the result; in-place c10d ops write it
            # into their first argument
            self.bytes[kind] += _nbytes(args[0] if func.namespace == "c10d"
                                        else out)
        return out
