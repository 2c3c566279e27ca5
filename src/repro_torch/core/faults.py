"""Declarative fault injection for the PipeGCN boundary exchange.

Port of the JAX package's ``repro.core.faults``. PipeGCN's
bounded-staleness argument makes a lost or corrupted boundary exchange
recoverable by design: the receiver already consumes payloads one step
old, so an invalid payload is one extra step of staleness (up to
``PipeConfig.max_staleness``). A :class:`FaultPlan` declares per-(step,
layer, direction, partition-pair) drop / corrupt / delay sites, compiles
to dense boolean tables (:class:`FaultTables`), and :func:`apply_faults`
injects them into the encoded wire tensors right before the exchange on
either backend.

Fault kinds:

``drop``     the payload never arrives: the wire rows are zeroed and the
             checksum column (``guard_exchange``) is set to 1, which no
             zero row sums to, so the receiver flags every row invalid
             and falls back to its stale buffer. Without the guard the
             zeros land silently.
``corrupt``  seeded pseudo-random XOR bit-flips over the wire bytes
             (``density`` = per-byte flip probability, each flipped byte
             XORed with a nonzero mask). The per-row checksum detects a
             changed row with probability about 1 - 2^-8.
``delay``    the payload arrives one step late; every step re-sends fresh
             data, so it is superseded on arrival and ``compile`` lowers
             it to ``drop``.
``device_down`` a whole device drops every exchange leaving its
             partitions toward any other device, both directions, every
             layer, for steps ``[step, until)``; ``src`` names the device
             and ``compile`` expands it over ``parts_per_device``.

``compile`` is numpy, line for line the JAX package's, so the tables equal
JAX's byte for byte. The flip bits cannot: JAX draws them from
``jax.random.bits``. Here each (seed, step, direction, layer, global
source partition) seeds its own ``torch.Generator``, so the sim and SPMD
backends inject the same bytes on one device type (CPU and CUDA
generators give different bits).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.codec import byteify, unbyteify

#: Direction indices of the fault tables (axis 1).
FWD, BWD = 0, 1

KINDS = ("drop", "corrupt", "delay", "device_down")
DIRECTIONS = ("fwd", "bwd")


class StalenessExceededError(RuntimeError):
    """Effective staleness of some exchange exceeded PipeConfig.max_staleness."""


class FaultTables(NamedTuple):
    """Compiled fault schedule.

    ``drop`` / ``corrupt`` are bool ``(T, 2, L, P_src, P_dst)`` tables
    indexed by (step, direction, layer, source partition, destination
    partition), as numpy on the host (``drop_np``, ``corrupt_np``: the
    step reads them to skip planes without faults, with no device sync)
    and as tensors on the training device. ``seed`` seeds the corruption
    flip streams, ``density`` is the per-byte flip probability. Steps
    beyond the horizon T clamp to the last row.
    """

    drop: torch.Tensor
    corrupt: torch.Tensor
    drop_np: np.ndarray
    corrupt_np: np.ndarray
    seed: int
    density: float


@dataclasses.dataclass(frozen=True)
class FaultSite:
    """One declarative fault: drop/corrupt/delay the (src -> dst) payload
    of ``layer`` in ``direction`` ("fwd"/"bwd") at ``step``.

    ``kind="device_down"`` reads ``src`` as a DEVICE id and holds from
    ``step`` until ``until`` (exclusive; None = permanent); its
    ``layer``/``dst``/``direction`` are ignored (see
    :func:`device_down_site`).
    """

    step: int
    layer: int
    src: int
    dst: int
    direction: str = "fwd"
    kind: str = "drop"
    until: int | None = None

    def __post_init__(self):
        if self.direction not in DIRECTIONS:
            raise ValueError(f"unknown direction {self.direction!r}; "
                             f"have {DIRECTIONS}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"have {KINDS}")
        if self.until is not None:
            if self.kind != "device_down":
                raise ValueError(
                    f"until= is only meaningful for kind='device_down' "
                    f"(got kind={self.kind!r}) — point faults last one step")
            if self.until <= self.step:
                raise ValueError(
                    f"until={self.until} must be > step={self.step}")


def device_down_site(step: int, device: int,
                     until: int | None = None) -> FaultSite:
    """A whole-device outage site: device ``device`` drops every outbound
    exchange for steps ``[step, until)`` (None = never comes back)."""
    return FaultSite(step=step, layer=0, src=device, dst=0,
                     kind="device_down", until=until)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative fault schedule: explicit ``sites`` plus an optional
    i.i.d. background ``rate`` of ``rate_kind`` faults over every
    (step, direction, layer, src != dst) site, seeded by ``seed``.

    ``density`` is the per-byte bit-flip probability of "corrupt" faults.
    An empty plan (no sites, rate 0) injects nothing; the trainer then
    builds no tables and runs the fault-free step.
    """

    sites: tuple = ()
    rate: float = 0.0
    rate_kind: str = "drop"
    seed: int = 0
    density: float = 0.02

    def __post_init__(self):
        if self.rate_kind not in KINDS:
            raise ValueError(f"unknown rate_kind {self.rate_kind!r}; "
                             f"have {KINDS}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        if not 0.0 < self.density <= 1.0:
            raise ValueError(f"density must be in (0, 1], got {self.density}")
        object.__setattr__(self, "sites", tuple(self.sites))

    def is_empty(self) -> bool:
        """True when the plan injects nothing at any step."""
        return not self.sites and self.rate == 0.0

    def downed_devices(self, step: int) -> frozenset:
        """Device ids whose ``device_down`` window covers ``step``."""
        return frozenset(
            s.src for s in self.sites
            if s.kind == "device_down" and s.step <= step
            and (s.until is None or step < s.until))

    def without_device_down(self) -> "FaultPlan":
        """This plan minus its device_down sites."""
        return dataclasses.replace(
            self, sites=tuple(s for s in self.sites
                              if s.kind != "device_down"))

    def compile(self, num_steps: int, num_layers: int, num_parts: int,
                parts_per_device: int = 1, device="cpu") -> FaultTables:
        """Lower the plan to dense boolean tables over a ``num_steps``
        horizon ("delay" lowers to "drop"; "device_down" lowers to
        persistent cross-device drops over the device's
        ``parts_per_device`` partition block), with their tensors on
        `device`."""
        shape = (max(num_steps, 1), 2, num_layers, num_parts, num_parts)
        drop = np.zeros(shape, bool)
        corrupt = np.zeros(shape, bool)
        if self.rate > 0.0:
            rng = np.random.default_rng(self.seed)
            mask = rng.random(shape) < self.rate
            # background faults model the network: self-pairs never leave
            # the device, so only src != dst sites are eligible
            eye = np.eye(num_parts, dtype=bool)
            mask &= ~eye[None, None, None]
            # layer 0 sends no backward gradient (Alg. 1 stops there)
            mask[:, BWD, 0] = False
            (corrupt if self.rate_kind == "corrupt" else drop)[:] = mask
        for s in self.sites:
            if s.kind == "device_down":
                if num_parts % parts_per_device:
                    raise ValueError(
                        f"num_parts={num_parts} is not a multiple of "
                        f"parts_per_device={parts_per_device}")
                n_dev = num_parts // parts_per_device
                if not 0 <= s.src < n_dev:
                    raise ValueError(
                        f"device_down site device {s.src} out of range for "
                        f"{n_dev} devices: {s}")
                lo = max(s.step, 0)
                hi = num_steps if s.until is None else min(s.until, num_steps)
                if lo >= hi:
                    continue
                on = np.zeros((num_parts,), bool)
                on[s.src * parts_per_device:(s.src + 1) * parts_per_device] \
                    = True
                # outbound only: the dead device's own inbound state is
                # never consumed
                drop[lo:hi] |= np.outer(on, ~on)[None, None]
                continue
            if not (0 <= s.layer < num_layers and 0 <= s.src < num_parts
                    and 0 <= s.dst < num_parts):
                raise ValueError(f"fault site out of range: {s}")
            if 0 <= s.step < num_steps:
                d = FWD if s.direction == "fwd" else BWD
                tab = corrupt if s.kind == "corrupt" else drop
                tab[s.step, d, s.layer, s.src, s.dst] = True
        return FaultTables(drop=torch.from_numpy(drop).to(device),
                           corrupt=torch.from_numpy(corrupt).to(device),
                           drop_np=drop, corrupt_np=corrupt,
                           seed=int(self.seed), density=float(self.density))


def _flip_generator(seed: int, step: int, direction: int, layer: int,
                    src: int, device) -> torch.Generator:
    """The flip stream of one (seed, step, direction, layer, global source
    partition): a generator on `device` seeded from numpy's SeedSequence
    of the five ints."""
    mix = np.random.SeedSequence([seed, step, direction, layer, src])
    return torch.Generator(device=device).manual_seed(
        int(mix.generate_state(1)[0]))


def _flip_bytes(wire, generator, density: float):
    """Seeded pseudo-random XOR bit-flips over a wire tensor's bytes: each
    byte flipped with probability ``density`` (threshold
    round(density·256) on a uniform byte), XORed with a nonzero mask."""
    b, it, dt = byteify(wire)
    sel = torch.randint(0, 256, b.shape, dtype=torch.uint8,
                        generator=generator, device=b.device)
    val = torch.randint(0, 256, b.shape, dtype=torch.uint8,
                        generator=generator, device=b.device)
    thresh = int(np.clip(np.round(np.float32(density) * np.float32(256.0)),
                         0, 255))
    flip = torch.where(sel < thresh, val | 1, torch.zeros_like(val))
    return unbyteify(b ^ flip, it, dt)


def _dropped_wire(wire, has_checksum: bool):
    """What a dropped payload decodes from: all-zero rows, with the
    checksum column (when the guard is on) set to 1 — the checksum of a
    zero row is 0, so every dropped row is invalid."""
    z = torch.zeros_like(wire)
    if has_checksum and wire.shape[-1]:
        z[..., -1] = 1
    return z


def apply_faults(wire, tables: FaultTables, step_idx: int, direction: int,
                 layer: int, part_ids, has_checksum: bool):
    """Inject this step's faults into one encoded wire tensor, sender-side.

    ``wire`` is the encoded send payload of shape (n, P_dst, slot, W),
    its leading axis the backend's partitions, whose GLOBAL ids
    ``part_ids`` are consecutive (all P on the sim backend, a rank's
    block under SPMD). ``step_idx`` is a host int; steps past the table
    horizon clamp to the last row. The host tables decide which planes
    and sources need work, so a plane with no fault returns ``wire``
    itself (bitwise what an empty mask gives); the selects read the
    device tables, so the injection never waits for the device.
    """
    t = min(max(int(step_idx), 0), tables.drop_np.shape[0] - 1)
    ids = list(part_ids)
    lo, hi = ids[0], ids[-1] + 1
    assert ids == list(range(lo, hi)), ids
    drop = tables.drop_np[t, direction, layer, lo:hi]       # (n, P_dst)
    corr = tables.corrupt_np[t, direction, layer, lo:hi]
    if not (drop.any() or corr.any()):
        return wire
    out = wire
    if corr.any():
        flipped = wire.clone()
        for i in np.flatnonzero(corr.any(axis=1)):
            gen = _flip_generator(tables.seed, int(step_idx), direction,
                                  layer, lo + int(i), wire.device)
            flipped[i] = _flip_bytes(wire[i], gen, tables.density)
        sel = tables.corrupt[t, direction, layer, lo:hi]
        out = torch.where(sel[..., None, None], flipped, out)
    if drop.any():
        sel = tables.drop[t, direction, layer, lo:hi]
        out = torch.where(sel[..., None, None],
                          _dropped_wire(wire, has_checksum), out)
    return out
