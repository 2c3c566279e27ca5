"""Elastic training runtime: survive device loss by remapping partitions.

Port of the JAX package's ``repro.core.elastic``. PipeGCN's
bounded-staleness theorems price every boundary exchange in iterations
of staleness, not in availability, so a lost device is an extreme
staleness event: the partitions it hosted are very stale on the
survivors.

1. :class:`ElasticPlan`: given the survivor set, remap the lost device's
   ``n_local`` partitions onto the survivors. The device-major layout
   (partition p on device ``p // n_local``) is kept by appending idle pad
   partitions at the end of the flat partition axis when the real count
   does not divide the survivor count. Real partitions keep their ids and
   order, so ``edge_col`` halo offsets, ``send_idx`` peer order and
   compiled fault tables stay valid; the pads have all-False send and
   inner masks and zero edges and tiles. Re-sharding is padding
   (:func:`remap_topology`, :func:`remap_data`, :func:`remap_buffers`);
   the partitioned graph is never rebuilt.
2. :func:`detect_device_loss`: a device is declared down once every
   forward exchange out of it has fallen back ``detect_after``
   consecutive steps on every off-device destination (the guarded
   exchange's "es" counters).
3. Warm recovery: the exchanges touching a remapped partition restart
   with ``warm_staleness`` consecutive fallbacks (:func:`warm_mark`). A
   mid-run recovery and a fresh launch on the survivor layout go through
   the same restore → remap → mark path, so they train bitwise alike.
4. Rejoin: at a checkpoint boundary the live state is unmapped back to
   the flat layout (:func:`unmap_buffers`) and training resumes on the
   original device count.

The port's Topology carries the CUDA kernels' schedules besides JAX's
fields (``tile_row_ptr``, ``tile_col_ptr``, ``tile_work``, ``tile_items``,
``tile_t_work``, ``tile_t_items``). A zero-padded schedule row is not a
schedule the kernels can walk (an item of 0 chunks never completes its
run, and output blocks without an item are never written), so
:func:`remap_topology` gives every pad partition the schedule that
``gcn_spmm.tile_schedule`` computes for an all-zero partition, one empty
item per output block, and gives every partition an empty transpose item
for each column block that the pads' halo slots add to the combined
array: the schedules of the padded tile streams.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.faults import FWD, FaultTables, StalenessExceededError
from repro_torch.core.pipegcn import ShardedData, Topology
from repro_torch.kernels.gcn_spmm import TILE, run_pointers, tile_schedule


class DeviceLossError(StalenessExceededError):
    """A whole device's exchanges went stale: staleness escalated to loss.

    Carries the lost `device` (an original device id), the `survivors` and
    the detection `epoch`, so the trainer can recover instead of aborting.
    """

    def __init__(self, message: str, device: int, survivors, epoch: int):
        super().__init__(message)
        self.device = int(device)
        self.survivors = tuple(survivors)
        self.epoch = int(epoch)


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Elastic-runtime policy (`train_pipegcn(elastic=...)`).

    ``detect_after``: consecutive whole-device fallback steps before a
    device is declared lost; ``warm_staleness``: the es count stamped on
    remapped exchanges at recovery (below ``detect_after``, or a recovered
    run would re-detect its own warm marks); ``max_recoveries``: recovery
    budget before the loss is re-raised; ``rejoin``: scale back up at a
    checkpoint boundary once the lost device is healthy; ``parts_per_device``:
    device granularity of the sim backend (SPMD runs take it from the
    world size).
    """

    enabled: bool = True
    detect_after: int = 2
    warm_staleness: int = 1
    max_recoveries: int = 2
    rejoin: bool = True
    parts_per_device: int = 1

    def __post_init__(self):
        if self.detect_after < 1:
            raise ValueError(
                f"detect_after must be >= 1, got {self.detect_after}")
        if not 0 <= self.warm_staleness < self.detect_after:
            raise ValueError(
                f"warm_staleness={self.warm_staleness} must be in "
                f"[0, detect_after={self.detect_after}) — a recovered run "
                "must not re-detect its own warm marks")
        if self.max_recoveries < 0:
            raise ValueError(
                f"max_recoveries must be >= 0, got {self.max_recoveries}")
        if self.parts_per_device < 1:
            raise ValueError(
                f"parts_per_device must be >= 1, got {self.parts_per_device}")


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Survivor remap of ``num_parts`` device-major partitions.

    The original layout has ``orig_devices`` devices hosting
    ``num_parts // orig_devices`` partitions each; ``survivors`` names the
    original device ids still alive. The remapped layout keeps the flat
    partition order and pads it to ``padded_parts`` (the smallest multiple
    of ``len(survivors)`` ≥ ``num_parts``), so survivor number ``d``
    (positional) hosts padded partitions ``[d*n_local, (d+1)*n_local)``.
    With every device surviving the plan is the identity.
    """

    num_parts: int
    orig_devices: int
    survivors: tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "survivors",
                           tuple(sorted(set(int(s) for s in self.survivors))))
        if self.orig_devices < 1 or self.num_parts % self.orig_devices:
            raise ValueError(
                f"num_parts={self.num_parts} is not a multiple of "
                f"orig_devices={self.orig_devices}")
        from repro_torch.launch.mesh import partition_layout
        partition_layout(self.num_parts, self.num_parts // self.orig_devices,
                         num_devices=self.orig_devices)
        if not self.survivors:
            raise ValueError("survivor set is empty — nothing to remap onto")
        if any(not 0 <= s < self.orig_devices for s in self.survivors):
            raise ValueError(
                f"survivors {self.survivors} out of range for "
                f"orig_devices={self.orig_devices}")

    @property
    def orig_n_local(self) -> int:
        """Partitions per device in the original layout."""
        return self.num_parts // self.orig_devices

    @property
    def n_devices(self) -> int:
        """Survivor count."""
        return len(self.survivors)

    @property
    def n_local(self) -> int:
        """Partitions per survivor (real + pad) in the remapped layout."""
        return math.ceil(self.num_parts / self.n_devices)

    @property
    def padded_parts(self) -> int:
        """Size of the remapped flat partition axis (pads appended)."""
        return self.n_devices * self.n_local

    @property
    def pad_parts(self) -> int:
        """Number of appended idle pad partitions."""
        return self.padded_parts - self.num_parts

    @property
    def lost(self) -> tuple[int, ...]:
        """Original device ids not in the survivor set."""
        return tuple(d for d in range(self.orig_devices)
                     if d not in self.survivors)

    def assignment(self) -> tuple[tuple[int, ...], ...]:
        """Real partition ids hosted by each survivor (positional), in
        device-major order; pads are omitted."""
        return tuple(
            tuple(p for p in range(d * self.n_local, (d + 1) * self.n_local)
                  if p < self.num_parts)
            for d in range(self.n_devices))

    def moved_partitions(self) -> frozenset:
        """Real partitions whose hosting device changed under the plan:
        the rows whose restored buffer state is warm-marked."""
        return frozenset(
            p for p in range(self.num_parts)
            if self.survivors[p // self.n_local] != p // self.orig_n_local)

    def device_view(self, tree, axis: int = 0):
        """Per-survivor (n_devices, n_local, …) view of a remapped
        flat-partition tree (graph_pipeline.to_local_layout)."""
        from repro_torch.data.graph_pipeline import to_local_layout
        return to_local_layout(tree, self.n_local, axis=axis)


# ---------------- remap / unmap (padding) ----------------


def _pad_axis(x, axis: int, extra: int):
    """`x` with `extra` zero (False) entries appended along `axis`."""
    if extra == 0:
        return x
    shape = list(x.shape)
    shape[axis] = extra
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _valid_items(items: np.ndarray) -> np.ndarray:
    """Items per partition before the (-1, …) fillers of `tile_schedule`."""
    return (items[..., 0] >= 0).sum(axis=1)


def _zero_partition_schedule(n_tiles: int, nb: int):
    """`tile_schedule` of one all-zero partition of n_tiles slots over nb
    output blocks: an empty work list and one empty item per block."""
    zeros = np.zeros((1, n_tiles), np.int32)
    return tile_schedule(run_pointers(zeros, nb), zeros.astype(bool), zeros,
                         zeros)


def _fit(rows: np.ndarray, width: int, filler, what: str) -> np.ndarray:
    """(n, k, f) rows padded with `filler` to (n, width, f)."""
    if rows.shape[1] > width:
        raise ValueError(
            f"the pad partitions' {what} needs {rows.shape[1]} entries but "
            f"the topology's has room for {width}: the kernels could not "
            "walk the padded layout")
    out = np.tile(np.asarray(filler, np.int32), (rows.shape[0], width, 1))
    out[:, :rows.shape[1]] = rows
    return out


def _remap_schedules(topo: Topology, plan: ElasticPlan) -> dict:
    """The six schedule fields on the padded layout: the real partitions'
    forward schedule as it is, their transpose schedule with one empty
    item (and run pointer) per column block the pads' halo slots add, and
    the pads' all-zero schedules (see the module docstring)."""
    pad, p = plan.pad_parts, plan.num_parts
    nrb = -(-topo.max_inner // TILE)
    ncb = -(-(topo.max_inner + topo.halo_size) // TILE)
    ncb_new = -(-(topo.max_inner + plan.padded_parts * topo.slot) // TILE)
    n_tiles = topo.tile_rows.shape[1]
    dev = topo.tile_items.device
    host = {k: getattr(topo, "tile_" + k).cpu().numpy()
            for k in ("row_ptr", "col_ptr", "work", "items", "t_work",
                      "t_items")}
    if host["row_ptr"].shape[1] != nrb + 1 or \
            host["col_ptr"].shape[1] != ncb + 1:
        raise ValueError(
            f"run pointers of widths {host['row_ptr'].shape[1]} / "
            f"{host['col_ptr'].shape[1]} do not fit {nrb} row and {ncb} "
            "column blocks")
    pad_work, pad_items = _zero_partition_schedule(n_tiles, nrb)
    _, pad_t_items = _zero_partition_schedule(n_tiles, ncb_new)
    filler = (-1, 0, 0, 0, 1)

    # the real partitions' transpose items, extended by the new blocks
    t_items = host["t_items"]
    count = _valid_items(t_items)
    extra = ncb_new - ncb
    width = max(int(count.max()) + extra, ncb_new)
    real_t = _fit(t_items[:, :int(count.max())], width, filler,
                  "transpose items")
    for q in range(p if extra else 0):
        c = int(count[q])
        end = int(t_items[q, c - 1, 2])
        real_t[q, c:c + extra] = [(r, end, end, 0, 1)
                                  for r in range(ncb, ncb_new)]
    col_ptr = np.concatenate(
        [host["col_ptr"], np.repeat(host["col_ptr"][:, -1:], extra, 1)], 1)
    pad_col_ptr = run_pointers(np.zeros((1, n_tiles), np.int32), ncb_new)
    pad_row_ptr = run_pointers(np.zeros((1, n_tiles), np.int32), nrb)

    def rows(real, pad_row):
        return np.concatenate([real, np.repeat(pad_row, pad, 0)], 0)

    out = dict(
        row_ptr=rows(host["row_ptr"], pad_row_ptr),
        col_ptr=rows(col_ptr, pad_col_ptr),
        work=rows(host["work"], _fit(pad_work, host["work"].shape[1],
                                     (0, 0), "work list")),
        items=rows(host["items"], _fit(pad_items, host["items"].shape[1],
                                       filler, "items")),
        t_work=rows(host["t_work"], _fit(pad_work, host["t_work"].shape[1],
                                         (0, 0), "transpose work list")),
        t_items=rows(real_t, _fit(pad_t_items, width, filler,
                                  "transpose items")))
    return {"tile_" + k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in out.items()}


def _unmap_schedules(topo: Topology, plan: ElasticPlan) -> dict:
    """Inverse of `_remap_schedules`: the real partitions' schedules with
    the items and run pointers of the pads' halo blocks stripped."""
    p = plan.num_parts
    ncb = -(-(topo.max_inner + p * topo.slot) // TILE)
    t_items = topo.tile_t_items[:p].cpu().numpy().copy()
    t_items[t_items[..., 0] >= ncb] = (-1, 0, 0, 0, 1)
    width = int(_valid_items(t_items).max())
    return dict(tile_row_ptr=topo.tile_row_ptr[:p],
                tile_col_ptr=topo.tile_col_ptr[:p, :ncb + 1],
                tile_work=topo.tile_work[:p], tile_items=topo.tile_items[:p],
                tile_t_work=topo.tile_t_work[:p],
                tile_t_items=torch.from_numpy(np.ascontiguousarray(
                    t_items[:, :width])).to(topo.tile_t_items.device))


_LEAD = ("edge_row", "edge_col", "edge_w", "inner_mask", "tile_rows",
         "tile_cols", "tile_vals", "tile_t_out", "tile_t_in", "tile_t_perm")
_SCHEDULES = ("tile_row_ptr", "tile_col_ptr", "tile_work", "tile_items",
              "tile_t_work", "tile_t_items")


def remap_topology(topo: Topology, plan: ElasticPlan) -> Topology:
    """Pad a Topology to the plan's survivor layout.

    The leading partition axis and the ``send_idx`` / ``send_mask`` peer
    axis grow to ``padded_parts``; pad partitions carry zero edges and
    tiles and all-False masks, so they aggregate nothing, send nothing
    valid, and (``inner_mask=False``) add nothing to loss or eval. The
    kernels' schedules become those of the padded tile streams
    (`_remap_schedules`); a pad schedule the kernels could not walk raises
    ValueError. COO views are built anew from the padded edges (pad
    partitions get empty segments).
    """
    if topo.num_parts != plan.num_parts:
        raise ValueError(
            f"topology has {topo.num_parts} partitions, plan remaps "
            f"{plan.num_parts}")
    pad = plan.pad_parts
    if pad == 0:
        return topo
    fields = {k: None if getattr(topo, k) is None
              else _pad_axis(getattr(topo, k), 0, pad) for k in _LEAD}
    fields.update(
        send_idx=_pad_axis(_pad_axis(topo.send_idx, 0, pad), 1, pad),
        send_mask=_pad_axis(_pad_axis(topo.send_mask, 0, pad), 1, pad))
    if all(getattr(topo, k) is not None for k in _SCHEDULES):
        fields.update(_remap_schedules(topo, plan))
    elif any(getattr(topo, k) is not None for k in _SCHEDULES):
        raise ValueError("the topology carries some of the kernels' "
                         "schedule fields but not all")
    padded = topo._replace(**fields)
    return padded if topo.coo_items is None else padded.with_coo_views()


def unmap_topology(topo: Topology, plan: ElasticPlan) -> Topology:
    """Inverse of :func:`remap_topology`: strip the pad partitions (COO
    views are built anew for the narrower halo)."""
    p = plan.num_parts
    if topo.num_parts == p:
        return topo
    fields = {k: None if getattr(topo, k) is None else getattr(topo, k)[:p]
              for k in _LEAD}
    fields.update(send_idx=topo.send_idx[:p, :p],
                  send_mask=topo.send_mask[:p, :p])
    if topo.tile_t_items is not None:
        fields.update(_unmap_schedules(topo, plan))
    unpadded = topo._replace(**fields)
    return unpadded if topo.coo_items is None else unpadded.with_coo_views()


def remap_data(data: ShardedData, plan: ElasticPlan) -> ShardedData:
    """Pad every leading-partition data tensor with zero rows (labels 0,
    masks False): pads never enter loss or metrics."""
    pad = plan.pad_parts
    if pad == 0:
        return data
    return type(data)(*(_pad_axis(a, 0, pad) for a in data))


def unmap_data(data: ShardedData, plan: ElasticPlan) -> ShardedData:
    """Inverse of :func:`remap_data`: strip the pad partitions."""
    if data.x.shape[0] == plan.num_parts:
        return data
    return type(data)(*(a[:plan.num_parts] for a in data))


def remap_buffers(buffers: dict, plan: ElasticPlan) -> dict:
    """Pad the pipeline staleness state to the survivor layout.

    Feature buffers ``(k?, P, P*slot, w)`` grow on both the partition axis
    and the peer-major halo axis (pad peers append ``pad*slot`` zero rows
    at the end; real halo offsets are untouched); gradient buffers
    ``(k?, P, max_inner, w)`` grow on the partition axis; the ``es``
    counters ``(P, 2, L, P)`` grow on both partition axes.
    """
    pad = plan.pad_parts
    if pad == 0:
        return buffers

    def feat(x):
        slot = x.shape[-2] // plan.num_parts
        x = _pad_axis(x, x.ndim - 3, pad)
        return _pad_axis(x, x.ndim - 2, pad * slot)

    out = {"feat": tuple(feat(b) for b in buffers["feat"]),
           "grad": tuple(_pad_axis(b, b.ndim - 3, pad)
                         for b in buffers["grad"])}
    if "es" in buffers:
        out["es"] = _pad_axis(_pad_axis(buffers["es"], 0, pad), 3, pad)
    return out


def unmap_buffers(buffers: dict, plan: ElasticPlan) -> dict:
    """Inverse of :func:`remap_buffers`: strip pad partitions and pad halo
    rows, restoring the flat original layout."""
    p = plan.num_parts
    if buffers["feat"] and buffers["feat"][0].shape[-3] == p:
        return buffers

    def feat(x):
        slot = x.shape[-2] // plan.padded_parts
        return x[..., :p, :p * slot, :]

    out = {"feat": tuple(feat(b) for b in buffers["feat"]),
           "grad": tuple(b[..., :p, :, :] for b in buffers["grad"])}
    if "es" in buffers:
        out["es"] = buffers["es"][:p, :, :, :p]
    return out


def warm_mark(buffers: dict, moved, warm: int, num_real: int) -> dict:
    """Escalate the es counters of every exchange touching a ``moved``
    partition to at least ``warm`` consecutive fallbacks.

    The restored rows of a remapped partition are checkpoint-old, which is
    what a ``warm``-deep fallback streak means to the guarded exchange:
    consumers keep using them, and ``max_staleness`` bounds how much
    longer they may keep failing. Pads (ids ≥ ``num_real``) are never
    marked.
    """
    if warm <= 0 or not moved or "es" not in buffers:
        return buffers
    es = buffers["es"]
    lead = es.shape[0]
    m = np.zeros((lead,), bool)
    m[list(moved)] = True
    real = np.zeros((lead,), bool)
    real[:num_real] = True
    touch = (m[:, None] | m[None, :]) & real[:, None] & real[None, :]
    touch = torch.from_numpy(touch[:, None, None, :]).to(es.device)
    stamp = torch.where(touch, torch.tensor(warm, dtype=es.dtype,
                                            device=es.device),
                        torch.zeros((), dtype=es.dtype, device=es.device))
    return {**buffers, "es": torch.maximum(es, stamp)}


def mask_pad_faults(tables: FaultTables, num_real: int) -> FaultTables:
    """Clear every compiled fault site whose source or destination is a
    pad partition (id ≥ ``num_real``), in the tensors and in their host
    copies (the step reads those to skip fault-free planes): pads ship
    all-zero payloads, and faulting them would leak spurious es counts
    into a remapped run."""

    def cut(t):
        t = t.clone() if isinstance(t, torch.Tensor) else t.copy()
        t[..., num_real:, :] = False
        t[..., :, num_real:] = False
        return t

    return tables._replace(drop=cut(tables.drop), corrupt=cut(tables.corrupt),
                           drop_np=cut(tables.drop_np),
                           corrupt_np=cut(tables.corrupt_np))


def detect_device_loss(es, n_local: int, num_real: int,
                       threshold: int = 2) -> int | None:
    """Scan one step's es counters for a whole-device outage.

    ``es`` is the (padded) ``(P, 2, L, P)`` counter array (numpy or a
    tensor), ``n_local`` the partitions per device of the current layout,
    ``num_real`` the real partition count. Returns the positional index of
    the first device whose every forward exchange to every off-device real
    destination has ≥ ``threshold`` consecutive fallbacks, else None: the
    min over the device's whole (dst, layer, src) block, so a scattered
    fault plan never trips it.
    """
    if isinstance(es, torch.Tensor):
        es = es.cpu().numpy()
    es = np.asarray(es)
    n_dev = es.shape[0] // n_local
    for d in range(n_dev):
        srcs = [p for p in range(d * n_local, (d + 1) * n_local)
                if p < num_real]
        dsts = [q for q in range(num_real) if q // n_local != d]
        if not srcs or not dsts:
            continue
        sub = es[np.ix_(dsts)][:, FWD][..., srcs]      # (dst, L, src)
        if sub.size and int(sub.min()) >= threshold:
            return d
    return None

